"""Framed MinLZ streams: Writer/Reader/ReadSeeker and the seek Index."""

from .index import Index
from .reader import Reader, ReadSeeker, decompress
from .writer import Writer, compress

__all__ = ["Writer", "Reader", "ReadSeeker", "Index", "compress", "decompress"]
