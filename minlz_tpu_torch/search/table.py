"""Search table configuration, spec hash family, and wire marshaling.

Parity: reference ``search_table.go`` (config/builders, 0x44/0x45 chunk
codec) and the SPEC_SEARCH.md §3.1 hash family.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..minlz import (
    CHUNK_TYPE_SEARCH_INFO,
    CHUNK_TYPE_SEARCH_TABLE,
    CorruptError,
    crc,
)

# SPEC_SEARCH.md §3.1 prime table.
_PRIMES = {
    2: 40503,
    3: 506832829,
    4: 2654435761,
    5: 889523592379,
    6: 227718039650203,
    7: 58295818150454627,
    8: 0xCF1BBCDCB7A56463,
}

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

TYPE_NO_PREFIX = 1
TYPE_BYTE_PREFIX = 2
TYPE_MASK_PREFIX = 3
TYPE_LONG_PREFIX = 4


def hash_value(val: int, table_size: int, match_len: int) -> int:
    """SPEC_SEARCH.md §3.1 HashValue — scalar form."""
    if match_len == 1:
        return val & 0xFF
    if match_len == 2:
        if table_size >= 16:
            return val & 0xFFFF
        return (((val << 16) & _M32) * _PRIMES[2] & _M32) >> (32 - table_size)
    if match_len == 3:
        return (((val << 8) & _M32) * _PRIMES[3] & _M32) >> (32 - table_size)
    if match_len == 4:
        return ((val & _M32) * _PRIMES[4] & _M32) >> (32 - table_size)
    if 5 <= match_len <= 7:
        shifted = (val << (64 - 8 * match_len)) & _M64
        return (shifted * _PRIMES[match_len] & _M64) >> (64 - table_size)
    if match_len == 8:
        return ((val & _M64) * _PRIMES[8] & _M64) >> (64 - table_size)
    raise ValueError(f"match_len must be 1..8, got {match_len}")


def hash_values_np(vals: np.ndarray, table_size: int, match_len: int):
    """Vectorized HashValue over uint64 window values."""
    vals = vals.astype(np.uint64)
    if match_len == 1:
        return (vals & np.uint64(0xFF)).astype(np.uint32)
    if match_len == 2:
        if table_size >= 16:
            return (vals & np.uint64(0xFFFF)).astype(np.uint32)
        v = (vals << np.uint64(16)).astype(np.uint32)
        with np.errstate(over="ignore"):
            return (v * np.uint32(_PRIMES[2])) >> np.uint32(32 - table_size)
    if match_len == 3:
        v = (vals << np.uint64(8)).astype(np.uint32)
        with np.errstate(over="ignore"):
            return (v * np.uint32(_PRIMES[3])) >> np.uint32(32 - table_size)
    if match_len == 4:
        v = vals.astype(np.uint32)
        with np.errstate(over="ignore"):
            return (v * np.uint32(_PRIMES[4])) >> np.uint32(32 - table_size)
    shift = 64 - 8 * match_len
    with np.errstate(over="ignore"):
        v = vals << np.uint64(shift) if shift else vals
        return ((v * np.uint64(_PRIMES[match_len]))
                >> np.uint64(64 - table_size)).astype(np.uint32)


@dataclass
class SearchTableConfig:
    """Search table configuration (reference SearchTableConfig,
    search_table.go:35; builder-style ``with_*`` helpers)."""

    match_len: int = 6
    table_bits: int = 0  # 0 = auto from block size, clamped [8, 23]
    table_type: int = TYPE_NO_PREFIX
    prefixes: bytes = b""  # type 2: 1-8 bytes; type 4: the long prefix
    prefix_mask: set = field(default_factory=set)  # type 3: byte values
    extra_matches: int = 0  # type 4 only; match_len+extras <= 16
    max_population: float = 0.70  # skip emitting tables denser than this
    max_reduced_population: float = 0.25
    compression: bool = True  # emit 0x46 chunks when smaller than 0x45

    def with_match_len(self, n: int) -> "SearchTableConfig":
        self.match_len = n
        return self

    def with_compression(self, on: bool) -> "SearchTableConfig":
        self.compression = on
        return self

    def with_byte_prefix(self, *values) -> "SearchTableConfig":
        b = bytes(values[0]) if len(values) == 1 and not isinstance(
            values[0], int) else bytes(values)
        if not 1 <= len(b) <= 8:
            raise ValueError("byte prefix needs 1-8 values")
        self.table_type = TYPE_BYTE_PREFIX
        self.prefixes = b
        return self

    def with_mask_prefix(self, values) -> "SearchTableConfig":
        self.table_type = TYPE_MASK_PREFIX
        self.prefix_mask = set(values)
        return self

    def with_long_prefix(self, prefix: bytes, extras: int = 0
                         ) -> "SearchTableConfig":
        if not 1 <= len(prefix) <= 256:
            raise ValueError("long prefix must be 1-256 bytes")
        if self.match_len + extras > 16:
            raise ValueError("match_len + extras must be <= 16")
        self.table_type = TYPE_LONG_PREFIX
        self.prefixes = bytes(prefix)
        self.extra_matches = extras
        return self

    def validate(self) -> None:
        if not 1 <= self.match_len <= 8:
            raise ValueError("match_len must be 1..8")
        if self.table_bits and not 8 <= self.table_bits <= 23:
            raise ValueError("table_bits must be 8..23")
        if self.table_type == TYPE_LONG_PREFIX:
            if self.match_len + self.extra_matches > 16:
                raise ValueError("match_len + extras must be <= 16")

    def auto_bits(self, block_size: int) -> int:
        if self.table_bits:
            return self.table_bits
        return max(8, min(23, (block_size - 1).bit_length()))

    # --- Wire: prefix field ------------------------------------------------

    def _prefix_field(self) -> bytes:
        if self.table_type == TYPE_NO_PREFIX:
            return b""
        if self.table_type == TYPE_BYTE_PREFIX:
            p = self.prefixes
            return p + p[-1:] * (8 - len(p))
        if self.table_type == TYPE_MASK_PREFIX:
            mask = bytearray(32)
            for v in self.prefix_mask:
                mask[v >> 3] |= 1 << (v & 7)
            return bytes(mask)
        # Long prefix: [len-1][extras][prefix]
        return bytes([len(self.prefixes) - 1, self.extra_matches]) + self.prefixes

    # --- Wire: 0x44 search info chunk --------------------------------------

    def marshal_info(self, block_size: int) -> bytes:
        self.validate()
        payload = bytes([self.table_type, self.match_len,
                         self.auto_bits(block_size)]) + self._prefix_field()
        return bytes([CHUNK_TYPE_SEARCH_INFO]) + len(payload).to_bytes(
            3, "little") + payload

    # --- Wire: 0x45 table chunk --------------------------------------------

    def marshal_table(self, block_size: int, table: bytes,
                      reductions: int) -> bytes:
        if self.compression:
            from .compressed import marshal_compressed_table

            chunk = marshal_compressed_table(
                self, block_size, table, reductions
            )
            if chunk is not None:
                return chunk
        payload = bytearray([self.table_type, self.match_len,
                             self.auto_bits(block_size)])
        payload += self._prefix_field()
        payload.append(reductions)
        payload += crc(table).to_bytes(4, "little")
        payload += table
        return bytes([CHUNK_TYPE_SEARCH_TABLE]) + len(payload).to_bytes(
            3, "little") + bytes(payload)


def parse_table_header(payload: bytes):
    """Parse a 0x44 or 0x45 payload header.

    Returns (config, base_bits, pos) with pos at the reductions byte (0x45)
    or end (0x44)."""
    if len(payload) < 3:
        raise CorruptError("short search table header")
    ttype, mlen, bits = payload[0], payload[1], payload[2]
    if not 1 <= mlen <= 8 or not 8 <= bits <= 23:
        raise CorruptError("invalid search table parameters")
    cfg = SearchTableConfig(match_len=mlen, table_bits=bits, table_type=ttype)
    pos = 3
    if ttype == TYPE_NO_PREFIX:
        pass
    elif ttype == TYPE_BYTE_PREFIX:
        cfg.prefixes = payload[pos : pos + 8]
        pos += 8
    elif ttype == TYPE_MASK_PREFIX:
        mask = payload[pos : pos + 32]
        pos += 32
        cfg.prefix_mask = {
            v for v in range(256) if mask[v >> 3] & (1 << (v & 7))
        }
    elif ttype == TYPE_LONG_PREFIX:
        plen = payload[pos] + 1
        cfg.extra_matches = payload[pos + 1]
        if mlen + cfg.extra_matches > 16:
            raise CorruptError("match_len + extras exceeds 16")
        cfg.prefixes = payload[pos + 2 : pos + 2 + plen]
        pos += 2 + plen
    else:
        raise CorruptError(f"unknown search table type {ttype}")
    return cfg, bits, pos


def parse_table_chunk(payload: bytes):
    """Parse a 0x45 payload.  Returns (config, bits, reductions, table)."""
    cfg, bits, pos = parse_table_header(payload)
    if pos + 5 > len(payload):
        raise CorruptError("truncated search table")
    reductions = payload[pos]
    want_crc = int.from_bytes(payload[pos + 1 : pos + 5], "little")
    table = payload[pos + 5 :]
    if len(table) < 32:
        raise CorruptError("search table below 256 entries")
    if len(table) != 1 << (bits - reductions - 3):
        raise CorruptError("search table size mismatch")
    if crc(table) != want_crc:
        raise CorruptError("search table CRC mismatch")
    return cfg, bits, reductions, table
