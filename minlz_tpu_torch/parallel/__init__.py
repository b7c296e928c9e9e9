"""Multi-device scaling for minlz_tpu_torch over ``torch.distributed``: one
process per device, ``make_mesh`` on an initialised process group, and the
``sharded_*`` functions on each rank's share of the blocks.
``parallel.ranks.run`` spawns local ranks."""

from .mesh import (
    assemble_blocks,
    make_mesh,
    sharded_decode_parse,
    sharded_encode_blocks,
    sharded_encode_blocks_dict,
    sharded_pipeline_step,
)

__all__ = [
    "assemble_blocks",
    "make_mesh",
    "sharded_decode_parse",
    "sharded_encode_blocks",
    "sharded_encode_blocks_dict",
    "sharded_pipeline_step",
]
