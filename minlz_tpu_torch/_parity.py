"""Public names of ``minlz_tpu`` that the port leaves out on purpose.

Every public function, class and method of a ``minlz_tpu`` module has a
counterpart of the same name in the same module of this package (module
path relative to the package root), except the names below, each with the
reason.  ``tests/test_torch_api_parity.py`` walks both packages and holds
them to this table: a missing name that is not listed fails, and so does a
listed name that the port has after all.  A module listed under ``"*"`` has
no file in the port; its table lists every public name it had.
"""

NOT_PORTED = {
    "ops/exec_chain.py": {
        "chain_geometry": "sizes the TPU's MAXC chains (segments a chain, "
                          "chain count); the port runs a thread block a "
                          "range and has no chains",
        "tile_words": "pads a grid step's op words to Mosaic's 1024-word "
                      "tiling; the port's records are plain int32 rows",
    },
    "ops/pallas_decode.py": {
        "*": "the Pallas decode kernels; their CUDA counterparts live in "
             "ops/parse.py, ops/exec_chain.py, ops/exec_block.py and csrc/",
        "parse_row_tile": "sizes the parse's VMEM row tile; the parse "
                          "kernel (csrc/parse.cu) takes a lane a block",
        "parse_segments_pallas": "kernel 1: ops/parse.py parse_segments "
                                 "(csrc/parse.cu); the scan layout is "
                                 "ops/decode_kernel.py parse_segments_scan",
        "compact_ops": "kernel 5: ops/exec_chain.py compact_records at "
                       "whole-block lane spans (csrc/compact.cu)",
        "execute_ops_pallas": "kernel 4: ops/exec_block.py execute_blocks "
                              "(csrc/exec_block.cu)",
        "decode_block_tpu": "the whole-block road: ops/exec_block.py "
                            "decode_block_whole",
    },
    "ops/pallas_encode.py": {
        "*": "the Pallas greedy kernel; its CUDA counterpart is ops/greedy.py "
             "(csrc/greedy.cu)",
        "greedy_parse_pallas": "kernel 8: ops/greedy.py greedy_parse "
                               "(csrc/greedy.cu), also under its JAX name in "
                               "ops/encode_kernel.py",
    },
}
