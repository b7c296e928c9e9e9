"""Where the port's API leaves ``minlz_tpu``'s on purpose: names and
arguments.

The name rule: every public function, class and method of a ``minlz_tpu``
module has a counterpart of the same name in the same module of this package
(module path relative to the package root), except the names in
``NOT_PORTED``, each with the reason.  A module listed under ``"*"`` has no
file in the port; its table lists every public name it had.

The argument rule: a counterpart that is a function or a method (a class's
``__init__`` included) takes the JAX function's parameters, by name, in
their order and of their kind (positional or keyword-only), with a default
wherever JAX has one, so that every call of the JAX function is a call of
the port's.  The port may add parameters after them, each with a default
(``device="cuda"`` mostly).  The exceptions are in ``ARGS_DIFFER``, each
with the port's parameters as they stand and the reason.

``tests/test_torch_api_parity.py`` walks both packages with ``ast`` and holds
them to both tables: a difference that is not listed fails, and so does a
listed one that has gone, or whose parameters are no longer the ones
listed.
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

ARGS_DIFFER = {
    # name: (the port's parameters, "=" after one with a default and "*"
    # before the keyword-only ones; the reason)
    "ops/exec_chain.py": {
        "compact_ops_fast": (
            "recs, counts, lane_start, lane_len, lane_lo, lane_hi",
            "JAX packs the scan's seven [P, B] arrays into the TPU arena's "
            "op words (lane offsets and counts, out_base, last_row, nchain, "
            "cap_chain, pc, n_arena_rows); the port's name is "
            "compact_records, on the parse's records"),
        "compact_ops_dense": (
            "recs, counts, lane_start, lane_len",
            "JAX packs the scan's arrays into per-chain arena words "
            "(nchain, cap_chain, pc, guard); the port's name is "
            "compact_records_dense, on the parse's records"),
        "execute_fast": (
            "crec, range_first, range_out, range_span, comp, total_out, "
            "max_span=, spans_checked=",
            "JAX runs tile-major arena words (ops_flat, ends, nchain, "
            "cap_chain, n_arena_rows); the port's name is execute_ranges, "
            "on positioned records and range tables"),
        "plan_batch": (
            "blocks_segs, seg, rng=",
            "cap_pr and planar size and lay out the TPU's VMEM arena (ops "
            "a chain row, byte-planar words); the port's plan is lanes and "
            "ranges, with no arena"),
        "decode_blocks_chained": (
            "blocks_segs, out_totals, seg, rng=, device=, executor=",
            "cap_pr and planar are the arena's knobs (see plan_batch); the "
            "port takes the device and the executor (fast or scheduled) in "
            "their place"),
        "execute_scheduled": (
            "drec, range_first, range_out, range_span, comp, total_out, "
            "max_span=, spans_checked=",
            "JAX takes the packed arena (ops_flat tile words, per-slot "
            "counts, bases, lastrows, nchain, K, cap_chain, n_arena_rows, "
            "planar); the port's append-only executor takes dense records "
            "and range tables, as execute_ranges does"),
    },
    "parallel/mesh.py": {
        "make_mesh": (
            "group=, device=",
            "a JAX mesh is an array of devices and an axis name; the "
            "port's is a torch.distributed group (one process a device) "
            "and this rank's device"),
    },
    "ops/transducer.py": {
        "init_state": (
            "lanes, device",
            "jnp builds the state for an array shape on the default "
            "device; torch takes the lane count and the device the state "
            "lives on"),
    },
    "ops/encode_kernel.py": {
        "greedy_parse_compact": (
            "off, length, seg=",
            "max_ops sizes JAX's padded output (a jit needs a static "
            "size); the port returns exactly count entries, so there is "
            "nothing to size"),
        "find_matches_dyn": (
            "data, n, seg=, rng=, level=, exact=",
            "data is [B, N], B blocks with their valid lengths n (the "
            "batch that JAX vmaps), where JAX takes one block, data_flat "
            "[1, N]"),
    },
    "ops/emit.py": {
        "encode_block_emit": (
            "data, n, seg, rng=, level=, ctx=",
            "data is [B, N], B blocks with their valid lengths n (the "
            "batch that JAX vmaps), where JAX takes one block, data_flat "
            "[1, N]"),
    },
}
