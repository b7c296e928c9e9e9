"""host_ms.unhinted: the median host time of one
``exec_block.decode_unhinted`` call, in ms, by ``time.perf_counter_ns`` in
the program's own span ``minlz.decode.unhinted``
(``minlz_tpu_torch.trace.snapshot``): the derivation's, the parse's, the
compaction's and the executor's launches."""

from mzbench import spans


def read(rec, trace):
    return spans.median_host_ms(rec, trace, "decode.unhinted")
