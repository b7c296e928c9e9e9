"""host_ms.decode: the median host time of one
``exec_chain.decode_planned`` call, in ms, by ``time.perf_counter_ns`` in
the program's own span ``minlz.decode.planned``
(``minlz_tpu_torch.trace.snapshot``): the four wrappers' launches, inside
the benchmark's own clock of ``enqueue_ms.decode``."""

from mzbench import spans


def read(rec, trace):
    return spans.median_host_ms(rec, trace, "decode.planned")
