"""enqueue_ms.decode: the median host time of one
exec_chain.decode_planned call and the event recorded after it (the
wrappers' launches), by the benchmark's own host clock around the call,
in ms; read in the traced run, so it carries the profiler's cost."""

from mzbench import yardstick


def read(rec, trace):
    if rec["kind"] != "decode" or not rec["enqueue_s"]:
        return None
    return 1e3 * yardstick.median(rec["enqueue_s"])
