"""decode_p95_ms: the 95th percentile (nearest rank) of every request's
latency in the window, from the host's submit to the host seeing the
request's CUDA event done, in ms."""

from mzbench import yardstick


def read(rec, trace):
    if rec["kind"] != "decode" or not rec["latency_s"]:
        return None
    return 1e3 * yardstick.nearest_rank(rec["latency_s"], 0.95)
