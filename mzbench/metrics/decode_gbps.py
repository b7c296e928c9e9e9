"""decode_gbps: decoded bytes delivered in device memory over the whole
window, drain included, in decimal GB a second."""

from mzbench import yardstick


def read(rec, trace):
    if rec["kind"] != "decode" or not rec["bytes_out"]:
        return None
    return yardstick.gbps(sum(rec["bytes_out"]), rec["window_s"])
