"""encode_gbps: input bytes whose blocks were written to the sink over
the whole window, the last stream's close included, in decimal GB a
second."""

from mzbench import yardstick


def read(rec, trace):
    if rec["kind"] != "encode" or not rec["bytes_in"]:
        return None
    return yardstick.gbps(rec["bytes_in"], rec["window_s"])
