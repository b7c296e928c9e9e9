"""encode_roofline: the input bytes read once plus the stream bytes
written once, over the card's HBM bandwidth, as a share (%) of the device
time in the traced window (match-find, greedy, verify_extend,
emit_segments and the copies in and back)."""

from mzbench import yardstick


def read(rec, trace):
    if trace is None or rec["kind"] != "encode" or not rec["bytes_in"]:
        return None
    return yardstick.roofline_pct(rec["bytes_in"] + rec["bytes_out"],
                                  trace["busy_s"])
