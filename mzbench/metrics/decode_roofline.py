"""decode_roofline: the compressed bytes read once plus the decoded bytes
written once, over the card's HBM bandwidth, as a share (%) of the device
time in the traced window, in which the card runs only the requests'
decodes (K1, the lane scan, K2, K3 and the torch ops between them).  It
counts the same work whatever implements it."""

from mzbench import yardstick


def read(rec, trace):
    if trace is None or rec["kind"] != "decode" or not rec["bytes_out"]:
        return None
    return yardstick.roofline_pct(sum(rec["bytes_in"]) + sum(rec["bytes_out"]),
                                  trace["busy_s"])
