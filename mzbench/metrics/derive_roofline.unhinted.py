"""derive_roofline.unhinted: what a derivation must move at least (every
compressed byte read once, the plan of the lanes the sequential walk cuts
written once: ``derive_reference.plan_bytes``), over the card's HBM
bandwidth, as a share (%) of the card's time in the program's span
``minlz.decode.derive`` over the traced window.  It counts the same work
whatever implements it.  None where the program has no such span."""

from mzbench import spans, yardstick


def read(rec, trace):
    if trace is None or rec["kind"] != "decode" or not rec.get("plan_bytes"):
        return None
    snap = spans.snapshot()
    st = snap and snap["spans"].get("decode.derive")
    if not st or not st["count"] or st["device_s"] is None:
        return None
    per_call = sum(rec["plan_bytes"]) / len(rec["plan_bytes"])
    return yardstick.roofline_pct(per_call * st["count"], st["device_s"])
