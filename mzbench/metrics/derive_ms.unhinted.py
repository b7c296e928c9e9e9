"""derive_ms.unhinted: the card's time deriving one request's plan from
blocks without parse hints (``derive.derive_plan``: token starts, lane
spans, incoming repeat offsets), in ms: the program's span
``minlz.decode.derive``'s two CUDA events, at its entry and exit on the
stream, summed over the traced window (``minlz_tpu_torch.trace.snapshot``),
over its count.  None where the program has no such span."""

from mzbench import spans


def read(rec, trace):
    if trace is None or rec["kind"] != "decode":
        return None
    snap = spans.snapshot()
    st = snap and snap["spans"].get("decode.derive")
    if not st or not st["count"] or st["device_s"] is None:
        return None
    return 1e3 * st["device_s"] / st["count"]
