"""idle_share.unhinted: the share, in %, of the traced window in which no
kernel, copy or memset ran on the card (torch.profiler), in the cell whose
requests derive their plans from blocks without parse hints; it moves
decode_gbps."""


def read(rec, trace):
    if trace is None or rec["kind"] != "decode" or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
