"""idle_share.compress: the share, in %, of the traced window in which no
kernel, copy or memset ran on the card (torch.profiler); it moves
encode_gbps."""


def read(rec, trace):
    if trace is None or rec["kind"] != "encode" or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
