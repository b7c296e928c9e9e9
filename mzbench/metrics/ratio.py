"""ratio: stream bytes over input bytes, every chunk counted (stream
identifier, parse hints, CRCs, EOF and index)."""


def read(rec, trace):
    if rec["kind"] != "encode" or not rec["bytes_in"]:
        return None
    return rec["bytes_out"] / rec["bytes_in"]
