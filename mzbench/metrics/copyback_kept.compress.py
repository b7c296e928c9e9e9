"""copyback_kept.compress: the share, in %, of the bytes copied back
from the card (the padded ``[B, nseg, seg + 64]`` segments and their
lengths; counter ``codec.copy_back_bytes``) that go into the stream as
segment bytes (counter ``codec.kept_bytes``), over the traced window
(``minlz_tpu_torch.trace.snapshot``)."""

from mzbench import spans


def read(rec, trace):
    return spans.share_pct(rec, trace, "codec.kept_bytes",
                           "codec.copy_back_bytes")
