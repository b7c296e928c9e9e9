"""verify_ms.compress: the card's time in the byte-exact check
and extension of the parsed matches (``verify_extend``) a batch, in ms:
the span ``minlz.emit.verify``'s two CUDA events, at its entry and exit
on the stream, summed over the traced window
(``minlz_tpu_torch.trace.snapshot``), over its count."""

from mzbench import spans


def read(rec, trace):
    return spans.device_ms(rec, trace, "emit.verify")
