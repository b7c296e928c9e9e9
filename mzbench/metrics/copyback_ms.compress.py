"""copyback_ms.compress: the card's time copying a batch's padded
segments and their lengths back to host memory (the two ``.cpu()`` of
``DeviceCodec._emit_results``), in ms: the span ``minlz.codec.copy_back``'s
two CUDA events, at its entry and exit on the stream, summed over the
traced window (``minlz_tpu_torch.trace.snapshot``), over its count."""

from mzbench import spans


def read(rec, trace):
    return spans.device_ms(rec, trace, "codec.copy_back")
