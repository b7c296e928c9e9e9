"""host_ms.compress: the host's own time a batch in the four host
stages of the device_emit Writer, in ms, by ``time.perf_counter_ns`` in
the program's spans (``minlz_tpu_torch.trace.snapshot``): the self time
(less the children's) of ``minlz.writer.encode_buffer`` (the block
slices), ``minlz.codec.pack_batch`` (the numpy batch),
``minlz.codec.frame_segments`` (the join of each block's segments and its
hints) and ``minlz.writer.frame`` (CRC and chunk framing), over the count
of ``minlz.writer.flush_batch``."""

from mzbench import spans

STAGES = ["writer.encode_buffer", "codec.pack_batch", "codec.frame_segments",
          "writer.frame"]


def read(rec, trace):
    return spans.self_ms(rec, trace, STAGES, "writer.flush_batch")
