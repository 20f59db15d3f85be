"""Stream milliseconds per GAN step of the discriminator's pass (two
forwards, the losses, the backward and gradient average), under the
profiler: the CUDA event pair of the span ``gan.d_pass`` under each
``gan.step``, the median over the window's profiled steps. It counts the
gaps in which the profiled host held the stream back
(``gan.g_pass_stream_ms``)."""
from benchmark.harness.program_spans import device, median_over, total


def read(record):
    return median_over("gan.step", total("gan.d_pass", device))
