"""Stream milliseconds per GAN step of the updates, under the profiler: the
CUDA event pairs of the spans ``gan.g_adam``, ``gan.d_adam`` and ``gan.ema``
under each ``gan.step``, summed, the median over the window's profiled
steps. Foreach Adam launches many small kernels, so this reads mostly the
gaps in which the profiled host held the stream back
(``gan.g_pass_stream_ms``)."""
from benchmark.harness.program_spans import device, median_over, total

UPDATES = ("gan.g_adam", "gan.d_adam", "gan.ema")


def read(record):
    return median_over("gan.step", total(UPDATES, device))
