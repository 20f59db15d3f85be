"""Host milliseconds per GAN step spent in the two Adams and the EMA under
the profiler: spans ``gan.g_adam``, ``gan.d_adam`` and ``gan.ema`` under
each ``gan.step``, summed, the median over the window's profiled steps. The
profiler's own cost is in it."""
from benchmark.harness.program_spans import host, median_over, total

UPDATES = ("gan.g_adam", "gan.d_adam", "gan.ema")


def read(record):
    v = median_over("gan.step", total(UPDATES, host))
    return None if v is None else 1000 * v
