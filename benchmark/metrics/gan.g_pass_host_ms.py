"""Host milliseconds per GAN step spent in the generator's pass under the
profiler: span ``gan.g_pass`` under each ``gan.step``, the median over the
window's profiled steps. The profiler's own cost is in it."""
from benchmark.harness.program_spans import host, median_over, total


def read(record):
    v = median_over("gan.step", total("gan.g_pass", host))
    return None if v is None else 1000 * v
