"""Stream milliseconds per height train step of the update (Adam with
coupled weight decay over the model and the log-vars), under the profiler:
the CUDA event pair of the span ``train.adam`` under each ``train.step``,
the median over the window's profiled steps but the oldest. Foreach Adam
launches many small kernels, so this reads mostly the gaps in which the
profiled host held the stream back."""
from benchmark.harness.program_spans import device, median_over, total


def read(record):
    return median_over("train.step", total("train.adam", device))
