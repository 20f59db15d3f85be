"""Stream milliseconds per height train step of the model pass (the height
model's forward with drop-connect, the three adaptive losses, the backward
and the log-vars' gradient average), under the profiler: the CUDA event
pair of the span ``train.model_pass`` under each ``train.step``, the median
over the window's profiled steps but the oldest. It counts the gaps in
which the profiled host held the stream back."""
from benchmark.harness.program_spans import device, median_over, total


def read(record):
    return median_over("train.step", total("train.model_pass", device))
