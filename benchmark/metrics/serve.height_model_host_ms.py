"""Host milliseconds per serving batch that the program spends enqueuing the
height model's forward under the profiler: its span
``predict.height_model`` under each root ``predict.step``, the median over
the window's profiled batches (beside ``serve.height_model_ms``). The
profiler's own cost is in it."""
from benchmark.harness.program_spans import host, median_over, total


def read(record):
    v = median_over("predict.step", total("predict.height_model", host))
    return None if v is None else 1000 * v
