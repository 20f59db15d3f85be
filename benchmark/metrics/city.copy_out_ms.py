"""Host milliseconds per batch of ``predict_city``'s copy of both maps to the
host (span ``predict.copy_out``: the wait for the step's kernels and the
copy), the mean over the batches of the window's profiled city
(``predict.city`` roots, the median where there are more)."""
from benchmark.harness.program_spans import host, median_over, per_unit


def read(record):
    v = median_over("predict.city", per_unit("predict.copy_out", host))
    return None if v is None else 1000 * v
