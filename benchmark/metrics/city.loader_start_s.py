"""Host seconds per city of the loader's start (span ``loader.start``: four
worker processes started and the first ``prefetch + 1`` batches read), in
the window's profiled city (``predict.city`` roots, the median where there
are more)."""
from benchmark.harness.program_spans import host, median_over, total


def read(record):
    return median_over("predict.city", total("loader.start", host))
