"""Host seconds per city of ``MosaicAccumulator.finalize`` (span
``predict.finalize``), in the window's profiled city (``predict.city``
roots, the median where there are more)."""
from benchmark.harness.program_spans import host, median_over, total


def read(record):
    return median_over("predict.city", total("predict.finalize", host))
