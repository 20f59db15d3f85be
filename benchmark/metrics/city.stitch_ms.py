"""Host milliseconds per batch of the host stitcher's blend,
``MosaicAccumulator.add_batch`` (the C++ blender), the mean over every batch
of every city of the traced run's window."""
from benchmark.harness.stats import mean


def read(record):
    adds = record.get("spans", {}).get("stitch")
    return None if not adds else 1e3 * mean(adds)
