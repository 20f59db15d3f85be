"""Device milliseconds of the RRDBNet feature pass per batch: CUDA events
around the SR module's forward (the benchmark's hooks), the mean over every
request of the traced run's window."""
from benchmark.harness.stats import mean


def read(record):
    return mean(record.get("forward_ms", {}).get("sr_trunk", []))
