"""Device milliseconds of the height model's forward per batch (EfficientNet
encoder, both decoders, the fusion heads): CUDA events around the module's
forward, the mean over every request of the traced run's window."""
from benchmark.harness.stats import mean


def read(record):
    return mean(record.get("forward_ms", {}).get("height_model", []))
