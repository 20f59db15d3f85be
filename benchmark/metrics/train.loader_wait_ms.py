"""Host milliseconds per height train step that the loop waits for its
next batch from the port's DataLoader (``S12GlobeDataset`` in worker
processes: GeoTIFF reads, normalisation, augmentation, the hierarchy
targets; the copy to the card): the mean over every step of the traced
run's window, epoch starts included."""
from benchmark.harness.stats import mean


def read(record):
    waits = record.get("loader_wait_s")
    return None if not waits else 1e3 * mean(waits)
