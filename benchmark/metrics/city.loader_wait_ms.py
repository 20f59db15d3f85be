"""Host milliseconds per batch that ``predict_city``'s loop waits for the
next batch from the port's DataLoader (grid windows read and normalised by
four worker processes, copied to the card): the mean over every batch of
every city of the traced run's window."""
from benchmark.harness.stats import mean


def read(record):
    waits = record.get("spans", {}).get("loader_wait")
    return None if not waits else 1e3 * mean(waits)
