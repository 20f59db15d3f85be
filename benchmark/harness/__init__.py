"""What every cell shares: the environment, the registry of files, seeded
weights, counts of operations and bytes, spans, the trace's reduction and
the statistics of a window."""
