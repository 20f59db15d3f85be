"""Per-layer metric readers, one file per metric, named as the metric.
Each defines ``read(record) -> float | None``."""
