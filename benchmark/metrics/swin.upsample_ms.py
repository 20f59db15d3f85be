"""Device milliseconds a SwinIR serving request of the ``nearest+conv``
head (two nearest x2 + conv stages, ``conv_hr``, ``conv_last``): the kernels
launched inside the port's range ``srbh.swinir.upsample`` in the profiled
stretch's trace, summed, the median over the stretch's requests (``None``
where the port opens no such span)."""
import statistics


def read(record):
    ms = record.get("range_kernel_ms", {}).get("swinir.upsample")
    return statistics.median(ms) if ms else None
