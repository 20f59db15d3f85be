"""Device milliseconds a SwinIR serving request of the body (the nine RSTBs,
the final LayerNorm and ``conv_after_body``): the kernels launched inside
the port's range ``srbh.swinir.body`` in the profiled stretch's trace,
summed, plus the window-attention kernels the trace links to no operation
(launched through ctypes; all 54 of a request run in the body), the median
over the stretch's requests (``None`` where the port opens no such span)."""
import statistics


def read(record):
    ms = record.get("range_kernel_ms", {}).get("swinir.body")
    return statistics.median(ms) if ms else None
