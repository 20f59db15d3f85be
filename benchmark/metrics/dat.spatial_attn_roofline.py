"""Share of the spatial attention product's roofline, %: the least time of
a request's window-branch attention products (the larger of their q k^T
and p v operations over the TF32 peak and their bytes over the HBM rate: q,
k, v and the output once, the position bias and the shift mask once,
float32; ``harness/dat_counts.py``, the same work whatever route computes
it) over the device time of the kernels launched inside the port's ranges
``srbh.dat.spatial_core`` a request in the profiled stretch."""
from benchmark.harness.dat_counts import roofline_ms


def read(record):
    ms = record.get("range_kernel_ms", {}).get("dat.spatial_core")
    n = record.get("traced_requests")
    c = record.get("counts", {})
    if not ms or not n or "spatial_flops" not in c or not sum(ms):
        return None
    least, _ = roofline_ms(c)
    return 100.0 * least * n / sum(ms)
