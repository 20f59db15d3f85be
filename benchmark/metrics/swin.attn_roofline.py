"""Share of the fused window attention's roofline, %: the least time of a
request's window attentions (the larger of their operations over the TF32
peak and their bytes, q, k, v and the output once and the bias and shift
mask once, over the HBM rate: the bytes; ``harness/swin_counts.py``) over
the device time of the kernels named ``window_attention_kernel`` a request
in the profiled stretch."""
from benchmark.harness.peaks import roofline_seconds


def read(record):
    if not record.get("attn_kernels") or not record.get("traced_requests"):
        return None
    c = record["counts"]
    least, _ = roofline_seconds(c["attn_flops"], c["attn_bytes"], "tf32")
    return 100.0 * least * record["traced_requests"] / record["attn_kernel_s"]
