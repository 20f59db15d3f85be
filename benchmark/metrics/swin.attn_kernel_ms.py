"""Device milliseconds a SwinIR serving request of the fused window
attention: the kernels named ``window_attention_kernel`` in the profiled
stretch's trace, summed, over the stretch's requests."""


def read(record):
    if not record.get("attn_kernels") or not record.get("traced_requests"):
        return None
    return 1000.0 * record["attn_kernel_s"] / record["traced_requests"]
