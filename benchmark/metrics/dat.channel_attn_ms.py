"""Device milliseconds a DAT serving request of the channel attention
blocks (qkv, the transposed attention, the conv branch, the gates and
``proj``): the kernels launched inside the port's ranges
``srbh.dat.channel_attn`` in the profiled stretch's trace, summed, over the
stretch's requests (``None`` where the port opens no such span)."""


def read(record):
    ms = record.get("range_kernel_ms", {}).get("dat.channel_attn")
    n = record.get("traced_requests")
    return sum(ms) / n if ms and n else None
