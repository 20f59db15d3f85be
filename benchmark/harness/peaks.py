"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates without sparsity). A card set below 700 W reaches less;
every run records the card's power limit beside its shares."""

FLOP_PER_S = {
    "bfloat16": 989e12,
    "tf32": 495e12,
}
HBM_BYTES_PER_S = 3.35e12


def roofline_seconds(flops: float, nbytes: float, kind: str):
    """(least seconds, bound): the larger of operations over the peak of
    ``kind`` and bytes over the HBM rate, and which of the two it is."""
    t_ops = flops / FLOP_PER_S[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
