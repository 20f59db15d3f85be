"""The DAT serving step's share of the card's TF32 peak, %: the benchmark's
operations a tile of DAT's forward (``FlopCounterMode`` on the reference at
the meta device: convolutions, linears and both attentions' products) times
the tiles per second of the traced run's unprofiled requests, over 495
TFLOP/s (H100 SXM, dense TF32: the configuration's float32 with cuDNN's
TF32; the card's power limit is in the run's notes)."""
from benchmark.harness.peaks import FLOP_PER_S


def read(record):
    c = record.get("counts", {})
    if "tile_flops" not in c or "spatial_flops" not in c:
        return None
    return 100.0 * c["tile_flops"] * record["tiles_per_s"] / FLOP_PER_S["tf32"]
