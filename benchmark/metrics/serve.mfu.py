"""The serving step's share of the card's bf16 peak, %: the benchmark's
operations per batch of the whole forward (SR features and height model)
times the batches per second of the traced run's window, over 989 TFLOP/s
(H100 SXM, dense; the card's power limit is in the run's notes)."""
from benchmark.harness.peaks import FLOP_PER_S


def read(record):
    if "flops" not in record:
        return None
    per_tile = record["flops"]["step_flops"] / record["batch"]
    return 100.0 * per_tile * record["tiles_per_s"] / FLOP_PER_S["bfloat16"]
