"""The GAN step's share of the card's TF32 peak, %: the benchmark's count
of one step's operations (every forward and backward the step's algorithm
runs, counted by ``FlopCounterMode`` on the reference step at the meta
device) times the steps per second of the traced run's unprofiled steps,
over 495 TFLOP/s (H100 SXM, dense TF32: the configuration's float32 with
cuDNN's TF32)."""
from benchmark.harness.peaks import FLOP_PER_S


def read(record):
    if "step_flops" not in record:
        return None
    return (100.0 * record["step_flops"] * record["steps_per_s"]
            / FLOP_PER_S["tf32"])
