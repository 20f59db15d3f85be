"""Stream milliseconds per GAN step of the generator's pass (USM, G, the
frozen D, VGG19, the losses, G's backward and gradient average), under the
profiler: the CUDA event pair of the span ``gan.g_pass`` under each
``gan.step``, the median over the window's profiled steps. It is the card's
work plus the gaps in which the profiled host held the stream back, so it
reads device time only where the card, not the host, sets the pace."""
from benchmark.harness.program_spans import device, median_over, total


def read(record):
    return median_over("gan.step", total("gan.g_pass", device))
