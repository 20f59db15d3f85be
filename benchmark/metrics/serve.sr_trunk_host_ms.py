"""Host milliseconds per serving batch that the program spends enqueuing the
RRDBNet feature pass under the profiler: its span ``predict.sr_features``
under each root ``predict.step`` (a step called alone, one batch), the
median over the window's profiled batches. The profiler's own cost is in
it: beside ``serve.sr_trunk_ms`` it overstates how close the trunk is to
being launch-bound."""
from benchmark.harness.program_spans import host, median_over, total


def read(record):
    v = median_over("predict.step", total("predict.sr_features", host))
    return None if v is None else 1000 * v
