"""Share of the SR trunk's roofline, %: the least time of one batch's
RRDBNet feature pass (the larger of its operations over the bf16 peak and
its bytes, each conv's input, weight and output once, over the HBM rate;
the benchmark's own count on the reference modules) over the device time
of the kernels launched inside the trunk's forward in the profiled
stretch, per batch."""
from benchmark.harness.peaks import roofline_seconds
from benchmark.harness.stats import mean


def read(record):
    spans = record.get("trace", {}).get("span_device_s", {}).get("sr_trunk")
    t = mean([s for s in spans or [] if s > 0])
    if not t:
        return None
    fl = record["flops"]
    least, _ = roofline_seconds(fl["trunk_flops"], fl["trunk_bytes"],
                                "bfloat16")
    return 100.0 * least / t
