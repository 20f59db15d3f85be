"""Host seconds per city of the GeoTIFF writer's strip encode (spans
``tiff.encode`` under both ``predict.write``: DEFLATE of the heights, the
build classes uncompressed), summed, in the window's profiled city
(``predict.city`` roots, the median where there are more)."""
from benchmark.harness.program_spans import host, median_over, total


def read(record):
    return median_over("predict.city", total("tiff.encode", host))
