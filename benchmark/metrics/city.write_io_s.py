"""Host seconds per city of the two GeoTIFF writes outside their strip
encode: each ``predict.write`` span's own time (header, tags, file I/O,
less its ``tiff.encode``), summed, in the window's profiled city
(``predict.city`` roots, the median where there are more). Beside
``city.tiff_encode_s`` it says whether the encode or the writer's I/O
holds the city back."""
from benchmark.harness.program_spans import median_over, own, total


def read(record):
    return median_over("predict.city", total("predict.write", own))
