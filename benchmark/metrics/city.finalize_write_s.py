"""Host seconds per city of ``MosaicAccumulator.finalize`` and both GeoTIFF
writes (``array2raster_rio`` of the classes, ``array2raster`` of the heights,
DEFLATE): their sum over the traced run's cities over the number of
cities."""


def read(record):
    sp = record.get("spans", {})
    n = record.get("cities")
    if not n or "finalize" not in sp:
        return None
    return (sum(sp["finalize"]) + sum(sp.get("write", []))) / n
