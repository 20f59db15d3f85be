"""Prediction GeoTIFF writers (2.5 m rescaled geotransform).

The port's copy of ``srbh_tpu/predict/writers.py``. Twins of utils/preprocess.py:106-195: write arrays with the source raster's
geotransform rescaled to ``nresolution`` (2.5 m), PACKBITS/DEFLATE
compression, the 7-colour build colormap, and projection passthrough.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from srbh_tpu_torch.data.tiff import TiffReader, write_tiff
from srbh_tpu_torch.predict.colormap import CMAP


def array2raster(res_tif: str, array: np.ndarray, src_tif: str,
                 nresolution: float = 2.5, compress: Optional[str] = "PACKBITS",
                 colormap=None, nodata=None):
    """GDAL-path twin (utils/preprocess.py:106-133): copy geotransform from
    ``src_tif``, override pixel size with ``nresolution``."""
    src = TiffReader(src_tif)
    gt = list(src.geotransform)
    gt[1], gt[5] = nresolution, -nresolution
    write_tiff(res_tif, array, geotransform=tuple(gt), compress=compress,
               colormap=colormap, nodata=nodata, like=src.info())


def array2raster_rio(res_tif: str, array: np.ndarray, src_tif: str,
                     bands: int = 1, nresolution: float = 2.5,
                     iscmap: bool = True, compress: Optional[str] = None):
    """rasterio-path twin (utils/preprocess.py:177-195): same geometry rules,
    optional build colormap."""
    array2raster(res_tif, array, src_tif, nresolution=nresolution,
                 compress=compress, colormap=CMAP if iscmap else None)
