"""City-scale prediction: the per-batch step, mosaics, writers."""
from srbh_tpu_torch.predict.colormap import CMAP
from srbh_tpu_torch.predict.device_stitcher import (
    DeviceMosaicAccumulator,
    finalize_mosaic,
    stitch_tiles,
)
from srbh_tpu_torch.predict.predictor import (
    city_names_from_dir,
    make_city_step,
    predict_cities,
    predict_city,
)
from srbh_tpu_torch.predict.sliding import predict_whole_image, window_anchors
from srbh_tpu_torch.predict.stitcher import MosaicAccumulator
from srbh_tpu_torch.predict.writers import array2raster, array2raster_rio

__all__ = [
    "CMAP", "city_names_from_dir", "make_city_step", "predict_cities",
    "predict_city", "predict_whole_image", "window_anchors",
    "MosaicAccumulator", "DeviceMosaicAccumulator", "stitch_tiles",
    "finalize_mosaic", "array2raster", "array2raster_rio",
]
