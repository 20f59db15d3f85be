"""The host data layer: tile datasets, the loader, codecs and grids."""
from srbh_tpu_torch.data.dataset import (
    LRHRPairDataset,
    S1GlobeDataset,
    S2GlobeDataset,
    S12GlobeDataset,
)

__all__ = ["LRHRPairDataset", "S1GlobeDataset", "S2GlobeDataset",
           "S12GlobeDataset"]
