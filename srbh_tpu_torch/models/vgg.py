"""VGG19 features for the perceptual loss (NCHW).

Counterpart of ``srbh_tpu/models/vgg.py`` (SR/srloss.py:61-103): the VGG19
trunk, with ImageNet input normalisation, returning the activations at
torchvision ``nn.Sequential`` indices (default 2, 7, 16, 25, 34: conv1_2,
conv2_2, conv3_4, conv4_4, conv5_4, before their ReLU). The trunk is
``features``, an ``nn.Sequential`` cut after the last index wanted, so its
parameters carry torchvision's ``features.{i}.weight/bias`` names and a
torchvision ``vgg19`` state dict loads through
:func:`load_torchvision_vgg19`. There is no torchvision here: the module is
first-party, and without a checkpoint its weights are random.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence

import torch
from torch import nn

# out channels per conv, "M" a 2x2 max-pool: the VGG19 feature stack
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DEFAULT_FEATURE_LAYERS = (2, 7, 16, 25, 34)


def _vgg19_layers(last: int) -> List[nn.Module]:
    """torchvision's ``vgg19().features`` children 0..``last``."""
    layers: List[nn.Module] = []
    in_ch = 3
    for item in VGG19_CFG:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_ch, item, 3, 1, 1), nn.ReLU()]
            in_ch = item
    return layers[: last + 1]


class VGG19Features(nn.Module):
    """Activations of the VGG19 trunk at ``feature_layers`` (torchvision
    indices: a conv's output before its ReLU, a ReLU's or a pool's after)."""

    def __init__(self, feature_layers: Sequence[int] = DEFAULT_FEATURE_LAYERS,
                 use_input_norm: bool = True, use_range_norm: bool = False):
        super().__init__()
        self.feature_layers = tuple(feature_layers)
        self.use_input_norm = use_input_norm
        self.use_range_norm = use_range_norm
        self.features = nn.Sequential(*_vgg19_layers(max(self.feature_layers)))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x) -> List[torch.Tensor]:
        if self.use_range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        wanted, out = set(self.feature_layers), []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in wanted:
                out.append(x)
        return out


def load_torchvision_vgg19(module: VGG19Features, state_dict: Mapping) -> None:
    """Load the ``features.*`` entries of a torchvision ``vgg19`` state dict
    that ``module``'s trunk holds (its classifier is not needed)."""
    own = module.state_dict()
    module.load_state_dict({k: torch.as_tensor(state_dict[k]) for k in own})
