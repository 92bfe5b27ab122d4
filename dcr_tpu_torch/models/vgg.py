"""VGG16 fc2 features: the embedder of Improved Precision and Recall.

Counterpart of ``dcr_tpu/models/vgg.py`` in NCHW under torchvision's names
(``features.N`` for the convolutions, ``classifier.0`` and ``classifier.3``
for fc1 and fc2), so a torchvision VGG16 state dict loads with ``strict=True``
once its last classifier layer (``classifier.6``) is dropped.

The feature map is flattened in torch's order (C, H, W), as torchvision's
fc1 expects. The JAX module flattens NHWC in (H, W, C) order, and its
converter reorders fc1's columns (``dcr_tpu/models/convert.py``
``convert_vgg16``); ``models/export.vgg16_from_flax`` undoes that reorder.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg16 conv plan: number = out channels, "M" = 2x2 max pool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv_indices() -> list[int]:
    """Index in ``features`` of each convolution, in order (conv, relu pairs
    and pools: 0, 2, 5, 7, 10, ..)."""
    out, i = [], 0
    for item in VGG16_PLAN:
        if item == "M":
            i += 1
        else:
            out.append(i)
            i += 2
    return out


class VGG16Features(nn.Module):
    """[B, 3, 224, 224] in [0, 1] -> fc2 activations [B, 4096] (after relu)."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        in_ch = 3
        for item in VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, int(item), 3, padding=1), nn.ReLU()]
                in_ch = int(item)
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Linear(512 * 7 * 7, 4096), nn.ReLU(),
                                        nn.Dropout(), nn.Linear(4096, 4096))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.features((x - self.mean) / self.std)
        h = torch.flatten(h, 1)
        h = F.relu(self.classifier[0](h))
        return F.relu(self.classifier[3](h))
