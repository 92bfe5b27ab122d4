"""ResNet-50 + GeM pooling + projection: the SSCD copy-detection embedder.

Counterpart of ``dcr_tpu/models/resnet.py`` in NCHW with the module names of
the SSCD TorchScript archive (torchvision's ResNet-50 under ``backbone.``,
the projection as ``embeddings``): ``backbone.conv1``, ``backbone.bn1``,
``backbone.layer1.0.conv1`` .. ``backbone.layer4.2.bn3``,
``backbone.layerN.0.downsample.0/1`` and ``embeddings.weight/bias``. A
published SSCD state dict (``torch.jit.load(path).state_dict()``) or a
torchvision ResNet-50's trunk therefore loads with ``strict=True``.

The backbones are frozen feature extractors: batch norm runs in inference
mode on its stored statistics, and the eval path calls them under
``torch.inference_mode()``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm(nn.Module):
    """Inference-only batch norm: ``x * inv + (bias - mean * inv)`` with
    ``inv = rsqrt(var + eps) * weight``, the JAX module's arithmetic.

    The statistics are buffers under ``nn.BatchNorm2d``'s names (``weight``,
    ``bias``, ``running_mean``, ``running_var``), never updated. Torch
    checkpoints of ``nn.BatchNorm2d`` also carry ``num_batches_tracked``:
    it is kept as a buffer too, so those state dicts load with
    ``strict=True``, and the forward pass never reads it. A state dict
    without it (older checkpoints, the ``*_from_flax`` bridge) loads as
    well: the missing counter is filled with 0, as ``nn.BatchNorm2d`` does
    for checkpoints written before it had one."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.setdefault(prefix + "num_batches_tracked",
                              torch.zeros((), dtype=torch.long))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, torchvision v1.5) -> 1x1, expansion 4."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = None
        if in_ch != out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out, 1, stride=stride, bias=False), FrozenBatchNorm(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet50(nn.Module):
    """ResNet-50 trunk: [B, 3, H, W] -> [B, 2048, H/32, W/32]."""

    def __init__(self, stage_sizes: tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch, features = 64, 64
        for stage, blocks in enumerate(stage_sizes):
            layers = []
            for block in range(blocks):
                layers.append(Bottleneck(in_ch, features,
                                         stride=2 if stage > 0 and block == 0 else 1))
                in_ch = features * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
            features *= 2
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


def gem_pool(x: torch.Tensor, p: float = 3.0, eps: float = 1e-6) -> torch.Tensor:
    """Generalized-mean pooling over the spatial dims of [B, C, H, W]."""
    return x.clamp(min=eps).pow(p).mean(dim=(2, 3)).pow(1.0 / p)


class SSCDModel(nn.Module):
    """SSCD descriptor: ResNet-50 -> GeM(p=3) -> Linear(2048 -> embed_dim).

    Input [B, 3, H, W] (normalised as the eval transform leaves it); output
    [B, embed_dim], not L2-normalised (the eval stage normalises)."""

    def __init__(self, embed_dim: int = 512, gem_p: float = 3.0):
        super().__init__()
        self.gem_p = gem_p
        self.backbone = ResNet50()
        self.embeddings = nn.Linear(2048, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embeddings(gem_pool(self.backbone(x), self.gem_p))
