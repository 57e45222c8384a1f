"""The vision backbones of the feature pipelines, as ``nn.Module``s (port of
the JAX package's features/backbones.py; inference only).

The reference extracts frame features with torchvision ResNet-152 pool5
(utils/video_feature/extract_image_features.py:27-41, 2048-d) and clip
features with the Kinetics I3D RGB network (utils/video_feature/i3d.py,
the 1024-d "avg_pool3d" endpoint, extract_i3d_features.py:207-208):

  * ``ResNet152``: torchvision's ResNet v1.5 layout (bottleneck counts
    [3, 8, 36, 3], stride on the 3x3 conv) under torchvision's parameter
    names, so a released torchvision checkpoint loads with
    ``load_state_dict(strict=True)`` once its fc is dropped
    (``torchvision_resnet152_to_state_dict``);
  * ``InceptionI3d``: the Inception-v1 3D inflation with the reference's
    Unit3D stack and Mixed_3b..Mixed_5c widths, TF "SAME" padding (pads
    put the odd element after, as TF and flax do) and Sonnet's BatchNorm
    without a scale (epsilon 1e-3); ``tf_i3d_variable_map`` names the
    kinetics-i3d TF variable of every entry of its state_dict.

The nets take the JAX layout, channels last: (B, H, W, 3) frames and
(B, T, H, W, 3) clips, permuted once inside; the blocks (``Bottleneck``,
``Unit3D``, ``InceptionMixed``, ``_max_pool3d_same``) work in torch's
NCHW / NCDHW. BatchNorm always uses its running statistics, whatever the
module's train flag, as the JAX modules do (``use_running_average=True``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# ResNet-152 (reference extract_image_features.py)
# ---------------------------------------------------------------------------


class BatchNorm2d(nn.BatchNorm2d):
    """torchvision's BatchNorm2d (its names, epsilon 1e-5), always on the
    running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (v1.5: stride on the 3x3 conv); NCHW."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride=stride,
                                                   bias=False),
                                         BatchNorm2d(planes * 4))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class ResNet152(nn.Module):
    """(B, H, W, 3) float images -> (B, 2048) pool5 features.

    torchvision.models.resnet152 minus the final fc (the reference removes
    it, extract_image_features.py:31-38). Inputs are expected
    ImageNet-normalized like the reference's (:21-24).
    """

    def __init__(self, block_counts: Sequence[int] = (3, 8, 36, 3)):
        super().__init__()
        self.block_counts = tuple(block_counts)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes, planes = 64, 64
        for stage, n_blocks in enumerate(self.block_counts):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(Bottleneck(inplanes, planes, stride, downsample=(b == 0)))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(len(self.block_counts)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))                             # pool5: (B, 2048)


# ---------------------------------------------------------------------------
# Inception I3D (reference i3d.py)
# ---------------------------------------------------------------------------


def _same_pads(sizes, window, strides):
    """F.pad's argument for TF / flax "SAME": per dim, total =
    max((ceil(n / s) - 1) * s + k - n, 0), total // 2 before and the rest
    after; F.pad takes the last dim first."""
    pads = []
    for n, k, s in zip(sizes, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


class ScaleFreeBatchNorm3d(nn.Module):
    """Sonnet's BatchNorm as Unit3D uses it: a bias (beta) and running
    statistics, no scale, epsilon 1e-3 (reference i3d.py:32-91)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, None, self.bias,
                            False, 0.0, self.eps)


class Unit3D(nn.Module):
    """Conv3D (no bias, TF "SAME" padding) + scale-free BatchNorm + ReLU;
    NCDHW."""

    def __init__(self, in_channels: int, channels: int,
                 kernel: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(in_channels, channels, self.kernel, stride=self.stride,
                                bias=False)
        self.bn = ScaleFreeBatchNorm3d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _same_pads(x.shape[2:], self.kernel, self.stride)
        if any(pads):
            x = F.pad(x, pads)
        return F.relu(self.bn(self.conv3d(x)))


def _max_pool3d_same(x: torch.Tensor, window, strides) -> torch.Tensor:
    """flax ``max_pool(padding="SAME")`` on NCDHW: pads of -inf, then a
    max pool without padding."""
    pads = _same_pads(x.shape[2:], window, strides)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool3d(x, window, stride=strides)


class InceptionMixed(nn.Module):
    """One Inception block: 1x1 / 1x1->3x3 / 1x1->3x3 / pool->1x1, the
    branches concatenated on the channels (reference i3d.py:194-219)."""

    def __init__(self, in_channels: int, b0: int, b1: Tuple[int, int],
                 b2: Tuple[int, int], b3: int):
        super().__init__()
        k3 = (3, 3, 3)
        self.b0_1x1 = Unit3D(in_channels, b0)
        self.b1_1x1 = Unit3D(in_channels, b1[0])
        self.b1_3x3 = Unit3D(b1[0], b1[1], k3)
        self.b2_1x1 = Unit3D(in_channels, b2[0])
        self.b2_3x3 = Unit3D(b2[0], b2[1], k3)
        self.b3_1x1 = Unit3D(in_channels, b3)
        self.out_channels = b0 + b1[1] + b2[1] + b3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        br0 = self.b0_1x1(x)
        br1 = self.b1_3x3(self.b1_1x1(x))
        br2 = self.b2_3x3(self.b2_1x1(x))
        br3 = self.b3_1x1(_max_pool3d_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([br0, br1, br2, br3], dim=1)


# (b0, (b1a, b1b), (b2a, b2b), b3) per Mixed block — reference i3d.py:194-455
I3D_MIXED_SPECS = {
    "Mixed_3b": (64, (96, 128), (16, 32), 32),     # -> 256
    "Mixed_3c": (128, (128, 192), (32, 96), 64),   # -> 480
    "Mixed_4b": (192, (96, 208), (16, 48), 64),    # -> 512
    "Mixed_4c": (160, (112, 224), (24, 64), 64),   # -> 512
    "Mixed_4d": (128, (128, 256), (24, 64), 64),   # -> 512
    "Mixed_4e": (112, (144, 288), (32, 64), 64),   # -> 528
    "Mixed_4f": (256, (160, 320), (32, 128), 128), # -> 832
    "Mixed_5b": (256, (160, 320), (32, 128), 128), # -> 832
    "Mixed_5c": (384, (192, 384), (48, 128), 128), # -> 1024
}
I3D_STEM = (("Conv3d_1a_7x7", 3, 64, (7, 7, 7), (2, 2, 2)),
            ("Conv3d_2b_1x1", 64, 64, (1, 1, 1), (1, 1, 1)),
            ("Conv3d_2c_3x3", 64, 192, (3, 3, 3), (1, 1, 1)))


class InceptionI3d(nn.Module):
    """(B, T, H, W, 3) RGB clips -> (B, 1024) avg_pool3d features.

    The reference extracts the "avg_pool3d" endpoint (the average over the
    remaining T' x 7 x 7 grid before the logits conv,
    extract_i3d_features.py:207-208); the logits are not needed for
    feature extraction and are left out.
    """

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s in I3D_STEM:
            setattr(self, name, Unit3D(cin, cout, k, s))
        cin = 192
        for name, spec in I3D_MIXED_SPECS.items():
            block = InceptionMixed(cin, *spec)
            setattr(self, name, block)
            cin = block.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool3d_same(x, (1, 3, 3), (1, 2, 2))         # MaxPool3d_2a_3x3
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _max_pool3d_same(x, (1, 3, 3), (1, 2, 2))         # MaxPool3d_3a_3x3
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = _max_pool3d_same(x, (3, 3, 3), (2, 2, 2))         # MaxPool3d_4a_3x3
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = _max_pool3d_same(x, (2, 2, 2), (2, 2, 2))         # MaxPool3d_5a_2x2
        x = self.Mixed_5c(self.Mixed_5b(x))
        return x.mean(dim=(2, 3, 4))                          # (B, 1024)


# ---------------------------------------------------------------------------
# Released checkpoints (none ships in the repository)
# ---------------------------------------------------------------------------


def _bn_keys(prefix: str):
    return [f"{prefix}.{k}" for k in ("weight", "bias", "running_mean", "running_var",
                                      "num_batches_tracked")]


def resnet152_state_keys(block_counts=(3, 8, 36, 3)):
    """The state_dict keys of ``ResNet152(block_counts)``, in its order."""
    keys = ["conv1.weight"] + _bn_keys("bn1")
    for s, n_blocks in enumerate(block_counts):
        for b in range(n_blocks):
            p = f"layer{s + 1}.{b}"
            for i in (1, 2, 3):
                keys += [f"{p}.conv{i}.weight"] + _bn_keys(f"{p}.bn{i}")
            if b == 0:
                keys += [f"{p}.downsample.0.weight"] + _bn_keys(f"{p}.downsample.1")
    return keys


def torchvision_resnet152_to_state_dict(state_dict, block_counts=(3, 8, 36, 3)
                                        ) -> Dict[str, torch.Tensor]:
    """A torchvision resnet152 state_dict (tensors or numpy arrays) ->
    ``ResNet152(block_counts)``'s: the fc and the blocks beyond
    ``block_counts`` dropped, every key the net needs checked present (a
    missing ``num_batches_tracked``, which older checkpoints lack, reads
    0). ``block_counts``: stage depths, (3, 8, 36, 3) for resnet152;
    smaller ones let tests run reduced nets through the same names."""
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for key in resnet152_state_keys(block_counts):
        if key in state_dict:
            out[key] = torch.as_tensor(np.asarray(state_dict[key]))
        elif key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(0, dtype=torch.long)
        else:
            missing.append(key)
    if missing:
        raise KeyError(f"not a torchvision resnet state_dict for {tuple(block_counts)}: "
                       f"missing {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    return out


# the JAX package's name (there the target is a flax variables dict)
torchvision_resnet152_to_flax = torchvision_resnet152_to_state_dict


def tf_i3d_variable_map() -> Dict[str, str]:
    """``InceptionI3d``'s state_dict key -> the released kinetics-i3d TF
    checkpoint variable, for every key: e.g.
    ``Mixed_3b.b1_3x3.conv3d.weight`` ->
    ``RGB/inception_i3d/Mixed_3b/Branch_1/Conv3d_0b_3x3/conv_3d/w`` (TF
    kernels are (t, h, w, in, out): permute (4, 3, 0, 1, 2) to torch's
    (out, in, t, h, w)), ``.bn.bias`` -> ``.../batch_norm/beta``,
    ``.bn.running_mean`` / ``running_var`` -> ``.../batch_norm/moving_mean``
    / ``moving_variance``."""
    branch_names = {"b0_1x1": "Branch_0/Conv3d_0a_1x1",
                    "b1_1x1": "Branch_1/Conv3d_0a_1x1",
                    "b1_3x3": "Branch_1/Conv3d_0b_3x3",
                    "b2_1x1": "Branch_2/Conv3d_0a_1x1",
                    "b2_3x3": "Branch_2/Conv3d_0b_3x3",
                    "b3_1x1": "Branch_3/Conv3d_0b_1x1"}
    leaves = {"conv3d.weight": "conv_3d/w", "bn.bias": "batch_norm/beta",
              "bn.running_mean": "batch_norm/moving_mean",
              "bn.running_var": "batch_norm/moving_variance"}
    units = {name: name for name, *_ in I3D_STEM}
    for block in I3D_MIXED_SPECS:
        units.update({f"{block}.{ours}": f"{block}/{tf}" for ours, tf in branch_names.items()})
    return {f"{ours}.{leaf}": f"RGB/inception_i3d/{tf}/{tf_leaf}"
            for ours, tf in units.items() for leaf, tf_leaf in leaves.items()}
