"""Video frame feature extraction (port of the JAX package's
features/video_features.py).

Capability parity with reference utils/video_feature/: per-frame appearance
features (ResNet-152 pool5, extract_image_features.py:27) and clip motion
features (Kinetics I3D, i3d.py + extract_i3d_features.py), followed by the
frame->clip pooling / alignment / normalize+concat transforms of
``features.pooling``.

The backbone is passed in (``frame_model_fn: (B, H, W, 3) uint8 ->
(B, D)``, ``clip_model_fn: (B, T, H, W, 3) uint8 -> (B, D)``), so the
pipeline's batching, pooling and HDF5 layout are testable with a fake
one. ``make_resnet152_frame_model`` and ``make_i3d_clip_model`` back them
with the port's backbones on the card (``device="cpu"`` for the CPU); no
pretrained weights ship in the repository, so without ``variables`` the
nets carry seeded random weights at the published widths.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from tvretrieval_tpu_torch.features.backbones import InceptionI3d, ResNet152
from tvretrieval_tpu_torch.features.pooling import frames_to_clips
from tvretrieval_tpu_torch.utils.device import resolve_device


def frame_clip_features(frames: np.ndarray, frame_model_fn: Callable[[np.ndarray], np.ndarray],
                        frames_per_clip: int = 3, pool: str = "max",
                        batch_size: int = 32) -> np.ndarray:
    """One video's (n_frames, H, W, 3) uint8 frames -> (n_clips, D) f32
    clip features: the frame model in batches, then frame->clip pooling."""
    feats = [np.asarray(frame_model_fn(frames[i:i + batch_size]))
             for i in range(0, len(frames), batch_size)]
    return frames_to_clips(np.concatenate(feats, axis=0), frames_per_clip,
                           pool).astype(np.float32)


def i3d_clip_features(frames: np.ndarray, clip_model_fn: Callable[[np.ndarray], np.ndarray],
                      frames_per_clip: int = 23, batch_size: int = 4) -> np.ndarray:
    """One video's frames -> (n_clips, D) f32: fixed-length clips, the last
    padded by repeating its final frame, through the clip model in
    batches."""
    n = len(frames)
    n_clips = max(1, -(-n // frames_per_clip))
    pad = n_clips * frames_per_clip - n
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)
    clips = frames.reshape(n_clips, frames_per_clip, *frames.shape[1:])
    feats = [np.asarray(clip_model_fn(clips[i:i + batch_size]))
             for i in range(0, n_clips, batch_size)]
    return np.concatenate(feats, 0).astype(np.float32)


def extract_clip_features(
    video_frames: Dict[str, np.ndarray],
    frame_model_fn: Callable[[np.ndarray], np.ndarray],
    out_h5_path: str,
    frames_per_clip: int = 3,
    pool: str = "max",
    batch_size: int = 32,
) -> int:
    """Per video: frame features -> clip features -> h5[vid_name] = (n_clips, D).

    video_frames: {vid_name: (n_frames, H, W, 3) uint8}. The reference
    samples 3 frames per 1.5s clip at 15fps and max-pools them into one clip
    feature (extract_image_features.py + convert_feature_frm_to_clip.py).
    """
    import h5py

    with h5py.File(out_h5_path, "w") as h5:
        for vid_name, frames in video_frames.items():
            h5.create_dataset(vid_name, data=frame_clip_features(
                frames, frame_model_fn, frames_per_clip, pool, batch_size))
    return len(video_frames)


def extract_i3d_clip_features(
    video_frames: Dict[str, np.ndarray],
    clip_model_fn: Callable[[np.ndarray], np.ndarray],
    out_h5_path: str,
    frames_per_clip: int = 23,
    batch_size: int = 4,
) -> int:
    """Per video: group frames into fixed-length clips and run a 3D-conv
    clip model -> h5[vid_name] = (n_clips, D).

    The reference feeds 23 frames per 1.5s clip to I3D
    (extract_i3d_features.py:39-41); the last partial clip is padded by
    repeating its final frame.
    """
    import h5py

    with h5py.File(out_h5_path, "w") as h5:
        for vid_name, frames in video_frames.items():
            h5.create_dataset(vid_name, data=i3d_clip_features(
                frames, clip_model_fn, frames_per_clip, batch_size))
    return len(video_frames)


# ImageNet normalization (reference extract_image_features.py:21-24)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights from ``seed`` for a net without a checkpoint: each
    conv LeCun-normal (std 1 / sqrt(fan_in), flax's default conv
    initializer, untruncated), each BatchNorm at its identity (mean 0,
    variance 1, bias 0, scale 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=gen)
    return module


def make_frame_embedder(module: torch.nn.Module, preprocess=None, device=None):
    """A frame_model_fn backed by any torch module taking (B, H, W, 3)
    float frames: uint8 frames in, copied to ``device`` (the card by
    default) and scaled to [0, 1], then ``preprocess`` (a torch function
    of that tensor) and the module without gradients; numpy features out.
    The function carries the module on the device as ``.module``."""
    dev = resolve_device(device, "make_frame_embedder")
    module = module.to(dev).eval()

    @torch.no_grad()
    def frame_model_fn(frames: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(dev).float() / 255.0
        if preprocess is not None:
            x = preprocess(x)
        return module(x).cpu().numpy()

    frame_model_fn.module = module
    return frame_model_fn


# the JAX package's name (there for a flax CNN's apply function)
make_flax_resnet_embedder = make_frame_embedder


def make_resnet152_frame_model(variables: Optional[dict] = None, seed: int = 0,
                               block_counts=(3, 8, 36, 3), device=None):
    """frame_model_fn backed by the port's ResNet-152
    (``features.backbones``) on ``device``, ImageNet-normalized inputs.
    ``variables``: a ``ResNet152`` state_dict, e.g. from
    ``torchvision_resnet152_to_state_dict`` for released weights; without
    it the net has seeded random weights, which still exercise the whole
    pipeline."""
    dev = resolve_device(device, "make_resnet152_frame_model")
    model = ResNet152(block_counts=tuple(block_counts))
    if variables is None:
        _seeded(model, seed)
    else:
        model.load_state_dict(variables, strict=True)
    mean, std = (torch.from_numpy(a).to(dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
    return make_frame_embedder(model, lambda x: (x - mean) / std, dev)


def make_i3d_clip_model(variables: Optional[dict] = None, seed: int = 0, device=None):
    """clip_model_fn backed by the port's InceptionI3d on ``device``:
    (B, T, H, W, 3) uint8 clips -> (B, 1024) avg_pool3d features, inputs
    rescaled to [-1, 1] (reference extract_i3d_features.py:207-208).
    ``variables``: an ``InceptionI3d`` state_dict (``tf_i3d_variable_map``
    names its TF sources); without it, seeded random weights. The function
    carries the module on the device as ``.module``."""
    dev = resolve_device(device, "make_i3d_clip_model")
    model = InceptionI3d()
    if variables is None:
        _seeded(model, seed)
    else:
        model.load_state_dict(variables, strict=True)
    model = model.to(dev).eval()

    @torch.no_grad()
    def clip_model_fn(clips: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(clips)).to(dev).float() / 127.5 - 1.0
        return model(x).cpu().numpy()

    clip_model_fn.module = model
    return clip_model_fn
