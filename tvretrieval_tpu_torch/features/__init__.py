"""Offline feature pipelines (the port of the JAX package's ``features``):
host transforms, the ResNet-152 / I3D backbones, text features and MLM
fine-tuning."""
from tvretrieval_tpu_torch.features.pooling import (
    frames_to_clips,
    align_lengths,
    normalize_and_concat,
    tokens_to_clip_features,
)
from tvretrieval_tpu_torch.features.subtitles import parse_srt, subtitles_to_jsonl
from tvretrieval_tpu_torch.features.video_split import build_video_duration_idx

__all__ = [
    "frames_to_clips",
    "align_lengths",
    "normalize_and_concat",
    "tokens_to_clip_features",
    "parse_srt",
    "subtitles_to_jsonl",
    "build_video_duration_idx",
]
