"""Offline feature-pipeline transforms (L0): frame->clip pooling, stream
length alignment, normalize+concat, and subtitle-token->clip assignment.
(The port's own copy of the JAX package's features/pooling.py; numpy only.)

Capability parity with the reference's offline utilities:
  * utils/video_feature/convert_feature_frm_to_clip.py:12-37 — max/avg pool
    fixed-size frame groups into clip features.
  * utils/video_feature/merge_align_i3d.py:12-33 — align a stream's length
    to another stream's clip count (truncate / repeat-last).
  * utils/video_feature/normalize_and_concat.py:11-29 — L2-normalize each
    stream then concat along the feature dim (ResNet||I3D -> 3072-d).
  * utils/text_feature/convert_sub_feature_word_to_clip.py:10-52 — assign
    each subtitle sentence's token span to 1.5s clips by timestamp overlap,
    pool tokens per clip.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from tvretrieval_tpu_torch.utils.io import l2_normalize


def frames_to_clips(frame_feats: np.ndarray, frames_per_clip: int,
                    pool: str = "max") -> np.ndarray:
    """(n_frames, D) -> (ceil(n/frames_per_clip), D) by max/avg pooling."""
    n = frame_feats.shape[0]
    n_clips = int(np.ceil(n / frames_per_clip))
    out = np.empty((n_clips, frame_feats.shape[1]), dtype=np.float32)
    for ci in range(n_clips):
        chunk = frame_feats[ci * frames_per_clip:(ci + 1) * frames_per_clip]
        out[ci] = chunk.max(axis=0) if pool == "max" else chunk.mean(axis=0)
    return out


def align_lengths(feats: np.ndarray, target_len: int) -> np.ndarray:
    """Truncate or pad-by-repeating-last so len(feats) == target_len."""
    n = feats.shape[0]
    if n >= target_len:
        return feats[:target_len]
    pad = np.repeat(feats[-1:], target_len - n, axis=0)
    return np.concatenate([feats, pad], axis=0)


def normalize_and_concat(streams: Sequence[np.ndarray]) -> np.ndarray:
    """L2-normalize each (L, D_i) stream, align lengths to the first, concat."""
    target = streams[0].shape[0]
    normed = [l2_normalize(align_lengths(np.asarray(s, np.float32), target))
              for s in streams]
    return np.concatenate(normed, axis=1)


def tokens_to_clip_features(
    token_feats: np.ndarray,
    sentence_spans: List[Tuple[float, float]],
    sentence_token_ranges: List[Tuple[int, int]],
    n_clips: int,
    clip_length: float = 1.5,
    pool: str = "max",
) -> np.ndarray:
    """Pool subtitle token features into clip-aligned features.

    Args:
        token_feats: (n_tokens, D) contextual token embeddings of the full
            subtitle text.
        sentence_spans: [(start_sec, end_sec)] per subtitle sentence.
        sentence_token_ranges: [(tok_start, tok_end)] per sentence into
            token_feats.
        n_clips: target clip count (aligned to the video stream).
        clip_length: seconds per clip.
        pool: "max" or "avg" over the tokens assigned to a clip.

    A sentence contributes its tokens to every clip its [start, end) span
    overlaps; clips with no assigned sentence reuse the nearest previous
    clip's feature (zeros if none yet) — mirroring the reference's
    sentence-to-clip assignment (convert_sub_feature_word_to_clip.py:10-32).
    """
    D = token_feats.shape[1]
    out = np.zeros((n_clips, D), dtype=np.float32)
    assigned = np.zeros(n_clips, dtype=bool)
    for (st_sec, ed_sec), (tok_st, tok_ed) in zip(sentence_spans,
                                                  sentence_token_ranges):
        toks = token_feats[tok_st:tok_ed]
        if len(toks) == 0:
            continue
        clip_st = int(np.floor(st_sec / clip_length))
        clip_ed = max(int(np.ceil(ed_sec / clip_length)), clip_st + 1)
        for ci in range(clip_st, min(clip_ed, n_clips)):
            pooled = toks.max(axis=0) if pool == "max" else toks.mean(axis=0)
            if assigned[ci]:
                stack = np.stack([out[ci], pooled])
                out[ci] = stack.max(axis=0) if pool == "max" else stack.mean(axis=0)
            else:
                out[ci] = pooled
                assigned[ci] = True
    # carry the last seen feature into silent clips
    last: Optional[np.ndarray] = None
    for ci in range(n_clips):
        if assigned[ci]:
            last = out[ci]
        elif last is not None:
            out[ci] = last
    return out
