"""One-stream fused video scores over a clip-major cache.

Port of tvretrieval_tpu/ops/pallas_kernels.py (reference
get_video_level_scores, model_xml.py:436-453, with the exp of
inference.py:317 fused in): ``scores[m, v] = max_l ((q[m] . feat[l, v]) *
mask[l, v] + (1 - mask[l, v]) * -1e10)``, optionally through ``exp(alpha *
.)``, without the (M, L, Nv) similarity reaching device memory.

- ``fused_video_scores_clip_major`` (B10, csrc/masked_score.cu, the source
  it shares with ops.video_score.video_scores_masked) replaces
  ``pallas_kernels.fused_video_scores_clip_major``;
- ``fused_video_scores`` is the video-major wrapper (it transposes once);
- ``fused_video_scores_xla`` is the plain version.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises (``ops._build.launch`` counts the launch).
No engine mode runs this function: it is a measured alternative to the
einsum video-score stage, run beside it by ``profiling.engine_modes``.

The bound on the H100 is arithmetic (Nv * L x D x M multiply-adds, half of
the two-stream stage's), on the tensor cores (bf16 products, or f32 as
three TF32 products); see the source for the tiling.
"""
from __future__ import annotations

from typing import Optional

import torch

from tvretrieval_tpu_torch.ops.video_score import launch_masked_scores

# this function's own fill value (pallas_kernels.py:34); equal to
# ops.masking.NEG_INF
NEG_INF = -1e10

def fused_video_scores_xla(queries: torch.Tensor, feat1: torch.Tensor, mask: torch.Tensor,
                           alpha: Optional[float] = None,
                           block_videos: int = 2048) -> torch.Tensor:
    """Plain version: (M, D) x (Nv, L, D) video-major + (Nv, L) mask ->
    (M, Nv) f32, the product in f32, one block of videos at a time so that
    only an (M, block, L) tile of the similarity exists."""
    nv, L, d = feat1.shape
    q = queries.float()
    outs = []
    for v0 in range(0, nv, block_videos):
        f = feat1[v0:v0 + block_videos].float()
        m = mask[v0:v0 + block_videos].float()[None]
        sims = (q @ f.reshape(-1, d).T).view(q.shape[0], -1, L)
        outs.append((sims * m + (1.0 - m) * NEG_INF).amax(dim=2))
    scores = torch.cat(outs, dim=1)
    return torch.exp(alpha * scores) if alpha is not None else scores


def fused_video_scores_clip_major(queries: torch.Tensor, feat1_t: torch.Tensor,
                                  mask_t: torch.Tensor,
                                  alpha: Optional[float] = None) -> torch.Tensor:
    """B10: (M, D) x (L, Nv, D) clip-major -> (M, Nv) f32 fused masked-max
    scores; mask_t: (L, 1, Nv) float validity; ``alpha`` not None returns
    ``exp(alpha * score)``. Queries and cache share bf16 or f32; the dots
    accumulate in f32. A fully masked video scores exactly -1e10 (0 after
    the exp). The TPU function's ``block_videos`` (and its ``Nv %
    block_videos == 0`` assertion) tiled its grid; this kernel masks its
    ragged last block itself, so any Nv is taken and the argument is gone.
    Replaces pallas_kernels.fused_video_scores_clip_major."""
    name = "fused_video_scores_clip_major"
    if feat1_t.dim() != 3 or mask_t.shape != (feat1_t.shape[0], 1, feat1_t.shape[1]):
        raise ValueError(f"{name}: cache must be (L, Nv, D) and mask (L, 1, Nv), got "
                         f"{tuple(feat1_t.shape)}, {tuple(mask_t.shape)}")
    if feat1_t.device.type == "cpu":
        return fused_video_scores_xla(queries, feat1_t.transpose(0, 1),
                                      mask_t[:, 0].T, alpha)
    L, nv, d = feat1_t.shape
    return launch_masked_scores(name, (queries,), (feat1_t,), mask_t, nv, L,
                                (d, nv * d), (1, nv), NEG_INF, alpha)


def fused_video_scores(queries: torch.Tensor, feat1: torch.Tensor, mask: torch.Tensor,
                       alpha: Optional[float] = None) -> torch.Tensor:
    """Video-major convenience wrapper: (Nv, L, D) + (Nv, L) inputs, one
    transposed copy of the cache per call. Replaces
    pallas_kernels.fused_video_scores."""
    feat1_t = feat1.transpose(0, 1).contiguous()
    mask_t = mask.T[:, None, :].contiguous()
    return fused_video_scores_clip_major(queries, feat1_t, mask_t, alpha)
