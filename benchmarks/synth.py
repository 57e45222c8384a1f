"""The inputs of a run, made from ``--seed``: weights, corpus and queries.

Both sides get the same inputs: the port (through the engine's own cache
assembly) and the plain reference (``benchmarks.reference``), which works out
again everything the port derives from them. Weights and corpus are drawn on
the run's device with a ``torch.Generator`` of that device, in a few large
calls; a second call with the same seed gives the same tensors, so the
reference can draw them again after the program's state is freed. Each
call's queries come from (seed, call index), drawn on the device too.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of draws: any whole ``seed`` (also past
    32 bits) and the tags that name the stream."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tags))
    return gen


def weight_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """The parameters the query side and the span head read, by the names
    of the port's ``state_dict`` (the published XML's modules): the query
    projection, positional embedding and encoder layer, the modular
    pooling, the two query linears and the merged ConvSE kernels."""
    h, qin = model["hidden_size"], model["query_input_size"]
    shapes = {
        "query_input_proj.ln.weight": (qin,), "query_input_proj.ln.bias": (qin,),
        "query_input_proj.dense.weight": (h, qin), "query_input_proj.dense.bias": (h,),
        "query_pos_embed.pos_embed": (model["max_desc_l"], h),
        "query_pos_embed.ln.weight": (h,), "query_pos_embed.ln.bias": (h,),
    }
    for name in ("query", "key", "value"):
        shapes[f"query_encoder.self.{name}.weight"] = (h, h)
        shapes[f"query_encoder.self.{name}.bias"] = (h,)
    shapes.update({
        "query_encoder.output.dense.weight": (h, h), "query_encoder.output.dense.bias": (h,),
        "query_encoder.output.ln.weight": (h,), "query_encoder.output.ln.bias": (h,),
        "modular_vector_mapping.weight": (2, h),
        "video_query_linear.weight": (h, h), "video_query_linear.bias": (h,),
        "sub_query_linear.weight": (h, h), "sub_query_linear.bias": (h,),
        "merged_st_predictor.conv.weight": (1, 1, model["conv_kernel_size"]),
        "merged_ed_predictor.conv.weight": (1, 1, model["conv_kernel_size"]),
    })
    return shapes


def make_weights(model: dict, device, seed: int) -> Dict[str, torch.Tensor]:
    """float32 weights from two draws: the published initializers' scales
    (dense and positional N(0, initializer_range); the ConvSE kernels
    U(-1/sqrt(k), 1/sqrt(k))), with biases N(0, initializer_range) and
    LayerNorm scales 1 + N(0, 0.1), shifts N(0, 0.1) in place of the
    published zeros and ones, so that a path that drops them shows."""
    shapes = weight_shapes(model)
    std = model["initializer_range"]
    sizes = [math.prod(s) for s in shapes.values()]
    gen = generator(device, seed, "weights")
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(2 * model["conv_kernel_size"], generator=gen, device=device)
    out, at, u = {}, 0, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        z = normal[at:at + size].view(shape)
        at += size
        if name.endswith("predictor.conv.weight"):
            k = shape[-1]
            out[name] = ((uniform[u:u + k] * 2 - 1) / math.sqrt(k)).view(shape)
            u += k
        elif ".ln.weight" in name:
            out[name] = 1.0 + 0.1 * z
        elif ".ln.bias" in name:
            out[name] = 0.1 * z
        else:
            out[name] = std * z
    return out


def make_corpus(corpus: dict, model: dict, device, seed: int,
                block_videos: int = 2048) -> Dict[str, torch.Tensor]:
    """The encoded corpus at encoder-output shape, as the engine's
    ``_finish_cache`` receives it at the bf16 cache dtype: feat1 of each
    stream as unit rows (drawn in f32, normalized, rounded to bf16), the
    concatenated feat2 [video ; sub] as bf16 normals, and the clip mask.
    Drawn a block of videos at a time, so the f32 draws stay small."""
    nv, L, d = corpus["n_videos"], corpus["n_clips"], model["hidden_size"]
    gen = generator(device, seed, "corpus")
    out = {"vf1": torch.empty((nv, L, d), dtype=torch.bfloat16, device=device),
           "sf1": torch.empty((nv, L, d), dtype=torch.bfloat16, device=device),
           "feat2_cat": torch.empty((nv, L, 2 * d), dtype=torch.bfloat16, device=device)}
    for v0 in range(0, nv, block_videos):
        n = min(block_videos, nv - v0)
        for key in ("vf1", "sf1"):
            x = torch.randn((n, L, d), generator=gen, device=device)
            out[key][v0:v0 + n] = (x / torch.linalg.norm(x, dim=-1, keepdim=True)).to(
                torch.bfloat16)
        out["feat2_cat"][v0:v0 + n] = torch.randn((n, L, 2 * d), generator=gen,
                                                  device=device).to(torch.bfloat16)
    out["mask"] = torch.ones((nv, L), dtype=torch.float32, device=device)
    return out


def make_queries(traffic: dict, model: dict, n_videos: int, device, seed: int,
                 call) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Call ``call``'s queries, drawn on the device: (features (Nq,
    max_desc_l, query_input_size) f32 with the padded tokens zero, mask (Nq,
    max_desc_l) f32, ground-truth video (Nq,) int64). The token lengths are
    the stream's first draw (``token_lengths``)."""
    nq, ltok = traffic["queries_per_call"], model["max_desc_l"]
    gen = generator(device, seed, "queries", call)
    lens = _lengths(traffic, device, gen)
    gt = torch.randint(0, n_videos, (nq,), generator=gen, device=device)
    mask = (torch.arange(ltok, device=device)[None, :] < lens[:, None]).float()
    feat = torch.randn((nq, ltok, model["query_input_size"]), generator=gen, device=device)
    return feat * mask[:, :, None], mask, gt


def _lengths(traffic: dict, device, gen: torch.Generator) -> torch.Tensor:
    lo, hi = traffic["token_len"]
    return torch.randint(lo, hi + 1, (traffic["queries_per_call"],), generator=gen,
                         device=device)


def token_lengths(traffic: dict, device, seed: int, calls: int) -> List[np.ndarray]:
    """The token lengths of calls 0 .. calls - 1, drawn again: the same
    first draw of each call's stream as ``make_queries``."""
    lens = [_lengths(traffic, device, generator(device, seed, "queries", c))
            for c in range(calls)]
    return list(torch.stack(lens).cpu().numpy()) if lens else []


class CorpusNames:
    """The video names and durations the engine's ``_finish_cache``
    records (it reads ``len``, ``vid_names``, ``durations``)."""

    def __init__(self, n_videos: int, duration: float):
        self.vid_names: List[str] = [f"video{i:05d}" for i in range(n_videos)]
        self.durations: List[float] = [duration] * n_videos

    def __len__(self) -> int:
        return len(self.vid_names)
