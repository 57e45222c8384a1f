"""CAL over every proposal of the port's resident corpus: the program of
``cal_tvr``.

Set-up draws the seed's weights and corpus, loads the port's CAL and builds
the resident cache with ``tvretrieval_tpu_torch.retrieval.proposal_engine.
encode_cal_corpus``; a call is one ``score_cal_batch`` over a batch of
queries (with each query's ground-truth video, for the SVMR row). ``judge``
holds the outputs of the checked calls against the plain reference
``benchmarks.reference.cal_ref``, drawn again from the seed. The harness's
module docstring says what each function is for and when it is called.

Inputs, all drawn on the run's device from the seed:

- weights by the names of the port's ``state_dict`` at PyTorch's default
  initializers, which the published model keeps: every weight and bias
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the LSTM's U(-1/sqrt(H), 1/sqrt(H));
  the LSTM's input biases zero (flax's cells have none);
- the corpus a block of ``block_videos`` videos at a time from (seed,
  block): every clip's video and subtitle features unit rows (drawn in
  f32, L2-normed), every video ``n_clips`` clips of ``clip_length``
  seconds; a test may set ``duration`` longer than the clips;
- a call's queries from (seed, call): ``synth.make_queries``'s token
  lengths, ground-truth videos and features, each token row L2-normed as
  the data layer normalizes query features (``x / (|x| + 1e-5)``).

The compared numbers (each larger-is-worse; scores are negated distances,
so differences are in squared-distance units; an index out of range, a
padded slot or a repeated moment returned, a non-finite score, or a list
out of ``lax.top_k``'s order (score descending, then flat index) reads
``inf``):

- ``q2c_err``: the widest |difference| between a returned VCMR moment's
  score and the reference's score of the same (video, proposal);
- ``topv_gap``: by how much the worst returned moment lies below the
  reference's ``max_before_nms``-th best score over the corpus;
- ``span_err``: the widest |difference|, in seconds, between a returned
  moment's (st, ed), VCMR or SVMR, and the reference generator's span of
  that (video, proposal);
- ``vcmr_gap``: rank by rank, the widest shortfall of the returned
  moments' reference scores against the reference's own top list;
- ``svmr_err``, ``svmr_gap``: the same as ``q2c_err`` and ``vcmr_gap`` for
  the ground-truth video's ranked proposals.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmarks import synth
from benchmarks.reference.cal_ref import STATED, Reference

INF = float("inf")
NUMBERS = ("q2c_err", "topv_gap", "span_err", "vcmr_gap", "svmr_err", "svmr_gap")
STREAMS = {"video": "visual_input_size", "sub": "textual_input_size"}


def _port():
    """The system under test: the port's CAL and its proposal engine."""
    from tvretrieval_tpu_torch.models.cal import CALConfig, CALWithSub
    from tvretrieval_tpu_torch.retrieval.proposal_engine import (
        CALServeConfig, encode_cal_corpus, score_cal_batch)
    return CALConfig, CALWithSub, CALServeConfig, encode_cal_corpus, score_cal_batch


# ---------------------------------------------------------------- inputs
def weight_shapes(model: dict) -> Dict[str, tuple]:
    """Every parameter by the port's ``state_dict`` names."""
    H, Do, Dh = model["lstm_hidden_size"], model["output_size"], model["visual_hidden_size"]
    shapes = {"query_lstm.fwd_cell.weight_ih_l0": (4 * H, model["query_feat_size"]),
              "query_lstm.fwd_cell.weight_hh_l0": (4 * H, H),
              "query_lstm.fwd_cell.bias_ih_l0": (4 * H,),
              "query_lstm.fwd_cell.bias_hh_l0": (4 * H,),
              "query_linear.weight": (Do, H), "query_linear.bias": (Do,)}
    for stream, key in STREAMS.items():
        p = f"{stream}_moment_mlp"
        shapes.update({f"{p}.Dense_0.weight": (Dh, model[key]), f"{p}.Dense_0.bias": (Dh,),
                       f"{p}.Dense_1.weight": (Do, Dh), f"{p}.Dense_1.bias": (Do,)})
    return shapes


def make_weights(model: dict, device, seed: int) -> Dict[str, torch.Tensor]:
    """float32 weights from one uniform draw (module docstring)."""
    shapes = weight_shapes(model)
    sizes = [math.prod(s) for s in shapes.values()]
    u_all = torch.rand(sum(sizes), generator=synth.generator(device, seed, "cal weights"),
                       device=device) * 2 - 1
    H = model["lstm_hidden_size"]
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        u = u_all[at:at + size].view(shape)
        at += size
        if name.endswith("bias_ih_l0"):
            out[name] = torch.zeros_like(u)
        elif name.startswith("query_lstm"):
            out[name] = u / math.sqrt(H)
        else:
            fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
            out[name] = u / math.sqrt(fan_in)
    return out


def draw_block(corpus: dict, model: dict, device, seed: int, b: int):
    """Block ``b`` of the corpus: (video clips (n, L, Dv), subtitle clips
    (n, L, Ds), valid clips (n,), durations (n,) seconds), the clips f32
    unit rows drawn from (seed, b)."""
    bv, nv, L = corpus["block_videos"], corpus["n_videos"], corpus["n_clips"]
    n = min(bv, nv - b * bv)
    gen = synth.generator(device, seed, "cal corpus", b)
    rows = lambda d: torch.nn.functional.normalize(
        torch.randn((n, L, d), generator=gen, device=device), dim=-1, eps=0.0)
    video = rows(model["visual_input_size"] // 2)
    sub = rows(model["textual_input_size"] // 2)
    duration = corpus.get("duration", L * corpus["clip_length"])
    return video, sub, np.full(n, L), np.full(n, duration)


def serve_config(config: dict):
    """The port's ``CALServeConfig`` of the configuration."""
    pc = config["proposals"]
    return _port()[2](dset_name=pc["dset"], max_moment_clips=pc["max_moment_clips"],
                      n_proposals=pc["per_video"], **config["retrieval"])


# ---------------------------------------------------------------- the program
def corpus(config: dict, device, seed: int):
    """The seed's corpus as ``encode_cal_corpus`` takes it: (the blocks
    {"video", "sub"}, drawn as they are consumed; valid clips (Nv,);
    durations (Nv,) seconds)."""
    model, corpus = config["model"], config["corpus"]
    nv = corpus["n_videos"]
    nb = math.ceil(nv / corpus["block_videos"])
    blocks = ({"video": v, "sub": s} for v, s, _, _ in
              (draw_block(corpus, model, device, seed, b) for b in range(nb)))
    duration = corpus.get("duration", corpus["n_clips"] * corpus["clip_length"])
    return blocks, np.full(nv, corpus["n_clips"]), np.full(nv, duration)


def build(config: dict, device, seed: int):
    """The port's CAL with the seed's weights and the cache that
    ``encode_cal_corpus`` builds from the seed's corpus. Returns (model,
    cache, the serving config, ``score_cal_batch``)."""
    CALConfig, CALWithSub, _, encode, score = _port()
    model = config["model"]
    keys = ("ctx_mode", "query_feat_size", "lstm_hidden_size", "visual_hidden_size",
            "output_size", "visual_input_size", "textual_input_size", "dtype_str")
    net = CALWithSub(CALConfig(**{k: model[k] for k in keys})).eval().to(device)
    net.load_state_dict(make_weights(model, device, seed), strict=True)
    blocks, n_clips, durations = corpus(config, device, seed)
    cfg = serve_config(config)
    return net, encode(net, blocks, n_clips, cfg, durations), cfg, score


def queries(traffic: dict, config: dict, n_videos: int, device, seed: int, call):
    """Call ``call``'s queries: (features, mask, ground-truth video), the
    token rows L2-normed."""
    model = config["model"]
    feat, mask, gt = synth.make_queries(
        traffic, {"max_desc_l": model["max_desc_l"], "query_input_size": model["query_feat_size"]},
        n_videos, device, seed, call)
    return feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-5), mask, gt


def call(state, queries, score_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """One ``score_cal_batch``; ``score_fn`` stands in for it where given."""
    model, cache, cfg, score = state
    q_feat, q_mask, gt = queries
    return (score_fn or score)(model, cache, q_feat, q_mask, gt, cfg)


def token_lengths(traffic: dict, device, seed: int, calls: int) -> List[np.ndarray]:
    """The query token lengths of calls 0 .. calls - 1."""
    return synth.token_lengths(traffic, device, seed, calls)


def reference(config: dict, device, seed: int, precision: str = STATED) -> Reference:
    """The plain reference over the seed's weights and corpus."""
    model, corpus = config["model"], config["corpus"]
    return Reference(make_weights(model, device, seed),
                     lambda b: draw_block(corpus, model, device, seed, b), corpus,
                     config["proposals"], config["retrieval"], precision)


def control_score_fn(config: dict, device, seed: int):
    """A stand-in for ``score_cal_batch``: the reference one precision below
    the stated one, with the entry's signature and outputs."""
    ref = reference(config, device, seed, "control")

    def score(model, cache, q_feat, q_mask, gt, cfg):
        return ref.score_batch(q_feat, q_mask, gt)

    return score


def judge(config: dict, traffic: dict, device, seed: int, queries: list,
          outputs: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The module docstring's numbers for the checked calls' ``queries`` and
    the program's ``outputs`` (row-aligned), against the reference."""
    feat, mask, gt = (torch.cat(parts) for parts in zip(*queries))
    return compare(reference(config, device, seed), feat, mask, gt, outputs)


def _worst(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def _in_order(scores, keys) -> bool:
    """Each row in ``lax.top_k``'s order: scores descending, equal scores
    by ascending key."""
    ds, dk = scores[:, 1:] - scores[:, :-1], keys[:, 1:] - keys[:, :-1]
    return bool(((ds < 0) | ((ds == 0) & (dk > 0))).all())


def compare(ref: Reference, feat, mask, gt, prog: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The compared numbers of the program's outputs ``prog`` for the
    queries (feat, mask, gt) against ``ref``."""
    _, _, slots, spans = ref.corpus()
    nv, P = slots.shape
    dev = feat.device
    on = lambda a, dt=torch.long: torch.as_tensor(np.asarray(a)).to(dev, dt)
    spans = spans.to(dev)
    q = ref.query(feat, mask)
    n = q.shape[0]
    k = min(ref.rc["max_before_nms"], nv * P)
    out: Dict[str, float] = {}

    vid, prop = on(prog["vcmr_video"]), on(prog["vcmr_prop"])
    p_s = on(prog["vcmr_scores"], torch.float64)
    p_sp = on(prog["vcmr_spans"], torch.float64)
    ok = (vid.shape == (n, k) and bool(((vid >= 0) & (vid < nv) & (prop >= 0)
                                        & (prop < P)).all()))
    if ok:
        flat = vid * P + prop
        keys = torch.sort(flat, dim=1).values
        ok = (bool((slots.flatten()[flat] > 0).all()) and bool(torch.isfinite(p_s).all())
              and bool((keys[:, 1:] != keys[:, :-1]).all()))
    if ok:
        r_s = ref.scores_of(q, vid, prop)
        r_top = ref.top(q, k)[0]
        out["q2c_err"] = _worst((p_s - r_s).abs())
        out["topv_gap"] = _worst((r_top[:, -1] - r_s.min(dim=1).values).clamp_min(0))
        out["span_err"] = _worst((p_sp - spans[vid, prop]).abs())
        out["vcmr_gap"] = (_worst((r_top - r_s).clamp_min(0)) if _in_order(p_s, flat)
                           else INF)
    else:
        out.update(q2c_err=INF, topv_gap=INF, span_err=INF, vcmr_gap=INF)

    g_prop = on(prog["svmr_prop"])
    g_s = on(prog["svmr_scores"], torch.float64)
    g_sp = on(prog["svmr_spans"], torch.float64)
    if (g_prop.shape == (n, P) and bool(torch.isfinite(g_s).all())
            and bool((torch.sort(g_prop, dim=1).values
                      == torch.arange(P, device=dev)[None]).all())):
        r_g = ref.gt_row(q, gt)
        r_at = torch.gather(r_g, 1, g_prop)
        out["svmr_err"] = _worst((g_s - r_at).abs())
        out["svmr_gap"] = (_worst((torch.sort(r_g, dim=1, descending=True).values
                                   - r_at).clamp_min(0)) if _in_order(g_s, g_prop) else INF)
        out["span_err"] = max(out["span_err"],
                              _worst((g_sp - spans[gt.long()[:, None], g_prop]).abs()))
    else:
        out.update(svmr_err=INF, svmr_gap=INF, span_err=INF)
    return out
