"""MEE + ExCL two-stage VCMR on the port's resident corpus: the program of
``mee_excl_tvr``.

Set-up draws the seed's weights and corpus, loads the port's MEE and ExCL
and builds the corpus cache with ``tvretrieval_tpu_torch.retrieval.
excl_engine.encode_mee_excl_corpus``; a call is one ``score_mee_excl_batch``
over a batch of queries (with each query's ground-truth video, for ExCL's
SVMR row). ``judge`` holds the outputs of the checked calls against the
plain reference ``benchmarks.reference.mee_excl_ref``, drawn again from the
seed. The harness's module docstring says what each function is for and
when it is called.

Inputs, all drawn on the run's device from the seed:

- weights by the names of the port's ``state_dict`` (MEE's under ``mee.``,
  ExCL's under ``excl.``) at the published initializers' scales: dense
  N(0, 0.02), NetVLAD's clusters N(0, 1/sqrt(D)), LSTM input kernels
  N(0, 1/sqrt(fan_in)) and recurrent ones N(0, 1/sqrt(H)) (an orthogonal
  matrix's entries' scale; N(mean, std) throughout); biases N(0, 0.02) in
  place of the published zeros, so that a path that drops one shows, except
  the LSTMs' input biases, which flax's cells lack (zero); BatchNorm scales
  1 + N(0, 0.1), shifts N(0, 0.1), running means N(0, 0.01), running
  variances 1 + |N(0, 0.1)|;
- the corpus a block of ``block_videos`` videos at a time from (seed,
  block): every clip's video and subtitle features unit rows (drawn in
  f32, L2-normed), every video ``n_clips`` clips. The port's inputs are
  what its data layer makes of them: ExCL's the clips with their TEF
  appended, MEE's each stream's clips averaged and L2-normed;
- a call's queries from (seed, call): ``synth.make_queries``'s token
  lengths, ground-truth videos and features, each token row L2-normed as
  the data layer normalizes query features.

The compared numbers (each larger-is-worse; a returned index out of range,
a repeated video or moment, a span outside the band, more than
``top_n_per_video`` moments of one video or a non-finite score reads
``inf``):

- ``q2c_err``: the widest |difference| between a returned video's VR score
  and the reference's score of that video (MEE);
- ``topv_gap``: by how much the worst returned video lies below the
  reference's N-th best score (the exact top N);
- ``span_err``: the widest relative |difference| between a returned
  moment's score and the reference's score of the same (video, st, ed),
  its start weighted by the reference's VR score of the video (ExCL);
- ``vcmr_gap``: the widest relative shortfall, rank by rank, of the
  returned moments' reference scores against the reference's own top
  ``max_before_nms`` over the returned videos (the two-level selection);
- ``svmr_err``, ``svmr_gap``: the same two for the SVMR row of the
  ground-truth video.

Random weights give near-uniform span probabilities, so moments are
compared by their scores and gaps, not by index equality.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmarks import synth
from benchmarks.reference.mee_excl_ref import STATED, Reference, length_mask, top_spans, vcmr_top

INF = float("inf")
NUMBERS = ("q2c_err", "topv_gap", "span_err", "vcmr_gap", "svmr_err", "svmr_gap")


def _port():
    """The system under test: the port's models and its MEE + ExCL engine."""
    from tvretrieval_tpu_torch.retrieval.excl_engine import (
        MEEExCLConfig, encode_mee_excl_corpus, score_mee_excl_batch)
    from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig
    from tvretrieval_tpu_torch.models.mee import MEE, MEEConfig
    return (MEE, MEEConfig, ExCL, ExCLConfig, MEEExCLConfig, encode_mee_excl_corpus,
            score_mee_excl_batch)


# ---------------------------------------------------------------- inputs
def _gu(prefix: str, d_in: int, d_out: int) -> dict:
    return {f"{prefix}.Dense_0.weight": (d_out, d_in), f"{prefix}.Dense_0.bias": (d_out,),
            f"{prefix}.ContextGating_0.Dense_0.weight": (d_out, d_out),
            f"{prefix}.ContextGating_0.Dense_0.bias": (d_out,),
            **_bn(f"{prefix}.ContextGating_0.bn", d_out)}


def _bn(prefix: str, d: int) -> dict:
    return {f"{prefix}.{k}": (d,) for k in ("weight", "bias", "running_mean", "running_var")}


def _lstm(prefix: str, d_in: int, h: int) -> dict:
    return {f"{prefix}.{cell}.{k}": shape for cell in ("fwd_cell", "bwd_cell")
            for k, shape in (("weight_ih_l0", (4 * h, d_in)), ("weight_hh_l0", (4 * h, h)),
                             ("bias_ih_l0", (4 * h,)), ("bias_hh_l0", (4 * h,)))}


def weight_shapes(model: dict) -> Dict[str, tuple]:
    """Every parameter and BatchNorm statistic of the two models, by the
    port's ``state_dict`` names under ``mee.`` and ``excl.``."""
    m, e = model["mee"], model["excl"]
    dq, out = m["text_input_size"], m["output_size"]
    k = m["netvlad_clusters"]
    shapes = {"mee.query_pooling.clusters": (dq, k), "mee.query_pooling.clusters2": (1, dq, k),
              **_bn("mee.query_pooling.bn", k),
              **_gu("mee.video_query_gu", k * dq, out), **_gu("mee.sub_query_gu", k * dq, out),
              **_gu("mee.video_gu", m["vid_input_size"], out),
              **_gu("mee.sub_gu", m["sub_input_size"], out),
              "mee.moe_fc.weight": (2, k * dq), "mee.moe_fc.bias": (2,)}
    H, h = e["hidden_size"], e["hidden_size"] // 2
    shapes.update(_lstm("excl.query_encoder", e["query_input_size"], h))
    for stream, d_in in (("video", e["visual_input_size"]), ("sub", e["sub_input_size"])):
        shapes.update(_lstm(f"excl.{stream}_encoder", d_in, h))
        shapes.update(_lstm(f"excl.{stream}_encoder2", 4 * h, h))
        for head in ("st", "ed"):
            p = f"excl.{stream}_{head}_predictor"
            shapes.update({f"{p}.Dense_0.weight": (H, 6 * h), f"{p}.Dense_0.bias": (H,),
                           f"{p}.Dense_1.weight": (1, H), f"{p}.Dense_1.bias": (1,)})
    return shapes


def make_weights(model: dict, device, seed: int) -> Dict[str, torch.Tensor]:
    """float32 weights from one normal draw, scaled by kind (module
    docstring)."""
    shapes = weight_shapes(model)
    sizes = [math.prod(s) for s in shapes.values()]
    z_all = torch.randn(sum(sizes), generator=synth.generator(device, seed, "mee_excl weights"),
                        device=device)
    std = model["initializer_range"]
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        z = z_all[at:at + size].view(shape)
        at += size
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("weight_ih_l0", "weight_hh_l0"):
            out[name] = z / math.sqrt(shape[1])
        elif leaf == "bias_ih_l0":
            out[name] = torch.zeros_like(z)
        elif name.startswith("mee.query_pooling.clusters"):
            out[name] = z / math.sqrt(shape[-2])
        elif ".bn." in name:
            out[name] = {"weight": 1.0 + 0.1 * z, "bias": 0.1 * z, "running_mean": 0.01 * z,
                         "running_var": 1.0 + 0.1 * z.abs()}[leaf]
        else:
            out[name] = std * z
    return out


def draw_block(corpus: dict, model: dict, device, seed: int, b: int):
    """Block ``b`` of the corpus: (video clips (n, L, Dv), subtitle clips
    (n, L, Ds), mask (n, L)), f32 unit rows drawn from (seed, b)."""
    bv, nv, L = corpus["block_videos"], corpus["n_videos"], corpus["n_clips"]
    n = min(bv, nv - b * bv)
    gen = synth.generator(device, seed, "mee_excl corpus", b)
    rows = lambda d: torch.nn.functional.normalize(
        torch.randn((n, L, d), generator=gen, device=device), dim=-1, eps=0.0)
    video, sub = rows(model["mee"]["vid_input_size"]), rows(model["mee"]["sub_input_size"])
    return video, sub, torch.ones((n, L), device=device)


def port_blocks(corpus: dict, model: dict, device, seed: int):
    """``encode_mee_excl_corpus``'s blocks: ExCL's clips with their TEF,
    MEE's per-stream clip means, L2-normed as ``MEEExampleBuilder`` does
    (``x / (||x|| + 1e-5)``)."""
    for b in range(math.ceil(corpus["n_videos"] / corpus["block_videos"])):
        video, sub, mask = draw_block(corpus, model, device, seed, b)
        n, L = mask.shape
        st = torch.arange(L, device=device, dtype=torch.float32) / L
        tef = torch.stack([st, st + np.float32(1.0 / L)], dim=-1).expand(n, L, 2)
        pooled = lambda x: (lambda m: m / (torch.linalg.norm(m, dim=-1, keepdim=True) + 1e-5))(
            x.mean(dim=1))
        yield dict(video_feat=torch.cat([video, tef], dim=-1), sub_feat=torch.cat([sub, tef], -1),
                   mask=mask, mee_video=pooled(video), mee_sub=pooled(sub))


# ---------------------------------------------------------------- the program
def build(config: dict, device, seed: int):
    """The two models with the seed's weights and the cache that
    ``encode_mee_excl_corpus`` builds from the seed's corpus. Returns (MEE,
    ExCL, the cache, the retrieval config, ``score_mee_excl_batch``)."""
    MEE, MEEConfig, ExCL, ExCLConfig, MEEExCLConfig, encode, score = _port()
    model, corpus = config["model"], config["corpus"]
    m = {k: v for k, v in model["mee"].items() if k != "netvlad_clusters"}
    mee, excl = MEE(MEEConfig(**m)).eval().to(device), ExCL(ExCLConfig(**model["excl"]))
    excl = excl.eval().to(device)
    weights = make_weights(model, device, seed)
    for prefix, net in (("mee.", mee), ("excl.", excl)):
        missing, unexpected = net.load_state_dict(
            {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)},
            strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise RuntimeError(f"weights do not fit {prefix[:-1]}: missing {missing}, "
                               f"unexpected {unexpected}")
    cache = encode(mee, excl, port_blocks(corpus, model, device, seed), corpus["n_videos"])
    return mee, excl, cache, MEEExCLConfig(**config["retrieval"]), score


def queries(traffic: dict, config: dict, n_videos: int, device, seed: int, call):
    """Call ``call``'s queries: (features, mask, ground-truth video), the
    token rows L2-normed."""
    model = config["model"]
    feat, mask, gt = synth.make_queries(
        traffic, {"max_desc_l": model["max_desc_l"],
                  "query_input_size": model["excl"]["query_input_size"]},
        n_videos, device, seed, call)
    return torch.nn.functional.normalize(feat, dim=-1, eps=1e-12), mask, gt


def call(state, queries, score_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """One ``score_mee_excl_batch``; ``score_fn`` stands in for it where
    given."""
    mee, excl, cache, rcfg, score = state
    q_feat, q_mask, gt = queries
    return (score_fn or score)(mee, excl, cache, q_feat, q_mask, rcfg, gt)


def token_lengths(traffic: dict, device, seed: int, calls: int) -> List[np.ndarray]:
    """The query token lengths of calls 0 .. calls - 1."""
    return synth.token_lengths(traffic, device, seed, calls)


def reference(config: dict, device, seed: int, precision: str = STATED, **kw) -> Reference:
    """The plain reference over the seed's weights and corpus."""
    model, corpus = config["model"], config["corpus"]
    return Reference(make_weights(model, device, seed),
                     lambda b: draw_block(corpus, model, device, seed, b), corpus,
                     config["retrieval"], precision, **kw)


def control_score_fn(config: dict, device, seed: int):
    """A stand-in for ``score_mee_excl_batch``: the reference one precision
    below the stated one, with the entry's signature and outputs."""
    ref = reference(config, device, seed, "control")

    def score(mee, excl, cache, q_feat, q_mask, rcfg, gt):
        return {k: torch.as_tensor(v) for k, v in ref.score_batch(q_feat, q_mask, gt).items()}

    return score


def judge(config: dict, traffic: dict, device, seed: int, queries: list,
          outputs: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The module docstring's numbers for the checked calls' ``queries`` and
    the program's ``outputs`` (row-aligned), against the reference."""
    feat, mask, gt = (torch.cat(parts) for parts in zip(*queries))
    return compare(reference(config, device, seed), feat, mask, gt, outputs)


def _relative(p, r):
    return (p - r).abs() / r.clamp_min(1e-300)


def _worst(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def compare(ref: Reference, feat, mask, gt, prog: Dict[str, np.ndarray]) -> Dict[str, float]:
    rc = ref.rc
    dev = feat.device
    on = lambda a, dt=torch.long: torch.as_tensor(np.asarray(a)).to(dev, dt)
    q2c = ref.vr_scores(feat)
    n, nv = q2c.shape
    sel = on(prog["vr_idx"])
    V = sel.shape[1]
    s_sel = torch.sort(sel, dim=1).values
    if (V != min(rc["top_n_videos"], nv) or bool(((sel < 0) | (sel >= nv)).any())
            or not bool((s_sel[:, 1:] != s_sel[:, :-1]).all())):
        return {k: INF for k in NUMBERS}
    out: Dict[str, float] = {}
    kth = torch.topk(q2c, V, dim=1).values[:, -1:]
    got = torch.gather(q2c, 1, sel)
    p_vr = on(prog["vr_scores"], torch.float64)
    out["q2c_err"] = _worst((p_vr - got).abs()) if bool(torch.isfinite(p_vr).all()) else INF
    out["topv_gap"] = _worst((kth - got).clamp_min(0))

    st, ed = ref.span_probs(feat, mask, torch.cat([sel, gt.long()[:, None]], dim=1))
    L = st.shape[-1]
    lmask = length_mask(L, rc["min_pred_l"], rc["max_pred_l"], dev)
    st_w = st[:, :V] * torch.exp(rc["q2c_alpha"] * got)[:, :, None]
    top_n, per_video = rc["max_before_nms"], rc["top_n_per_video"]
    rows = torch.arange(n, device=dev)[:, None]

    def spans_ok(s, e):
        return bool(((s >= 0) & (e < L) & (e - s >= rc["min_pred_l"])
                     & (e - s < rc["max_pred_l"])).all())

    # the moments: (VR rank, st, ed) over the returned videos
    mom = on(prog["moments"])
    vid, s, e = mom[..., 0], mom[..., 1], mom[..., 2]
    p_m = on(prog["moment_scores"], torch.float64)
    keys = torch.sort((vid * L + s) * L + e, dim=1).values
    per = torch.zeros((n, V + 1), dtype=torch.long, device=dev).scatter_add_(
        1, vid.clamp(0, V), torch.ones_like(vid))
    ok = (spans_ok(s, e) and bool(((vid >= 0) & (vid < V)).all())
          and bool((keys[:, 1:] != keys[:, :-1]).all()) and int(per.max()) <= per_video
          and bool(torch.isfinite(p_m).all()) and mom.shape[1] == top_n)
    if ok:
        r_m = st_w[rows, vid, s] * ed[:, :V][rows, vid, e]
        ref_top = vcmr_top(st_w, ed[:, :V], lmask, per_video, top_n)[0]
        out["span_err"] = _worst(_relative(p_m, r_m))
        out["vcmr_gap"] = _worst((ref_top - r_m).clamp_min(0) / ref_top.clamp_min(1e-300))
    else:
        out["span_err"] = out["vcmr_gap"] = INF

    # the SVMR row of the ground-truth video
    g = on(prog["svmr"])
    gs, ge = g[..., 0], g[..., 1]
    p_g = on(prog["svmr_scores"], torch.float64)
    gkeys = torch.sort(gs * L + ge, dim=1).values
    if (spans_ok(gs, ge) and bool((gkeys[:, 1:] != gkeys[:, :-1]).all())
            and bool(torch.isfinite(p_g).all()) and g.shape[1] == top_n):
        r_g = st[:, V][rows, gs] * ed[:, V][rows, ge]
        g_top = top_spans(st[:, V], ed[:, V], lmask, top_n)[0]
        out["svmr_err"] = _worst(_relative(p_g, r_g))
        out["svmr_gap"] = _worst((g_top - r_g).clamp_min(0) / g_top.clamp_min(1e-300))
    else:
        out["svmr_err"] = out["svmr_gap"] = INF
    return out
