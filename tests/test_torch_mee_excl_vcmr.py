"""MEE + ExCL two-stage VCMR over a resident corpus, on the CPU at small
widths, with no JAX: ``retrieval/excl_engine.py`` (``encode_mee_excl_corpus``,
``score_mee_excl_batch``, ``mee_excl_retrieve_vcmr``, ``vcmr_spans``),
``models/excl.py`` (``encode_context``, ``fused_span_logits``) and
``ops/span.py::banded_topk_spans_per_video``.

- the split ExCL equals ``span_logits`` in eval mode, and refuses training
  mode;
- a batch against the plain float64 reference
  (``benchmarks/reference/mee_excl_ref.py``) on the benchmark program's
  seeded toy configuration: VR indices exact, VR scores within 1e-5,
  moment and SVMR scores within a relative 1e-5 of the reference's scores
  of the same spans, and the same spans wherever the reference's scores
  are apart by more than that;
- the batched path against the port's other engines on a synthetic world
  of videos of unequal length: VR as ``mee_retrieve_vr``, VCMR as
  ``excl_retrieve_vcmr_with_external_vr`` fed the same VR result, SVMR as
  ``excl_retrieve_svmr``; without GT videos the same VR and VCMR, no SVMR;
- the external-VR path groups queries by their number of candidates and
  splits a group into calls of the ExCL stage without changing a result;
- planted ties across the per-video cap and across videos: the span stage
  keeps Python's stable order (score, then VR rank, then rank within the
  video), bit for bit.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.programs import mee_excl as program
from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
from tvretrieval_tpu_torch.data.retrieval_datasets import MEEExampleBuilder
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig
from tvretrieval_tpu_torch.models.mee import MEE, MEEConfig
from tvretrieval_tpu_torch.retrieval import excl_engine as ee
from tvretrieval_tpu_torch.retrieval.vr_engine import mee_retrieve_vr
from tvretrieval_tpu_torch.testing import rank_mismatches

SEED = 2 ** 33 + 21
WORLD = dict(n_videos=30, n_queries=12, vid_dim=10, text_dim=6, max_clips=12, seed=3,
             query_dim=9)
LQ, LC = 6, 12


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed=0):
    g = torch.Generator().manual_seed(seed)
    excl = ExCL(ExCLConfig(visual_input_size=WORLD["vid_dim"] + 2,
                           sub_input_size=WORLD["text_dim"] + 2,
                           query_input_size=WORLD["query_dim"], hidden_size=8)).init_weights(g)
    mee = MEE(MEEConfig(text_input_size=WORLD["query_dim"], vid_input_size=WORLD["vid_dim"],
                        sub_input_size=WORLD["text_dim"], output_size=8)).init_weights(g)
    with torch.no_grad():            # biases and BatchNorm statistics away from their defaults
        for name, p in list(excl.named_parameters()) + list(mee.named_parameters()):
            if name.endswith("bias") or name.endswith("bias_hh_l0"):
                p.normal_(0.0, 0.1, generator=g)
        for m in mee.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return mee.eval(), excl.eval()


def test_split_excl_equals_span_logits():
    _, excl = _models(1)
    g = torch.Generator().manual_seed(2)
    n = 5
    lengths = torch.tensor([12, 1, 7, 12, 4])
    mask = (torch.arange(LC)[None] < lengths[:, None]).float()
    q_len = torch.tensor([6, 3, 1, 5, 6])
    q_mask = (torch.arange(LQ)[None] < q_len[:, None]).float()
    q = torch.randn((n, LQ, WORLD["query_dim"]), generator=g) * q_mask[:, :, None]
    v = torch.randn((n, LC, WORLD["vid_dim"] + 2), generator=g) * mask[:, :, None]
    s = torch.randn((n, LC, WORLD["text_dim"] + 2), generator=g) * mask[:, :, None]
    with torch.no_grad():
        st, ed = excl.span_logits(q, q_mask, v, mask, s, mask)
        _, q_hidden = excl.query_encoder(q, q_len.int())
        got = excl.fused_span_logits(q_hidden, excl.encode_context(v, mask, s, mask),
                                     (mask, mask))
    assert torch.equal(got[0], st) and torch.equal(got[1], ed)
    assert (st == -1e10).any()
    with pytest.raises(RuntimeError, match="eval mode"):
        excl.train().encode_context(v, mask, s, mask)


def _toy_config() -> dict:
    """The benchmark's ``mee_excl_tvr`` with its semantics kept and toy
    widths, corpus and batch."""
    with open(Path(program.__file__).parent.parent / "configs" / "mee_excl_tvr.json") as f:
        cfg = json.load(f)
    cfg["model"]["mee"].update(text_input_size=40, vid_input_size=36, sub_input_size=20,
                               output_size=16)
    cfg["model"]["excl"].update(visual_input_size=38, sub_input_size=22, query_input_size=40,
                                hidden_size=16)
    cfg["model"]["max_desc_l"] = 10
    cfg["corpus"].update(n_videos=200, n_clips=20, block_videos=48)
    cfg["retrieval"].update(top_n_videos=16, top_n_per_video=5, max_before_nms=30,
                            max_pred_l=8)
    return cfg


def test_batch_matches_the_float64_reference():
    cfg = _toy_config()
    traffic = {"loop": "closed", "callers": 1, "queries_per_call": 8, "token_len": [3, 10],
               "gt_video": "uniform", "check_queries": 16}
    nv = cfg["corpus"]["n_videos"]
    state = program.build(cfg, "cpu", SEED)
    ref = program.reference(cfg, "cpu", SEED)
    for i in range(2):
        q = program.queries(traffic, cfg, nv, "cpu", SEED, i)
        got = {k: v.numpy() for k, v in program.call(state, q).items()}
        want = ref.score_batch(*q)
        np.testing.assert_array_equal(got["vr_idx"], want["vr_idx"])
        np.testing.assert_allclose(got["vr_scores"], want["vr_scores"], rtol=0, atol=1e-5)
        numbers = program.compare(ref, *q, got)
        assert max(numbers[k] for k in ("span_err", "vcmr_gap", "svmr_err",
                                        "svmr_gap")) <= 1e-5, numbers
        assert numbers["q2c_err"] <= 1e-7 and numbers["topv_gap"] == 0.0, numbers
        L = cfg["corpus"]["n_clips"]
        for key, score, flat in (("moments", "moment_scores",
                                  lambda m: (m[..., 0] * L + m[..., 1]) * L + m[..., 2]),
                                 ("svmr", "svmr_scores", lambda m: m[..., 0] * L + m[..., 1])):
            np.testing.assert_allclose(got[score], want[score], rtol=1e-5, atol=0)
            assert rank_mismatches(flat(want[key]), want[score], flat(got[key]),
                                   rtol=1e-5) == 0


@pytest.fixture(scope="module")
def world():
    w = make_synthetic_world(**WORLD)
    builder = ExampleBuilder(query_source=w.query_source, video_source=w.video_source,
                             sub_source=w.sub_source, ctx_mode="video_sub_tef", max_desc_l=LQ,
                             max_ctx_l=LC, clip_length=w.clip_length)
    mee_builder = MEEExampleBuilder(query_source=w.query_source, video_source=w.video_source,
                                    sub_source=w.sub_source, max_desc_l=LQ, max_ctx_l=LC)
    mee, excl = _models(3)
    cache = ee.encode_mee_excl_corpus(
        mee, excl, ee.mee_excl_corpus_blocks(builder, mee_builder, w.corpus, "cpu", 8),
        len(w.corpus))
    return w, builder, mee_builder, mee, excl, cache


CFG = ee.MEEExCLConfig(top_n_videos=6, q2c_alpha=5.0, min_pred_l=1, max_pred_l=5,
                       top_n_per_video=4, max_before_nms=10)


def _assert_same(want, got, atol=0.0, rtol=1e-5):
    assert [e["desc_id"] for e in want] == [e["desc_id"] for e in got]
    for a, b in zip(want, got):
        pa, pb = np.asarray(a["predictions"]), np.asarray(b["predictions"])
        assert pa.shape == pb.shape and len(pa)
        np.testing.assert_allclose(pb[:, 3], pa[:, 3], rtol=rtol, atol=atol)
        key = lambda p: (p[:, 0] * 1000 + p[:, 1] / 1.5) * 1000 + p[:, 2] / 1.5
        assert rank_mismatches(key(pa), pa[:, 3], key(pb), atol=atol, rtol=rtol) == 0


def test_batch_path_matches_the_ports_engines(world, tmp_path):
    w, builder, mee_builder, mee, excl, cache = world
    rows = w.annotations[:12]
    got = ee.mee_excl_retrieve_vcmr(mee, excl, cache, builder, w.corpus, rows, CFG,
                                    query_bsz=5, clip_length=w.clip_length)
    assert set(got) == {"VR", "VCMR", "SVMR"}
    vr = mee_retrieve_vr(mee, mee_builder, w.corpus, rows, ctx_bsz=7, query_bsz=4, topk=6)["VR"]
    _assert_same(vr, got["VR"], atol=1e-6, rtol=0)
    path = tmp_path / "vr.json"
    path.write_text(json.dumps({"VR": got["VR"]}))
    kw = dict(clip_length=w.clip_length, top_n_videos=6, q2c_alpha=5.0, min_pred_l=1,
              max_pred_l=5, top_n_per_video=4, max_before_nms=10)
    want = ee.excl_retrieve_vcmr_with_external_vr(excl, builder, w.corpus, rows, str(path),
                                                  **kw)["VCMR"]
    _assert_same(want, got["VCMR"])
    svmr = ee.excl_retrieve_svmr(excl, builder, w.corpus, rows, clip_length=w.clip_length,
                                 query_bsz=5, min_pred_l=1, max_pred_l=5, max_before_nms=10)
    _assert_same(svmr["SVMR"], got["SVMR"])


def test_outputs_with_and_without_the_gt_video(world):
    """Without GT videos the call returns the VR and VCMR outputs alone,
    equal to those it returns beside the SVMR row."""
    w, builder, _, mee, excl, cache = world
    qf, qm = (torch.from_numpy(a) for a in builder.build_queries(
        [r["desc_id"] for r in w.annotations[:6]]))
    with_gt = ee.score_mee_excl_batch(mee, excl, cache, qf, qm, CFG, torch.arange(6) * 4)
    alone = ee.score_mee_excl_batch(mee, excl, cache, qf, qm, CFG)
    assert alone.keys() == {"vr_idx", "vr_scores", "moments", "moment_scores"}
    assert with_gt.keys() == alone.keys() | {"svmr", "svmr_scores"}
    assert with_gt["moments"].shape == (6, 10, 3) and with_gt["svmr"].shape == (6, 10, 2)
    assert with_gt["moments"].dtype == with_gt["vr_idx"].dtype == torch.int32
    for k in alone:
        torch.testing.assert_close(alone[k], with_gt[k], rtol=1e-6, atol=0)


def test_external_vr_calls_split_and_group_alike(world, tmp_path, monkeypatch):
    """Queries naming 6, 3 or no videos (one twice) through the external-VR
    path: one call of the ExCL stage a group, or one a query, give the same
    predictions bit for bit."""
    w, builder, _, _, excl, _ = world
    rows = w.annotations[:9]
    rng = np.random.default_rng(4)
    vr = []
    for qi, r in enumerate(rows):
        n = (6, 3, 0)[qi % 3]
        vids = rng.choice(WORLD["n_videos"], n, replace=False).tolist()
        if n == 6:
            vids[5] = vids[1]
        vr.append({"desc_id": r["desc_id"], "predictions": [
            [w.corpus.video2idx[w.corpus.vid_names[v]], 0, 0, float(x)]
            for v, x in zip(vids, np.sort(rng.uniform(0.1, 0.5, n))[::-1])]})
    path = tmp_path / "vr.json"
    path.write_text(json.dumps({"VR": vr}))
    kw = dict(clip_length=w.clip_length, top_n_videos=6, q2c_alpha=5.0, min_pred_l=1,
              max_pred_l=5, top_n_per_video=4, max_before_nms=10)
    calls = []
    stage = ee.excl_vcmr_batch
    monkeypatch.setattr(ee, "excl_vcmr_batch",
                        lambda *a, **k: calls.append(a[4].shape) or stage(*a, **k))
    grouped = ee.excl_retrieve_vcmr_with_external_vr(excl, builder, w.corpus, rows, str(path),
                                                     **kw)["VCMR"]
    assert sorted(calls) == [(3, 3), (3, 6)]
    monkeypatch.setattr(ee, "EXTERNAL_VR_PAIRS", 1)
    alone = ee.excl_retrieve_vcmr_with_external_vr(excl, builder, w.corpus, rows, str(path),
                                                   **kw)["VCMR"]
    assert len(calls) == 2 + 6
    assert [len(e["predictions"]) for e in grouped] == [10, 10, 0] * 3
    for a, b in zip(grouped, alone):
        assert a["desc_id"] == b["desc_id"]
        assert a["predictions"] == b["predictions"]


def _python_vcmr(st_w, ed, min_l, max_l, per_video, top_n):
    """inference_with_vcmr.py's selection in plain Python over one query's
    (V, L) weighted starts and ends: the scores are the same f32 products."""
    V, L = st_w.shape
    merged = []
    for v in range(V):
        spans = [(float(st_w[v, s] * ed[v, e]), s, e) for s in range(L)
                 for e in range(s + min_l, min(s + max_l, L))]
        merged += [(sc, v, s, e) for sc, s, e in
                   sorted(spans, key=lambda t: -t[0])[:per_video]]
    return sorted(merged, key=lambda t: -t[0])[:top_n]


def test_planted_ties_keep_the_stable_merge_order():
    """Span probabilities of three levels (many equal spans in each video,
    more than the cap of 50 at the top), one video uniform, one a copy of
    another with the same VR score; the stage's output equals Python's
    stable sorts entry for entry."""
    g = torch.Generator().manual_seed(7)
    V, L, alpha = 6, 100, 20.0
    st = torch.randint(1, 4, (1, V, L), generator=g).float()
    ed = torch.randint(1, 4, (1, V, L), generator=g).float()
    st[0, 4], ed[0, 4] = 1.0, 1.0
    st[0, 3], ed[0, 3] = st[0, 1], ed[0, 1]
    st, ed = st / st.sum(-1, keepdim=True), ed / ed.sum(-1, keepdim=True)
    vr = torch.tensor([[0.031, 0.02, 0.031, 0.02, 0.025, 0.01]])
    vid, s, e, scores = ee.vcmr_spans(st, ed, vr, alpha, 2, 16, 50, 200)
    want = _python_vcmr(st[0] * torch.exp(alpha * vr)[0, :, None], ed[0], 2, 16, 50, 200)
    assert [(float(a), int(b), int(c), int(d)) for a, b, c, d in
            zip(scores[0], vid[0], s[0], e[0])] == want
    assert len({t[0] for t in want}) < 100                         # ties across the list
    assert any(a[0] == b[0] and a[1] != b[1] for a, b in zip(want, want[1:]))
    assert sum(t[1] == 4 for t in want) == 50 or all(t[1] != 4 for t in want)
