"""The plain reference against the port's CPU path at toy sizes, stage by
stage, and the whole check on sound runs of both tiny cells."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmarks import harness, synth
from benchmarks.reference import xml_ref
from benchmarks.tests import tiny
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import span as port_span
from tvretrieval_tpu_torch.ops import video_score as port_vs

SEED = 2 ** 33 + 17


def _setup(config_name):
    cfg = tiny.tiny_config(config_name)
    weights = synth.make_weights(cfg["model"], "cpu", SEED)
    corpus = synth.make_corpus(cfg["corpus"], cfg["model"], "cpu", SEED)
    model = XML(XMLConfig(**cfg["model"])).eval()
    model.load_state_dict(weights, strict=False)
    ref = xml_ref.Reference(weights, corpus, cfg["model"], cfg["retrieval"], cfg["semantics"])
    traffic = dict(tiny.TRAFFIC)
    feat, mask, gt = synth.make_queries(traffic, cfg["model"], cfg["corpus"]["n_videos"],
                                        "cpu", SEED, 0)
    return cfg, model, ref, corpus, feat, mask, gt


def test_synth_is_a_function_of_the_seed():
    cfg = tiny.tiny_config("xml_tvr_shipped")
    a = synth.make_corpus(cfg["corpus"], cfg["model"], "cpu", 2 ** 40 + 3)
    b = synth.make_corpus(cfg["corpus"], cfg["model"], "cpu", 2 ** 40 + 3)
    c = synth.make_corpus(cfg["corpus"], cfg["model"], "cpu", 2 ** 40 + 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["feat2_cat"], c["feat2_cat"])
    wa = synth.make_weights(cfg["model"], "cpu", 5)
    assert all(torch.equal(v, synth.make_weights(cfg["model"], "cpu", 5)[k]) for k, v in wa.items())
    qa = synth.make_queries(tiny.TRAFFIC, cfg["model"], 300, "cpu", 5, 7)
    qb = synth.make_queries(tiny.TRAFFIC, cfg["model"], 300, "cpu", 5, 7)
    assert all(torch.equal(a, b) for a, b in zip(qa, qb))
    lens = synth.token_lengths(tiny.TRAFFIC, "cpu", 5, 8)[7]
    lo, hi = tiny.TRAFFIC["token_len"]
    assert lens.min() >= lo and lens.max() <= hi
    assert np.array_equal(qa[1].sum(1).long().numpy(), lens)
    assert bool((qa[0].abs().sum(-1) > 0).eq(qa[1] > 0).all())
    assert int(qa[2].min()) >= 0 and int(qa[2].max()) < 300


def test_query_encoder_matches_the_port():
    _, model, ref, _, feat, mask, _ = _setup("xml_tvr_shipped")
    with torch.no_grad():
        pv, ps = model.encode_query(feat, mask)
    rv, rs = ref.encode(feat, mask)
    for p, r in ((pv, rv), (ps, rs)):
        assert torch.allclose(p.double(), r, rtol=1e-5, atol=1e-5)


def test_video_scores_match_the_port_bit_for_bit():
    cfg, model, ref, corpus, feat, mask, _ = _setup("xml_tvr_shipped")
    vq, sq = ref.encode(feat, mask)
    got = ref.video_scores(vq, sq, block=64)
    L = corpus["mask"].shape[1]
    flat = [port_vs.quantize_unit_i8(port_vs.build_flat_feat1(corpus[k], corpus["mask"]))
            for k in ("vf1", "sf1")]
    q8 = [xml_ref.quantize_unit_i8(xml_ref._l2n(q)).to(torch.int8) for q in (vq, sq)]
    want = port_vs.video_scores_int8_xla(q8[0], q8[1], flat[0], flat[1],
                                         corpus["mask"].shape[0], port_vs.flat_lp(L))
    assert torch.equal(got.float(), want)


def test_int8_row_quantizer_matches_the_port():
    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(3)) * 3
    q, s = xml_ref.quantize_rows_i8_f32(x)
    pq, ps = port_vs.quantize_rows_i8(x)
    assert torch.equal(q.to(torch.int8), pq) and torch.equal(s[:, 0], ps)


@pytest.mark.parametrize("config_name", ["xml_tvr_shipped", "xml_tvr_int8_exact"])
def test_span_probabilities_match_the_port(config_name):
    cfg, model, ref, corpus, feat, mask, gt = _setup(config_name)
    vq, sq = ref.encode(feat, mask)
    idx = torch.randint(0, corpus["mask"].shape[0], (feat.shape[0], 5),
                        generator=torch.Generator().manual_seed(1))
    st, ed = ref.span_probs(vq, sq, idx)
    pvq, psq = (q.float() for q in (vq, sq))
    with torch.no_grad():
        if cfg["semantics"]["feat2"] == "bf16":
            pst, ped = model.merged_st_ed_scores_simgather_cat(
                pvq, psq, corpus["feat2_cat"], corpus["mask"], idx, sim_dtype=torch.bfloat16)
        else:
            f8, fs = port_vs.build_flat_feat2_i8(corpus["feat2_cat"])
            pst, ped = model.merged_st_ed_scores_pallas_cat_i8(pvq, psq, f8, fs,
                                                               corpus["mask"], idx)
    # the stored bf16 similarity may round either way where the two sums
    # straddle a rounding boundary: one bf16 step moves a probability by
    # well under 2%
    for p, r in ((pst, st), (ped, ed)):
        prob = torch.softmax(p.double(), dim=-1)
        assert torch.allclose(prob, r, rtol=2e-2, atol=1e-6)
        assert (prob - r).abs().median() < 1e-6


def test_band_topn_matches_the_ports_flat_selection():
    g = torch.Generator().manual_seed(4)
    st = torch.softmax(torch.randn(6, 9, 24, generator=g), -1)
    ed = torch.softmax(torch.randn(6, 9, 24, generator=g), -1)
    vs = torch.rand(6, 9, generator=g) + 0.5
    vals, vid, s, e = xml_ref.band_topn(st.double(), ed.double(), vs.double(), 2, 16, 30)
    pvid, ps, pe, pvals = port_span.banded_topk_spans(st, ed, vs, 2, 16, 30)
    assert torch.allclose(vals.float(), pvals, rtol=1e-6)
    assert torch.equal(vid.int(), pvid) and torch.equal(s.int(), ps) and torch.equal(e.int(), pe)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_runs_are_correct(tiny_root, device, cell):
    res = harness.run_cell(cell, SEED, 0.3, False, device, time.perf_counter(), tiny_root,
                           log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= tiny.TRAFFIC["queries_per_call"]
    names = set(tiny.tiny_config(tiny.CELLS[cell])["limits"])
    assert set(res["checks"]) == names
    assert list(res)[-1] == "checks"
