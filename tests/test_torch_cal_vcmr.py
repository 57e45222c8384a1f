"""CAL served over a resident corpus (retrieval/proposal_engine.py:
``encode_cal_corpus``, ``score_cal_batch``) at toy widths on the CPU,
against the data layer's host-built path, the benchmark's plain reference
(benchmarks/reference/cal_ref.py) and the former scoring path; no JAX.

The world's videos differ in length: proposal slots are padded past the
shorter videos' proposals, two videos last longer than their clips (the
proposals that start past the clips take the last two), and a 16-clip
window is cut by the ``max_moment_clips`` cap of 10 and another at a
video's end."""
import numpy as np
import pytest
import torch

from benchmarks.programs import cal as program
from benchmarks.reference.cal_ref import Reference
from tvretrieval_tpu_torch.data.datasets import CorpusIndex
from tvretrieval_tpu_torch.data.features import MemoryFeatureSource
from tvretrieval_tpu_torch.data.retrieval_datasets import CALBuilderConfig, CALExampleBuilder
from tvretrieval_tpu_torch.models.cal import CALConfig, CALWithSub, sum_last
from tvretrieval_tpu_torch.ops.span import topk_stable
from tvretrieval_tpu_torch.retrieval import proposal_engine as pe
from tvretrieval_tpu_torch.testing import rank_mismatches

N_CLIPS = [12, 7, 16, 3, 10, 12, 20, 5]
DURATIONS = [18.0, 16.0, 24.0, 4.5, 15.0, 25.5, 30.0, 7.5]
DV, DS, DQ, LQ = 6, 5, 8, 6
MAX_CLIPS, BLOCK = 10, 3
PROPOSALS = {"length": 3, "scales": [1, 2, 4, 8], "stride": 0.3, "round_base": 1,
             "max_moment_clips": MAX_CLIPS}


@pytest.fixture(scope="module")
def world():
    torch.manual_seed(0)
    rng = np.random.default_rng(5)
    names = [f"v{i}" for i in range(len(N_CLIPS))]
    video = {n: rng.standard_normal((c, DV)).astype(np.float32) for n, c in zip(names, N_CLIPS)}
    sub = {n: rng.standard_normal((c, DS)).astype(np.float32) for n, c in zip(names, N_CLIPS)}
    queries = {str(i): rng.standard_normal((int(rng.integers(2, LQ + 1)), DQ)).astype(np.float32)
               for i in range(10)}
    builder = CALExampleBuilder(
        CALBuilderConfig(ctx_mode="video_sub", max_desc_l=LQ, max_ctx_l=max(N_CLIPS),
                         max_moment_clips=MAX_CLIPS),
        MemoryFeatureSource(queries), MemoryFeatureSource(video), MemoryFeatureSource(sub))
    corpus = CorpusIndex(vid_names=names, durations=DURATIONS,
                         video2idx={n: 100 + i for i, n in enumerate(names)})
    model = CALWithSub(CALConfig(ctx_mode="video_sub", visual_input_size=2 * DV,
                                 textual_input_size=2 * DS, query_feat_size=DQ,
                                 visual_hidden_size=9, output_size=7, lstm_hidden_size=8))
    model.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or name.endswith("bias_hh_l0"):
                p.normal_(0.0, 0.1)
    L = max(N_CLIPS)
    pad = lambda t, n: np.pad(t[n], ((0, L - len(t[n])), (0, 0)))
    feats = {"video": torch.from_numpy(np.stack([pad(video, n) for n in names])),
             "sub": torch.from_numpy(np.stack([pad(sub, n) for n in names]))}
    rows = [{"desc_id": i, "vid_name": names[i % len(names)]} for i in range(10)]
    return model, builder, corpus, feats, rows


def _blocks(feats):
    nv = feats["video"].shape[0]
    return [{k: v[b:b + BLOCK] for k, v in feats.items()} for b in range(0, nv, BLOCK)]


def _serve(P, **kw):
    return pe.CALServeConfig(max_moment_clips=MAX_CLIPS, n_proposals=P, **kw)


@pytest.fixture(scope="module")
def caches(world):
    model, builder, corpus, feats, _ = world
    host = pe.encode_proposal_corpus(model, builder, corpus, ctx_bsz=3)
    P = host.prop_spans.shape[1]
    served = pe.encode_cal_corpus(model, _blocks(feats), N_CLIPS, _serve(P), DURATIONS)
    return host, served


def test_the_world_reaches_every_edge(caches):
    host, _ = caches
    lens = host.prop_mask.sum(1).numpy()
    assert lens.min() < host.prop_spans.shape[1]                 # padded slots
    c = 1.5
    starts = host.prop_spans[..., 0] / c
    assert (starts[1] >= N_CLIPS[1]).any()                        # the st >= len edge
    wide = (np.ceil(host.prop_spans[..., 1] / c) - np.floor(starts)) > MAX_CLIPS
    assert wide.any()                                             # the cap
    assert (host.prop_spans[6, :, 1] == DURATIONS[6]).any()       # cut at the end


def test_encode_cal_corpus_matches_the_host_built_path(world, caches):
    """The served cache's scoring rows against those ``prepare_scoring``
    folds from the host-built cache's means; the served cache keeps no
    means."""
    model = world[0]
    host, served = caches
    np.testing.assert_array_equal(served.prop_spans, host.prop_spans)
    np.testing.assert_array_equal(served.prop_mask.numpy(), host.prop_mask.numpy())
    assert all(getattr(served, key) is None for key in pe.CACHE_KEYS)
    want = pe.prepare_scoring(pe.ProposalCorpusCache(
        prop_mask=host.prop_mask, prop_spans=host.prop_spans, n_videos=host.n_videos,
        **{k: getattr(host, k) for k in pe.CACHE_KEYS}), model)
    N = served.prop_mask.numel()
    assert served.score_rows.shape == want.score_rows.shape
    assert served.score_rows.shape[0] % pe.ROW_ALIGN == 0 and served.score_rows.shape[0] >= N
    np.testing.assert_allclose(served.score_rows.numpy(), want.score_rows.numpy(),
                               rtol=0, atol=2e-6)
    assert (served.score_rows[:N, 7] == -1e10).sum() == (host.prop_mask == 0).sum() > 0
    assert (served.score_rows[N:, 7] == -float("inf")).all()
    np.testing.assert_array_equal(served.span_table.numpy(), want.span_table.numpy())


def test_a_served_cache_is_not_saved(caches, tmp_path):
    """The served cache keeps only its scoring rows: saving it would write a
    cache without means, which nothing could score."""
    _, served = caches
    with pytest.raises(ValueError, match="no per-stream means"):
        pe.save_proposal_cache(served, str(tmp_path / "c.npz"))
    assert not (tmp_path / "c.npz").exists()


def _queries(builder, rows):
    qb = builder.build_query_batch(rows)
    return torch.from_numpy(qb["query_feat"]), torch.from_numpy(qb["query_mask"])


def _reference(world, P, k):
    model, _, _, feats, _ = world

    def draw(b):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        return (feats["video"][sl], feats["sub"][sl], N_CLIPS[sl], DURATIONS[sl])

    return Reference({k: v.detach() for k, v in model.state_dict().items()}, draw,
                     {"n_videos": len(N_CLIPS), "block_videos": BLOCK, "clip_length": 1.5},
                     dict(PROPOSALS, per_video=P), {"max_before_nms": k})


@pytest.mark.parametrize("chunk", [16, 1 << 20])
def test_score_cal_batch_matches_the_reference(world, caches, chunk):
    """The judge's numbers: scores within f32 rounding of the float64
    reference, spans exact, the lists in ``lax.top_k``'s order."""
    model, builder, _, _, rows = world
    _, served = caches
    P = served.prop_spans.shape[1]
    q_feat, q_mask = _queries(builder, rows)
    gt = torch.arange(len(rows)) % len(N_CLIPS)
    out = pe.score_cal_batch(model, served, q_feat, q_mask, gt,
                             _serve(P, proposal_chunk=chunk, max_before_nms=60))
    assert out["vcmr_scores"].shape == (len(rows), 60)
    assert out["svmr_prop"].shape == (len(rows), P)
    numbers = program.compare(_reference(world, P, 60), q_feat, q_mask, gt,
                              {k: v.numpy() for k, v in out.items()})
    assert set(numbers) == set(program.NUMBERS)
    assert numbers["span_err"] == 0.0, numbers
    assert max(numbers.values()) <= 2e-6, numbers


def _a_with_ties(n, k_width, seed):
    """Integer rows (exact f32 sums in any order) with a run of equal rows
    that every query scores highest, across the chunk edges at 16 and 24,
    and a -inf alignment tail."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(-3, 4, (-(-n // 8) * 8, k_width), generator=g).float()
    rows[13] = 0.0
    rows[13, 0] = 50.0                  # above 3 + 5 * 9, any other row's best
    for j in (14, 15, 16, 17, 22, 23, 24, 25, 40):
        rows[j] = rows[13]
    rows[n:] = 0.0
    rows[n:, 0] = -float("inf")
    a = torch.randint(-3, 4, (5, k_width), generator=g).float()
    a[:, 0] = 1.0
    return a, rows


@pytest.mark.parametrize("n,k,chunk", [(45, 12, 16), (45, 12, 8), (64, 30, 24), (45, 45, 16),
                                       (45, 12, 1 << 20)])
def test_chunked_top_k_is_the_unchunked_stable_top_k(n, k, chunk):
    a, rows = _a_with_ties(n, 6, n + k + chunk)
    full = a @ rows[:n].T
    want_v, want_i = topk_stable(full, k)
    assert (want_i[:, :10] == torch.tensor([13, 14, 15, 16, 17, 22, 23, 24, 25, 40])).all()
    got_v, got_i = pe._top_moments(a, rows, n, k, chunk)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    torch.testing.assert_close(got_i.long(), want_i, rtol=0, atol=0)


def test_cal_retrieve_matches_the_former_scoring(world, caches):
    """``cal_retrieve`` against the former path (per-stream distances, pads
    at +1e10, one stable top-k of the negated row, the GT rows ranked by
    ``np.argsort``), on the host-built cache."""
    model, builder, corpus, _, rows = world
    host, _ = caches
    P = host.prop_spans.shape[1]
    got = pe.cal_retrieve(model, builder, host, corpus, rows, query_bsz=4, max_before_nms=30,
                          return_arrays=True)
    q_feat, q_mask = _queries(builder, rows)
    with torch.no_grad():
        q = model.encode_query(q_feat, q_mask)
    d = sum(sum_last(q ** 2)[:, None] - 2 * q @ getattr(host, f"mean_emb_{s}").reshape(-1, 7).T
            + getattr(host, f"mean_sq_{s}").reshape(1, -1) for s in ("video", "sub")) / 2
    d = d + (1.0 - host.prop_mask.reshape(1, -1)) * 1e10
    neg, idx = topk_stable(-d, 30)
    vids = np.asarray([100 + i for i in range(len(N_CLIPS))])
    gv, gs, gsc = got["VCMR"]
    np.testing.assert_allclose(gsc, neg.numpy(), rtol=0, atol=1e-6)
    key = lambda v, s: (v * 1000 + s[..., 0] / 1.5) * 1000 + s[..., 1] / 1.5
    want_v = vids[idx.numpy() // P]
    want_s = host.prop_spans[idx.numpy() // P, idx.numpy() % P]
    assert rank_mismatches(key(want_v, want_s), neg.numpy(), key(gv, gs), atol=2e-6) == 0
    gt = np.arange(len(rows)) % len(N_CLIPS)
    sd = d.view(len(rows), len(N_CLIPS), P)[torch.arange(len(rows)), torch.from_numpy(gt)]
    order = np.argsort(sd.numpy(), axis=1)[:, :30]
    want = -np.take_along_axis(sd.numpy(), order, 1)
    sv, ss, ssc = got["SVMR"]
    np.testing.assert_array_equal(sv, np.broadcast_to(vids[gt][:, None], order.shape))
    np.testing.assert_allclose(ssc, want, rtol=0, atol=1e-6)
    assert rank_mismatches(order, want, _ranked(ss, host, gt), atol=2e-6) == 0


def _ranked(spans, cache, gt):
    """Each row's proposal indices of the SVMR ``spans`` of its GT video."""
    table = cache.prop_spans[gt]                                  # (B, P, 2)
    eq = (spans[:, :, None, :] == table[:, None, :, :]).all(-1)   # (B, K, P)
    return eq.argmax(-1)


def test_a_call_is_one_root_with_its_stages_and_counters(world, caches):
    """Under the profiler a call is one root ``score_query_batch`` that
    carries every counter (the proposals scored, the scoring rows' bytes,
    the outputs' bytes), over ``cal_query``, a ``cal_dist`` and a
    ``cal_topk`` a chunk, the merge's ``cal_topk`` and ``cal_svmr``, which
    count nothing; the outputs equal the call's without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from tvretrieval_tpu_torch.utils import trace
    model, builder, _, _, rows = world
    _, served = caches
    P = served.prop_spans.shape[1]
    n = served.prop_mask.numel()
    q_feat, q_mask = _queries(builder, rows)
    gt = torch.arange(len(rows)) % len(N_CLIPS)
    cfg = _serve(P, proposal_chunk=64, max_before_nms=60)
    call = lambda: pe.score_cal_batch(model, served, q_feat, q_mask, gt, cfg)
    trace.take()
    want = call()
    with profile(activities=[ProfilerActivity.CPU]):
        out = call()
    records = trace.take()
    chunks = -(-n // 64)
    assert chunks > 1
    assert [r.name for r in records] == (["score_query_batch", "cal_query"]
                                         + ["cal_dist", "cal_topk"] * chunks
                                         + ["cal_topk", "cal_svmr"])
    assert records[0].parent is None and all(r.parent == 0 for r in records[1:])
    assert records[0].counters == {
        "proposals": len(rows) * n, "cache_bytes": served.score_rows.nbytes,
        "out_bytes": sum(v.nbytes for v in out.values())}
    assert all(r.counters == {} for r in records[1:])
    for k in want:
        assert torch.equal(out[k], want[k]), k
    assert trace.take() == []
