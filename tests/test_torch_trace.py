"""The port's tracer (``utils/trace.py``) and the engine's spans.

- Without a profiler nothing is recorded and ``take()`` is empty.
- Under ``torch.profiler`` spans nest: parent indices, call ids, host
  times and counters as opened; ``take()`` clears the buffer.
- With a stand-in event clock off the card: a span opened right after its
  sibling closed starts at the sibling's exit event (12 events for the
  engine's 9 spans), and the device times are read from the call's first
  event.
- A ``_score_query_batch`` call on a toy corpus, in the retrieval modes of
  the benchmark's two deployments (*shipped*: int8 video scores, bf16
  sweep, approximate selections; *int8 exact*: int8 video scores and span
  sweep, exact selections), is one root span with the stages inside in
  order; its ``out_bytes`` is the outputs' bytes and no other span counts
  (*int8 exact*'s span sweep also over its flat cache at 128 rows a
  video, with outputs equal to those at flat_lp(L)); the outputs are
  bit-equal with and without the profiler.
- On a card (``cuda`` marker), each span's events lie inside its parent's
  and after its previous sibling's on the device clock (read from the
  call's first event), and each stage's device self time is at least 0.

Imports no JAX; on a machine with the card the last case runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_trace.py
"""
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import video_score as vs
from tvretrieval_tpu_torch.retrieval import engine as te
from tvretrieval_tpu_torch.utils import trace

MODEL = dict(visual_input_size=40, sub_input_size=24, query_input_size=48, hidden_size=32,
             n_heads=4, max_ctx_l=24, max_desc_l=12)
NV, NQ = 120, 10
COMMON = dict(max_vcmr_video=20, max_before_nms=30, cache_dtype_str="bfloat16",
              video_score_mode="pallas_int8", video_chunk_v=16)
MODES = {
    "shipped": dict(COMMON, span_score_mode="simsweep_cat_bf16", span_sim_pad_l=32,
                    span_topk_mode="grouped_shift_approx", video_topk_approx=True,
                    topk_approx_recall=0.9),
    "int8exact": dict(COMMON, span_score_mode="simsweep_cat_int8_flat",
                      span_topk_mode="grouped_shift_psort", video_topk_psort=True),
}
# one call's spans in the order they open, and each one's parent (an index
# relative to the root): the span head runs inside the sweep, then once more
# around the softmaxes
STAGES = ["score_query_batch", "encode_query", "video_scores", "video_topk", "span_sweep",
          "span_head", "span_head", "span_topk", "svmr"]
PARENTS = [None, 0, 0, 0, 0, 4, 0, 0, 0]


class _Names:
    def __init__(self, n):
        self.vid_names, self.durations = [f"v{i}" for i in range(n)], [36.0] * n

    def __len__(self):
        return len(self.vid_names)


def _engine(mode, device):
    """A seeded toy model, its corpus cache in ``mode`` and a call of the
    engine on a fresh query batch."""
    cfg = te.RetrievalConfig(**MODES[mode])
    model = XML(XMLConfig(**MODEL)).eval().init_weights(torch.Generator().manual_seed(0))
    model = model.to(device)
    g = torch.Generator().manual_seed(1)
    L, d = MODEL["max_ctx_l"], MODEL["hidden_size"]
    unit = lambda *s: torch.nn.functional.normalize(torch.randn(*s, generator=g), dim=-1)
    lengths = torch.randint(4, L + 1, (NV,), generator=g)
    bufs = {"vf1": unit(NV, L, d), "sf1": unit(NV, L, d),
            "feat2_cat": torch.randn(NV, L, 2 * d, generator=g),
            "mask": (torch.arange(L)[None] < lengths[:, None]).float()}
    bufs = {k: v.to(device, cfg.cache_dtype if k != "mask" else torch.float32)
            for k, v in bufs.items()}
    cache = te._finish_cache(model, cfg, _Names(NV), bufs)
    tok = torch.randint(3, MODEL["max_desc_l"] + 1, (NQ,), generator=g)
    q_mask = (torch.arange(MODEL["max_desc_l"])[None] < tok[:, None]).float()
    q_feat = torch.randn(NQ, MODEL["max_desc_l"], MODEL["query_input_size"], generator=g)
    q_feat, q_mask = (q_feat * q_mask[:, :, None]).to(device), q_mask.to(device)
    gt = torch.randint(0, NV, (NQ,), generator=g).to(device)

    def call():
        return te._score_query_batch(model, cfg, q_feat, q_mask, cache.video_feat1,
                                     cache.video_feat2, cache.sub_feat1, cache.sub_feat2,
                                     cache.mask, gt, True, feat2_cat=cache.feat2_cat,
                                     feat2_cat_scale=cache.feat2_cat_scale)
    return call


def _self_times(one, root, field):
    """Each span of one call (``one``, whose root has index ``root`` in
    ``take()``'s list) less its children, by ``field``."""
    dur = [field(r) for r in one]
    own = list(dur)
    for r, t in zip(one, dur):
        if r.parent is not None:
            own[r.parent - root] -= t
    return own


def test_nothing_is_recorded_without_a_profiler():
    trace.take()
    with trace.span("outer", torch.device("cpu")) as outer:
        with trace.span("inner") as inner:
            pass
    assert outer is None and inner is None
    assert trace.span("a") is trace.span("b")
    _engine("shipped", "cpu")()
    assert trace.take() == []


def test_nesting_parents_and_call_ids_under_the_profiler():
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a") as a:
            with trace.span("b"):
                with trace.span("c") as c:
                    c.count(rows=3)
                    c.count(rows=4, bytes=8)
            with trace.span("d"):
                pass
            a.count(out_bytes=16)
        with trace.span("e"):
            with trace.span("f"):
                pass
    records = trace.take()
    assert [r.name for r in records] == ["a", "b", "c", "d", "e", "f"]
    assert [r.parent for r in records] == [None, 0, 1, 0, None, 4]
    calls = [r.call for r in records]
    assert len(set(calls[:4])) == 1 and len(set(calls[4:])) == 1 and calls[0] != calls[4]
    assert records[0].counters == {"out_bytes": 16}
    assert records[2].counters == {"rows": 7, "bytes": 8}
    assert records[1].counters == {}
    for r in records:
        assert r.start_ns <= r.end_ns and r.device_ms is None
        if r.parent is not None:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert records[0].end_ns <= records[4].start_ns
    assert trace.take() == []


class _ClockEvent:
    """A stand-in for ``torch.cuda.Event`` off the card: each record reads
    a clock that ticks 1 ms a record; counts the events made."""
    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream):
        type(self).clock += 1.0
        self.t = type(self).clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_siblings_share_an_event_and_times_read_from_the_first(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _ClockEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(device_index=0))
    monkeypatch.setattr(_ClockEvent, "made", 0)

    def one():                              # the engine's spans, in its order
        with trace.span("score_query_batch", torch.device("cuda", 0)):
            for name in ("encode_query", "video_scores", "video_topk"):
                with trace.span(name):
                    pass
            with trace.span("span_sweep"):
                with trace.span("span_head"):
                    pass
            for name in ("span_head", "span_topk", "svmr"):
                with trace.span(name):
                    pass

    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        one()
        one()
    records = trace.take()
    assert [r.name for r in records] == STAGES * 2
    assert _ClockEvent.made == 24           # 12 a call: a stage opened after another shares
    # (device_start_ms, device_ms) on the clock: a tick a record
    want = [(0, 11), (1, 1), (2, 1), (3, 1), (4, 3), (5, 1), (7, 1), (8, 1), (9, 1)]
    for root in (0, len(STAGES)):
        got = [(r.device_start_ms, r.device_ms) for r in records[root:root + len(STAGES)]]
        assert got == want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_call_is_one_root_with_its_stages(mode):
    call = _engine(mode, "cpu")
    trace.take()
    want = call()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [call(), call()]
    records = trace.take()
    assert [r.name for r in records] == STAGES * 2
    roots = [i for i, r in enumerate(records) if r.parent is None]
    assert roots == [0, len(STAGES)]
    for root, out in zip(roots, outs):
        one = records[root:root + len(STAGES)]
        assert [None if r.parent is None else r.parent - root for r in one] == PARENTS
        assert len({r.call for r in one}) == 1
        assert one[0].counters == {"out_bytes": sum(v.nbytes for v in out.values())}
        assert all(r.counters == {} for r in one[1:])
        assert all(s >= 0 for s in _self_times(one, root, lambda r: r.end_ns - r.start_ns))
        assert set(out) == set(want)
        for k in want:
            assert out[k].dtype == want[k].dtype and torch.equal(out[k], want[k]), k
    assert records[0].call != records[len(STAGES)].call
    assert trace.take() == []


@pytest.mark.parametrize("lp_of", ["flat_lp", "jax_128"])
def test_span_sweep_counts_the_rows_b5_walks(lp_of):
    """*int8exact*'s cache built as the engine builds it (flat_lp(L) rows a
    video) and at the JAX package's 128: the span sweep B5 walks counts
    nothing, and the engine's outputs are equal in both layouts."""
    cfg = te.RetrievalConfig(**MODES["int8exact"])
    model = XML(XMLConfig(**MODEL)).eval().init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    nv, L, d = 40, MODEL["max_ctx_l"], MODEL["hidden_size"]
    unit = lambda *s: torch.nn.functional.normalize(torch.randn(*s, generator=g), dim=-1)
    bufs = {"vf1": unit(nv, L, d).bfloat16(), "sf1": unit(nv, L, d).bfloat16(),
            "feat2_cat": torch.randn(nv, L, 2 * d, generator=g).bfloat16(),
            "mask": (torch.arange(L)[None] < torch.randint(4, L + 1, (nv, 1), generator=g))
            .float()}
    cache = te._finish_cache(model, cfg, _Names(nv), dict(bufs))
    lp = 24                                               # flat_lp(24)
    assert cache.feat2_cat.shape == (48 * lp, 2 * d) and cache.feat2_cat_scale.shape == (48, lp)
    f8, fs = cache.feat2_cat, cache.feat2_cat_scale
    if lp_of == "jax_128":
        lp = 128
        f8, fs = vs.build_flat_feat2_i8(bufs["feat2_cat"], lp=lp)
    q_feat = torch.randn(6, MODEL["max_desc_l"], MODEL["query_input_size"], generator=g)
    q_mask = torch.ones(6, MODEL["max_desc_l"])
    gt = torch.arange(6)
    call = lambda f, s: te._score_query_batch(
        model, cfg, q_feat, q_mask, cache.video_feat1, None, cache.sub_feat1, None,
        cache.mask, gt, True, feat2_cat=f, feat2_cat_scale=s)
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = call(f8, fs)
    sweep = [r for r in trace.take() if r.name == "span_sweep"]
    assert len(sweep) == 1
    assert sweep[0].counters == {}
    ref = call(cache.feat2_cat, cache.feat2_cat_scale)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stage_device_times_nest_on_the_device_clock(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    call = _engine(mode, torch.device("cuda", 0))
    tol = 1e-3                                   # ms; an event's resolution is ~0.5 us

    call()
    torch.cuda.synchronize()
    trace.take()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(3):
            call()
    records = trace.take()
    assert [r.name for r in records] == STAGES * 3
    for root in range(0, len(records), len(STAGES)):
        one = records[root:root + len(STAGES)]
        assert one[0].device_start_ms == 0.0
        ends = [r.device_start_ms + r.device_ms for r in one]
        for i, r in enumerate(one):
            assert r.device_ms >= 0, (r.name, r.device_ms)
            if r.parent is None:
                continue
            p = r.parent - root
            # each span's events lie inside its parent's on the device
            assert one[p].device_start_ms - tol <= r.device_start_ms, (r.name, one[p].name)
            assert ends[i] <= ends[p] + tol, (r.name, one[p].name)
        # siblings follow one another on the stream, in the order they opened
        for i, r in enumerate(one):
            later = [j for j in range(i + 1, len(one)) if one[j].parent == r.parent]
            if r.parent is not None and later:
                assert ends[i] <= one[later[0]].device_start_ms + tol, (r.name, one[later[0]].name)
        assert all(s >= -tol for s in _self_times(one, root, lambda r: r.device_ms))
