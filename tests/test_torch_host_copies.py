"""The port's own copies of the numpy-only host modules (data, evaluation,
utils) against the JAX package's originals, on the same seeded inputs.
The copies share no state with the originals, so equality is exact."""
import numpy as np
import pytest
import torch

from tvretrieval_tpu.data import datasets as jd
from tvretrieval_tpu.data import synthetic as jsyn
from tvretrieval_tpu.evaluation import metrics as jmet
from tvretrieval_tpu.evaluation import nms as jnms
from tvretrieval_tpu.evaluation import submission as jsub
from tvretrieval_tpu.training.early_stop import EarlyStopper as JEarlyStopper
from tvretrieval_tpu.utils import io as jio
from tvretrieval_tpu_torch.data import datasets as td
from tvretrieval_tpu_torch.data import synthetic as tsyn
from tvretrieval_tpu_torch.data.pipeline import BatchIterator, DevicePrefetcher
from tvretrieval_tpu_torch.evaluation import metrics as tmet
from tvretrieval_tpu_torch.evaluation import nms as tnms
from tvretrieval_tpu_torch.evaluation import submission as tsub
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.training.early_stop import EarlyStopper
from tvretrieval_tpu_torch.utils import io as tio

WORLD = dict(n_videos=14, n_queries=30, vid_dim=20, text_dim=12, query_dim=16,
             max_clips=12, seed=5)


def _builders():
    out = []
    for syn, d in ((jsyn, jd), (tsyn, td)):
        w = syn.make_synthetic_world(**WORLD)
        out.append((w, d.ExampleBuilder(
            query_source=w.query_source, video_source=w.video_source,
            sub_source=w.sub_source, ctx_mode="video_sub_tef", max_desc_l=10,
            max_ctx_l=12, clip_length=w.clip_length)))
    return out


def test_synthetic_world_identical():
    (jw, _), (tw, _) = _builders()
    assert jw.annotations == tw.annotations
    assert jw.corpus.vid_names == tw.corpus.vid_names
    assert jw.corpus.durations == tw.corpus.durations
    assert jw.corpus.video2idx == tw.corpus.video2idx
    assert jw.clip_length == tw.clip_length
    for src in ("video_source", "sub_source", "query_source"):
        a, b = getattr(jw, src), getattr(tw, src)
        assert list(a.keys()) == list(b.keys()) and a.dim == b.dim
        for key in a.keys():
            np.testing.assert_array_equal(a.get(key), b.get(key))


@pytest.mark.parametrize("what", ["train_batch", "contexts", "queries", "context_batch",
                                  "prebuilt"])
def test_example_builder_bit_equal(what):
    (jw, jb), (tw, tb) = _builders()
    rows = jw.annotations[3:11]
    names, durs = jw.corpus.vid_names[:9], jw.corpus.durations[:9]
    if what == "train_batch":
        a, b = jb.build_train_batch(rows).model_inputs(), tb.build_train_batch(rows).model_inputs()
        assert a.keys() == b.keys()
        pairs = [(a[k], b[k]) for k in a]
    elif what == "contexts":
        pairs = list(zip(jb.build_contexts(names, durs), tb.build_contexts(names, durs)))
    elif what == "queries":
        ids = [r["desc_id"] for r in rows]
        pairs = list(zip(jb.build_queries(ids), tb.build_queries(ids)))
    elif what == "context_batch":
        a, b = jb.build_context_batch(names, durs), tb.build_context_batch(names, durs)
        pairs = [(getattr(a, k), getattr(b, k))
                 for k in ("video_feat", "video_mask", "sub_feat", "sub_mask")]
    else:
        a = jd.PrebuiltExamples(jb, jw.annotations, eval_labels=False)
        b = td.PrebuiltExamples(tb, tw.annotations, eval_labels=False)
        a, b = a.batch_for_rows(rows).model_inputs(), b.batch_for_rows(rows).model_inputs()
        pairs = [(a[k], b[k]) for k in a]
    assert pairs
    for x, y in pairs:
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _predictions(rng, n_q, n_vid, top):
    vid = rng.integers(0, n_vid, size=(n_q, top))
    st = rng.uniform(0, 12, size=(n_q, top)).round(1)
    spans = np.stack([st, st + rng.uniform(1, 8, size=(n_q, top)).round(1)], axis=-1)
    return vid, spans, -np.sort(-rng.random((n_q, top)), axis=1)


def test_eval_retrieval_same_metrics():
    (jw, _), _ = _builders()
    rng = np.random.default_rng(2)
    rows = jw.annotations
    v2i = jw.corpus.video2idx
    vid, spans, scores = _predictions(rng, len(rows), len(v2i), 20)
    gt_vid = np.asarray([v2i[r["vid_name"]] for r in rows])
    vid[::3, 0] = gt_vid[::3]                       # plant some hits
    for qi in range(0, len(rows), 3):
        spans[qi, 0] = rows[qi]["ts"]
    kw = dict(vcmr=(vid, spans), svmr=(np.broadcast_to(gt_vid[:, None], vid.shape), spans),
              vr=vid)
    a = jmet.eval_retrieval_arrays(rows, v2i, **kw)
    b = tmet.eval_retrieval_arrays(rows, v2i, **kw)
    assert a == b and a["VCMR"]["0.7-r1"] > 0
    sub = {"video2idx": v2i}
    for task, v in (("VCMR", vid), ("SVMR", kw["svmr"][0]), ("VR", vid)):
        sub[task] = [{"desc_id": r["desc_id"], "desc": r["desc"], "predictions": [
            [int(v[qi, k]), float(spans[qi, k, 0]), float(spans[qi, k, 1]),
             float(scores[qi, k])] for k in range(vid.shape[1])]} for qi, r in enumerate(rows)]
    assert jmet.eval_retrieval(sub, rows) == tmet.eval_retrieval(sub, rows)
    assert jsub.submission_top_n(sub, 7) == tsub.submission_top_n(sub, 7)


def test_nms_same_kept_spans():
    rng = np.random.default_rng(3)
    for _ in range(5):
        n = int(rng.integers(5, 60))
        st = rng.integers(0, 200, n) / 4
        preds = np.stack([st, st + rng.integers(4, 80, n) / 4,
                          rng.permutation(n) / 64], axis=1).tolist()
        for thd in (0.3, 0.5, 0.7):
            a = jnms.temporal_nms(preds, thd, 10, use_native=False)
            b = tnms.temporal_nms(preds, thd, 10)
            assert a == b and 0 < len(a) <= 10
    # values exact in float32, so the original's optional native path agrees too
    entries = [{"desc_id": i, "desc": "", "predictions": [
        [int(rng.integers(0, 4)), float(s), float(s + 5), float(k / 64)]
        for k, s in enumerate(rng.integers(0, 120, 25) / 4)]} for i in range(4)]
    for task in ("SVMR", "VCMR"):
        a = jnms.POST_PROCESSING_NMS_FUNC[task](entries, nms_thd=0.5, max_before_nms=20,
                                                max_after_nms=8)
        b = tnms.POST_PROCESSING_NMS_FUNC[task](entries, nms_thd=0.5, max_before_nms=20,
                                                max_after_nms=8)
        assert a == b


def test_io_helpers_and_early_stopper(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    np.testing.assert_array_equal(jio.l2_normalize(x), tio.l2_normalize(x))
    obj = {"a": [1, 2.5, "x"], "b": {"c": None}}
    tio.save_json(obj, str(tmp_path / "t.json"), pretty=True)
    jio.save_json(obj, str(tmp_path / "j.json"), pretty=True)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tio.load_json(str(tmp_path / "j.json")) == obj
    tio.save_jsonl([obj, obj], str(tmp_path / "t.jsonl"))
    assert jio.load_jsonl(str(tmp_path / "t.jsonl")) == [obj, obj]
    tio.dump_pickle_throttled({"x": x}, str(tmp_path / "t.pkl"))
    import pickle
    with open(tmp_path / "t.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["x"], x)
    model = XML(XMLConfig(visual_input_size=8, sub_input_size=6, query_input_size=5,
                          hidden_size=8, n_heads=2, max_ctx_l=4, max_desc_l=3))
    assert tio.count_params(model) == sum(p.numel() for p in model.parameters()) > 0
    a, b = JEarlyStopper(max_es_cnt=2, min_delta=0.5, best=-1.0), \
        EarlyStopper(max_es_cnt=2, min_delta=0.5, best=-1.0)
    for score in (1.0, 1.2, 1.6, 1.7, 1.8, 1.9):
        assert a.update(score) == b.update(score)


def test_batch_iterator_and_prefetcher_order():
    rows = [{"i": i} for i in range(23)]
    it = BatchIterator(rows, 5, shuffle=True, drop_last=True, seed=3)
    first = [[r["i"] for r in b] for b in it]
    assert len(first) == len(it) == 4 and sorted(sum(first, [])) != sum(first, [])
    it2 = BatchIterator(rows, 5, shuffle=True, drop_last=True, seed=3)
    for workers in (1, 3):
        it2.epoch = 0
        got = list(DevicePrefetcher(it2, build_fn=lambda b: [r["i"] for r in b],
                                    put_fn=torch.tensor, n_workers=workers))
        assert [g.tolist() for g in got] == first
    tail = BatchIterator(rows, 5, shuffle=False, drop_last=False)
    assert [len(b) for b in tail] == [5, 5, 5, 5, 3]


# --------------------------------------------------------------------------
# the baselines' host modules: proposals, the proposal upper bound, the MEE
# and CAL example builders, late fusion
# --------------------------------------------------------------------------

from tvretrieval_tpu.data import proposal_upper_bound as jpub  # noqa: E402
from tvretrieval_tpu.data import proposals as jprop  # noqa: E402
from tvretrieval_tpu.data import retrieval_datasets as jrd  # noqa: E402
from tvretrieval_tpu.evaluation import fusion as jfus  # noqa: E402
from tvretrieval_tpu_torch.data import proposal_upper_bound as tpub  # noqa: E402
from tvretrieval_tpu_torch.data import proposals as tprop  # noqa: E402
from tvretrieval_tpu_torch.data import retrieval_datasets as trd  # noqa: E402
from tvretrieval_tpu_torch.evaluation import fusion as tfus  # noqa: E402


@pytest.mark.parametrize("dset", ["tvr", "didemo", "anet_cap", "charades_sta"])
def test_proposals_bit_equal(dset):
    assert jprop.PROPOSAL_CONFIGS == tprop.PROPOSAL_CONFIGS
    jp, tp = jprop.get_proposal_interface(dset), tprop.get_proposal_interface(dset)
    rng = np.random.default_rng(6)
    for dur in list(rng.uniform(1, 160, 12)) + [1.5, 150.0, 0.4]:
        a, b = jp(dur), tp(dur)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        for max_n in (5, 300):
            for x, y in zip(jprop.pad_proposals(a, max_n), tprop.pad_proposals(b, max_n)):
                np.testing.assert_array_equal(x, y)


def test_proposal_upper_bound_and_cli(tmp_path, capsys):
    (jw, _), _ = _builders()
    for dset in ("tvr", "charades_sta"):
        assert jpub.proposal_upper_bound(jw.annotations, dset) == \
            tpub.proposal_upper_bound(jw.annotations, dset)
    path = str(tmp_path / "eval.jsonl")
    tio.save_jsonl(jw.annotations, path)
    assert tpub.main(["--eval_path", path]) == jpub.main(["--eval_path", path])
    assert "upper_bound_recall_iou0.7" in capsys.readouterr().out


def _baseline_builders(kind, model_type="cal", ctx_mode="video_sub_tef", external=False):
    out = []
    for syn, rd in ((jsyn, jrd), (tsyn, trd)):
        w = syn.make_synthetic_world(**WORLD)
        if kind == "mee":
            out.append((w, rd.MEEExampleBuilder(
                query_source=w.query_source, video_source=w.video_source,
                sub_source=w.sub_source, ctx_mode=ctx_mode, max_desc_l=10, max_ctx_l=12)))
            continue
        vr = None
        if external:     # guided negatives: each query's top videos, its own among them
            vr = {r["desc_id"]: [(n, d) for n, d in zip(w.corpus.vid_names[i % 5:][:6],
                                                        w.corpus.durations[i % 5:][:6])]
                  for i, r in enumerate(w.annotations)}
        cfg = rd.CALBuilderConfig(ctx_mode=ctx_mode, model_type=model_type,
                                  clip_length=w.clip_length, max_desc_l=10, max_ctx_l=12,
                                  max_moment_clips=5)
        out.append((w, rd.CALExampleBuilder(cfg, w.query_source, w.video_source,
                                            w.sub_source, external_vr_top_videos=vr, seed=9)))
    return out


@pytest.mark.parametrize("ctx_mode", ["video_sub", "video", "sub"])
def test_mee_builder_bit_equal(ctx_mode):
    (jw, jb), (_, tb) = _baseline_builders("mee", ctx_mode=ctx_mode)
    rows, names = jw.annotations[2:9], jw.corpus.vid_names[3:11]
    for a, b in ((jb.build_train_batch(rows), tb.build_train_batch(rows)),
                 (jb.build_context_batch(names), tb.build_context_batch(names)),
                 (jb.build_query_batch(rows), tb.build_query_batch(rows))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("model_type,ctx_mode,external", [
    ("cal", "video_sub_tef", False), ("mcn", "video_sub_tef", False),
    ("cal", "tef", False), ("cal", "video_sub", True)])
def test_cal_builder_bit_equal(model_type, ctx_mode, external):
    """Three train batches in a row from the builders' own generators (the
    intra negatives' random spans, the inter negatives' videos or the
    exp-decay ranks of guided sampling), then the query batch and a video's
    proposal batch."""
    (jw, jb), (tw, tb) = _baseline_builders("cal", model_type, ctx_mode, external)
    for i in range(3):
        rows = jw.annotations[4 * i:4 * i + 6]
        a = jb.build_train_batch(rows, jw.annotations)
        b = tb.build_train_batch(rows, tw.annotations)
        assert a.keys() == b.keys() and len(a) == 11
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=(i, k))
    assert jb.rng.integers(1 << 30) == tb.rng.integers(1 << 30)
    qa, qb = jb.build_query_batch(jw.annotations[:5]), tb.build_query_batch(tw.annotations[:5])
    for k in qa:
        np.testing.assert_array_equal(qa[k], qb[k])
    name, dur = jw.corpus.vid_names[1], jw.corpus.durations[1]
    props = jprop.get_proposal_interface("tvr")(dur)
    for max_n in (len(props) + 3, 4):
        for x, y in zip(jb.build_proposal_batch(name, dur, props, max_n),
                        tb.build_proposal_batch(name, dur, props, max_n)):
            np.testing.assert_array_equal(x, y)
    if model_type == "mcn":
        assert tb.cfg.max_moment_clips == 1


def _vcmr(rng, rows, n_vid, top):
    return {"video2idx": {f"v{i}": i for i, _ in enumerate(range(n_vid))}, "VCMR": [
        {"desc_id": r["desc_id"], "desc": r["desc"], "predictions": [
            [int(rng.integers(0, n_vid)), float(s), float(s + 3), float(-k)]
            for k, s in enumerate(rng.integers(0, 8, top) * 1.5)]} for r in rows]}


def test_fusion_bit_equal_and_cli(tmp_path, capsys):
    """mix_predictions on two saved prediction files whose moments overlap
    in part (fewer survivors than max_after_nms: padded by repetition), and
    the CLI with ground truth."""
    (jw, _), _ = _builders()
    rows = jw.annotations[:10]
    rng = np.random.default_rng(8)
    a, b = _vcmr(rng, rows, 4, 30), _vcmr(rng, rows, 4, 40)
    paths = {n: str(tmp_path / f"{n}.json") for n in ("a", "b", "j", "t", "jc", "tc")}
    tio.save_json(a, paths["a"])
    tio.save_json(b, paths["b"])
    for n_after in (100, 7):
        want = jfus.mix_predictions(paths["a"], paths["b"], paths["j"], max_after_nms=n_after)
        got = tfus.mix_predictions(paths["a"], paths["b"], paths["t"], max_after_nms=n_after)
        assert want == got and any(0 < len(e["predictions"]) for e in got["VCMR"])
        assert open(paths["j"]).read() == open(paths["t"]).read()
    gt = str(tmp_path / "gt.jsonl")
    tio.save_jsonl([dict(r, vid_name=f"v{i % 4}") for i, r in enumerate(rows)], gt)
    for mod, out in ((jfus, paths["jc"]), (tfus, paths["tc"])):
        mod.main(["--pred_path", paths["a"], "--rerank_pred_path", paths["b"],
                  "--save_path", out, "--gt_path", gt])
    assert open(paths["jc"]).read() == open(paths["tc"]).read()
    assert tio.load_json(paths["jc"].replace(".json", "_metrics.json")) == \
        tio.load_json(paths["tc"].replace(".json", "_metrics.json"))
    capsys.readouterr()
