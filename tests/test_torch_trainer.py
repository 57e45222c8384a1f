"""The port's XML trainer (training/xml_trainer.py), its resident-corpus
engine entry points, checkpoints and the train_xml CLI.

Against the JAX trainer: the same initial weights (converted), the same
shuffles, no dropout, and the negative ranks the JAX trainer draws
(its key sequence, xml_trainer.py:188, folded by flax's ``make_rng``)
injected into the port; per-step losses then agree within 1e-4 over 6
optimizer steps. Inside the port: the device-resident path equals the
host path bit for bit under float32 storage."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from tvretrieval_tpu.data.datasets import ExampleBuilder as JExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world as j_make_world
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.training import xml_trainer as jt
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
from tvretrieval_tpu_torch.data.device_corpus import (
    ContextTable,
    QueryTable,
    build_device_data,
)
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.models.xml import XMLConfig
from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.retrieval import inference_xml
from tvretrieval_tpu_torch.retrieval.engine import (
    RetrievalConfig,
    encode_corpus,
    encode_corpus_resident,
    retrieve,
)
from tvretrieval_tpu_torch.training import train_xml
from tvretrieval_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from tvretrieval_tpu_torch.training.xml_trainer import TrainSettings, XMLTrainer

WORLD = dict(vid_dim=32, text_dim=16, max_clips=12)


def _world_and_builder(n_videos=12, n_queries=40, seed=0, make=make_synthetic_world,
                       cls=ExampleBuilder):
    w = make(n_videos=n_videos, n_queries=n_queries, seed=seed, **WORLD)
    return w, cls(query_source=w.query_source, video_source=w.video_source,
                  sub_source=w.sub_source, ctx_mode="video_sub_tef", max_desc_l=30,
                  max_ctx_l=12, clip_length=w.clip_length)


def _model_cfg(builder, cls=XMLConfig, **kw):
    return cls(ctx_mode="video_sub", merge_two_stream=True, cross_att=True,
               visual_input_size=builder.video_source.dim + 2,
               sub_input_size=builder.sub_source.dim + 2,
               query_input_size=builder.query_source.dim,
               hidden_size=32, n_heads=2, max_ctx_l=12, max_desc_l=30, **kw)


def test_six_steps_track_the_jax_trainer():
    no_drop = dict(input_drop=0.0, drop=0.0)
    skw = dict(n_epoch=2, bsz=8, seed=7, prefetch_workers=1, lr=1e-3,
               hard_negative_start_epoch=-1, lw_st_ed=0.05)
    jw, jb = _world_and_builder(n_queries=48, make=j_make_world, cls=JExampleBuilder)
    jtr = jt.XMLTrainer(_model_cfg(jb, JXMLConfig, **no_drop), jt.TrainSettings(**skw), jb,
                        jw.annotations)
    tw, tb = _world_and_builder(n_queries=48)
    ttr = XMLTrainer(_model_cfg(tb, **no_drop), TrainSettings(**skw), tb, tw.annotations,
                     device="cpu")
    ttr.model.load_state_dict(flax_params_to_state_dict(jax.device_get(jtr.params)),
                              strict=True)
    # the ranks of each step, from the JAX trainer's key sequence
    ranks, rng = [], jtr.rng
    for _ in range(6):
        _, k_neg, rng = jax.random.split(rng, 3)
        key = jtr.model.apply({"params": jtr.params}, rngs={"negatives": k_neg},
                              method=lambda m: m.make_rng("negatives"))
        k_ctx, k_q = jax.random.split(key)
        ranks.append(tuple(torch.from_numpy(np.array(jax.random.randint(k, (8,), 1, 8)))
                           for k in (k_ctx, k_q)))
    ttr.neg_ranks_fn = lambda step, bsz, upper: ranks[step]
    jl = jtr.train_epoch(0)
    tl = ttr.train_epoch(0)
    assert len(jtr.last_step_losses) == len(ttr.last_step_losses) == 6 == ttr.global_step
    for step, (a, b) in enumerate(zip(jtr.last_step_losses, ttr.last_step_losses)):
        for k in a:
            assert abs(float(a[k]) - b[k]) <= 1e-4, (step, k, float(a[k]), b[k])
    assert abs(jl["loss_overall"] - tl["loss_overall"]) <= 1e-4
    # and it moved: the last step's loss is not the first's
    assert ttr.last_step_losses[0]["loss_overall"] != ttr.last_step_losses[-1]["loss_overall"]
    want = flax_params_to_state_dict(jax.device_get(jtr.params))
    for k, p in ttr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("scan_steps", [1, 3, 4])
def test_device_path_equals_host_path_f32(scan_steps):
    """6 steps per epoch: scan_steps=4 leaves a tail of 2 chunks of one."""
    w, builder = _world_and_builder(n_queries=48)
    cfg = _model_cfg(builder)                                  # dropout on
    host = XMLTrainer(cfg, TrainSettings(n_epoch=2, bsz=8, seed=7, prefetch_workers=2),
                      builder, w.annotations, device="cpu")
    dd = build_device_data(builder, w.corpus, w.annotations, [], dtype_name="float32", device="cpu")
    dev = XMLTrainer(cfg, TrainSettings(n_epoch=2, bsz=8, seed=7, scan_steps=scan_steps,
                                        flush_every_steps=2),
                     builder, w.annotations, device_data=dd, device="cpu")
    _build.reset_launch_counts()
    for epoch in range(2):
        torch.manual_seed(100 + epoch)
        lh = host.train_epoch(epoch)
        torch.manual_seed(100 + epoch)
        ld = dev.train_epoch(epoch)
        assert ld["steps"] == dev.steps_per_epoch == 6
        assert host.last_step_losses == dev.last_step_losses
        assert lh["loss_overall"] == ld["loss_overall"]
    for (k, a), (_, b) in zip(host.model.named_parameters(), dev.model.named_parameters()):
        assert torch.equal(a, b), k
    assert _build.LAUNCHES["gather_byte_rows"] == 0           # CPU: the plain version


def test_device_epoch_checks_its_step_count():
    w, builder = _world_and_builder(n_queries=20)
    dd = build_device_data(builder, w.corpus, w.annotations, [], dtype_name="float32", device="cpu")
    tr = XMLTrainer(_model_cfg(builder), TrainSettings(n_epoch=1, bsz=8, scan_steps=2),
                    builder, w.annotations, device_data=dd, device="cpu")
    assert tr.train_epoch(0)["steps"] == 2
    tr.steps_per_epoch = 3                                     # more than the rows hold
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        tr.train_epoch(1)
    tr.steps_per_epoch, tr.s.debug_max_steps = 2, 1
    assert tr.train_epoch(2)["steps"] == 2                     # a chunk is not cut


def test_eval_loss_includes_remainder_and_paths_agree():
    w, builder = _world_and_builder(n_queries=40)
    train, evalr = w.annotations[:16], w.annotations[16:]      # 24 eval rows: 16 + 8
    dd = build_device_data(builder, w.corpus, train, evalr, dtype_name="float32", device="cpu")
    s = TrainSettings(n_epoch=1, bsz=16, seed=7, hard_negative_start_epoch=0, hard_pool_size=3)
    dev = XMLTrainer(_model_cfg(builder), s, builder, train, device_data=dd, device="cpu")
    host = XMLTrainer(_model_cfg(builder), s, builder, train, device="cpu")
    a, b = dev.eval_loss_epoch(evalr, 0), host.eval_loss_epoch(evalr, 0)
    assert a == b and np.isfinite(a["loss_overall"])
    first = host._eval_step(host._put(host._build(evalr[:16])), *host._schedule(0))
    rest = host._eval_step(host._put(host._build(evalr[16:])), *host._schedule(0))
    assert a["loss_overall"] == pytest.approx((first["loss_overall"] + rest["loss_overall"]) / 2)
    assert host.eval_loss_epoch([], 0) == {}
    assert not host.model.training


def test_trainer_options():
    w, builder = _world_and_builder(n_queries=16)
    # data-parallel training (A10b) needs a batch that splits and a process
    # group of that many ranks (tests/test_torch_ddp.py trains with one)
    with pytest.raises(ValueError, match="not divisible"):
        XMLTrainer(_model_cfg(builder), TrainSettings(bsz=8), builder, w.annotations,
                   device="cpu", n_devices=3)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        XMLTrainer(_model_cfg(builder), TrainSettings(bsz=8), builder, w.annotations,
                   device="cpu", n_devices=4)
    # bf16 compute was refused until A8; it now trains with float32 master weights
    bf16 = XMLTrainer(_model_cfg(builder, dtype_str="bfloat16"), TrainSettings(bsz=8),
                      builder, w.annotations, device="cpu")
    assert bf16.model.cfg.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.model.parameters())
    tr = XMLTrainer(_model_cfg(builder), TrainSettings(bsz=8, n_epoch=1, grad_clip=0.01,
                                                       train_span_start_epoch=1),
                    builder, w.annotations, device="cpu")
    assert tr._schedule(0) == (0.0, 8) and tr._schedule(1) == (0.01, 8)
    assert tr._schedule(25) == (0.01, 8)                       # min(1 + 20, bsz)
    before = [p.detach().clone() for p in tr.model.parameters()]
    out = tr.train_epoch(0)
    assert out["loss_st_ed"] == 0.0 and np.isfinite(out["loss_overall"])
    assert any(not torch.equal(a, p) for a, p in zip(before, tr.model.parameters()))


def test_prebuilt_examples_path_equals_builder_path(tmp_path):
    w, builder = _world_and_builder(n_queries=16)
    kw = dict(n_epoch=1, bsz=8, seed=3, prefetch_workers=1)
    plain = XMLTrainer(_model_cfg(builder), TrainSettings(**kw), builder, w.annotations,
                       device="cpu")
    for _ in range(2):                        # the second trainer loads the first's cache
        pre = XMLTrainer(_model_cfg(builder),
                         TrainSettings(prebuild_examples=True,
                                       prebuild_cache_dir=str(tmp_path), **kw),
                         builder, w.annotations, device="cpu")
    assert os.path.exists(tmp_path / "train_prebuilt.pkl")
    torch.manual_seed(0)
    a = plain.train_epoch(0)
    torch.manual_seed(0)
    b = pre.train_epoch(0)
    assert a["loss_overall"] == b["loss_overall"]
    assert pre.eval_loss_epoch(w.annotations[:5], 0) == plain.eval_loss_epoch(w.annotations[:5], 0)


def test_encode_corpus_resident_and_query_table_match():
    w, builder = _world_and_builder()
    tr = XMLTrainer(_model_cfg(builder), TrainSettings(n_epoch=1, bsz=8, seed=7), builder,
                    w.annotations, device="cpu")
    model = tr.model.eval()
    dd = build_device_data(builder, w.corpus, w.annotations, w.annotations,
                           dtype_name="float32", device="cpu")
    for mode in (dict(), dict(span_score_mode="simsweep_cat", span_topk_mode="grouped_shift",
                              video_score_mode="pallas_int8", span_sim_pad_l=16)):
        rcfg = RetrievalConfig(query_bsz=8, context_bsz=5, max_vcmr_video=4, **mode)
        ref = encode_corpus(model, builder, w.corpus, rcfg)
        out = encode_corpus_resident(model, dd, w.corpus, rcfg)        # 5 + 5 + overlap
        for name in ("video_feat1", "video_feat2", "sub_feat1", "sub_feat2", "mask",
                     "feat2_cat"):
            a, b = getattr(ref, name), getattr(out, name)
            assert (a is None) == (b is None), name
            if a is not None and a.dtype == torch.int8:
                assert (a.int() - b.int()).abs().max() <= 1, name
            elif a is not None:
                assert a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=name)
        assert out.metas == ref.metas and out.n_videos == ref.n_videos
    rcfg = RetrievalConfig(query_bsz=8, context_bsz=5, max_vcmr_video=4)
    cache = encode_corpus(model, builder, w.corpus, rcfg)
    ctx = ContextTable.build(builder, w.corpus, "float32")
    qt = QueryTable.build(builder, w.annotations, w.corpus, ctx.ctx_l, "float32")
    ref = retrieve(model, builder, cache, w.annotations, w.corpus, rcfg, return_arrays=True)
    out = retrieve(model, builder, cache, w.annotations, w.corpus, rcfg, return_arrays=True,
                   query_table=qt)
    for task in ref:
        for a, b in zip(ref[task], out[task]):
            np.testing.assert_array_equal(a, b, err_msg=task)
    with pytest.raises(ValueError, match="row-aligned"):
        retrieve(model, builder, cache, w.annotations[:3], w.corpus, rcfg, query_table=qt)


def test_checkpoint_round_trip(tmp_path):
    w, builder = _world_and_builder(n_queries=16)
    cfg = _model_cfg(builder)
    tr = XMLTrainer(cfg, TrainSettings(n_epoch=1, bsz=8), builder, w.annotations, device="cpu")
    tr.train_epoch(0)
    save_checkpoint(str(tmp_path / "ckpt"), tr.model.state_dict(), tr.optimizer.state_dict(),
                    cfg, 4)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["meta.json", "state"]
    params, opt_state, cfg_dict, epoch = load_checkpoint(str(tmp_path / "ckpt"))
    assert epoch == 4 and XMLConfig(**cfg_dict) == cfg
    assert params.keys() == tr.model.state_dict().keys()
    for k, v in tr.model.state_dict().items():
        assert torch.equal(params[k], v), k
    fresh = XMLTrainer(cfg, TrainSettings(n_epoch=1, bsz=8, seed=1), builder, w.annotations,
                       device="cpu")
    fresh.model.load_state_dict(params, strict=True)
    fresh.optimizer.load_state_dict(opt_state)
    assert fresh.optimizer.state["step"] == tr.optimizer.state["step"] == 2
    for a, b in zip(tr.model.parameters(), fresh.model.parameters()):
        assert torch.equal(tr.optimizer.state[a]["v"], fresh.optimizer.state[b]["v"])


TINY = ["--synthetic", "--synthetic_videos", "16", "--synthetic_queries", "96",
        "--synthetic_vid_dim", "32", "--synthetic_text_dim", "16", "--synthetic_max_clips", "12",
        "--max_ctx_l", "12", "--bsz", "16", "--hidden_size", "32", "--n_heads", "2",
        "--eval_query_bsz", "8", "--eval_context_bsz", "8", "--max_vcmr_video", "8"]


def test_start_training_learns_on_cpu(tmp_path, monkeypatch):
    """start_training itself, on the resident float8 corpus: the loss falls and
    the metrics rise from the untrained model's; it early-stops or ends,
    and its checkpoint reads back. The planted signal is scored on the
    queries it trained on (as tests/test_e2e.py scores the JAX trainer): a
    world this small does not carry over to held-out queries."""
    split = train_xml.setup_world

    def all_rows_both_ways(args):
        train, held_out, builder, corpus = split(args)
        return train + held_out, train + held_out, builder, corpus

    monkeypatch.setattr(train_xml, "setup_world", all_rows_both_ways)
    res = train_xml.start_training(TINY + [
        "--device", "cpu", "--device_data", "--scan_steps", "2", "--n_epoch", "8",
        "--lr", "1e-3", "--hard_negtiave_start_epoch", "4", "--eval_untrained",
        "--nms_thd", "0.5", "--results_root", str(tmp_path), "--exp_id", "learn"])
    rdir = res["results_dir"]
    log = [json.loads(line.split("] ", 1)[1]) for line in open(os.path.join(rdir, "eval.log.txt"))]
    untrained, best = log[0], res["best_metrics"]
    assert best["VCMR"]["0.5-r1"] >= untrained["VCMR"]["0.5-r1"] + 15.0
    assert best["VR"]["r1"] >= untrained["VR"]["r1"] + 30.0
    assert res["final_metrics"]["SVMR"]["0.5-r1"] > untrained["SVMR"]["0.5-r1"] + 10.0
    losses = [float(line.split("loss_overall ")[1].split()[0])
              for line in open(os.path.join(rdir, "train.log.txt"))]
    assert len(losses) >= 2 and losses[-1] < losses[0]
    for name in ("opt.json", "metrics.jsonl", "best_predictions.json",
                 "inference_predictions.json", "inference_predictions_nms_thd_0.5.json"):
        assert os.path.exists(os.path.join(rdir, name)), name
    params, opt_state, cfg_dict, epoch = load_checkpoint(os.path.join(rdir, "ckpt"))
    assert 0 <= epoch < 8 and opt_state["state"]["step"] == 6 * (epoch + 1)
    assert XMLConfig(**cfg_dict).hidden_size == 32 and "video_cross_ln.weight" in params
    # resume from it for one more epoch, on the host path
    res2 = train_xml.start_training(TINY + [
        "--device", "cpu", "--n_epoch", str(epoch + 2), "--resume", os.path.join(rdir, "ckpt"),
        "--results_root", str(tmp_path), "--exp_id", "resume"])
    assert res2["final_metrics"]["VR"]["r5"] > 0


def test_eval_context_batches_are_kept_on_disk(tmp_path, monkeypatch):
    """--prebuild_cache_dir keeps the host-built eval context batches in
    eval_ctx_batches.pkl, as the JAX train_xml does: the first run writes it
    after its first evaluation, a second run reads it and builds no context
    batch in its evaluations, and both runs evaluate alike."""
    cache_dir = tmp_path / "cache"
    built = {"eval": 0}
    build = ExampleBuilder.build_context_batch
    fast = train_xml.evaluate_retrieval_fast
    in_eval = []

    def counting_build(self, *a, **kw):
        built["eval"] += bool(in_eval)
        return build(self, *a, **kw)

    def counting_fast(*a, **kw):
        in_eval.append(1)
        try:
            return fast(*a, **kw)
        finally:
            in_eval.pop()

    monkeypatch.setattr(ExampleBuilder, "build_context_batch", counting_build)
    monkeypatch.setattr(train_xml, "evaluate_retrieval_fast", counting_fast)
    argv = TINY + ["--device", "cpu", "--n_epoch", "2", "--eval_untrained",
                   "--prebuild_cache_dir", str(cache_dir), "--results_root", str(tmp_path)]
    logs = []
    for run in ("first", "second"):
        built["eval"] = 0
        res = train_xml.start_training(argv + ["--exp_id", run])
        logs.append(open(os.path.join(res["results_dir"], "eval.log.txt")).read())
        assert (cache_dir / "eval_ctx_batches.pkl").exists()
        # 16 videos in context batches of 8: built once, then reused
        assert built["eval"] == (2 if run == "first" else 0), (run, built)
    assert logs[0] == logs[1] and logs[0].count("[epoch") == 3


def test_start_inference_reads_the_run_back(tmp_path):
    """The standalone inference CLI on a run directory of the trainer:
    same weights (one epoch, so the checkpoint is the final model), so the
    same metrics as the trainer's closing inference; eval flags override."""
    res = train_xml.start_training(TINY + [
        "--device", "cpu", "--n_epoch", "1", "--results_root", str(tmp_path), "--exp_id", "inf"])
    out = inference_xml.start_inference(["--model_dir", res["results_dir"], "--nms_thd", "0.5",
                                         "--device", "cpu"])
    assert out["metrics"] == res["final_metrics"] and out["metrics_nms"] is not None
    assert len(out["files"]) == 4 and all(os.path.exists(f) for f in out["files"])
    vr = inference_xml.start_inference(["--model_dir", res["results_dir"], "--tasks", "VR",
                                        "--span_score_mode", "simsweep_cat",
                                        "--span_topk_mode", "grouped_shift",
                                        "--eval_id", "vr_only", "--device", "cpu"])
    assert set(vr["metrics"]) >= {"VR"} and "VCMR" not in vr["metrics"]
    assert vr["metrics"]["VR"] == res["final_metrics"]["VR"]
    streamed = inference_xml.start_inference(["--model_dir", res["results_dir"],
                                              "--streaming", "flat", "--eval_id", "streamed",
                                              "--device", "cpu"])
    assert streamed["metrics"] == res["final_metrics"]       # the streaming engine
    approx = inference_xml.start_inference(["--model_dir", res["results_dir"],
                                            "--video_topk_approx", "1", "--eval_id", "approx",
                                            "--device", "cpu"])
    assert approx["metrics"]["VR"] == res["final_metrics"]["VR"]      # every row <= its bins
    psort = inference_xml.start_inference(["--model_dir", res["results_dir"],
                                           "--video_topk_psort", "1", "--eval_id", "psort",
                                           "--device", "cpu"])
    assert psort["metrics"] == res["final_metrics"]               # a parity mode
    if not torch.cuda.is_available():
        # the run trained with --device cpu; inference does not inherit that
        with pytest.raises(SystemExit) as exc:
            inference_xml.start_inference(["--model_dir", res["results_dir"]])
        assert "--device cpu" in str(exc.value.code)


def test_start_training_needs_a_card_or_device_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as exc:
        train_xml.start_training(TINY + ["--results_root", str(tmp_path)])
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)
    assert "\n" not in str(exc.value.code) and not os.listdir(tmp_path)


@pytest.mark.parametrize("flags,item", [
    (["--encoder_type", "lstm"], "A8"), (["--encoder_type", "cnn"], "A8"),
    (["--no_merge_two_stream"], "A8"), (["--no_modular"], "A8"), (["--no_cross_att"], "A8"),
    (["--span_predictor_type", "cat_linear"], "A8"), (["--ctx_mode", "video_tef"], "A8"),
    (["--compute_dtype", "bfloat16"], "A8"),
    (["--span_score_mode", "simsweep_cat_int8"], "A11"),
    (["--span_score_mode", "simsweep"], "A15"),
    (["--span_topk_mode", "grouped_shift_psort"], "A11"),
    (["--span_topk_mode", "grouped_shift_approx"], "A11"),
    (["--video_topk_approx", "1"], "A11"), (["--video_topk_psort", "1"], "A11"),
    (["--n_devices", "4"], "A10"),
])
def test_unported_flags_raise_before_any_data(tmp_path, monkeypatch, flags, item):
    """``item`` is the ROADMAP item each flag was queued under. The model
    variants (A8), the int8, psort and approximate engine modes,
    ``simsweep`` and data-parallel training (A10) have been ported since:
    their flags pass the check and the CLI goes on to build its data (with
    ``--n_devices``: to start the ranks that build it)."""
    class DataWasBuilt(Exception):
        pass

    def setup_world(*args):
        raise DataWasBuilt

    monkeypatch.setattr(train_xml, "setup_world", setup_world)
    monkeypatch.setattr(train_xml, "_spawn_ranks", setup_world)
    with pytest.raises(DataWasBuilt):
        train_xml.start_training(TINY + ["--device", "cpu", "--results_root", str(tmp_path)]
                                 + flags)


def test_arg_parser_keeps_the_reference_flags():
    from tvretrieval_tpu.training.train_xml import build_arg_parser as j_parser
    ja = {a.dest: a.default for a in j_parser()._actions}
    ta = {a.dest: a.default for a in train_xml.build_arg_parser()._actions}
    assert ta.pop("device") == "cuda"
    assert ta == ja and "hard_negtiave_start_epoch" in ta
