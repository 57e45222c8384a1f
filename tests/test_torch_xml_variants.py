"""The XML variants of the port against the JAX model on the same flax
parameters (tests/_xml_pairs.py): CNN encoders, single-stream ``ctx_mode``,
the "w/o merge", "w/o cross-att" and "w/o modular" ablations, the
``cat_linear`` and stacked ConvSE span heads (mirroring tests/test_xml.py
and tests/test_config_variants.py); then the engine end to end on a tiny
corpus for a configuration without the merged head (the JAX engine's
second branch, span top-k "grouped" and, through B6's plain version,
"grouped_shift_psort") and one with it (stacked ConvSE); then the two CLIs
on a GRU subtitle-only run (its cache holds no video stream) and with
each variant flag. The LSTM and GRU encoder variants of the XML
are held against the JAX model in tests/test_torch_rnn.py, beside the
other compiles of the JAX scan-RNN.

Tolerance: 2e-4 on every float output, the bound the JAX package meets
against the original torch model (tests/test_xml.py:426); the engine's
selections (video indices, span videos, starts and ends, in order) must be
equal, its scores within 2e-4 relative."""
import argparse
import functools
import json
import os

import numpy as np
import pytest
import torch

from _xml_pairs import (
    SIZES,
    assert_outputs_close,
    flax_params,
    jax_outputs,
    make_batch,
    port_model,
    port_outputs,
)
from tvretrieval_tpu.data.datasets import ExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world
from tvretrieval_tpu.models import xml as jx
from tvretrieval_tpu.retrieval import engine as je
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.retrieval import engine as te
from tvretrieval_tpu_torch.retrieval import inference_xml
from tvretrieval_tpu_torch.training import train_xml
from tvretrieval_tpu_torch.training.checkpoint import load_checkpoint
from tvretrieval_tpu_torch.utils.logging import MetricsLogger

TOL = dict(rtol=2e-4, atol=2e-4)
ONE_STREAM = dict(cross_att=False, merge_two_stream=False)   # as train_xml sets them
VARIANTS = {
    "cnn": dict(encoder_type="cnn"),
    "video": dict(ctx_mode="video", **ONE_STREAM),
    "sub": dict(ctx_mode="sub", **ONE_STREAM),
    "no_merge": dict(merge_two_stream=False),
    "no_cross_att": dict(cross_att=False),
    "cat_linear": dict(span_predictor_type="cat_linear", merge_two_stream=False),
    "stack_conv": dict(stack_conv_predictor_conv_kernel_sizes=(3, 5)),
    "no_modular": dict(no_modular=True),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(name):
    kw = dict(SIZES, **VARIANTS[name])
    batch = make_batch()
    params = flax_params(jx.XMLConfig(**kw), batch)
    want = jax_outputs(jx.XMLConfig(**kw), params, batch)
    model = port_model(kw, params)
    got = port_outputs(model, batch)
    assert_outputs_close(got, want, **TOL)
    if name == "no_modular":                   # one max-pooled vector for both streams
        vq, sq = model.encode_query(torch.from_numpy(batch["query_feat"]),
                                    torch.from_numpy(batch["query_mask"]))
        assert torch.equal(vq, sq)
    if name in ("video", "sub"):               # the other stream is not built
        assert not any(k.startswith("sub_" if name == "video" else "video_")
                       for k in model.state_dict())


def test_cat_linear_with_merge_uses_the_per_stream_heads():
    """The JAX model takes its merged branch for cat_linear with two
    merged streams and fails there: it builds no merged head for
    cat_linear. The port runs the per-stream heads that are built, which
    are the same parameters as without the merge."""
    kw = dict(SIZES, span_predictor_type="cat_linear", merge_two_stream=False)
    batch = make_batch()
    params = flax_params(jx.XMLConfig(**kw), batch)
    a = port_outputs(port_model(kw, params), batch)
    b = port_outputs(port_model(dict(kw, merge_two_stream=True), params), batch)
    for k in ("loss", "pred.True"):
        for x, y in zip(np.atleast_1d(a[k]) if k == "loss" else a[k],
                        np.atleast_1d(b[k]) if k == "loss" else b[k]):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def world():
    w = make_synthetic_world(n_videos=20, n_queries=12, vid_dim=16, text_dim=12,
                             max_clips=SIZES["max_ctx_l"], seed=7)
    builder = ExampleBuilder(
        query_source=w.query_source, video_source=w.video_source, sub_source=w.sub_source,
        ctx_mode="video_sub_tef", max_desc_l=SIZES["max_desc_l"],
        max_ctx_l=SIZES["max_ctx_l"], clip_length=w.clip_length)
    return w, builder


COMMON = dict(max_vcmr_video=9, max_before_nms=40, min_pred_l=1, max_pred_l=6,
              context_bsz=8, query_bsz=5)


def _engine_pair(world, variant, **modes):
    w, builder = world
    kw = dict(SIZES, **variant, query_input_size=builder.query_source.dim)
    batch = {k: np.asarray(v) for k, v in
             builder.build_train_batch(w.annotations[:4]).model_inputs().items()}
    params = flax_params(jx.XMLConfig(**kw), batch)
    jcfg = je.RetrievalConfig(**COMMON)
    jcache = je.encode_corpus(jx.XML(jx.XMLConfig(**kw)), {"params": params}, builder,
                              w.corpus, jcfg)
    want = je.retrieve(jx.XML(jx.XMLConfig(**kw)), {"params": params}, builder, jcache,
                       w.annotations, w.corpus, jcfg, return_arrays=True)
    model = port_model(kw, params)
    got = {}
    for name, mode in modes.items():
        tcfg = te.RetrievalConfig(**COMMON, **mode)
        tcache = te.encode_corpus(model, builder, w.corpus, tcfg)
        got[name] = (tcache, te.retrieve(model, builder, tcache, w.annotations, w.corpus,
                                         tcfg, return_arrays=True))
    return jcache, want, got


def _assert_same_selections(want, got):
    assert set(want) == set(got) == {"VCMR", "SVMR", "VR"}
    for task in want:
        wv, wspans, wscores = (np.asarray(x) for x in want[task])
        gv, gspans, gscores = got[task]
        np.testing.assert_array_equal(gv, wv, err_msg=task)
        np.testing.assert_array_equal(gspans, wspans, err_msg=task)
        np.testing.assert_allclose(gscores, wscores, rtol=2e-4, atol=0, err_msg=task)


def test_engine_without_merged_head_matches_jax(world):
    """"w/o merge": the JAX engine's second branch. The port's grouped and
    grouped_shift_psort runs (B6's plain version on the CPU) both equal
    the JAX grouped run; the JAX package holds its psort mode bit-equal
    to grouped (tests/test_pallas_sort.py). The caches keep both streams'
    feat1 and feat2, unflattened, whatever the span score mode."""
    _build.reset_launch_counts()
    jcache, want, got = _engine_pair(
        world, dict(merge_two_stream=False),
        grouped=dict(span_topk_mode="grouped"),
        psort=dict(span_topk_mode="grouped_shift_psort", span_score_mode="simsweep_cat",
                   video_score_mode="pallas_int8"))
    for name, (tcache, arrays) in got.items():
        assert tcache.feat2_cat is None and tcache.video_feat1.dim() == 3, name
        np.testing.assert_allclose(tcache.video_feat2.numpy(), np.asarray(jcache.video_feat2),
                                   rtol=0, atol=1e-5)
        _assert_same_selections(want, arrays)
    assert all(v == 0 for v in _build.LAUNCHES.values())          # CPU: plain only


def test_engine_stacked_conv_matches_jax(world):
    """The stacked ConvSE on the fast path: every span mode's conv goes
    through the stacked head."""
    _, want, got = _engine_pair(world, dict(stack_conv_predictor_conv_kernel_sizes=(3, 5)),
                                gather=dict(span_topk_mode="grouped"),
                                cat=dict(span_topk_mode="grouped_shift",
                                         span_score_mode="simsweep_cat"))
    for _, arrays in got.values():
        _assert_same_selections(want, arrays)


# --------------------------------------------------------------------- CLIs
TINY = ["--synthetic", "--synthetic_videos", "12", "--synthetic_queries", "64",
        "--synthetic_vid_dim", "16", "--synthetic_text_dim", "12", "--synthetic_max_clips", "8",
        "--max_ctx_l", "8", "--max_desc_l", "12", "--bsz", "16", "--hidden_size", "16",
        "--n_heads", "2", "--eval_query_bsz", "8", "--eval_context_bsz", "8",
        "--max_vcmr_video", "6", "--min_pred_l", "1", "--max_pred_l", "6"]


@pytest.fixture
def no_tensorboard(monkeypatch):
    """jsonl metrics only: importing TensorBoard costs seconds, and no test
    here reads it."""
    monkeypatch.setattr(train_xml, "MetricsLogger",
                        functools.partial(MetricsLogger, use_tensorboard=False))


def test_cli_trains_and_infers_a_gru_subtitle_only_model(tmp_path, no_tensorboard):
    res = train_xml.start_training(TINY + [
        "--device", "cpu", "--n_epoch", "1", "--ctx_mode", "sub_tef", "--encoder_type", "gru",
        "--results_root", str(tmp_path), "--exp_id", "gru_sub"])
    out = inference_xml.start_inference(["--model_dir", res["results_dir"], "--device", "cpu",
                                         "--eval_id", "again"])
    assert out["metrics"] == res["final_metrics"]
    sub = out["files"][0]
    assert os.path.basename(sub) == "inference_tvr_val_again_predictions.json"
    with open(sub) as f:
        preds = json.load(f)
    assert {"VCMR", "SVMR", "VR", "video2idx"} <= set(preds)
    assert all(len(e["predictions"]) > 0 for e in preds["VCMR"])
    # the subtitle-only cache holds no video stream, as the JAX engine's
    with open(os.path.join(res["results_dir"], "opt.json")) as f:
        args = argparse.Namespace(**json.load(f))
    _, _, builder, corpus = train_xml.setup_world(args)
    params, _, cfg_dict, _ = load_checkpoint(os.path.join(res["results_dir"], "ckpt"))
    model = XML(XMLConfig(**cfg_dict)).eval()
    model.load_state_dict(params, strict=True)
    cache = te.encode_corpus(model, builder, corpus, train_xml.retrieval_config(args, 12))
    assert cache.video_feat1 is None and cache.video_feat2 is None
    assert cache.sub_feat1.shape == (12, 8, 16) and cache.sub_feat2.shape == (12, 8, 16)


@pytest.mark.parametrize("flags", [
    ["--encoder_type", "cnn", "--no_modular"],
    ["--no_merge_two_stream", "--span_predictor_type", "cat_linear",
     "--span_topk_mode", "grouped_shift_approx"],
    ["--no_cross_att", "--stack_conv_predictor_conv_kernel_sizes", "3", "5",
     "--compute_dtype", "bfloat16", "--device_data"],
    ["--ctx_mode", "video_tef", "--encoder_type", "lstm", "--add_pe_rnn", "--device_data"],
])
def test_cli_accepts_every_variant_flag(tmp_path, no_tensorboard, flags):
    """Each variant flag of the JAX CLI trains an epoch, a one-stream
    model and a bf16 one on the resident corpus too, and its run directory
    reads back into inference_xml with its compute dtype."""
    res = train_xml.start_training(TINY + ["--device", "cpu", "--n_epoch", "1",
                                           "--results_root", str(tmp_path)] + flags)
    out = inference_xml.start_inference(["--model_dir", res["results_dir"], "--device", "cpu"])
    assert {"VCMR", "SVMR", "VR"} <= set(out["metrics"])
    if "--device_data" not in flags:       # the resident corpus stores float8 features
        assert out["metrics"] == res["final_metrics"]
    cfg = load_checkpoint(os.path.join(res["results_dir"], "ckpt"))[2]
    assert cfg["dtype_str"] == ("bfloat16" if "bfloat16" in flags else "float32")
