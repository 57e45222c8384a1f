"""The port's baseline CLIs end to end on ``--device cpu`` (as
tests/test_baseline_e2e.py runs the JAX ones): train_mee, train_cal (CAL
and MCN, the warm start), train_excl, then inference_baselines on each run
directory, whose metrics equal the ones the run computed from the same
checkpoint; the CAL proposal cache written and read back; ExCL's VCMR over
MEE's VR submission; NMS. Without a card and without ``--device cpu``
every CLI exits with one line, and each takes the JAX CLI's flags plus
``--device`` only."""
import json
import os
import sys

import pytest
import torch

from _baseline_pairs import one_torch_thread  # noqa: F401
from tvretrieval_tpu_torch.retrieval import inference_baselines
from tvretrieval_tpu_torch.training import train_cal, train_excl, train_mee

WORLD = ["--synthetic", "--device", "cpu", "--synthetic_videos", "10",
         "--synthetic_queries", "48", "--seed", "3"]
MEE = ["--n_epoch", "12", "--bsz", "16", "--output_size", "16", "--eval_query_bsz", "12",
       "--eval_ctx_bsz", "10", "--lr", "1e-3"]
CAL = ["--n_epoch", "3", "--bsz", "12", "--visual_hidden_size", "16", "--output_size", "8",
       "--lstm_hidden_size", "12", "--max_ctx_l", "24", "--max_desc_l", "20",
       "--max_moment_clips", "8", "--eval_query_bsz", "9", "--lr", "0.02"]
EXCL = ["--n_epoch", "3", "--bsz", "12", "--hidden_size", "16", "--max_ctx_l", "24",
        "--max_desc_l", "20", "--eval_query_bsz", "9", "--min_pred_l", "1",
        "--max_pred_l", "10", "--drop", "0.2"]


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    """The CLIs' MetricsLogger writes its jsonl alone when TensorBoard
    cannot be imported (utils/logging.py). Importing it pulls in
    TensorFlow, 12 s on an idle core and minutes beside the other test
    workers, and these tests read no TensorBoard file."""
    name = "torch.utils.tensorboard"
    saved = sys.modules.get(name)
    sys.modules[name] = None                 # the import raises ImportError
    yield
    if saved is None:
        del sys.modules[name]
    else:
        sys.modules[name] = saved


def _infer(model_type, run_dir, *flags):
    return inference_baselines.start_inference(
        ["--model_type", model_type, "--model_dir", run_dir, "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def mee_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mee"))
    return train_mee.start_training(WORLD + MEE + ["--exp_id", "t", "--results_root", root])


def test_mee_cli_round_trip(mee_run):
    best = mee_run["best_metrics"]
    assert best is not None and best["VR"]["r10"] > 0
    assert os.path.exists(os.path.join(mee_run["results_dir"], "best_predictions.json"))
    res = _infer("mee", mee_run["results_dir"], "--nms_thd", "0.5")
    assert res["metrics"]["VR"] == best["VR"]
    # VR predictions carry no spans: NMS keeps them
    assert res["metrics_nms"] is not None
    state = torch.load(os.path.join(mee_run["results_dir"], "ckpt", "state"),
                       weights_only=True)["params"]
    assert any(k.endswith("bn.running_var") for k in state)


@pytest.mark.parametrize("model_type", ["cal", "mcn"])
def test_cal_cli_round_trip(tmp_path, model_type):
    out = train_cal.start_training(WORLD + CAL + ["--exp_id", "t", "--model_type", model_type,
                                                  "--results_root", str(tmp_path)])
    best = out["best_metrics"]
    assert best is not None and {"VCMR", "SVMR"} <= set(best)
    cache = str(tmp_path / "props.npz")
    res = _infer(model_type, out["results_dir"], "--proposal_cache_path", cache,
                 "--nms_thd", "0.5")
    assert os.path.exists(cache)
    for task in ("VCMR", "SVMR"):
        assert res["metrics"][task] == best[task]
    again = _infer(model_type, out["results_dir"], "--proposal_cache_path", cache)
    assert again["metrics"]["VCMR"] == res["metrics"]["VCMR"]
    assert res["metrics_nms"]["VCMR"]["0.5-r100"] >= 0
    if model_type == "cal":       # the re-train recipe: a warm start from the run
        out2 = train_cal.start_training(
            WORLD + CAL + ["--exp_id", "t2", "--results_root", str(tmp_path), "--n_epoch", "1",
                           "--init_ckpt_path", os.path.join(out["results_dir"], "ckpt")])
        assert out2["best_metrics"] is not None


def test_excl_cli_round_trip(tmp_path, mee_run):
    vr = os.path.join(mee_run["results_dir"], "best_predictions.json")
    out = train_excl.start_training(WORLD + EXCL + ["--exp_id", "t", "--results_root",
                                                    str(tmp_path),
                                                    "--external_inference_vr_res_path", vr])
    best = out["best_metrics"]
    assert best is not None and best["SVMR"]["0.5-r100"] > 0
    with open(os.path.join(out["results_dir"], "vcmr_external_predictions_metrics.json")) as f:
        assert "VCMR" in json.load(f)
    res = _infer("excl", out["results_dir"], "--external_inference_vr_res_path", vr,
                 "--nms_thd", "0.5")
    assert res["metrics"]["SVMR"] == best["SVMR"]
    assert {"SVMR", "VCMR"} <= set(res["metrics"]) and "VCMR" in res["metrics_nms"]


@pytest.mark.parametrize("cli", ["train_mee", "train_cal", "train_excl", "inference"])
def test_needs_a_card_or_device_cpu(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    call = {"train_mee": train_mee.start_training, "train_cal": train_cal.start_training,
            "train_excl": train_excl.start_training,
            "inference": inference_baselines.start_inference}[cli]
    argv = (["--model_type", "mee", "--model_dir", str(tmp_path)] if cli == "inference"
            else ["--synthetic", "--results_root", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        call(argv)
    msg = str(exc.value.code)
    assert exc.value.code not in (0, None) and "--device cpu" in msg and "\n" not in msg
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name", ["train_mee", "train_cal", "train_excl",
                                  "inference_baselines"])
def test_arg_parsers_keep_the_jax_flags(name):
    import importlib
    pkg = "retrieval" if name.startswith("inference") else "training"
    jp = importlib.import_module(f"tvretrieval_tpu.{pkg}.{name}").build_arg_parser()
    tp = importlib.import_module(f"tvretrieval_tpu_torch.{pkg}.{name}").build_arg_parser()
    ja = {a.dest: (a.default, a.choices) for a in jp._actions}
    ta = {a.dest: (a.default, a.choices) for a in tp._actions}
    assert ta.pop("device") == ("cuda", ["cuda", "cpu"])
    assert ta == ja
