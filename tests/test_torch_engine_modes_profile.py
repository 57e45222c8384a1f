"""The stage-study entry point of the port
(tvretrieval_tpu_torch.profiling.engine_modes) on the CPU at a tiny size,
against the JAX engine.

The JAX model's weights are converted into the port, and one numpy-made
query batch and corpus cache set goes through ``engine_modes.run`` (the
kernels' plain versions) and, combination by combination, through the JAX
engine's ``_score_query_batch`` with the layouts the JAX file builds (its
Pallas kernels in interpret mode). Held: the span candidates of every exact
combination equal to the JAX engine's wherever the JAX scores are not
near-ties, scores within the f32 tolerances of tests/test_torch_engine.py;
combinations that share their stages equal to the reference combination
bit for bit; the six stage-study lines present, with the agreement each
reports, B9 and B10 on planted masked videos; the approximate flags
running (equal to the exact combinations at this size); no card and no ``--device cpu``
exiting 1 with one line.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.ops import pallas_score as jps
from tvretrieval_tpu.retrieval import engine as je
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.profiling import engine_modes
from tvretrieval_tpu_torch.testing import rank_mismatches, within

NV, NQ, H, L = 24, 6, 32, 100
KW = dict(ctx_mode="video_sub", visual_input_size=3074, sub_input_size=770,
          query_input_size=768, hidden_size=H, n_heads=4, max_ctx_l=L, max_desc_l=30)
SPAN_RTOL = 1e-3 + np.expm1(20.0 * 2e-5)      # f32 encoders, then exp(alpha * q2c)
EXACT = ["gather/einsum", "gather/einsum/grouped_shift", "simsweep/pallas",
         "simsweep_cat/pallas/grouped_shift/preexp",
         "simsweep_cat/pallas/grouped_shift_psort/vpsort/fused",
         "simsweep_cat/einsum/grouped_shift/pad128"]
ARGS = ["--device", "cpu", "--n_videos", str(NV), "--nq", str(NQ), "--hidden", str(H),
        "--iters", "1", "--warmup", "0"]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    unit = lambda x: x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
    data = dict(qf=f(NQ, 30, 768), qm=np.ones((NQ, 30), np.float32),
                vf1=unit(f(NV, L, H)), sf1=unit(f(NV, L, H)), vf2=f(NV, L, H),
                sf2=f(NV, L, H), mask=np.ones((NV, L), np.float32))
    jm = JXML(JXMLConfig(**KW))
    variables = jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)},
        query_feat=data["qf"][:2], query_mask=data["qm"][:2],
        video_feat=jnp.zeros((2, L, 3074)), video_mask=jnp.ones((2, L)),
        sub_feat=jnp.zeros((2, L, 770)), sub_mask=jnp.ones((2, L)),
        st_ed_indices=jnp.zeros((2, 2), jnp.int32), deterministic=True)
    tm = XML(XMLConfig(**KW)).eval()
    tm.load_state_dict(flax_params_to_state_dict(jax.device_get(variables["params"])),
                       strict=True)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tdata["gt"] = torch.zeros((NQ,), dtype=torch.long)
    return data, jm, variables, tm, tdata


def _jax_spans(setup, combo):
    """One combination through the JAX engine, as the JAX file runs it."""
    data, jm, variables, _, _ = setup
    parts = combo.split("/")
    flags = set(parts[3:])
    rcfg = je.RetrievalConfig(
        cache_dtype_str="float32", query_bsz=NQ, pallas_interpret=True, video_chunk_v=16,
        span_score_mode=parts[0], video_score_mode=parts[1],
        span_topk_mode=parts[2] if len(parts) > 2 else "grouped",
        video_topk_pre_exp="preexp" in flags, video_topk_fused="fused" in flags,
        video_topk_psort="vpsort" in flags, span_sim_pad_l=128 if "pad128" in flags else 0)
    d = {k: jnp.asarray(v) for k, v in data.items()}
    kw = {}
    if parts[0].startswith("simsweep_cat"):
        cat = jnp.concatenate([d["vf2"], d["sf2"]], axis=-1)
        if "pad128" in flags:
            cat = jnp.pad(cat, ((0, 0), (0, 128 - L), (0, 0)))
        kw = {"feat2_cat": cat}
    f1v, f1s = d["vf1"], d["sf1"]
    if parts[1] == "pallas":
        f1v = jps.build_flat_feat1(f1v, d["mask"], chunk_v=16)
        f1s = jps.build_flat_feat1(f1s, d["mask"], chunk_v=16)
    out = je._score_query_batch(jm, variables, rcfg, d["qf"], d["qm"], f1v, d["vf2"], f1s,
                                d["sf2"], d["mask"], jnp.zeros((NQ,), jnp.int32), True, **kw)
    return tuple(np.asarray(out[k]) for k in
                 ("vcmr_vid_local", "vcmr_st", "vcmr_ed", "vcmr_scores"))


@pytest.fixture(scope="module")
def records(setup):
    args = engine_modes.build_arg_parser().parse_args(ARGS + ["--modes"] + EXACT)
    return engine_modes.run(args, model=setup[3], data=setup[4])


@pytest.mark.parametrize("combo", EXACT)
def test_combo_candidates_equal_the_jax_engine(setup, records, combo):
    rec = next(r for r in records if r.get("combo") == combo)
    vid, st, ed, scores = rec["spans"]
    jvid, jst, jed, jscores = _jax_spans(setup, combo)
    assert scores.shape == jscores.shape == (NQ, 200)
    assert within(jscores, scores, rtol=SPAN_RTOL, atol=1e-12)
    key = lambda v, s, e: (v.astype(np.int64) * 1000 + s) * 1000 + e
    assert rank_mismatches(key(jvid, jst, jed), jscores, key(vid, st, ed),
                           rtol=2 * SPAN_RTOL) == 0
    assert rec["ms"] > 0 and rec["qps"] > 0


def test_combos_sharing_their_stages_are_bit_exact(records):
    combos = [r for r in records if r["kind"] == "combo"]
    assert [r["combo"] for r in combos] == EXACT
    assert combos[0]["exact"] == "ref"
    # the same gather and einsum stages, another exact span top-k
    assert combos[1]["exact"] == "bit-exact vs gather/einsum"
    for r in combos[2:]:        # other summation orders: exact or flagged, never silent
        assert r["exact"].endswith(" vs gather/einsum")
        assert r["exact"].split()[0] in ("bit-exact", "MISMATCH")


def test_stage_study_lines(records):
    study = [r for r in records if r["kind"] == "study"]
    assert [(r["kernel"], r["case"]) for r in study] == [
        ("video_scores_masked", "float32"),
        ("fused_video_scores_clip_major", "alpha=20"),
        ("fused_video_scores_clip_major", "alpha=None"),
        ("gathered_similarity", "float32"),
        ("banded_topk_spans_fused", "own"), ("banded_topk_spans_fused", "peaked")]
    assert engine_modes.launch_counts() == dict.fromkeys(engine_modes.STUDY_KERNELS, 0)
    for r in study:
        assert r["kernel_ms"] > 0 and r["stage_ms"] > 0 and "MISMATCH" not in r["agreement"]
    # on the CPU the kernel column runs the plain version: it agrees with the stage
    assert study[0]["max_abs_err"] <= 1e-6 and study[3]["max_rel_err"] <= 1e-6
    assert study[1]["max_err"] <= 1e-5 and study[2]["max_err"] <= 1e-6
    assert study[4]["equal"] and study[5]["equal"]
    assert study[4]["videos_share"] == study[5]["videos_share"] == 1.0
    assert study[4]["grouped_shift_ms"] > 0 and study[5]["grouped_shift_ms"] > 0


def test_stage_study_plants_masked_videos(setup, records):
    """B9 and B10 run their masked branch: the study's records carry one
    fully and one partly masked video, the fully masked one exactly -1e10
    (0.0 after exp) in kernel and stage; the caller's mask is untouched."""
    study = [r for r in records if r["kind"] == "study"][:3]
    for r in study:
        assert (r["planted_fully_masked"], r["planted_partly_masked"]) == (1, 1)
        assert r["masked_exact"] is True and "1 + 1 planted masked videos" in r["agreement"]
    mask = setup[4]["mask"]
    planted, (fully, partly) = engine_modes.plant_masked_videos(mask)
    assert (fully, partly) == ([NV - 1], [0]) and bool((mask == 1).all())
    assert float(planted[NV - 1].sum()) == 0 and float(planted[0].sum()) == L // 2
    assert bool((planted[1:NV - 1] == mask[1:NV - 1]).all())
    single, ids = engine_modes.plant_masked_videos(torch.ones((1, 5)))
    assert ids == ([0], []) and float(single.sum()) == 0


def test_main_prints_one_line_per_combo_and_study(capsys):
    """The defaults of the JAX file (bf16 caches, synthesized from the
    seed), with an int8 combination, which is no parity mode."""
    combos = ["simsweep_cat_bf16/pallas_int8/grouped_shift/pad128",
              "simsweep_cat_bf16/pallas_int8/grouped_shift_psort/pad128/vpsort",
              "simsweep_cat_int8_flat/pallas_int8/grouped_shift"]
    assert engine_modes.main(ARGS + ["--modes"] + combos) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 + 6
    assert lines[0].startswith(combos[0]) and lines[0].endswith("[ref]")
    assert lines[1].endswith(f"[bit-exact vs {combos[0]}]")      # a parity selection
    assert " vs " + combos[0] in lines[2] and "ms/batch" in lines[2] and "q/s" in lines[2]
    assert all(ln.startswith("study ") for ln in lines[3:])
    assert "bfloat16" in lines[3] and "all four outputs equal" in lines[-1]


def test_study_follows_combos_that_read_only_derived_layouts(setup):
    """The study reads the caches the combination did not, and the
    caller's dictionary comes back as it went in."""
    data = dict(setup[4])
    args = engine_modes.build_arg_parser().parse_args(
        ARGS + ["--modes", "simsweep_cat/pallas_int8/grouped_shift"])
    recs = engine_modes.run(args, model=setup[3], data=data)
    assert [r["kind"] for r in recs] == ["combo"] + ["study"] * 6
    assert data.keys() == setup[4].keys()
    assert all(data[k] is setup[4][k] for k in data)


def test_default_combos_are_the_jax_files():
    args = engine_modes.build_arg_parser().parse_args(ARGS)
    assert args.modes is None and args.chunk_v == 16
    assert [r["combo"] for r in engine_modes.run(args) if r["kind"] == "combo"] == [
        "gather/einsum", "gather/pallas", "simsweep/einsum", "simsweep/pallas"]
    d = engine_modes.build_arg_parser().parse_args([])
    assert (d.nq, d.n_videos, d.iters, d.warmup, d.hidden, d.device) == \
        (200, 21818, 8, 2, 256, "cuda")


@pytest.mark.parametrize("combo", ["gather/einsum/grouped/vapprox",
                                   "gather/einsum/grouped_shift_approx",
                                   "simsweep/pallas/grouped_shift/rt0.95"])
def test_approximate_flags_raise(combo):
    """They raised NotImplementedError (ROADMAP A11) until the approximate
    top-k was ported; now they run, and at 24 videos (every row no longer
    than its bins) equal the exact combination they follow."""
    exact = combo.replace("_approx", "").replace("/vapprox", "/preexp")
    exact = "/".join(f for f in exact.split("/") if not f.startswith("rt"))
    args = engine_modes.build_arg_parser().parse_args(ARGS + ["--modes", exact, combo])
    records = [r for r in engine_modes.run(args) if r["kind"] == "combo"]
    assert [r["exact"] for r in records] == ["ref", "bit-exact vs " + exact]
    cfg = engine_modes.combo_config(engine_modes.RetrievalConfig(), combo)
    assert cfg.video_topk_approx == ("vapprox" in combo)
    assert cfg.topk_approx_recall == (0.95 if "rt0.95" in combo else 0.99)


def test_combo_grammar():
    base = engine_modes.RetrievalConfig(cache_dtype_str="bfloat16")
    cfg = engine_modes.combo_config(
        base, "simsweep_cat_bf16/pallas_int8/grouped_shift_psort/pad128/vpsort/preexp/fused")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(dataclasses.replace(
        base, span_score_mode="simsweep_cat_bf16", video_score_mode="pallas_int8",
        span_topk_mode="grouped_shift_psort", span_sim_pad_l=128, video_topk_psort=True,
        video_topk_pre_exp=True, video_topk_fused=True))
    assert engine_modes.combo_config(base, "gather/einsum").span_topk_mode == "grouped"
    with pytest.raises(ValueError, match="unknown flags"):
        engine_modes.combo_config(base, "gather/einsum/grouped/pad64")
    with pytest.raises(ValueError, match="span/video"):
        engine_modes.combo_config(base, "gather")
    with pytest.raises(ValueError, match="span_score_mode"):
        engine_modes.combo_config(base, "sweep/einsum")
    args = engine_modes.build_arg_parser().parse_args(
        ARGS + ["--modes", "gather/einsum/grouped/pad128"])
    with pytest.raises(SystemExit, match="pad128 flag only valid"):
        engine_modes.run(args)


def test_without_a_card_and_without_device_cpu_it_exits_1_with_one_line():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "tvretrieval_tpu_torch.profiling.engine_modes", "--nq", "2"],
        capture_output=True, text=True)
    assert proc.returncode == 1 and proc.stdout == ""
    assert proc.stderr.strip().splitlines() == [
        "engine_modes: no CUDA device is available; pass --device cpu to run the plain "
        "versions on the CPU"]
