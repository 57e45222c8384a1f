"""The port's blocks and XML methods against the flax modules
(tvretrieval_tpu_torch.models vs tvretrieval_tpu.models), weights from
flax ``init`` (perturbed so LayerNorm scales and biases are not trivial)
through ``convert.flax_params_to_state_dict``. Tolerance: 2e-4, the bound
the JAX package meets against the original torch model
(tests/test_xml.py:426); both sides run float32 at full precision."""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.models import components as jc
from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.models.xml import cosine_video_scores as j_cosine
from tvretrieval_tpu.ops.masking import mask_logits as j_mask_logits
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models import components as tc
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig, cosine_video_scores
from tvretrieval_tpu_torch.ops.masking import mask_logits

TOL = dict(rtol=2e-4, atol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
        jax.device_get(params))


def _load(module, params):
    module.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return module.eval()


def _mask(rng, n, length):
    lengths = rng.integers(1, length + 1, size=n)
    lengths[0] = length
    return (np.arange(length)[None] < lengths[:, None]).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **TOL)


def test_mask_logits_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7)).astype(np.float32)
    m = _mask(rng, 3, 7)
    np.testing.assert_array_equal(np.asarray(j_mask_logits(x, m)),
                                  mask_logits(torch.from_numpy(x), torch.from_numpy(m)).numpy())


@pytest.mark.parametrize("layer_norm,relu", [(True, True), (False, False)])
def test_linear_layer(layer_norm, relu):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    jm = jc.LinearLayer(32, layer_norm, 0.1, relu)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 1)
    tm = _load(tc.LinearLayer(12, 32, layer_norm, 0.1, relu), p)
    _close(jm.apply({"params": p}, x), tm(torch.from_numpy(x)))


def test_positional_encoding():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    jm = jc.TrainablePositionalEncoding(16)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 2)
    tm = _load(tc.TrainablePositionalEncoding(16, 32), p)
    _close(jm.apply({"params": p}, x), tm(torch.from_numpy(x)))


@pytest.mark.parametrize("mask_kind", ["key", "cross"])
def test_self_attention(mask_kind):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 8, 32)).astype(np.float32)
    kv = rng.normal(size=(3, 11, 32)).astype(np.float32)
    if mask_kind == "key":
        mask = _mask(rng, 3, 11)                                   # (N, Lk)
    else:
        mask = np.einsum("bm,bn->bmn", _mask(rng, 3, 8), _mask(rng, 3, 11))
    jm = jc.BertSelfAttention(2)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), q, kv, kv, mask)["params"], 3)
    tm = _load(tc.BertSelfAttention(32, 2), p)
    t = torch.from_numpy
    _close(jm.apply({"params": p}, q, kv, kv, mask), tm(t(q), t(kv), t(kv), t(mask)))


def test_bert_attention_and_self_output():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 32)).astype(np.float32)
    mask = _mask(rng, 2, 10)
    jm = jc.BertAttention(2)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x, mask)["params"], 4)
    tm = _load(tc.BertAttention(32, 2), p)
    _close(jm.apply({"params": p}, x, mask), tm(torch.from_numpy(x), torch.from_numpy(mask)))

    h = rng.normal(size=(2, 10, 32)).astype(np.float32)
    jo = jc.BertSelfOutput()
    po = _perturbed(jo.init(jax.random.PRNGKey(1), h, x)["params"], 5)
    to = _load(tc.BertSelfOutput(32), po)
    _close(jo.apply({"params": po}, h, x), to(torch.from_numpy(h), torch.from_numpy(x)))


@pytest.mark.parametrize("k", [5, 4, 1])
def test_conv1d_same(k):
    """'SAME' zero padding, including an even kernel ((k-1)//2 left,
    k//2 right, as flax pads), over rows of any leading shape."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 13)).astype(np.float32)
    jm = jc.Conv1dSame(k)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 6)
    tm = _load(tc.Conv1dSame(k), p)
    _close(jm.apply({"params": p}, x), tm(torch.from_numpy(x)))


def test_init_like_flax_is_seeded():
    a = XML(XMLConfig(visual_input_size=18, sub_input_size=14, query_input_size=16,
                      hidden_size=32, n_heads=2, max_ctx_l=12, max_desc_l=8))
    b = XML(a.cfg)
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    conv = a.state_dict()["merged_st_predictor.conv.weight"]
    assert conv.abs().max() <= 1 / np.sqrt(5)
    assert torch.all(a.state_dict()["video_cross_ln.weight"] == 1)


# ------------------------------------------------------------------- XML
KW = dict(visual_input_size=18, sub_input_size=14, query_input_size=16,
          hidden_size=32, n_heads=2, max_ctx_l=12, max_desc_l=10)


@pytest.fixture(scope="module")
def xml_pair():
    rng = np.random.default_rng(7)
    B = 4
    batch = dict(
        query_feat=rng.normal(size=(B, 10, 16)).astype(np.float32),
        query_mask=_mask(rng, B, 10),
        video_feat=rng.normal(size=(B, 12, 18)).astype(np.float32),
        video_mask=_mask(rng, B, 12),
        sub_feat=rng.normal(size=(B, 12, 14)).astype(np.float32),
        st_ed_indices=np.zeros((B, 2), np.int32))
    batch["sub_mask"] = batch["video_mask"]
    jm = JXML(JXMLConfig(**KW))
    # jitted init: one compile instead of op-by-op dispatch of the whole
    # training forward
    v = jax.jit(lambda r, b: jm.init(r, **b, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)}, batch)
    p = _perturbed(v["params"], 8)
    tm = _load(XML(XMLConfig(**KW)), p)
    return jm, {"params": p}, tm, batch


def test_xml_encoders_match_flax(xml_pair):
    jm, v, tm, b = xml_pair
    t = torch.from_numpy
    jctx = jm.apply(v, b["video_feat"], b["video_mask"], b["sub_feat"], b["sub_mask"],
                    method=JXML.encode_context)
    tctx = tm.encode_context(t(b["video_feat"]), t(b["video_mask"]), t(b["sub_feat"]),
                             t(b["sub_mask"]))
    for a, c in zip(jctx, tctx):
        _close(a, c)
    jq = jm.apply(v, b["query_feat"], b["query_mask"], method=JXML.encode_query)
    tq = tm.encode_query(t(b["query_feat"]), t(b["query_mask"]))
    for a, c in zip(jq, tq):
        _close(a, c)


def test_xml_span_scores_match_flax(xml_pair):
    jm, v, tm, b = xml_pair
    t = torch.from_numpy
    vf1, vf2, sf1, sf2 = (np.array(x) for x in jm.apply(
        v, b["video_feat"], b["video_mask"], b["sub_feat"], b["sub_mask"],
        method=JXML.encode_context))
    vq, sq = (np.array(x) for x in jm.apply(v, b["query_feat"], b["query_mask"],
                                              method=JXML.encode_query))
    mask = b["video_mask"]
    with torch.no_grad():
        for cross in (True, False):
            js = jm.apply(v, vq, vf2, sq, sf2, mask, cross, method=JXML.merged_st_ed_scores)
            ts = tm.merged_st_ed_scores(t(vq), t(vf2), t(sq), t(sf2), t(mask), cross)
            for a, c in zip(js, ts):
                _close(a, c)
        _close(j_cosine(vq, vf1, mask), cosine_video_scores(t(vq), t(vf1), t(mask)))

        # corpus sweep over the concatenated cache, pad columns, row gather
        f2c = np.concatenate([vf2, sf2], axis=-1)
        f2c_pad = np.pad(f2c, ((0, 0), (0, 4), (0, 0)))
        gidx = np.array([[2, 0, 3], [1, 1, 0], [3, 2, 2], [0, 3, 1]], np.int32)
        for sim_dtype, tol in ((None, TOL), (jnp.bfloat16, dict(rtol=2e-2, atol=2e-2))):
            js = jm.apply(v, vq, sq, f2c_pad, mask, gidx, sim_dtype=sim_dtype,
                          method=JXML.merged_st_ed_scores_simgather_cat)
            ts = tm.merged_st_ed_scores_simgather_cat(
                t(vq), t(sq), t(f2c_pad), t(mask), t(gidx).long(),
                sim_dtype=None if sim_dtype is None else torch.bfloat16)
            for a, c in zip(js, ts):
                np.testing.assert_allclose(np.asarray(a), c.numpy(), **tol)


@pytest.mark.parametrize("field,value", [
    ("encoder_type", "cnn"), ("no_modular", True), ("cross_att", False),
    ("span_predictor_type", "cat_linear"), ("merge_two_stream", False),
    ("stack_conv_predictor_conv_kernel_sizes", (3, 5)), ("ctx_mode", "video"),
    ("dtype_str", "bfloat16")])
def test_unsupported_xml_config_raises(field, value):
    """Each of these values was refused until the variants were ported
    (ROADMAP A8); each now builds, takes the converted flax tree with
    ``strict=True`` and trains (tests/test_torch_xml_variants.py and
    tests/test_torch_xml_bf16.py hold them against the JAX model). What
    the port still refuses is what the JAX model refuses: an unknown
    encoder or span head, and cross-attention with one stream."""
    cfg = {**KW, field: value}
    if field == "ctx_mode":
        with pytest.raises(ValueError, match="cross_att requires both streams"):
            XML(XMLConfig(**cfg))
        cfg.update(cross_att=False, merge_two_stream=False)   # as train_xml sets them
    rng = np.random.default_rng(1)
    B = 3
    batch = dict(
        query_feat=rng.normal(size=(B, 10, 16)).astype(np.float32),
        query_mask=_mask(rng, B, 10),
        video_feat=rng.normal(size=(B, 12, 18)).astype(np.float32),
        video_mask=_mask(rng, B, 12),
        sub_feat=rng.normal(size=(B, 12, 14)).astype(np.float32),
        st_ed_indices=np.zeros((B, 2), np.int32))
    batch["sub_mask"] = batch["video_mask"]
    model = XML(XMLConfig(**cfg)).init_weights(torch.Generator().manual_seed(0))
    loss, parts = model(**{k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.requires_grad]
    assert grads and all(g is not None and torch.isfinite(g).all() for g in grads)
    for bad in (dict(encoder_type="rnn"), dict(span_predictor_type="linear")):
        with pytest.raises(NotImplementedError):
            XML(XMLConfig(**{**cfg, **bad}))


def test_converter_rejects_unknown_leaf():
    with pytest.raises(ValueError, match="unknown flax leaf"):
        flax_params_to_state_dict({"dense": {"kernel": np.zeros((2, 3)), "gamma": np.ones(3)}})


# the profiling suite and the offline feature pipelines, which the two
# checks below must reach
NEW_SLICE = tuple(f"tvretrieval_tpu_torch.{m}" for m in (
    "features", "features.pooling", "features.subtitles", "features.video_split",
    "features.backbones", "features.video_features", "features.text_features",
    "features.lm_finetune", "profiling.profile_models", "profiling.search_simulation",
    "parallel", "parallel.mesh", "parallel.sharded_retrieval"))
SUBPACKAGES = ("data", "evaluation", "features", "models", "native", "ops", "parallel",
               "profiling", "retrieval", "training", "utils")


def test_port_imports_without_jax():
    """Importing every module of the port leaves neither JAX nor any module
    of the JAX package in ``sys.modules``."""
    code = ("import importlib, pkgutil, sys\n"
            "import tvretrieval_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "assert len(names) > 20, names\n"
            f"missing = set({NEW_SLICE!r}) - set(names)\n"
            "assert not missing, missing\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_dtypes', 'tvretrieval_tpu')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_do_not_name_the_jax_package():
    """No source of the port, nor chip_smoke.py, imports ``tvretrieval_tpu``
    (the JAX package) or JAX itself."""
    pat = re.compile(r"^\s*(import|from)\s+(tvretrieval_tpu|jax|flax|optax|orbax|ml_dtypes)"
                     r"(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tvretrieval_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    scanned = {os.path.relpath(f, REPO)[:-3].replace(os.sep, ".") for f in files}
    assert {m if m.count(".") > 1 else m + ".__init__" for m in NEW_SLICE} <= scanned
    bad = [(os.path.relpath(f, REPO), m.group(0).strip())
           for f in files for m in pat.finditer(open(f).read())]
    assert not bad, bad


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_importing_a_subpackage_builds_nothing(sub):
    """A subpackage alone, its ``__init__`` re-exports resolved: no kernel
    or native library built or loaded, and neither JAX, the JAX package
    nor transformers imported."""
    code = ("import sys\n"
            f"import tvretrieval_tpu_torch.{sub} as m\n"
            "assert m.__all__ and all(hasattr(m, n) for n in m.__all__), m.__all__\n"
            "from tvretrieval_tpu_torch.ops import _build\n"
            "from tvretrieval_tpu_torch.native import loader\n"
            "assert _build.load.cache_info().currsize == 0\n"
            "assert loader._lib is None and not loader._load_failed\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'transformers', 'tvretrieval_tpu')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
