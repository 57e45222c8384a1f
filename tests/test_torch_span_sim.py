"""The int8 span sweep of the port (ops.video_score.build_flat_feat2_i8,
span_sim_int8_xla / span_sim_cat_i8, and the XML methods built on them)
against the JAX package on identical numpy inputs. The JAX kernel
(span_sim_pallas_cat_i8) runs in interpret mode; on the CPU the port's
wrapper runs its plain version, which the CUDA kernel B5 is held to on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances:
- cache bytes, cache scales, the plain version's bf16 bits, and the query
  quantizer on an injected ``qcat``: exactly equal;
- span logits with converted weights: the two frameworks' query linear
  layers agree to f32 round-off, which can move a quantized query component
  by one step. The test counts those components per query; each moves a
  similarity by at most 127 * q_scale * max f_scale, and the ConvSE conv is
  linear, so a logit moves by at most the L1 norm of the conv kernel times
  that. On top, LOGIT_RTOL of the largest similarity covers f32 round-off of
  the rescale and, for the bf16-stored similarity, one bf16 step (2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.ops import pallas_score as jps
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops import video_score as vs

T = torch.from_numpy
LOGIT_RTOL = {"simsweep_cat_int8": 1e-5, "simsweep_cat_int8_flat": 2.0 ** -8 + 1e-5}


def _feat2(seed, nv, L, k, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nv, L, k)).astype(np.float32) * 3.0
    x[nv // 2, L // 2] = 0.0                 # an all-zero row: scale 1e-12, zeros
    return x.astype(dtype)


@pytest.mark.parametrize("nv,L,k,lp,chunk_v", [
    (37, 12, 32, 128, 8),       # Nv not a chunk_v multiple
    (16, 20, 64, 128, 16),
    (9, 7, 16, 256, 3),
    (5, 100, 512, 128, 16),     # the flagship row: 100 clips, 2D = 512
])
def test_build_flat_feat2_i8_bytes_and_scales_equal(nv, L, k, lp, chunk_v):
    x = _feat2(nv, nv, L, k)
    jf, js_ = jps.build_flat_feat2_i8(jnp.asarray(x), lp=lp, chunk_v=chunk_v)
    tf, ts_ = vs.build_flat_feat2_i8(T(x), lp=lp, chunk_v=chunk_v)
    assert tf.dtype == torch.int8 and ts_.dtype == torch.float32
    assert tf.is_contiguous() and ts_.is_contiguous()
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    nv_pad = -(-nv // chunk_v) * chunk_v
    assert tf.shape == (nv_pad * lp, k) and ts_.shape == (nv_pad, lp)
    # pad rows and pad videos: zero bytes, zero scales
    assert not tf.view(nv_pad, lp, k)[:, L:].any() and not ts_[:, L:].any()
    assert not tf.view(nv_pad, lp, k)[nv:].any() and not ts_[nv:].any()


def test_build_flat_feat2_i8_bf16_cache_and_validation():
    x = torch.from_numpy(_feat2(3, 6, 10, 16)).to(torch.bfloat16)
    jf, js_ = jps.build_flat_feat2_i8(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    tf, ts_ = vs.build_flat_feat2_i8(x)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    with pytest.raises(ValueError, match="exceeds"):
        vs.build_flat_feat2_i8(torch.zeros(2, 130, 16))
    # the TPU's lp % 128 rule is not the port's: its stores take any lp % 4
    assert vs.build_flat_feat2_i8(torch.zeros(2, 10, 16), lp=104)[1].shape == (16, 104)
    with pytest.raises(ValueError, match="multiple of 4"):
        vs.build_flat_feat2_i8(torch.zeros(2, 10, 16), lp=102)


@pytest.mark.parametrize("nq,nv,L,k,lp,chunk_v", [
    (6, 37, 12, 32, 128, 8),
    (5, 16, 20, 64, 128, 16),
    (40, 24, 14, 48, 256, 8),
    (3, 9, 7, 16, 128, 3),
    (7, 5, 100, 512, 128, 16),  # 2D = 512: sums up to 512 * 127^2, exact in f32
])
def test_span_sim_plain_bits_equal_jax_kernel(nq, nv, L, k, lp, chunk_v):
    """span_sim_int8_xla (the plain version of B5) and the CPU path of the
    wrapper: the same bf16 bits as the JAX kernel in interpret mode and as
    the JAX integer reference."""
    x = _feat2(nq * 100 + nv, nv, L, k)
    rng = np.random.default_rng(nq)
    qcat = rng.normal(size=(nq, k)).astype(np.float32)
    jf, jsc = jps.build_flat_feat2_i8(jnp.asarray(x), lp=lp, chunk_v=chunk_v)
    jq8, jqs = jps.quantize_rows_i8(jnp.asarray(qcat))
    ref = jps.span_sim_pallas_cat_i8(jq8, jqs[:, None], jf, jsc, lp=lp, chunk_v=chunk_v,
                                     q_tile=32, interpret=True)
    ref_xla = jps.span_sim_int8_xla(jq8, jqs[:, None], jf, jsc, lp=lp)
    tf, tsc = vs.build_flat_feat2_i8(T(x), lp=lp, chunk_v=chunk_v)
    tq8, tqs = vs.quantize_rows_i8(T(qcat))
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))
    _build.reset_launch_counts()
    bits = lambda a: np.asarray(a).view(np.uint16) if not isinstance(a, torch.Tensor) \
        else a.view(torch.int16).numpy().view(np.uint16)
    for block in (64, 4):
        plain = vs.span_sim_int8_xla(tq8, tqs[:, None], tf, tsc, lp=lp, block_videos=block)
        assert plain.dtype == torch.bfloat16 and plain.shape == ref.shape
        np.testing.assert_array_equal(bits(plain), bits(ref))
    np.testing.assert_array_equal(bits(plain), bits(ref_xla))
    out = vs.span_sim_cat_i8(tq8, tqs[:, None], tf, tsc, lp=lp)
    assert torch.equal(out.view(torch.int16), plain.view(torch.int16))
    assert _build.LAUNCHES["span_sim_cat_i8"] == 0             # CPU: the plain version
    assert not out[:, :, L:].any() and not out[:, nv:].any()


def test_span_sim_wrapper_checks_operands():
    q8, qs = torch.zeros(2, 16, dtype=torch.int8), torch.ones(2, 1)
    f8, fs = torch.zeros(4 * 8, 16, dtype=torch.int8), torch.ones(4, 8)
    assert vs.span_sim_cat_i8(q8, qs, f8, fs, lp=8).shape == (2, 4, 8)
    with pytest.raises(TypeError, match="int8"):
        vs.span_sim_cat_i8(q8.float(), qs, f8, fs, lp=8)
    with pytest.raises(TypeError, match="float32"):
        vs.span_sim_cat_i8(q8, qs.double(), f8, fs, lp=8)
    with pytest.raises(ValueError, match="does not divide"):
        vs.span_sim_cat_i8(q8, qs, f8, fs, lp=5)
    with pytest.raises(ValueError, match="shapes"):
        vs.span_sim_cat_i8(q8, qs[:, 0], f8, fs, lp=8)
    with pytest.raises(ValueError, match="one CUDA device"):
        vs.span_sim_cat_i8(q8.to("meta"), qs.to("meta"), f8.to("meta"), fs.to("meta"), lp=8)


KW = dict(ctx_mode="video_sub", visual_input_size=18, sub_input_size=14,
          query_input_size=28, hidden_size=32, n_heads=2, max_ctx_l=14, max_desc_l=16)


@pytest.fixture(scope="module")
def models():
    from tvretrieval_tpu.data.datasets import ExampleBuilder
    from tvretrieval_tpu.data.synthetic import make_synthetic_world
    world = make_synthetic_world(n_videos=8, n_queries=6, vid_dim=16, text_dim=12,
                                 max_clips=14, seed=7)
    builder = ExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=16,
        max_ctx_l=14, clip_length=world.clip_length)
    jm = JXML(JXMLConfig(**KW))
    qb = builder.build_train_batch(world.annotations[:6])
    variables = jax.jit(lambda r, b: jm.init(r, **b, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)}, qb.model_inputs())
    tm = XML(XMLConfig(**KW)).eval()
    tm.load_state_dict(flax_params_to_state_dict(jax.device_get(variables["params"])),
                       strict=True)
    return jm, variables, tm


@jax.jit
def _jax_query_quantizer(qcat):
    """The quantizer lines of XML.merged_st_ed_scores_*_i8 (JAX xml.py:480-482,
    525-527), compiled as they are inside the engine's program."""
    q_scale = jnp.maximum(jnp.max(jnp.abs(qcat), axis=-1, keepdims=True) / 127.0, 1e-12)
    q8 = jnp.clip(jnp.round(qcat / q_scale), -127, 127).astype(jnp.int8)
    return q8, q_scale


def test_query_quantizer_equals_jax_for_an_injected_qcat(models):
    """q_scale and q8 equal for the same qcat: the linear layers are set to
    the identity so that ``qcat`` is exactly 0.5 * [vq ; sq]."""
    _, _, tm = models
    import copy
    tm = copy.deepcopy(tm)
    d = KW["hidden_size"]
    with torch.no_grad():
        for lin in (tm.video_query_linear, tm.sub_query_linear):
            lin.weight.copy_(torch.eye(d))
            lin.bias.zero_()
    rng = np.random.default_rng(5)
    q = (rng.normal(size=(2000, 2 * d)) * rng.random((2000, 1)) * 4).astype(np.float32)
    q[7] = 0.0                                                   # scale floor 1e-12
    with torch.no_grad():
        t8, tscale = tm._quantized_cat_query(T(q[:, :d]), T(q[:, d:]))
    j8, jscale = _jax_query_quantizer(jnp.asarray(q) * 0.5)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    # a true division by 127 would not give these scales
    assert (tscale.numpy() != (np.abs(q * 0.5).max(-1, keepdims=True)
                               / np.float32(127.0)).clip(1e-12)).any()


@pytest.mark.parametrize("mode", ["simsweep_cat_int8", "simsweep_cat_int8_flat"])
def test_int8_span_logits_match_jax_with_converted_weights(models, mode):
    jm, variables, tm = models
    d, nv, L, nq, V = KW["hidden_size"], 21, 14, 9, 6
    rng = np.random.default_rng(11)
    feat2 = _feat2(13, nv, L, 2 * d)
    vq = rng.normal(size=(nq, d)).astype(np.float32)
    sq = rng.normal(size=(nq, d)).astype(np.float32)
    mask = (np.arange(L)[None] < rng.integers(3, L + 1, size=(nv, 1))).astype(np.float32)
    gidx = np.stack([rng.permutation(nv)[:V] for _ in range(nq)]).astype(np.int32)

    if mode == "simsweep_cat_int8":
        jf, jsc = jps.quantize_rows_i8(jnp.asarray(feat2))
        tf, tsc = vs.quantize_rows_i8(T(feat2))
        jo = jm.apply(variables, jnp.asarray(vq), jnp.asarray(sq), jf, jsc, jnp.asarray(mask),
                      jnp.asarray(gidx), method=JXML.merged_st_ed_scores_simgather_cat_i8)
        with torch.no_grad():
            to = tm.merged_st_ed_scores_simgather_cat_i8(T(vq), T(sq), tf, tsc, T(mask),
                                                         T(gidx).long())
    else:
        jf, jsc = jps.build_flat_feat2_i8(jnp.asarray(feat2))
        tf, tsc = vs.build_flat_feat2_i8(T(feat2))
        jo = jm.apply(variables, jnp.asarray(vq), jnp.asarray(sq), jf, jsc, jnp.asarray(mask),
                      jnp.asarray(gidx), interpret=True,
                      method=JXML.merged_st_ed_scores_pallas_cat_i8)
        with torch.no_grad():
            to = tm.merged_st_ed_scores_pallas_cat_i8(T(vq), T(sq), tf, tsc, T(mask),
                                                      T(gidx).long())
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))

    # one-step differences of the quantized query between the frameworks
    jqcat = jnp.concatenate(
        [jm.apply(variables, jnp.asarray(vq), method=lambda m, x: m.video_query_linear(x)),
         jm.apply(variables, jnp.asarray(sq), method=lambda m, x: m.sub_query_linear(x))],
        axis=-1) * 0.5
    j8, jscale = _jax_query_quantizer(jqcat)
    with torch.no_grad():
        t8, tscale = tm._quantized_cat_query(T(vq), T(sq))
    steps = np.abs(t8.numpy().astype(np.int32) - np.asarray(j8).astype(np.int32))
    assert steps.max() <= 1
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-6)
    n_diff = steps.sum(axis=1)                                    # per query
    print(f"{mode}: {int(n_diff.sum())} one-step q8 differences in {nq * 2 * d} components")

    fmax = float(np.asarray(jsc).max())
    sim_max = 127.0 * 127.0 * 2 * d * float(tscale.max()) * fmax  # no similarity is larger
    for name, j, t in (("st", jo[0], to[0]), ("ed", jo[1], to[1])):
        w = getattr(tm, f"merged_{name}_predictor").conv.weight
        w_l1 = float(w.detach().abs().sum())
        tol = w_l1 * (n_diff * 127.0 * tscale.numpy()[:, 0] * fmax
                      + LOGIT_RTOL[mode] * sim_max)               # (Nq,)
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape == (nq, V, L)
        masked = mask[gidx] == 0
        np.testing.assert_array_equal(t[masked], j[masked])       # -1e10 on both sides
        err = np.abs(t - j).max(axis=(1, 2))
        assert (err <= tol).all(), (err, tol)
