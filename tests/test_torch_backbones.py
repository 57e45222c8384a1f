"""The port's vision backbones (tvretrieval_tpu_torch.features.backbones)
against the JAX package's flax modules, on the same seeded weights carried
by ``convert.flax_resnet152_to_state_dict`` / ``flax_i3d_to_state_dict``.

The flax variables are drawn with numpy into the shapes ``jax.eval_shape``
gives (a flax ``init`` of the full I3D compiles for tens of seconds on one
core): LeCun-normal kernels, and BatchNorm statistics, scales and biases
away from the identity so that epsilon and the mean / variance wiring
show. Tolerance: atol = rtol = 1e-5, the bound the JAX package's
backbones meet against torch (tests/test_backbones_numeric.py); max
pooling is exact. Inputs are channels-last for the nets and NC(D)HW for
the port's blocks, which work in torch's layout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.features import backbones as jb
from tvretrieval_tpu.features import video_features as jvf
from tvretrieval_tpu_torch.convert import flax_i3d_to_state_dict, flax_resnet152_to_state_dict
from tvretrieval_tpu_torch.features import backbones as tb
from tvretrieval_tpu_torch.features import video_features as tvf
from _baseline_pairs import one_torch_thread  # noqa: F401


TOL = dict(atol=1e-5, rtol=1e-5)


def _random_variables(module, x, seed):
    """Seeded numpy values in the shapes of ``module.init(key, x)``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(x.shape, x.dtype))

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
        elif name == "mean":
            a = rng.normal(0, 0.3, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.normal(0, 0.1, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _nc(x):
    """channels-last -> channels-first (the port's blocks' layout)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_matches_flax(stride):
    """v1.5: the stride on the 3x3 conv and on the downsample path; the
    block's variables go through the ResNet converter's renames."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 13, 17, 64)).astype(np.float32)
    jm = jb.Bottleneck(planes=32, stride=stride, downsample=True)
    v = _random_variables(jm, x, seed=10 + stride)
    sd = flax_resnet152_to_state_dict({"params": {"layer1_0": v["params"]},
                                       "batch_stats": {"layer1_0": v["batch_stats"]}})
    tm = tb.Bottleneck(64, 32, stride, downsample=True)
    tm.load_state_dict(_strip(sd, "layer1.0."), strict=True)
    with torch.no_grad():
        got = tm(_nc(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(jm.apply(v, x)), **TOL)


@pytest.mark.parametrize("kernel,stride,size", [
    ((7, 7, 7), (2, 2, 2), (9, 13, 11)),     # the stem: asymmetric TF-SAME pads
    ((7, 7, 7), (2, 2, 2), (8, 12, 10)),     # even sizes: the other split
    ((3, 3, 3), (1, 1, 1), (9, 13, 11)),
    ((3, 3, 3), (1, 1, 1), (8, 12, 10)),
    ((1, 1, 1), (1, 1, 1), (9, 13, 11)),
])
def test_unit3d_matches_flax(kernel, stride, size):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, *size, 3)).astype(np.float32)
    jm = jb.Unit3D(8, kernel, stride)
    v = _random_variables(jm, x, seed=20)
    tm = tb.Unit3D(3, 8, kernel, stride)
    tm.load_state_dict(flax_i3d_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(_nc(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(jm.apply(v, x)), **TOL)


@pytest.mark.parametrize("size", [(9, 13, 11), (8, 12, 10)])
@pytest.mark.parametrize("window,stride", [
    ((1, 3, 3), (1, 2, 2)),   # MaxPool3d_2a/3a
    ((3, 3, 3), (2, 2, 2)),   # MaxPool3d_4a
    ((2, 2, 2), (2, 2, 2)),   # MaxPool3d_5a
    ((3, 3, 3), (1, 1, 1)),   # the Mixed blocks' pool branch
])
def test_max_pool3d_same_exact(window, stride, size):
    x = np.random.default_rng(3).normal(0, 1, (2, *size, 4)).astype(np.float32)
    got = tb._max_pool3d_same(_nc(x), window, stride).numpy()
    np.testing.assert_array_equal(np.moveaxis(got, 1, -1),
                                  np.asarray(jb._max_pool3d_same(x, window, stride)))


def test_inception_mixed_matches_flax():
    spec = jb.I3D_MIXED_SPECS["Mixed_3b"]
    x = np.random.default_rng(4).normal(0, 1, (1, 5, 9, 7, 16)).astype(np.float32)
    jm = jb.InceptionMixed(*spec)
    v = _random_variables(jm, x, seed=40)
    tm = tb.InceptionMixed(16, *spec)
    tm.load_state_dict(flax_i3d_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(_nc(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(jm.apply(v, x)), **TOL)


def test_resnet_forward_and_frame_model_match_flax():
    """Reduced depth (1, 1, 1, 1), odd sizes for the paddings; then the
    frame models of both packages (ImageNet normalization, uint8 in) on
    the same variables."""
    counts = (1, 1, 1, 1)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 61, 47, 3)).astype(np.float32)
    jm = jb.ResNet152(block_counts=counts)
    v = _random_variables(jm, x, seed=50)
    sd = flax_resnet152_to_state_dict(v)
    tm = tb.ResNet152(block_counts=counts)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), **TOL)

    frames = rng.integers(0, 255, (3, 40, 36, 3), np.uint8)
    ref = jvf.make_resnet152_frame_model(v, block_counts=counts)(frames)
    out = tvf.make_resnet152_frame_model(sd, block_counts=counts, device="cpu")(frames)
    np.testing.assert_allclose(out, ref, **TOL)


def test_i3d_forward_and_clip_model_match_flax():
    """The full I3D at the JAX clip model's init shape (1, 8, 32, 32, 3),
    as floats and through both clip models (uint8 rescaled to [-1, 1])."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (1, 8, 32, 32, 3)).astype(np.float32)
    jm = jb.InceptionI3d()
    v = _random_variables(jm, x, seed=60)
    sd = flax_i3d_to_state_dict(v)
    tm = tb.InceptionI3d()
    tm.load_state_dict(sd, strict=True)
    japply = jax.jit(jm.apply)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(japply(v, x)), **TOL)

    clips = rng.integers(0, 255, (1, 8, 32, 32, 3), np.uint8)
    ref = np.asarray(japply(v, clips.astype(np.float32) / 127.5 - 1.0))
    out = tvf.make_i3d_clip_model(sd, device="cpu")(clips)
    np.testing.assert_allclose(out, ref, **TOL)


def _jax_param_count(module, x):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))


def _param_count(module):
    return sum(p.numel() for p in module.parameters() if p.requires_grad)


def test_full_depth_parameter_counts_equal_jax():
    """ResNet-152 without its fc: 58,143,808 (tests/test_backbones.py:33-40);
    I3D: the JAX module's count, conv weights and BatchNorm biases."""
    jr = _jax_param_count(jb.ResNet152(), jnp.zeros((1, 64, 64, 3)))
    ji = _jax_param_count(jb.InceptionI3d(), jnp.zeros((1, 8, 32, 32, 3)))
    assert jr == 58_143_808
    assert _param_count(tb.ResNet152()) == jr
    assert _param_count(tb.InceptionI3d()) == ji


def _torchvision_state(block_counts):
    """A torchvision resnet state_dict's keys and shapes (fc included), for
    the given depth, from a port net of that depth."""
    sd = {k: v.clone() for k, v in tb.ResNet152(block_counts).state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_torchvision_state_dict_check_and_filter():
    """The full torchvision layout loads strictly into the full net, the fc
    dropped; a reduced depth keeps only its blocks; a missing key raises;
    a missing ``num_batches_tracked`` (older checkpoints) reads 0."""
    full = _torchvision_state((3, 8, 36, 3))
    out = tb.torchvision_resnet152_to_state_dict(full)
    assert "fc.weight" not in out and list(out) == tb.resnet152_state_keys()
    tb.ResNet152().load_state_dict(out, strict=True)

    small = tb.torchvision_resnet152_to_state_dict(full, block_counts=(1, 2, 1, 1))
    assert "layer2.1.conv1.weight" in small and "layer2.2.conv1.weight" not in small
    tb.ResNet152((1, 2, 1, 1)).load_state_dict(small, strict=True)

    old = {k: v for k, v in full.items() if not k.endswith("num_batches_tracked")}
    assert int(tb.torchvision_resnet152_to_state_dict(old)["bn1.num_batches_tracked"]) == 0
    del old["layer4.2.bn3.running_var"]
    with pytest.raises(KeyError, match="layer4.2.bn3.running_var"):
        tb.torchvision_resnet152_to_state_dict(old)
    assert tb.torchvision_resnet152_to_flax is tb.torchvision_resnet152_to_state_dict


def test_tf_i3d_variable_map_covers_every_conv_and_bn():
    """Every entry of the port's I3D state_dict has a TF source, and every
    conv kernel / BatchNorm beta the JAX map names goes to the same one."""
    mapping = tb.tf_i3d_variable_map()
    assert set(mapping) == set(tb.InceptionI3d().state_dict())
    assert all(v.startswith("RGB/inception_i3d/") for v in mapping.values())
    assert len(set(mapping.values())) == len(mapping)
    jmap = jb.tf_i3d_variable_map()
    ours = {k.replace("/", ".").replace("conv3d.kernel", "conv3d.weight"): v
            for k, v in jmap.items()}
    assert ours == {k: v for k, v in mapping.items()
                    if k.endswith(("conv3d.weight", "bn.bias"))}


def test_models_refuse_a_missing_card(monkeypatch):
    """Without device="cpu" the frame and clip models need the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tvf.make_resnet152_frame_model(block_counts=(1, 1, 1, 1))
    with pytest.raises(SystemExit, match="no CUDA device"):
        tvf.make_i3d_clip_model()
