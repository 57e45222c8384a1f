"""BertAdam, the LR schedules and the EMA of the port against the JAX
package's optax versions, on the same seeded parameters and gradients.
Tolerance 1e-6 relative: both run float32; the port takes the LR product
in double before the last rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tvretrieval_tpu.training import optimization as jo
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.training import optimization as to


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(5, 7)
        self.ln = nn.LayerNorm(7)
        self.cross_ln = nn.LayerNorm(7)
        self.pos_embed = nn.Parameter(torch.zeros(3, 7))


def _flax_tree(params):
    return {"dense": {"kernel": params["dense.weight"].T, "bias": params["dense.bias"]},
            "ln": {"scale": params["ln.weight"], "bias": params["ln.bias"]},
            "cross_ln": {"scale": params["cross_ln.weight"], "bias": params["cross_ln.bias"]},
            "pos_embed": params["pos_embed"]}


def _from_flax(tree):
    return {"dense.weight": np.asarray(tree["dense"]["kernel"]).T,
            "dense.bias": np.asarray(tree["dense"]["bias"]),
            "ln.weight": np.asarray(tree["ln"]["scale"]), "ln.bias": np.asarray(tree["ln"]["bias"]),
            "cross_ln.weight": np.asarray(tree["cross_ln"]["scale"]),
            "cross_ln.bias": np.asarray(tree["cross_ln"]["bias"]),
            "pos_embed": np.asarray(tree["pos_embed"])}


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("max_grad_norm", [1.0, -1.0])
def test_bert_adam_tracks_optax_over_warmup_knee(use_mask, max_grad_norm):
    rng = np.random.default_rng(0)
    net = _Net()
    init = {k: rng.normal(size=tuple(p.shape)).astype(np.float32)
            for k, p in net.named_parameters()}
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(torch.from_numpy(init[k]))
    # 20 steps of t_total=40 with warmup 0.25: the knee falls at step 10
    kw = dict(lr=1e-2, t_total=40, warmup=0.25, weight_decay=0.1)
    jparams = jax.tree_util.tree_map(jnp.asarray, _flax_tree(init))
    tx = jo.bert_adam(decay_mask=jo.no_decay_mask(jparams) if use_mask else None,
                      max_grad_norm=max_grad_norm, **kw)
    jstate = tx.init(jparams)
    mask = to.no_decay_mask(net) if use_mask else None
    opt = to.BertAdam(to.param_groups_from_mask(net, mask, kw["weight_decay"]),
                      max_grad_norm=max_grad_norm, **kw)
    for step in range(20):
        # large and small gradients, so the per-tensor clip is active for some
        grads = {k: (rng.normal(size=v.shape) * rng.choice([0.01, 3.0])).astype(np.float32)
                 for k, v in init.items()}
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, _flax_tree(grads)),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        want = _from_flax(jparams)
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    assert opt.state["step"] == 20 == int(jstate.step)


def test_no_decay_mask_matches_flax_names():
    """By parameter name: biases and LayerNorm parameters do not decay; the
    port's names map onto the flax tree's through convert.py's rules."""
    cfg = dict(visual_input_size=8, sub_input_size=6, query_input_size=5, hidden_size=8,
               n_heads=2, max_ctx_l=4, max_desc_l=3)
    model = XML(XMLConfig(**cfg))
    mask = to.no_decay_mask(model)
    assert set(mask) == {k for k, _ in model.named_parameters()}
    for k, decays in mask.items():
        parts = k.split(".")
        is_ln = any(p == "ln" or p.endswith("_ln") for p in parts)
        assert decays == (parts[-1] != "bias" and not is_ln), k
    assert not mask["video_cross_ln.weight"] and not mask["query_input_proj.ln.weight"]
    assert mask["query_input_proj.dense.weight"] and mask["ctx_pos_embed.pos_embed"]
    assert mask["merged_st_predictor.conv.weight"]
    net = _Net()
    jmask = _from_flax(jo.no_decay_mask(_flax_tree(
        {k: np.zeros(tuple(p.shape), np.float32) for k, p in net.named_parameters()})))
    assert {k: bool(v) for k, v in jmask.items()} == to.no_decay_mask(net)


@pytest.mark.parametrize("schedule", ["warmup_linear", "warmup_constant", "warmup_cosine",
                                      "none"])
def test_lr_multiplier_matches(schedule):
    for t_total, warmup in ((100, 0.1), (37, 0.01), (-1, 0.1)):
        jf = jo.make_lr_multiplier(schedule, warmup, t_total)
        tf = to.make_lr_multiplier(schedule, warmup, t_total)
        steps = np.arange(0, max(t_total, 10) + 5)
        want = np.asarray(jf(jnp.asarray(steps, jnp.int32)))
        got = np.asarray([tf(int(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown schedule"):
        to.make_lr_multiplier("bogus", 0.1, 10)(1)


def test_ema_matches():
    rng = np.random.default_rng(1)
    net = _Net()
    shadow = to.ema_init(net)
    jshadow = jo.ema_init({k: jnp.asarray(v.numpy()) for k, v in shadow.items()})
    for step in (None, 0, 5, 5000):
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
        jparams = {k: jnp.asarray(p.detach().numpy()) for k, p in net.named_parameters()}
        jshadow = jo.ema_update(jshadow, jparams, decay=0.99, step=step)
        shadow = to.ema_update(shadow, net, decay=0.99, step=step)
        for k in shadow:
            np.testing.assert_allclose(shadow[k].numpy(), np.asarray(jshadow[k]),
                                       rtol=1e-6, atol=1e-7)


def test_bert_adam_state_dict_round_trip():
    net = _Net()
    opt = to.BertAdam(net.parameters(), lr=1e-3, t_total=10)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.state_dict()
    opt2 = to.BertAdam(net.parameters(), lr=1e-3, t_total=10)
    opt2.load_state_dict(state)
    assert opt2.state["step"] == 1
    for p in net.parameters():
        assert torch.equal(opt2.state[p]["m"], opt.state[p]["m"])
    with pytest.raises(ValueError, match="invalid learning rate"):
        to.BertAdam(net.parameters(), lr=-1.0)
