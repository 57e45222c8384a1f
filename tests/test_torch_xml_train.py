"""The training half of the port's XML (forward loss, ranking losses,
gradients) against the flax model on converted weights. The negative ranks
come from the JAX PRNG, which torch cannot reproduce, so the ranks JAX
draws are injected into the port. Tolerances: 1e-6 on the ranking losses
(identical arithmetic on identical scores), 2e-4 on the model's losses and
on each gradient relative to that gradient's largest entry: the bound the
JAX package meets against the original torch model (tests/test_xml.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.data.datasets import ExampleBuilder as JExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world as j_make_world
from tvretrieval_tpu.models import xml as jx
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models import xml as tx

KW = dict(ctx_mode="video_sub", visual_input_size=18, sub_input_size=14,
          query_input_size=28, hidden_size=32, n_heads=2, max_ctx_l=14, max_desc_l=16)


def jax_ranks(key, n, upper):
    """The (ctx, query) ranks video_level_ranking_losses draws from ``key``
    (tvretrieval_tpu/models/xml.py:714-720)."""
    k_ctx, k_q = jax.random.split(key)
    draw = lambda k: np.array(jax.random.randint(k, (n,), 1, max(min(upper, n), 2)))
    return draw(k_ctx), draw(k_q)


@pytest.fixture(scope="module")
def setup():
    world = j_make_world(n_videos=20, n_queries=24, vid_dim=16, text_dim=12,
                         max_clips=14, seed=7)
    builder = JExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=16,
        max_ctx_l=14, clip_length=world.clip_length)
    batch = builder.build_train_batch(world.annotations[:12]).model_inputs()
    jm = jx.XML(jx.XMLConfig(**KW))
    variables = jax.jit(lambda r, b: jm.init(r, **b, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)}, batch)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    tm = tx.XML(tx.XMLConfig(**KW))
    missing, unexpected = tm.load_state_dict(flax_params_to_state_dict(params), strict=False)
    assert not missing and not unexpected         # the map covers every trained parameter
    return jm, params, tm.eval(), batch


@pytest.mark.parametrize("loss_type", ["hinge", "lse"])
@pytest.mark.parametrize("upper", [12, 5, 1])
def test_ranking_losses_with_injected_ranks(loss_type, upper):
    rng = np.random.default_rng(3)
    n = 12
    # two decimals: many exactly tied scores, within rows and columns
    scores = np.round(rng.uniform(-1, 1, size=(n, n)), 1).astype(np.float32)
    assert (np.sort(scores, axis=1)[:, 1:] == np.sort(scores, axis=1)[:, :-1]).any()
    key = jax.random.PRNGKey(11)
    want = jx.video_level_ranking_losses(jnp.asarray(scores), key, margin=0.1,
                                         loss_type=loss_type,
                                         neg_sample_upper=jnp.asarray(upper))
    ranks = tuple(torch.from_numpy(r) for r in jax_ranks(key, n, upper))
    got = tx.video_level_ranking_losses(torch.from_numpy(scores), None, margin=0.1,
                                        loss_type=loss_type, neg_sample_upper=upper,
                                        ranks=ranks)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.item(), float(a), rtol=1e-6, atol=1e-6)


def test_ranking_losses_draw_inside_bounds_and_reproducibly():
    scores = torch.from_numpy(np.random.default_rng(0).normal(size=(9, 9)).astype(np.float32))
    for upper, hi in ((9, 9), (4, 4), (1, 2), (0, 2)):
        a, b = tx.draw_negative_ranks(2000, upper, torch.Generator().manual_seed(1), "cpu")
        for r in (a, b):
            assert r.min() >= 1 and r.max() == hi - 1
    g = lambda: torch.Generator().manual_seed(5)
    one = tx.video_level_ranking_losses(scores, g(), 0.1, "hinge", 9)
    two = tx.video_level_ranking_losses(scores, g(), 0.1, "hinge", 9)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    with pytest.raises(NotImplementedError):
        tx.video_level_ranking_losses(scores, g(), 0.1, "bogus", 9)


@pytest.mark.parametrize("n_rows,upper", [(12, None), (12, 6), (5, 16)])
def test_forward_loss_matches_flax_eval(setup, n_rows, upper):
    """Eval mode against ``deterministic=True`` (key PRNGKey(0)); (5, 16) is
    the smaller final batch, where the rank bound clamps to the batch size."""
    jm, params, tm, batch = setup
    batch = {k: v[:n_rows] for k, v in batch.items()}
    jkw = {} if upper is None else dict(neg_sample_upper=jnp.asarray(upper))
    want_loss, want = jm.apply({"params": params}, **batch, lw_st_ed=0.01, deterministic=True,
                               **jkw)
    ranks = tuple(torch.from_numpy(r) for r in
                  jax_ranks(jax.random.PRNGKey(0), n_rows, n_rows if upper is None else upper))
    assert max(int(r.max()) for r in ranks) < n_rows
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got_loss, got = tm(**tb, lw_st_ed=0.01, neg_sample_upper=upper, neg_ranks=ranks)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=0, atol=2e-4, err_msg=k)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=0, atol=2e-4)
    # eval mode draws with a fixed seed: the loss does not depend on the caller's state
    with torch.no_grad():
        a = tm(**tb, neg_sample_upper=upper)[0]
        torch.manual_seed(123)
        b = tm(**tb, neg_sample_upper=upper)[0]
    assert torch.equal(a, b)


def test_gradients_match_jax_grad(setup):
    jm, params, tm, batch = setup
    lw = 0.5                                  # weigh the span loss in, not 0.01

    def loss_fn(p):
        return jm.apply({"params": p}, **batch, lw_st_ed=lw, deterministic=True)[0]

    jgrads = flax_params_to_state_dict(jax.device_get(jax.grad(loss_fn)(params)))
    ranks = tuple(torch.from_numpy(r) for r in jax_ranks(jax.random.PRNGKey(0), 12, 12))
    tm.zero_grad(set_to_none=True)
    loss, _ = tm(**{k: torch.from_numpy(v) for k, v in batch.items()}, lw_st_ed=lw,
                 neg_ranks=ranks)
    loss.backward()
    names = [k for k, _ in tm.named_parameters()]
    assert set(names) == set(jgrads)
    for k, p in tm.named_parameters():
        want = jgrads[k].numpy()
        scale = np.abs(want).max()
        if k.endswith(".key.bias"):
            # softmax ignores a shift of all its scores, so an attention key
            # bias has no gradient: both sides hold round-off only
            assert scale < 1e-8 and np.abs(p.grad.numpy()).max() < 1e-8, k
            continue
        assert scale > 1e-6, k
        assert np.abs(p.grad.numpy() - want).max() <= 2e-4 * scale, k
    tm.zero_grad(set_to_none=True)


def test_train_mode_uses_dropout_and_the_generator(setup):
    _, _, tm, batch = setup
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tm.train()
    try:
        torch.manual_seed(0)
        a = tm(**tb, generator=torch.Generator().manual_seed(1))[0]
        torch.manual_seed(0)
        b = tm(**tb, generator=torch.Generator().manual_seed(1))[0]
        torch.manual_seed(1)
        c = tm(**tb, generator=torch.Generator().manual_seed(1))[0]
    finally:
        tm.eval()
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        assert not torch.equal(a, tm(**tb)[0])
