"""Helpers shared by the XML variant tests: a seeded batch, seeded flax
parameters for any ``XMLConfig`` (the tree's shapes come from
``jax.eval_shape`` of ``init``, so nothing is compiled for it), the JAX
model's outputs, and the port's same outputs on the converted tree.

Outputs compared, keyed alike on both sides: the training forward's loss
and loss dict (eval mode, the negative ranks JAX draws injected into the
port), ``encode_context``, ``get_pred_from_raw_query`` in-batch and cross,
and ``visualization_data`` where the JAX model defines it."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tvretrieval_tpu.models import xml as jx
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models import xml as tx

SIZES = dict(visual_input_size=18, sub_input_size=14, query_input_size=16,
             hidden_size=16, n_heads=2, max_ctx_l=8, max_desc_l=6)
B, LQ, LC = 6, SIZES["max_desc_l"], SIZES["max_ctx_l"]
LW_ST_ED = 1.0                      # weigh the span loss in


def make_batch(seed: int = 0) -> dict:
    """Row 0 full length, row 1 a single clip / token, the rest between."""
    rng = np.random.default_rng(seed)

    def mask(L):
        n = rng.integers(1, L + 1, size=B)
        n[0], n[1] = L, 1
        return (np.arange(L)[None] < n[:, None]).astype(np.float32)

    vm = mask(LC)
    n_clips = vm.sum(1).astype(np.int32)
    st = rng.integers(0, n_clips)
    ed = np.minimum(st + rng.integers(0, 3, size=B), n_clips - 1)
    return dict(query_feat=rng.normal(size=(B, LQ, SIZES["query_input_size"])).astype(np.float32),
                query_mask=mask(LQ),
                video_feat=rng.normal(size=(B, LC, SIZES["visual_input_size"])).astype(np.float32),
                video_mask=vm,
                sub_feat=rng.normal(size=(B, LC, SIZES["sub_input_size"])).astype(np.float32),
                sub_mask=vm.copy(),
                st_ed_indices=np.stack([st, ed], 1).astype(np.int32))


def flax_params(cfg, batch: dict, seed: int = 1) -> dict:
    """Seeded numpy parameters in the flax tree of ``cfg``: kernels
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2),
    positional embeddings N(0, 0.1^2)."""
    shapes = jax.eval_shape(
        lambda b: jx.XML(cfg).init({"params": jax.random.PRNGKey(0),
                                    "dropout": jax.random.PRNGKey(1),
                                    "negatives": jax.random.PRNGKey(2)},
                                   **b, deterministic=True), batch)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_ranks(key, n: int, upper: int):
    """The (ctx, query) negative ranks video_level_ranking_losses draws
    from ``key`` (tvretrieval_tpu/models/xml.py:714-720)."""
    k_ctx, k_q = jax.random.split(key)
    draw = lambda k: np.array(jax.random.randint(k, (n,), 1, max(min(upper, n), 2)))
    return draw(k_ctx), draw(k_q)


def has_visualization(cfg) -> bool:
    """Where the JAX model's visualization_data runs: two merged streams
    and the modular query (its assert), with the conv head it calls."""
    return (cfg.merge_two_stream and cfg.use_video and cfg.use_sub and not cfg.no_modular
            and cfg.span_predictor_type == "conv")


def _context_args(ctx, b):
    vf1, vf2, sf1, sf2 = ctx
    return (vf1, vf2, b["video_mask"], sf1, sf2, b["sub_mask"])


ALL = ("loss", "ctx", "pred.False", "pred.True", "vis")


def jax_outputs(cfg, params, batch, compiler_options=None, parts=ALL) -> dict:
    """Every compared output of the JAX model: op by op (each primitive
    compiles once and is shared by every variant, where compiling each
    variant's program costs seconds), or with ``compiler_options`` as one
    program compiled with those XLA options. ``parts``: the outputs to
    compute besides the losses and the context."""
    m = jx.XML(cfg)

    def run(p, b):
        v = {"params": p}
        loss, losses = m.apply(v, **b, lw_st_ed=LW_ST_ED, deterministic=True)
        ctx = m.apply(v, b["video_feat"], b["video_mask"], b["sub_feat"], b["sub_mask"],
                      method=jx.XML.encode_context)
        out = dict(loss=loss, **{f"loss.{k}": x for k, x in losses.items()}, ctx=ctx)
        for cross in (False, True):
            if f"pred.{cross}" in parts:
                out[f"pred.{cross}"] = m.apply(v, b["query_feat"], b["query_mask"],
                                               *_context_args(ctx, b), cross,
                                               method=jx.XML.get_pred_from_raw_query)
        if "vis" in parts and has_visualization(cfg):
            out["vis"] = m.apply(v, b["query_feat"], b["query_mask"], b["video_feat"],
                                 b["video_mask"], b["sub_feat"], b["sub_mask"],
                                 method=jx.XML.visualization_data)
        return out

    if compiler_options is not None:
        run = jax.jit(run).lower(params, batch).compile(compiler_options=compiler_options)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), run(params, batch))


def port_model(cfg_kwargs: dict, params) -> tx.XML:
    model = tx.XML(tx.XMLConfig(**cfg_kwargs))
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return model.eval()


@torch.no_grad()
def port_outputs(model: tx.XML, batch, parts=ALL) -> dict:
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    ranks = tuple(torch.from_numpy(r) for r in jax_ranks(jax.random.PRNGKey(0), B, B))
    loss, losses = model(**t, lw_st_ed=LW_ST_ED, neg_ranks=ranks)
    ctx = model.encode_context(t["video_feat"], t["video_mask"], t["sub_feat"], t["sub_mask"])
    out = dict(loss=loss, **{f"loss.{k}": x for k, x in losses.items()}, ctx=ctx)
    for cross in (False, True):
        if f"pred.{cross}" in parts:
            out[f"pred.{cross}"] = model.get_pred_from_raw_query(
                t["query_feat"], t["query_mask"], *_context_args(ctx, t), cross=cross)
    if "vis" in parts and has_visualization(model.cfg):
        out["vis"] = model.visualization_data(t["query_feat"], t["query_mask"], t["video_feat"],
                                              t["video_mask"], t["sub_feat"], t["sub_mask"])
    as_np = lambda x: None if x is None else x.float().numpy()
    return jax.tree_util.tree_map(as_np, out, is_leaf=lambda x: x is None)


def flat(outputs: dict) -> dict:
    """{name: array} with one entry per leaf; missing streams stay None."""
    leaves = {}
    for k, v in outputs.items():
        if isinstance(v, dict):
            leaves.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        elif isinstance(v, (tuple, list)):
            leaves.update({f"{k}.{i}": vv for i, vv in enumerate(v)})
        else:
            leaves[k] = v
    return leaves


def assert_outputs_close(got: dict, want: dict, atol: float, rtol: float) -> None:
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)
