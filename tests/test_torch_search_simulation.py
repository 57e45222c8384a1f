"""The port's search simulation (tvretrieval_tpu_torch.profiling.
search_simulation) against the JAX package's. The port draws its initial
centroids with a torch generator, so the Lloyd steps are held to JAX's from
JAX's own initial indices; well-separated clusters keep every assignment
away from a tie, so the centroids agree to f32 summation order (1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.profiling import search_simulation as js
from tvretrieval_tpu_torch.profiling import search_simulation as ts


def _blobs(n_per, k, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, (k, d))
    x = centers[:, None] + rng.normal(0, 0.5, (k, n_per, d))
    return x.reshape(k * n_per, d).astype(np.float32)


@pytest.mark.parametrize("iters", [1, 10])
def test_lloyd_from_jax_initial_centroids(iters):
    x = _blobs(60, 6, 8, seed=0)
    k, seed = 6, 3
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), x.shape[0], (k,),
                                        replace=False))
    jc, ja = js.kmeans(jnp.asarray(x), k, iters, seed)
    tc, ta = ts.lloyd(torch.from_numpy(x), torch.from_numpy(x[init]), iters)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_kmeans_initial_centroids_are_seeded_rows():
    x = torch.from_numpy(_blobs(20, 4, 5, seed=1))
    idx = ts.initial_indices(x.shape[0], 4, seed=7)
    assert len(set(idx.tolist())) == 4
    np.testing.assert_array_equal(idx.numpy(), ts.initial_indices(x.shape[0], 4, 7).numpy())
    c0, a0 = ts.kmeans(x, 4, iters=0, seed=7)
    np.testing.assert_array_equal(c0.numpy(), x[idx].numpy())
    assert a0.shape == (x.shape[0],)


def test_flat_search_equals_lax_top_k():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(7, 16)).astype(np.float32)
    v = rng.normal(size=(300, 16)).astype(np.float32)
    jv, ji = js.flat_search(jnp.asarray(q), jnp.asarray(v), 20)
    tv, ti = ts.flat_search(torch.from_numpy(q), torch.from_numpy(v), 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-6)


def test_ivf_index_buckets_hold_every_vector_once():
    v = _blobs(30, 5, 6, seed=4)
    index = ts.IVFIndex.build(v, 5, device="cpu")
    ids = index.bucket_ids.numpy()
    held = ids[ids >= 0]
    assert sorted(held.tolist()) == list(range(v.shape[0]))
    np.testing.assert_array_equal(index.bucket_mask.numpy() > 0, ids >= 0)
    rows = index.buckets.numpy()[ids >= 0]
    np.testing.assert_array_equal(rows, v[held])


def test_ivf_exact_at_full_probe():
    res = ts.simulate(n_videos=1200, n_queries=10, dim=16, n_clusters=8, nprobe=8,
                      device="cpu")
    assert res["ivf_recall_at_topk"] == 1.0
    jres = js.simulate(n_videos=1200, n_queries=10, dim=16, n_clusters=8, nprobe=8)
    assert set(res) == set(jres)
    for key in ("n_videos", "n_clusters", "nprobe", "ivf_recall_at_topk"):
        assert res[key] == jres[key]
    assert res["flat_search_ms"] > 0 and res["ivf_search_ms"] > 0


def test_ivf_partial_probe_recall_reasonable():
    res = ts.simulate(n_videos=1200, n_queries=10, dim=16, n_clusters=8, nprobe=2,
                      device="cpu")
    assert 0.1 < res["ivf_recall_at_topk"] <= 1.0


def test_cli_on_the_cpu(capsys):
    res = ts.main(["--n_videos", "600", "--n_queries", "5", "--dim", "8",
                   "--n_clusters", "4", "--nprobe", "4", "--device", "cpu"])
    assert res["ivf_recall_at_topk"] == 1.0
    assert '"ivf_recall_at_topk": 1.0' in capsys.readouterr().out


def test_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ts.main(["--n_videos", "600"])
