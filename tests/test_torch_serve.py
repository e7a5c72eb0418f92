"""The port's streaming scorer (``repro_torch.serve``) on the CPU, against
its own contracts and against the JAX reference's engine.

* batching: the reference's unit tests against the port's own copy;
* the feed keeps order and content;
* ``ServeEngine(device="cpu")`` over uneven chunks for ``attn``, ``ssm``,
  ``rglru`` and ``cnn``:
  bitwise equal to the scorer on the same padded bucket batches, within
  1e-6 of one unpadded ``predict_proba_routed`` call, within 1e-5 of the
  JAX engine on the same params;
* checkpoints written by either package load in the other, params bitwise;
* routes, scorer statistics, personalised heads, and the explicit device.

Params are the JAX ``spec.init`` draws carried across, not trained ones.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_syn
from repro.models.spec import get_model_spec as j_get_spec
from repro.models.spec import meta_for as j_meta_for
from repro.serve import ServeEngine as JServeEngine
from repro.serve import save_serving_checkpoint as j_save

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.models.spec import DataMeta, get_model_spec
from repro_torch.serve import (SERVE_STATS, Bucketer, ServeEngine,
                               batches_of, bucket_for, device_feed, pad_to,
                               plan_chunks, save_serving_checkpoint)
from repro_torch.serve.cli import main as serve_main
from repro_torch.serve.engine import _get_scorer
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fed():
    return j_syn.make_federated(0, "road_raw", n_samples=300, n_clients=4)


def _setup(fed, name, seed=0):
    jmeta = j_meta_for(fed, 64)
    jspec = j_get_spec(name, jmeta)
    jparams = jspec.init(jax.random.key(seed))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    meta = DataMeta(*jmeta)
    return jspec, jparams, get_model_spec(name, meta), meta, tparams


# ---------------------------------------------------------------------------
# batching (the reference's cases, on the port's copy)
# ---------------------------------------------------------------------------


def test_plan_chunks_covers_and_uses_buckets():
    buckets = (8, 32)
    for n in (1, 7, 8, 9, 31, 32, 33, 100, 129):
        chunks = plan_chunks(n, buckets)
        assert sum(chunks) >= n
        assert all(c in buckets for c in chunks)
        assert all(c == 32 for c in chunks[:-1])


def test_bucket_for_picks_smallest_fit():
    assert bucket_for(1, (8, 32)) == 8
    assert bucket_for(8, (8, 32)) == 8
    assert bucket_for(9, (8, 32)) == 32
    with pytest.raises(ValueError, match="exceed"):
        bucket_for(33, (8, 32))


def test_pad_to_preserves_rows():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    padded, n = pad_to(x, 8)
    assert n == 3 and padded.shape == (8, 4)
    assert np.array_equal(padded[:3], x) and not padded[3:].any()


def test_bucketer_preserves_order_and_emits_zero_copy():
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=(m, 5)).astype(np.float32)
              for m in (3, 40, 1, 31, 7)]
    bk = Bucketer((8, 32))
    batches = []
    for c in chunks:
        batches.extend(bk.add(c))
    batches.extend(bk.flush())
    assert bk.pending == 0
    assert all(b.shape[0] in (8, 32) for b, _ in batches)
    got = np.concatenate([b[:n] for b, n in batches])
    assert np.array_equal(got, np.concatenate(chunks))


def test_batches_of_roundtrip():
    rng = np.random.default_rng(1)
    chunks = [rng.normal(size=(m, 3)).astype(np.float32) for m in (5, 9, 2)]
    got = np.concatenate(
        [b[:n] for b, n in batches_of(iter(chunks), (4, 16))])
    assert np.array_equal(got, np.concatenate(chunks))


# ---------------------------------------------------------------------------
# feed
# ---------------------------------------------------------------------------


def test_device_feed_preserves_order_and_content():
    rng = np.random.default_rng(2)
    batches = [(rng.normal(size=(4, 3)).astype(np.float32), 4 - i)
               for i in range(5)]
    out = list(device_feed(iter(batches), "cpu"))
    assert [n for _, n in out] == [n for _, n in batches]
    for (xd, _), (xh, _) in zip(out, batches):
        assert isinstance(xd, torch.Tensor) and xd.device.type == "cpu"
        assert np.array_equal(xd.numpy(), xh)
    assert list(device_feed(iter([]), "cpu")) == []


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["attn", "ssm", "rglru", "cnn"])
def test_score_stream_matches_scorer_reference_and_jax(fed, name):
    jspec, jparams, spec, meta, params = _setup(fed, name)
    x = np.asarray(fed.test_x[:21], np.float32)
    chunks = [x[i:i + 8] for i in range(0, 21, 8)]
    eng = ServeEngine(spec, meta, params, buckets=(4, 16), device="cpu")
    assert eng.route == "kernel"
    rep = eng.score_stream(chunks)
    assert rep.n_windows == 21 and rep.n_batches == len(rep.batch_walls_s)
    assert rep.windows_per_sec > 0 and rep.p99_s >= rep.p50_s
    # batching and feeding change no bits: the same scorer on the same
    # padded bucket batches
    scorer_out = np.concatenate([
        _get_scorer(spec, meta, b.shape[0], "kernel")(
            params, torch.as_tensor(b)).numpy()[:n]
        for b, n in batches_of(chunks, (4, 16))])
    assert np.array_equal(rep.scores, scorer_out)
    assert np.array_equal(eng.score(x), rep.scores)
    single = spec.predict_proba_routed(params, torch.as_tensor(x))[:, 1]
    np.testing.assert_allclose(rep.scores, single.numpy(), atol=1e-6)
    jeng = JServeEngine(jspec, j_meta_for(fed, 64), jparams, buckets=(4, 16),
                        route="ref")
    np.testing.assert_allclose(rep.scores, jeng.score(x), atol=1e-5)
    naive = eng.score_naive(x[:5])
    assert naive.n_batches == 5
    np.testing.assert_allclose(naive.scores, rep.scores[:5], atol=1e-6)


def test_jax_checkpoint_loads_in_the_port(tmp_path, fed):
    jspec, jparams, spec, meta, params = _setup(fed, "ssm", seed=1)
    path = j_save(str(tmp_path / "serve_ssm"), jparams, "ssm",
                  j_meta_for(fed, 64))
    eng = ServeEngine.from_checkpoint(path, buckets=(4, 16), device="cpu")
    assert eng.spec.name == "ssm" and eng.meta == meta
    for a, b in zip(tree_leaves(eng.params), jax.tree.leaves(jparams)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    x = np.asarray(fed.test_x[:9], np.float32)
    jeng = JServeEngine.from_checkpoint(path, buckets=(4, 16), route="ref")
    np.testing.assert_allclose(eng.score(x), jeng.score(x), atol=1e-5)


def test_port_checkpoint_loads_in_jax(tmp_path, fed):
    _, _, spec, meta, _ = _setup(fed, "attn")
    params = spec.init(torch.Generator().manual_seed(5))
    path = save_serving_checkpoint(str(tmp_path / "serve_attn"), params,
                                   "attn", meta)
    assert t_ckpt.load_manifest(path)["keys"][0] == "params/embed/b"
    jeng = JServeEngine.from_checkpoint(path, route="ref")
    assert jeng.spec.name == "attn"
    flat = t_ckpt.load_flat(path)
    assert "params/rkv/wk" in flat
    for a, (p, b) in zip(tree_leaves(params),
                         jax.tree_util.tree_flatten_with_path(jeng.params)[0]):
        assert np.array_equal(a.numpy(), np.asarray(b)), p
    with pytest.raises(ValueError, match="not a serving checkpoint"):
        ServeEngine.from_checkpoint(
            t_ckpt.save_pytree(str(tmp_path / "plain"), {"w": np.ones(3)}),
            device="cpu")


def test_routes_stats_heads_and_device(fed):
    _, _, spec, meta, params = _setup(fed, "attn", seed=2)
    with pytest.raises(KeyError, match="no score route"):
        ServeEngine(spec, meta, params, route="nope", device="cpu")
    # one scorer per (model, bucket, route): the first use misses, every
    # later use hits
    before = dict(SERVE_STATS)
    for route in ("kernel", "ref"):
        eng = ServeEngine(spec, DataMeta(*meta[:2], 65, meta[3]), params,
                          buckets=(4, 16), route=route, device="cpu")
        eng.warmup()
        eng.score(np.asarray(fed.test_x[:21], np.float32))
    assert SERVE_STATS["misses"] - before["misses"] == 4
    assert SERVE_STATS["hits"] - before["hits"] == 4   # 16 + padded 16
    # stacked personalised heads: client i scores with the i-th slice
    heads = tree_map(lambda t: torch.stack([t, 1.5 * t, t - 0.1]), params)
    eng = ServeEngine(spec, meta, params, buckets=(4, 16), heads=heads,
                      device="cpu")
    assert eng.n_personalized == 3
    x = np.asarray(fed.test_x[:7], np.float32)
    plain = ServeEngine(spec, meta, tree_map(lambda h: h[1], heads),
                        buckets=(4, 16), device="cpu")
    assert np.array_equal(eng.score(x, client=1), plain.score(x))
    with pytest.raises(ValueError, match="no personalized heads"):
        plain.score(x, client=0)
    if not torch.cuda.is_available():   # the engine never runs on the CPU
        with pytest.raises(RuntimeError, match="CUDA"):   # unasked
            ServeEngine(spec, meta, params)


def test_cli_trains_checkpoint_then_serves_on_cpu(tmp_path):
    """``python -m repro_torch.serve`` end to end on the CPU: no checkpoint
    yet, so one round of ``run_fl_legacy`` trains ``attn``, the checkpoint
    is written, reloaded and streamed; a second call serves from it."""
    args = ["--model", "attn", "--dataset", "road_raw", "--ckpt",
            str(tmp_path / "ck"), "--rounds", "1", "--clients", "4",
            "--samples", "300", "--repeat", "1", "--buckets", "8,32",
            "--device", "cpu"]
    rep = serve_main(args)
    assert rep.n_windows == 75 and (tmp_path / "ck.npz").exists()
    assert np.all((rep.scores >= 0) & (rep.scores <= 1))
    assert np.array_equal(serve_main(args).scores, rep.scores)
