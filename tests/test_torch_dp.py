"""DP clip+noise: the port's plain versions against the JAX reference.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against
these plain versions on the card.  On the CPU the port's wrappers take the
plain route because the tensors lie on the CPU, so these tests cover the
arithmetic every route shares.  Inputs come from a NumPy seed; where the
reference's noise matters it is rebuilt from the reference's own keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp as j_dp
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.dp_clip_noise import scale_noise, sumsq

from repro_torch.core import dp as t_dp
from repro_torch.kernels import dp_clip_noise as t_kern
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.tree import flatten_rows, tree_leaves

torch.set_num_threads(1)


def _np_tree(rng, hidden=16, d_in=42):
    """An MLP-shaped update tree of f32 NumPy arrays."""
    def lin(a, b):
        return {"w": rng.normal(0, 0.3, (a, b)).astype(np.float32),
                "b": rng.normal(0, 0.3, (b,)).astype(np.float32)}
    return {"l1": lin(d_in, hidden), "l2": lin(hidden, hidden // 2),
            "out": lin(hidden // 2, 2)}


def _tt(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _leaf_noise(key, tree):
    """The reference's per-leaf noise (split(key, n_leaves), leaf order),
    flat."""
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    return np.concatenate([np.asarray(jax.random.normal(k, l.shape,
                                                        jnp.float32)).ravel()
                           for k, l in zip(keys, leaves)])


@pytest.mark.parametrize("n", [64, 1000, 40_000])
@pytest.mark.parametrize("clip,sigma", [(1.0, 0.0), (0.5, 0.1), (100.0, 1.0)])
def test_dp_clip_noise_plain_matches_pallas_interpret(n, clip, sigma):
    """The grid of the reference's kernel test, at its 1e-5 bars: the port's
    plain sumsq / scale_noise / dp_clip_noise against interpret-mode Pallas
    and the reference's ``dp_clip_noise_ref``."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    nz = rng.standard_normal(n).astype(np.float32)
    o_pl, norm_pl = j_ops.dp_clip_noise(jnp.asarray(x), jnp.asarray(nz),
                                        clip, sigma)
    o_ref = j_ref.dp_clip_noise_ref(jnp.asarray(x), jnp.asarray(nz), clip,
                                    sigma)
    xt, nt = torch.as_tensor(x), torch.as_tensor(nz)
    o_t, norm_t = t_ops.dp_clip_noise(xt, nt, clip, sigma)
    for expect in (o_pl, o_ref):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(expect),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(norm_t), float(norm_pl), rtol=1e-5)
    np.testing.assert_allclose(
        t_ref.dp_clip_noise_ref(xt, nt, clip, sigma).numpy(),
        np.asarray(o_ref), atol=1e-5, rtol=1e-5)
    # the two halves on their own, through the kernel wrappers' CPU route
    sq = t_kern.sumsq_rows(xt[None])
    np.testing.assert_allclose(float(sq[0]), float(sumsq(jnp.asarray(x))),
                               rtol=1e-5)
    scale = t_ref.clip_scale(torch.sqrt(sq), clip)
    o_sn = t_kern.scale_noise_rows(xt[None], nt[None], scale, sigma)
    np.testing.assert_allclose(
        o_sn[0].numpy(),
        np.asarray(scale_noise(jnp.asarray(x), jnp.asarray(nz),
                               float(scale[0]), sigma=sigma)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("clip,sigma", [(1.0, 0.0), (0.5, 0.7)])
def test_dp_clip_noise_tree_matches_reference_tree(clip, sigma):
    """``dp_clip_noise_tree`` and ``privatize_update('clipped')`` against
    ``dp_clip_noise_tree_ref`` with the reference's per-leaf noise injected
    in leaf order: updates to 1e-6, the shared norm to 1e-5 relative."""
    tree = _np_tree(np.random.default_rng(5))
    key = jax.random.key(11)
    expect, norm = j_ref.dp_clip_noise_tree_ref(
        jax.tree.map(jnp.asarray, tree), key, clip, sigma)
    noise = torch.as_tensor(_leaf_noise(key, tree))
    for got, got_norm in (
            t_ops.dp_clip_noise_tree(_tt(tree), noise, clip, sigma),
            t_dp.privatize_update(_tt(tree), noise, mode="clipped",
                                  clip=clip, sigma=sigma)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(expect)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
        np.testing.assert_allclose(float(got_norm), float(norm), rtol=1e-5)


def test_privatize_update_paper_mode_matches_reference():
    """Paper mode (fixed σ, no clip) with injected noise, to 1e-6."""
    tree = _np_tree(np.random.default_rng(6))
    key = jax.random.key(12)
    expect, norm = j_dp.privatize_update(jax.tree.map(jnp.asarray, tree), key,
                                         mode="paper", clip=1.0, sigma=0.3)
    got, got_norm = t_dp.privatize_update(
        _tt(tree), torch.as_tensor(_leaf_noise(key, tree)), mode="paper",
        clip=1.0, sigma=0.3)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(expect)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got_norm), float(norm), rtol=1e-5)


@pytest.mark.parametrize("mode", ["clipped", "paper"])
def test_privatize_rows_matches_vmapped_reference(mode):
    """The row-batched form over [10, P] against ``jax.vmap`` of the
    reference's per-client privatize step (the round step's DP call), with
    the reference's per-client keys: updates to 1e-6, norms to 1e-5."""
    rng = np.random.default_rng(7)
    trees = [_np_tree(rng) for _ in range(10)]
    stacked = jax.tree.map(lambda *l: jnp.asarray(np.stack(l)), *trees)
    keys = jax.random.split(jax.random.key(13), 10)
    clip, sigma = 0.8, 0.2
    expect, norms = jax.vmap(lambda d, k: j_dp.privatize_update(
        d, k, mode=mode, clip=clip, sigma=sigma, use_kernel=False))(stacked,
                                                                    keys)
    noise = torch.as_tensor(np.stack([_leaf_noise(k, trees[0]) for k in keys]))
    rows = flatten_rows(_tt(stacked))
    got, got_norms = t_dp.privatize_rows(rows, noise, mode=mode, clip=clip,
                                         sigma=sigma)
    np.testing.assert_allclose(
        got.numpy(),
        np.concatenate([np.asarray(l).reshape(10, -1)
                        for l in jax.tree.leaves(expect)], axis=1),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_norms.numpy(), np.asarray(norms), rtol=1e-5)


def test_clip_by_global_norm_and_noise_match_reference():
    """The tree mechanics the paper mode and the plain clipped path share:
    ``global_norm``, ``clip_by_global_norm``, ``add_gaussian_noise``."""
    tree = _np_tree(np.random.default_rng(8))
    jtree = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(t_dp.global_norm(_tt(tree))),
                               float(j_dp.global_norm(jtree)), rtol=1e-6)
    for clip in (0.5, 1e3):
        expect, norm = j_dp.clip_by_global_norm(jtree, clip)
        got, got_norm = t_dp.clip_by_global_norm(_tt(tree), clip)
        np.testing.assert_allclose(float(got_norm), float(norm), rtol=1e-6)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(expect)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    key = jax.random.key(14)
    expect = j_dp.add_gaussian_noise(jtree, 0.4, key)
    got = t_dp.add_gaussian_noise(_tt(tree), 0.4,
                                  torch.as_tensor(_leaf_noise(key, tree)))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(expect)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_gaussian_sigma_matches_reference():
    for eps, delta, clip in ((8.0, 1e-5, 1.0), (50.0, 1e-5, 5.0), (0.5, 1e-6, 2.0)):
        assert t_dp.gaussian_sigma(eps, delta, clip) == j_dp.gaussian_sigma(
            eps, delta, clip)
        assert t_dp.gaussian_sigma_rt(eps, delta, clip) == \
            j_dp.gaussian_sigma_rt(eps, delta, clip)


def test_kernel_wrappers_reject_other_devices():
    """A wrapper takes the plain route only for a CPU tensor; anything else
    must be a CUDA tensor of the right kind, or it raises."""
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        t_kern.sumsq_rows(meta)
    with pytest.raises(ValueError):
        t_kern.scale_noise_rows(meta, meta, torch.empty(2, device="meta"), 1.0)
