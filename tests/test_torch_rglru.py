"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's ``repro/models/rglru.py`` on the CPU.

* the log-depth plain scan against ``jax.lax.associative_scan`` (the
  reference's ``rglru_scan``) to 1e-6, at even, odd and tiny lengths,
  with and without h0, and its gradient under ``torch.func.vmap`` against
  ``jax.vmap(jax.grad)`` (XLA on the CPU fuses multiply-adds that torch
  rounds twice, so not bitwise);
* ``_causal_conv`` (the Python ``sum`` order, then ``+ b``) and
  ``rglru_block`` on both scans against the reference at 1e-6 / 1e-5;
* ``init_rglru``'s ParamMeta tree (paths, shapes, axes), and its Λ
  against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as j_rglru
from repro.models.sharding import split_meta

from repro_torch import convert
from repro_torch.kernels import ref as t_ref
from repro_torch.models import rglru as t_rglru
from repro_torch.models.detectors import _RecCfg
from repro_torch.models.sharding import split_meta as t_split_meta
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)


class _JCfg:
    """The config fields the reference's ``init_rglru`` reads."""

    def __init__(self, d_model, lru_width, conv_width):
        self.d_model, self.lru_width = d_model, lru_width
        self.conv_width, self.dtype = conv_width, "float32"


def _scan_inputs(rng, b, l, w):
    a = rng.uniform(0.5, 1.0, (b, l, w)).astype(np.float32)
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, x, h0


@pytest.mark.parametrize("l", [1, 2, 5, 37, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_log_depth_scan_matches_associative_scan(l, with_h0):
    rng = np.random.default_rng(l)
    a, x, h0 = _scan_inputs(rng, 3, l, 16)
    h0 = h0 if with_h0 else None
    jh, jlast = j_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(x),
                                   None if h0 is None else jnp.asarray(h0))
    th, tlast = t_rglru.rglru_scan(torch.as_tensor(a), torch.as_tensor(x),
                                   None if h0 is None else torch.as_tensor(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-6,
                               rtol=1e-6)
    # and the sequential plain version of the kernel computes the same
    sh, _ = t_ref.rglru_scan_ref(torch.as_tensor(a), torch.as_tensor(x),
                                 None if h0 is None else torch.as_tensor(h0))
    np.testing.assert_allclose(th.numpy(), sh.numpy(), atol=1e-6, rtol=1e-6)


def test_log_depth_scan_differentiates_under_vmap():
    """``torch.func.vmap(grad)`` through the scan, as the local SGD takes
    it, against ``jax.vmap(jax.grad)`` of the reference's scan."""
    rng = np.random.default_rng(7)
    a, x, _ = _scan_inputs(rng, 4, 64, 8)
    a, x = a[:, None], x[:, None]                   # 4 rows of [1, 64, 8]
    wt = rng.standard_normal((64, 8)).astype(np.float32)

    def jloss(a, x):
        return jnp.sum(j_rglru.rglru_scan(a, x)[0][0] * wt)

    def tloss(a, x):
        return torch.sum(t_rglru.rglru_scan(a, x)[0][0] * torch.as_tensor(wt))

    jga, jgx = jax.vmap(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a),
                                                         jnp.asarray(x))
    tga, tgx = torch.func.vmap(torch.func.grad(tloss, argnums=(0, 1)))(
        torch.as_tensor(a), torch.as_tensor(x))
    np.testing.assert_allclose(tga.numpy(), np.asarray(jga), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    st = rng.standard_normal((2, 3, 5)).astype(np.float32) if with_state \
        else None
    jout, jstate = j_rglru._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    tout, tstate = t_rglru._causal_conv(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
        None if st is None else torch.as_tensor(st))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_rglru_block_matches_reference(impl):
    """The block at the detector's width (d = w = 16, conv 4) over 64
    steps, params carried across; the port's ``"flash"`` runs the kernel's
    plain sequential scan on the CPU, the reference's its interpret-mode
    Pallas kernel."""
    cfg = _RecCfg(d_model=16, lru_width=16, conv_width=4)
    jparams = split_meta(j_rglru.init_rglru(jax.random.key(2),
                                            _JCfg(16, 16, 4)))[0]
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    x = np.random.default_rng(4).standard_normal((3, 64, 16)).astype(
        np.float32)
    jout, jcache = j_rglru.rglru_block(jparams, jnp.asarray(x), None,
                                       impl=impl)
    tout, tcache = t_rglru.rglru_block(tparams, torch.as_tensor(x), cfg,
                                       impl=impl)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tcache["h"].numpy(), np.asarray(jcache["h"]),
                               atol=1e-5, rtol=1e-5)
    # the conv state is the input projection's last steps (an einsum each)
    np.testing.assert_allclose(tcache["conv"].numpy(),
                               np.asarray(jcache["conv"]), atol=1e-6,
                               rtol=1e-6)


def test_init_rglru_structure_and_decay():
    """A ParamMeta tree with the reference's paths, shapes and axes."""
    cfg = _RecCfg(d_model=16, lru_width=16, conv_width=4)
    own, own_axes = t_split_meta(
        t_rglru.init_rglru(torch.Generator().manual_seed(0), cfg))
    jparams, jaxes = split_meta(j_rglru.init_rglru(jax.random.key(0),
                                                   _JCfg(16, 16, 4)))
    assert own_axes == jaxes
    assert tree_paths(own) == sorted((k,) for k in jparams)
    assert [tuple(l.shape) for l in tree_leaves(own)] == \
        [tuple(jparams[k].shape) for k in sorted(jparams)]
    # Λ: the same f32 formula; linspace may round an element an ulp apart
    np.testing.assert_allclose(own["lam"].numpy(), np.asarray(jparams["lam"]),
                               rtol=1e-5)
    a = np.exp(-8.0 * np.log1p(np.exp(own["lam"].numpy())))
    np.testing.assert_allclose(a, np.linspace(0.9, 0.999, 16), rtol=1e-5)
