"""The port's window-native detectors (``cnn``, ``rglru``, ``attn``,
``ssm``) against the JAX reference on raw ROAD windows at hidden 64, from
params carried across by ``repro_torch.convert``.  On the CPU the
``"kernel"`` route runs the kernels' plain versions; the JAX ``"kernel"``
route runs its Pallas kernels in interpret mode.  ``cnn`` has one
implementation, which serves both routes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_syn
from repro.models.spec import get_model_spec as j_get_spec
from repro.models import ssm as j_ssm
from repro.models.spec import meta_for as j_meta_for

from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import make_federated
from repro_torch.kernels import ops as t_ops
from repro_torch.models import ssm as t_ssm
from repro_torch.models.spec import DataMeta, get_model_spec, model_names
from repro_torch.train.fl_driver import run_fl_legacy
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fed():
    return j_syn.make_federated(0, "road_raw", n_samples=300, n_clients=4)


def _specs(fed, name):
    jmeta = j_meta_for(fed, 64)
    return (j_get_spec(name, jmeta), get_model_spec(name, DataMeta(*jmeta)))


def _params(jspec, seed):
    jparams = jspec.init(jax.random.key(seed))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                            "cpu")


def _jax_paths(tree):
    return [tuple(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["attn", "ssm", "cnn", "rglru"])
def test_logits_match_jax_on_both_routes(fed, name):
    """8 windows, logits at 1e-5 on each route; the port's two routes are
    bitwise equal on the CPU (the kernel route runs the plain versions),
    except ``rglru``'s, whose sequential and log-depth scans agree to
    1e-6.  ``convert`` carries the whole tree (``mix``, ``rkv``, ``rec``
    included), and the port's own init draws the same structure and
    shapes."""
    assert name in model_names()
    jspec, tspec = _specs(fed, name)
    jparams, tparams = _params(jspec, 3)
    assert tree_paths(tparams) == _jax_paths(jparams)
    own = tspec.init(torch.Generator().manual_seed(0))
    assert tree_paths(own) == tree_paths(tparams)
    assert [l.shape for l in tree_leaves(own)] == \
        [l.shape for l in tree_leaves(tparams)]
    x = fed.test_x[:8]
    got = {}
    for route in ("kernel", "ref"):
        got[route] = tspec.logits_routed(route)(tparams, torch.as_tensor(x))
        want = jax.jit(jspec.logits_routed(route))(jparams, jnp.asarray(x))
        np.testing.assert_allclose(got[route].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    if name == "rglru":
        np.testing.assert_allclose(got["kernel"].numpy(), got["ref"].numpy(),
                                   atol=1e-6, rtol=1e-6)
    else:
        assert torch.equal(got["kernel"], got["ref"])
    assert torch.equal(tspec.logits(tparams, torch.as_tensor(x)),
                       got["kernel"])


@pytest.mark.parametrize("name", ["attn", "ssm", "cnn", "rglru"])
def test_loss_and_grads_match_jax(fed, name):
    """``torch.func.grad`` of the port's loss (the plain "ref" math) against
    ``jax.grad`` of the reference's, leaf by leaf at 1e-5."""
    jspec, tspec = _specs(fed, name)
    jparams, tparams = _params(jspec, 4)
    x, y = fed.test_x[:8], fed.test_y[:8]
    jloss, jgrad = jax.jit(jax.value_and_grad(jspec.loss))(
        jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tgrad, tloss = torch.func.grad_and_value(tspec.loss)(
        tparams, {"x": torch.as_tensor(x), "y": torch.as_tensor(y).long()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert tree_paths(tgrad) == _jax_paths(jgrad)
    for a, b in zip(tree_leaves(tgrad), jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["cnn", "rglru", "ssm", "attn"])
def test_window_detectors_refuse_tabular_data(name):
    """Every window-native detector refuses a tabular federation's meta,
    with the reference's message."""
    assert name in model_names()
    with pytest.raises(ValueError, match="window-native"):
        get_model_spec(name, DataMeta(42, 2, 64, (42,)))


def test_sequence_detectors_need_windows_and_train_in_the_round_loop(fed):
    """A tabular federation is refused; on windows ``run_fl_legacy`` trains
    ``ssm`` through the unchanged round step (one round on the CPU)."""
    with pytest.raises(ValueError, match="window-native"):
        get_model_spec("attn", DataMeta(42, 2, 64, (42,)))
    tfed = make_federated(0, "road_raw", n_samples=300, n_clients=4)
    fl = FLConfig(n_clients=4, clients_per_round=2, local_epochs=1,
                  local_batch=8, dp_enabled=False, fault_tolerance=False,
                  model="ssm")
    res = run_fl_legacy(tfed, fl, "random", rounds=1, device="cpu")
    assert np.isfinite(res.history["loss"][0]) and 0.0 <= res.auc <= 1.0
    assert all(bool(torch.isfinite(l).all()) for l in tree_leaves(res.params))


def test_chunk_scan_via_plain_scan_matches_inline_lax_scan():
    """``ssd_chunked`` with the inter-chunk recurrence on the port's plain
    ``rglru_scan`` (``chunk_scan_via``) against the reference's inline
    ``lax.scan`` (``scan_fn=None``), at the ssm detector's shapes.  The
    three-operand einsums reduce in another order in torch: 1e-5."""
    rng = np.random.default_rng(5)
    b, l, h, p, n, chunk = 3, 64, 2, 16, 16, 16
    x = _normal(rng, (b, l, h, p))
    dt = np.log1p(np.exp(_normal(rng, (b, l, h)) - 2.0)).astype(np.float32)
    A = np.array([1.0, 16.0], np.float32)
    B, C = _normal(rng, (b, l, n)), _normal(rng, (b, l, n))
    jy, jfinal = j_ssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, A, B,
                                                               C)), chunk)
    ty, tfinal = t_ssm.ssd_chunked(
        *(torch.as_tensor(v) for v in (x, dt, A, B, C)), chunk,
        scan_fn=t_ssm.chunk_scan_via(t_ops.rglru_scan))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=1e-5,
                               rtol=1e-5)
