"""The port's MLP detector, data generators and accountant against the JAX
reference, from weights carried across by ``repro_torch.convert``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import fl_params as j_fl_params
from repro.configs.base import fl_static as j_fl_static
from repro.configs.paper_mlp import paper_fl_config as j_paper
from repro.core import plans as j_plans
from repro.data import synthetic as j_syn
from repro.models import mlp as j_mlp
from repro.models.spec import get_model_spec as j_get_spec
from repro.models.spec import meta_for as j_meta_for
from repro.privacy import accountant as j_acct
from repro.train import fl_driver as j_fl_driver

from repro_torch import convert
from repro_torch.configs.base import FLConfig, fl_params, fl_static
from repro_torch.configs.paper_mlp import paper_fl_config as t_paper
from repro_torch.core import plans as t_plans
from repro_torch.data import synthetic as t_syn
from repro_torch.models import mlp as t_mlp
from repro_torch.models.spec import get_model_spec, meta_for, model_names
from repro_torch.privacy import accountant as t_acct
from repro_torch.train import fl_driver as t_fl_driver
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


def _batch(seed, n=64, d=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("hidden", [32, 128])
def test_mlp_logits_loss_grads_match_reference(hidden):
    """Logits, loss and grads to 1e-5 (f32 sums in another order)."""
    jparams = j_mlp.init_mlp(jax.random.key(hidden), 42, hidden, 2)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    x, y = _batch(hidden)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.as_tensor(x), "y": torch.as_tensor(y).long()}
    np.testing.assert_allclose(t_mlp.mlp_logits(tparams, tb["x"]).numpy(),
                               np.asarray(j_mlp.mlp_logits(jparams, jb["x"])),
                               atol=1e-5, rtol=1e-5)
    jloss, jgrad = jax.value_and_grad(j_mlp.mlp_loss)(jparams, jb)
    tgrad, tloss = torch.func.grad_and_value(t_mlp.mlp_loss)(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for a, b in zip(tree_leaves(tgrad), jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        t_mlp.mlp_predict_proba(tparams, tb["x"]).numpy(),
        np.asarray(j_mlp.mlp_predict_proba(jparams, jb["x"])), atol=1e-6)
    # XLA divides a mean by multiplying with 1/n: one f32 rounding apart
    np.testing.assert_allclose(
        float(t_mlp.accuracy(tparams, tb["x"], tb["y"])),
        float(j_mlp.accuracy(jparams, jb["x"], jb["y"])), rtol=1e-6)


def test_model_spec_matches_reference():
    fed = j_syn.make_federated(1, "unsw", n_samples=400, n_clients=4)
    tfed = t_syn.make_federated(1, "unsw", n_samples=400, n_clients=4)
    assert tuple(meta_for(tfed, 32)) == tuple(j_meta_for(fed, 32))
    assert "mlp" in model_names()
    jspec = j_get_spec("mlp", j_meta_for(fed, 32))
    tspec = get_model_spec("mlp", meta_for(tfed, 32))
    jparams = jspec.init(jax.random.key(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    x, y = torch.as_tensor(tfed.test_x), torch.as_tensor(tfed.test_y)
    np.testing.assert_allclose(
        tspec.predict_proba(tparams, x).numpy(),
        np.asarray(jspec.predict_proba(jparams, jnp.asarray(fed.test_x))),
        atol=1e-6)
    np.testing.assert_allclose(
        float(tspec.accuracy(tparams, x, y)),
        float(jspec.accuracy(jparams, jnp.asarray(fed.test_x),
                             jnp.asarray(fed.test_y))), rtol=1e-6)
    with pytest.raises(KeyError):
        get_model_spec("cnn", meta_for(tfed, 32))
    # torch.Generator init: right shapes, fresh draws per generator state
    p = tspec.init(torch.Generator().manual_seed(0))
    assert [tuple(l.shape) for l in tree_leaves(p)] == \
        [tuple(l.shape) for l in jax.tree.leaves(jparams)]


@pytest.mark.parametrize("seed", [0, 3])
def test_auc_roc_matches_reference_oracle(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, 500)
    scores = rng.random(500).astype(np.float32)
    scores[:50] = scores[50:100]  # ties exercise the average-rank path
    assert t_mlp.auc_roc(scores, labels) == j_mlp.auc_roc(scores, labels)
    cont = rng.random(500).astype(np.float32)
    np.testing.assert_allclose(
        float(t_mlp.auc_roc_torch(torch.as_tensor(cont),
                                  torch.as_tensor(labels))),
        float(j_mlp.auc_roc_jnp(jnp.asarray(cont), jnp.asarray(labels))),
        rtol=1e-6)


@pytest.mark.parametrize("seed,dataset,n", [(0, "unsw", 20_000),
                                            (5, "unsw", 3_000),
                                            (2, "road", 600)])
def test_make_federated_and_round_batches_bitwise(seed, dataset, n):
    """Same seed, bitwise the same arrays as the reference's generators."""
    j = j_syn.make_federated(seed, dataset, n_samples=n)
    t = t_syn.make_federated(seed, dataset, n_samples=n)
    assert (t.n_features, t.n_classes, t.feature_shape) == \
        (j.n_features, j.n_classes, j.feature_shape)
    for a, b in zip(t.x + t.y + [t.test_x, t.test_y],
                    j.x + j.y + [j.test_x, j.test_y]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.data_sizes(), j.data_sizes())
    np.testing.assert_array_equal(t.label_entropy(), j.label_entropy())
    tb = t_syn.round_batches(np.random.default_rng(seed), t, 5, 64)
    jb = j_syn.round_batches(np.random.default_rng(seed), j, 5, 64)
    for k in ("x", "y"):
        np.testing.assert_array_equal(tb[k], jb[k])


def test_fl_config_and_plan_registry_match_reference():
    """The port's copies of FLConfig/FLParams and the plan registry accept,
    canonicalise and reject configs as the reference does."""
    assert [f.name for f in dataclasses.fields(FLConfig)] == \
        [f.name for f in dataclasses.fields(JFLConfig)]
    assert t_plans.plan_names() == j_plans.plan_names()
    for name in t_plans.plan_names():
        tp, jp = t_plans.get_plan(name), j_plans.get_plan(name)
        assert (tp.family, tp.code, tp.builder, tp.time_model,
                tp.fault_arrivals, tp.driver_capable, tp.cohort_capable) == \
            (jp.family, jp.code, jp.builder, jp.time_model, jp.fault_arrivals,
             jp.driver_capable, jp.cohort_capable)
    for kw in ({}, {"plan": "buffered_async", "async_buffer": 2.0,
                    "dp_epsilon": 3.0}, {"plan": "hierarchical", "k_tol": 0.1}):
        t, j = FLConfig(**kw), JFLConfig(**kw)
        assert tuple(fl_params(t)) == tuple(j_fl_params(j))
        assert dataclasses.asdict(fl_static(t)) == \
            dataclasses.asdict(j_fl_static(j))
    for bad in ({"plan": "nope"}, {"plan": "buffered_async"},
                {"async_buffer": 2.0}, {"plan": "client_cohort"},
                {"plan": "hierarchical", "hierarchy_edges": 0}):
        with pytest.raises(ValueError):
            JFLConfig(**bad)
        with pytest.raises(ValueError):
            FLConfig(**bad)


def test_personalize_matches_reference():
    """FedL2P-lite fine-tuning from the same global params with the same
    NumPy batch draws: personalised accuracy and AUC as the reference's."""
    fed = j_syn.make_federated(2, "unsw", n_samples=800, n_clients=4)
    tfed = t_syn.make_federated(2, "unsw", n_samples=800, n_clients=4)
    jspec = j_get_spec("mlp", j_meta_for(fed, 32))
    tspec = get_model_spec("mlp", meta_for(tfed, 32))
    jparams = jspec.init(jax.random.key(4))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jacc, jauc = j_fl_driver._personalize(jparams, fed, jspec, seed=3)
    tacc, tauc = t_fl_driver._personalize(tparams, tfed, tspec, seed=3)
    np.testing.assert_allclose(tacc, jacc, rtol=1e-6)
    np.testing.assert_allclose(tauc, jauc, rtol=1e-6)


@pytest.mark.parametrize("rounds", [1, 10, 200])
def test_accounted_epsilon_equals_reference(rounds):
    """The host f64 accountant is the reference's NumPy code: equal ε."""
    assert t_acct.accounted_epsilon(t_paper(), rounds) == \
        j_acct.accounted_epsilon(j_paper(), rounds)
    for kw in (dict(dp_mode="paper", dp_sigma=0.5), dict(dp_enabled=False),
               dict(dp_epsilon=50.0, dp_clip=5.0, n_clients=10,
                    clients_per_round=4)):
        assert t_acct.accounted_epsilon(FLConfig(**kw), rounds) == \
            j_acct.accounted_epsilon(JFLConfig(**kw), rounds)
