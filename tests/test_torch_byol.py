"""The port's BYOL engine and LARS-SGD (advise_tpu_torch/engine,
advise_tpu_torch/solver) against the JAX package's, with the JAX state
passed through the param bridge.

Tolerances (float32): elementwise updates (EMA, LARS, kNN scatter) agree
to 1e-6 relative; losses and keys go through the whole model and its
4-sample-per-view BN head, and are held to 1e-3 relative to their largest
value (measured below 3e-4); BN running statistics to 1e-4 (the same
amplification, on statistics of magnitude ~0.1). Gradients are held to
1e-2 of the largest gradient: the JAX float32 reference itself is off by
up to 4.4e-3 of it (the stem weight, through the interpreted Pallas wgrad
and XLA-CPU's sequential reductions), measured against a float64 run of the
port, whose own float32 gradients are within 5e-5 of that run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu.engine import contrastive as jc
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.solver import optimizer as jopt
from advise_tpu_torch.engine import contrastive as tc
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.norm import commit_bn_stats
from advise_tpu_torch.solver import optimizer as topt
from advise_tpu_torch.utils.convert import (
    batch_stats_to_torch,
    convert_train_state,
    params_to_torch,
)

from torch_port_common import B, both_cfgs, jax_variables, rel_err, views

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = both_cfgs()
    # outside shard_map: the JAX collectives of knn_update/byol_loss become
    # identities, as on the one-device mesh (batch_axes(cfg) == ())
    jcfg.TPU.PARTITION_MODE = "auto"
    jm = jbuild_model(jcfg, sync_axes=())
    params, batch_stats = jax_variables(jm, seed=0)
    ema_params, _ = jax_variables(jm, seed=7)  # a momentum encoder apart from the online one
    ssl = jc.init_ssl_state(jcfg, params, batch_stats, jax.random.PRNGKey(3))
    ssl["ema_params"] = ema_params
    return jcfg, tcfg, jm, params, batch_stats, ssl


def _port(tcfg, params, batch_stats, ssl):
    conv = convert_train_state(params, batch_stats, ssl=ssl)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(conv["model"])
    tssl = tc.init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    tssl["ema_model"].load_state_dict(conv["ema"])
    tssl["knn_mem"] = conv["knn_mem"].clone()
    model.train()
    tssl["ema_model"].train()
    return model, tssl


def test_l2_normalize_floors_the_squared_norm():
    x = np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32)
    x[1] = 0.0
    x[2] *= 1e-8  # below the floor: F.normalize would give a unit vector here
    want = np.asarray(jc.l2_normalize(jnp.asarray(x)))
    got = tc.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.abs(np.linalg.norm(got[2]) - 1.0) > 0.5


@pytest.mark.parametrize("epoch", [0.0, 1.0, 57.5, 200.0])
def test_momentum_at(setup, epoch):
    jcfg, tcfg = setup[:2]
    assert tc.momentum_at(tcfg, epoch) == pytest.approx(float(jc.momentum_at(jcfg, jnp.float32(epoch))), abs=1e-7)


def test_update_ema(setup):
    jcfg, tcfg, _, params, batch_stats, ssl = setup
    m = 0.9
    want = jax.jit(lambda s, p: jc.update_ema(s, p, batch_stats, jnp.float32(m)))(
        ssl, params)["ema_params"]
    model, tssl = _port(tcfg, params, batch_stats, ssl)
    tc.update_ema(tssl, model, m)
    got = dict(tssl["ema_model"].named_parameters())
    for k, v in params_to_torch(jax.device_get(want)).items():
        assert rel_err(got[k].detach(), v) <= 1e-6, k


def test_compute_keys_per_view(setup):
    """The momentum encoder's keys of two views (per-view BN, train mode)
    and its updated running statistics."""
    jcfg, tcfg, jm, params, batch_stats, ssl = setup
    x = views(seed=1)
    with pltpu.force_tpu_interpret_mode():
        keys_j, ema_bs = jax.jit(lambda s, v: jc.compute_keys(
            jcfg, jm, s, [v[0], v[1]], jax.random.PRNGKey(0)))(ssl, jnp.asarray(x))
    model, tssl = _port(tcfg, params, batch_stats, ssl)
    keys_t = tc.compute_keys(tcfg, tssl, torch.from_numpy(x))
    commit_bn_stats(tssl["ema_model"])
    for i in range(2):
        assert rel_err(keys_t[i], keys_j[i]) <= 1e-3
    own = tssl["ema_model"].state_dict()
    for k, v in batch_stats_to_torch(jax.device_get(ema_bs)).items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


def test_knn_update(setup):
    jcfg, tcfg, _, params, batch_stats, ssl = setup
    q = np.random.default_rng(2).standard_normal((B, 16)).astype(np.float32)
    idx = np.arange(B, dtype=np.int32) * 7 + 5
    want = np.asarray(jc.knn_update(jcfg, ssl, jnp.asarray(q), jnp.asarray(idx))["knn_mem"])
    tssl = {"knn_mem": torch.from_numpy(np.array(ssl["knn_mem"]))}
    tc.knn_update(tcfg, tssl, torch.from_numpy(q), torch.from_numpy(idx).long())
    np.testing.assert_array_equal(tssl["knn_mem"].numpy(), want)


def test_byol_loss_and_grads(setup):
    """The BYOL loss of two views (VMAP_VIEWS in JAX, per-view BN in the
    port), its parameter gradients, the online and momentum-encoder BN
    statistics and the kNN bank after the scatter. JAX runs the Pallas stem
    in interpret mode."""
    jcfg, tcfg, jm, params, batch_stats, ssl = setup
    x = views(seed=2)
    infos = {"item_id": np.arange(B, dtype=np.int32) * 9 + 3}

    def loss_fn(p):
        loss, bs, new_ssl, _ = jc.byol_loss(jcfg, jm, p, batch_stats, ssl,
                                            [x[0], x[1]], infos, jax.random.PRNGKey(0))
        return loss, (bs, new_ssl)

    with pltpu.force_tpu_interpret_mode():
        (loss_j, (bs_j, ssl_j)), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model, tssl = _port(tcfg, params, batch_stats, ssl)
    loss_t, tssl, _ = tc.byol_loss(tcfg, model, tssl, torch.from_numpy(x),
                                   {"item_id": torch.from_numpy(infos["item_id"]).long()})
    loss_t.backward()
    commit_bn_stats(model)
    commit_bn_stats(tssl["ema_model"])

    assert abs(loss_t.item() - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_ref = params_to_torch(jax.device_get(g_j))
    top = max(float(v.abs().max()) for v in g_ref.values())
    for k, v in g_ref.items():
        assert float((grads[k] - v).abs().max()) <= 1e-2 * top, k
    for mod, ref in ((model, bs_j), (tssl["ema_model"], ssl_j["ema_batch_stats"])):
        own = mod.state_dict()
        for k, v in batch_stats_to_torch(jax.device_get(ref)).items():
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
    assert rel_err(tssl["knn_mem"], ssl_j["knn_mem"]) <= 1e-3


def test_param_labels_and_weight_decay_match_jax(setup):
    """ZERO_WD_1D_PARAM / BN.WEIGHT_DECAY labels per parameter."""
    jcfg, tcfg, _, params, _, _ = setup
    want = params_to_torch(jax.tree_util.tree_map(
        lambda w: np.float32(w), jopt.wd_tree(jcfg, params)))
    model = build_model(tcfg, "cpu")
    got = topt.wd_tree(tcfg, dict(model.named_parameters()))
    assert set(got) == set(want)
    for k in got:
        assert got[k] == pytest.approx(float(want[k])), k


def test_lars_sgd_matches_optax(setup):
    """Two LARS-SGD updates (coupled wd -> masked trust ratio -> Nesterov
    momentum trace, lr last) from random gradients, with one zero gradient
    to exercise the ratio-of-one rule; parameters, momentum trace and the
    global grad norm, also with the second update resumed from JAX's state
    through the param bridge."""
    jcfg, tcfg, _, params, _, _ = setup
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    g_leaves = [rng.standard_normal(np.shape(l)).astype(np.float32) * 0.01 for l in leaves]
    g_leaves[0] = np.zeros_like(g_leaves[0])
    grads = jax.tree_util.tree_unflatten(treedef, g_leaves)
    lr = float(np.float32(0.05))

    bundle = jopt.build_tx(jcfg, params)

    @functools.partial(jax.jit, static_argnums=2)
    def updates(p, g, n):
        opt = bundle.tx.init(p)
        for _ in range(n):
            d, opt = bundle.tx.update(g, opt, p)
            p = jopt.apply_direction(p, d, jnp.float32(lr), bundle.lr_scales)
        return p, [s for s in opt if hasattr(s, "trace")][0].trace

    p_j, trace_j = (params_to_torch(jax.device_get(t)) for t in updates(params, grads, 2))

    tparams = {k: v.clone() for k, v in params_to_torch(params).items()}
    tgrads = params_to_torch(grads)
    tb = topt.build_tx(tcfg, tparams)
    state = tb.tx.init(tparams)
    for _ in range(2):
        d, state = tb.tx.update(tgrads, state, tparams)
        topt.apply_direction(tparams, d, lr, tb.lr_scales)

    # the second update again, resumed from JAX's first one: its params and
    # momentum trace cross the bridge (convert_train_state)
    p1, trace1 = jax.device_get(updates(params, grads, 1))
    conv = convert_train_state(p1, {}, momentum=trace1)
    rparams = conv["model"]
    d, rstate = tb.tx.update(tgrads, {"trace": conv["momentum"]}, rparams)
    topt.apply_direction(rparams, d, lr, tb.lr_scales)

    for k, v in p_j.items():
        for got, got_trace in ((tparams, state), (rparams, rstate)):
            assert rel_err(got[k], v) <= 1e-6, k
            assert rel_err(got_trace["trace"][k], trace_j[k]) <= 1e-5, k
    assert float(topt.global_grad_norm(tgrads)) == pytest.approx(
        float(jopt.global_grad_norm(grads)), rel=1e-6)
