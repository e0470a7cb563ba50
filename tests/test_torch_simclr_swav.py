"""The port's SimCLR and SwAV (advise_tpu_torch/engine/contrastive.py:
init_ssl_state, simclr_loss, sinkhorn, swav_loss; models/contrastive.py:
the SwAV prototypes) against the JAX package's, on
configs/chip/moco_knn_minik400.yaml cut to a Slow R10 (tests/
torch_port_common.py ``contrastive_cfg``) with the JAX state passed through
the param bridge. JAX's losses run with TPU.PARTITION_MODE 'auto' (one
device: the gathers and Sinkhorn's psums are identities).

Tolerances (float32): the loss 1e-4 relative; the gradients 1e-2 of the
largest gradient (tests/test_torch_byol.py); BN running statistics 1e-4;
Sinkhorn's codes 1e-5; the queue's rows and the kNN bank, unit vectors,
1e-3 of 1; ``swav_started`` equal. The 3-step trajectories at lr 1e-4
compare what each tensor MOVED (tests/test_torch_step.py): within 5e-2 of
the JAX move plus 1e-6 of the tree's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu.engine import contrastive as jc
from advise_tpu.models import build_model as jbuild_model
from advise_tpu_torch.engine import contrastive as tc
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.norm import commit_bn_stats
from advise_tpu_torch.utils.convert import batch_stats_to_torch, params_to_torch

from torch_port_common import (
    CON_B,
    CON_DIM,
    contrastive_cfg,
    contrastive_clips,
    contrastive_setup,
    contrastive_step_pair,
    moved_within,
    port_contrastive,
    rel_err,
)
from advise_tpu import config as jconfig
from advise_tpu_torch import config as tconfig

torch.set_num_threads(1)

LR = float(np.float32(1e-4))
SWAV_QUEUE = 8  # two steps of 4 videos fill it


def _jax_loss(jcfg, params, batch_stats, ssl, x, infos, key=0):
    """JAX's loss of cfg's type on clips ``x`` [B, K, ...] with its value,
    gradients, batch statistics, new SSL state and stats."""
    jcfg = jcfg.clone()
    jcfg.TPU.PARTITION_MODE = "auto"
    jm = jbuild_model(jcfg, sync_axes=())
    views = [jnp.asarray(x[:, i]) for i in range(x.shape[1])]
    algo = jc.CONTRASTIVE_LOSSES[jcfg.CONTRASTIVE.TYPE]

    def loss_fn(p, s):
        loss, bs, new_ssl, stats = algo(jcfg, jm, p, batch_stats, s, views, infos, jax.random.PRNGKey(key))
        return loss, (bs, new_ssl, stats)

    (loss, (bs, new_ssl, stats)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, ssl)
    return float(loss), jax.device_get(bs), jax.device_get(new_ssl), jax.device_get(g)


def _port_loss(tcfg, params, batch_stats, ssl, x, infos):
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    algo = tc.CONTRASTIVE_LOSSES[tcfg.CONTRASTIVE.TYPE]
    tinfos = {k: torch.as_tensor(np.asarray(v)) if k != "epoch_exact" else float(v) for k, v in infos.items()}
    loss, tssl, stats = algo(tcfg, model, tssl, torch.from_numpy(x).transpose(0, 1), tinfos,
                             torch.Generator().manual_seed(0))
    loss.backward()
    commit_bn_stats(model)
    return model, tssl, loss, stats


def _check_grads(model, g_j):
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_ref = params_to_torch(g_j)
    assert set(grads) == set(g_ref)
    top = max(float(v.abs().max()) for v in g_ref.values())
    for k, v in g_ref.items():
        assert float((grads[k] - v).abs().max()) <= 1e-2 * top, k


def _check_bn(model, bs_j):
    own = model.state_dict()
    for k, v in batch_stats_to_torch(bs_j).items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("ctype,queue", [("simclr", 0), ("swav", 0), ("swav", 3840)])
def test_init_ssl_state(ctype, queue):
    """No momentum encoder for simclr and swav; swav with SWAV_QEUE_LEN > 0
    a zero queue [2, SWAV_QEUE_LEN, DIM] and swav_started False (a bool
    tensor); the kNN bank; the same names, shapes and dtypes as JAX's; the
    prototypes [DIM, 1000] in the model, with lecun-normal's spread."""
    over = {"CONTRASTIVE.SWAV_QEUE_LEN": queue}
    jcfg, tcfg = contrastive_cfg(jconfig, ctype, **over), contrastive_cfg(tconfig, ctype, **over)
    model = build_model(tcfg, "cpu")
    ssl = tc.init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    jssl = jc.init_ssl_state(jcfg, {}, {}, jax.random.PRNGKey(0))
    assert set(ssl) == set(jssl)
    for name, v in jssl.items():
        assert tuple(ssl[name].shape) == v.shape and str(ssl[name].dtype).split(".")[1] == str(v.dtype), name
    if queue:
        assert not bool(ssl["queue_swav"].any()) and not bool(ssl["swav_started"])
    assert hasattr(model, "swav_prototypes") == (ctype == "swav")
    if ctype == "swav":
        w = model.swav_prototypes.detach()
        assert tuple(w.shape) == (CON_DIM, 1000)
        # truncated normal of std 1 / sqrt(DIM), at most two of the untruncated std out
        assert abs(float(w.std()) * CON_DIM ** 0.5 - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 / 0.87962566 / CON_DIM ** 0.5


@pytest.mark.parametrize("vmap", [True, False])
def test_simclr_loss_and_grads_match_jax(vmap):
    """NT-Xent over the two views' projections, as one batch with per-view
    BN (running statistics averaged) or one view after the other (chained):
    the loss, the gradients, the running statistics and the kNN bank."""
    jcfg, tcfg, params, batch_stats, ssl = contrastive_setup("simclr", **{"TPU.VMAP_VIEWS": vmap})
    x = contrastive_clips(2)
    infos = {"item_id": np.arange(CON_B, dtype=np.int32) * 5 + 2}
    loss_j, bs_j, ssl_j, g_j = _jax_loss(jcfg, params, batch_stats, ssl, x, infos)
    model, tssl, loss_t, stats = _port_loss(tcfg, params, batch_stats, ssl, x, infos)
    assert set(stats) == {"loss_simclr"}
    assert abs(loss_t.item() - loss_j) <= 1e-4 * abs(loss_j)
    _check_grads(model, g_j)
    _check_bn(model, bs_j)
    assert float((tssl["knn_mem"] - torch.from_numpy(np.array(ssl_j["knn_mem"]))).abs().max()) <= 1e-3


def test_sinkhorn_matches_jax_and_its_constraints():
    """The codes of JAX's one-device Sinkhorn to 1e-5; each sample's codes
    sum to 1, and three rounds bring the prototypes' shares closer to
    equal (1 / K of the batch each) than the raw scores have them."""
    rng = np.random.default_rng(0)
    for b, k in ((8, 1000), (12, 40)):
        scores = np.exp(rng.standard_normal((b, k)) * 3.0).astype(np.float32)
        want = np.asarray(jax.jit(lambda s: jc.sinkhorn(s, 3, ()))(jnp.asarray(scores)))
        got = tc.sinkhorn(torch.from_numpy(scores)).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
        spread_in = np.abs(scores.sum(0) / scores.sum() * k - 1).max()
        spread_out = np.abs(got.sum(0) / b * k - 1).max()
        assert spread_out < spread_in


def test_prototypes_are_straight_through_and_float32():
    """``prototypes``: the value proj @ w_n (columns normalized) and the
    gradient of proj @ w, against JAX's ``prototypes`` method; float32 out
    of a bf16 projection under autocast."""
    jcfg, tcfg = contrastive_cfg(jconfig, "swav"), contrastive_cfg(tconfig, "swav")
    jm = jbuild_model(jcfg, sync_axes=())
    rng = np.random.default_rng(1)
    w = rng.standard_normal((CON_DIM, 1000)).astype(np.float32)
    proj = rng.standard_normal((6, CON_DIM)).astype(np.float32)
    up = rng.standard_normal((6, 1000)).astype(np.float32)

    def f(w, proj):
        return jm.apply({"params": {"swav_prototypes": w}}, proj, method="prototypes")

    want, vjp = jax.vjp(f, jnp.asarray(w), jnp.asarray(proj))
    gw_j, gp_j = vjp(jnp.asarray(up))
    model = build_model(tcfg, "cpu")
    with torch.no_grad():
        model.swav_prototypes.copy_(torch.from_numpy(w))
    p = torch.from_numpy(proj).requires_grad_()
    out = model.prototypes(p)
    gw, gp = torch.autograd.grad(out, [model.swav_prototypes, p], torch.from_numpy(up))
    assert rel_err(out.detach(), want) <= 1e-5
    np.testing.assert_allclose(gw.numpy(), proj.T @ up, rtol=1e-4, atol=1e-4)  # identity to the raw weight
    assert rel_err(gw, gw_j) <= 1e-5 and rel_err(gp, gp_j) <= 1e-5
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert model.prototypes(p.bfloat16()).dtype == torch.float32


def _queue_state(kind, seed=4):
    """(SWAV queue [2, SWAV_QUEUE, DIM], swav_started, epoch_exact) of a
    case: 'shut' a full queue before epoch 15, 'filling' half a queue
    (its last row 0) past it, 'open' a started queue at epoch 15."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, SWAV_QUEUE, CON_DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if kind == "shut":
        return q, False, 14.0
    if kind == "filling":
        q[:, SWAV_QUEUE // 2:] = 0.0
        return q, False, 20.0
    return q, True, 15.0


@pytest.mark.parametrize("kind", ["none", "shut", "filling", "open"])
def test_swav_loss_matches_jax(kind):
    """The swapped CE over Sinkhorn codes, without the queue and with it
    shut (epoch < 15), filling (not started: its last row is 0) and open:
    the loss, the gradients, the running statistics, the queue after its
    roll and write, swav_started, the kNN bank and the ``swav_gate`` stat
    (open only in the 'open' case)."""
    over = {} if kind == "none" else {"CONTRASTIVE.SWAV_QEUE_LEN": SWAV_QUEUE}
    jcfg, tcfg, params, batch_stats, ssl = contrastive_setup("swav", **over)
    epoch = 0.0
    if kind != "none":
        q, started, epoch = _queue_state(kind)
        ssl = dict(ssl, queue_swav=q, swav_started=np.bool_(started))
    x = contrastive_clips(3)
    infos = {"item_id": np.arange(CON_B, dtype=np.int32) * 3 + 1, "epoch_exact": np.float32(epoch)}
    loss_j, bs_j, ssl_j, g_j = _jax_loss(jcfg, params, batch_stats, ssl, x, infos)
    model, tssl, loss_t, stats = _port_loss(tcfg, params, batch_stats, ssl, x, infos)
    assert set(stats) == ({"loss_swav"} if kind == "none" else {"loss_swav", "swav_gate"})
    assert abs(loss_t.item() - loss_j) <= 1e-4 * abs(loss_j)
    _check_grads(model, g_j)
    _check_bn(model, bs_j)
    names = ["knn_mem"] + (["queue_swav"] if kind != "none" else [])
    for name in names:
        assert float((tssl[name] - torch.from_numpy(np.array(ssl_j[name]))).abs().max()) <= 1e-3, name
    if kind != "none":
        assert bool(tssl["swav_started"]) == bool(ssl_j["swav_started"]) == (kind != "filling")
        assert tssl["swav_started"].dtype == torch.bool
        assert stats["swav_gate"].item() == float(kind == "open")


@pytest.mark.parametrize("ctype", ["simclr", "swav"])
def test_three_step_trajectory_matches_jax(ctype):
    """The contrastive step 3 times from the same state, the augmentation
    held apart, against JAX's jitted step: the loss and grad norm of each
    step, what each parameter and BN statistic moved, the kNN bank. SwAV
    runs with an 8-row queue at epoch 15.5: shut while two steps fill it,
    open at the third (``swav_started`` False, False, True, as in JAX, and
    the ``swav_gate`` stat with it)."""
    over = {"CONTRASTIVE.SWAV_QEUE_LEN": SWAV_QUEUE} if ctype == "swav" else {}
    jcfg, tcfg, params, batch_stats, ssl = contrastive_setup(ctype, **over)
    jstep, jstate, tstep, tstate = contrastive_step_pair(jcfg, tcfg, params, batch_stats, ssl)
    gen = torch.Generator().manual_seed(0)
    loss_name = f"loss_{ctype}"
    started = []
    for i in range(3):
        ids = np.arange(CON_B, dtype=np.int32) * 3 + i
        x = contrastive_clips(10 + i)
        jstate, jstats = jstep(jstate, jnp.asarray(x), {"item_id": ids}, jax.random.PRNGKey(i),
                               jnp.float32(LR), jnp.float32(15.5))
        tstats = tstep(tstate, torch.from_numpy(x), {"item_id": torch.from_numpy(ids).long()}, gen, LR, 15.5)
        assert set(tstats) == {loss_name, "grad_norm"} | ({"swav_gate"} if ctype == "swav" else set())
        assert abs(tstats[loss_name].item() - float(jstats[loss_name])) <= 1e-4 * abs(float(jstats[loss_name]))
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
        if ctype == "swav":
            started.append(bool(tstate.ssl["swav_started"]))
            assert started[-1] == bool(jstate.ssl["swav_started"])
            assert tstats["swav_gate"].item() == float(started[-1])
    if ctype == "swav":
        assert started == [False, False, True]
    jstate = jax.device_get(jstate)
    model = tstate.model
    own = model.state_dict()
    assert not moved_within(own, params_to_torch(jstate.params), params_to_torch(params))
    assert not moved_within(own, batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(batch_stats))
    names = ["knn_mem"] + (["queue_swav"] if ctype == "swav" else [])
    for name in names:
        assert float((tstate.ssl[name] - torch.from_numpy(np.array(jstate.ssl[name]))).abs().max()) <= 1e-3, name


def test_trainer_runs_swav_and_resumes_the_queue_bit_exactly(tmp_path):
    """SwAV through the trainer from SOLVER.START_EPOCH 15 with an 8-row
    queue: shut over epoch 15 while two iterations fill it, open in epoch
    16 (``epoch_exact`` reaches the gate); the run cut after epoch 15 and
    resumed EQUALS the run never cut: stats, model, queue and
    ``swav_started``, bit for bit; the kNN probe ran each epoch."""
    from torch_port_common import resume_matches_straight

    state, _, straight, _, saved = resume_matches_straight(
        tmp_path, "swav", ["queue_swav", "swav_started", "knn_mem"],
        **{"SOLVER.START_EPOCH": 15, "CONTRASTIVE.SWAV_QEUE_LEN": SWAV_QUEUE})
    assert set(state.ssl) == {"queue_swav", "swav_started", "knn_mem", "knn_labels"}
    assert not bool(saved["ssl"]["swav_started"]) and saved["ssl"]["swav_started"].dtype == torch.bool
    assert bool(state.ssl["swav_started"])
    assert all(set(st) == {"loss_swav", "swav_gate", "grad_norm"} for st in straight["stats"])
    assert [st["swav_gate"] for st in straight["stats"]] == [0.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("ctype", ["simclr", "swav", "mem"])
def test_step_with_a_predictor_the_loss_does_not_reach(ctype):
    """A config with CONTRASTIVE.PREDICTOR_DEPTHS (the BYOL presets) under
    simclr, swav or mem: the predictor gets zero gradients, as JAX's
    ``value_and_grad`` gives them, and the contrastive step runs."""
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.solver.optimizer import build_tx

    tcfg = contrastive_cfg(tconfig, ctype, **{"CONTRASTIVE.PREDICTOR_DEPTHS": [2]})
    model = build_model(tcfg, "cpu")
    ssl = tc.init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(contrastive_clips(7)).transpose(0, 1)
    infos = {"item_id": torch.arange(CON_B), "time_idx": torch.zeros(CON_B)}
    loss, ssl, _ = tc.CONTRASTIVE_LOSSES[ctype](tcfg, model, ssl, x, infos, torch.Generator().manual_seed(1))
    grads = tc.loss_grads(loss, dict(model.named_parameters()))
    pred = [n for n in grads if "predictor" in n]
    assert pred and all(not bool(grads[n].any()) for n in pred)
    assert any(bool(g.any()) for n, g in grads.items() if n not in pred)
    named = dict(model.named_parameters())
    bundle = build_tx(tcfg, named)
    state = TrainState(model, bundle.tx.init(named), 0, ssl)
    stats = make_train_step(tcfg, bundle, None)(state, torch.from_numpy(contrastive_clips(8)), infos,
                                                torch.Generator().manual_seed(2), 1e-3, 0.5)
    assert all(bool(torch.isfinite(v)) for v in stats.values())
