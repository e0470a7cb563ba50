"""The port's sequential paths against the JAX package's:
CONTRASTIVE.SEQUENTIAL (advise_tpu_torch/engine/contrastive.py
``sequential_contrastive_grads``: keys of every clip once, then one query
forward and backward per clip) for BYOL and MoCo, on
configs/chip/moco_knn_minik400.yaml cut to a Slow R10 (tests/
torch_port_common.py ``contrastive_cfg``), and TRAIN.SEQUENTIAL (one clip
of each video at a time through the task step, engine/steps.py) on the
Slow R10 speed preset of tests/test_torch_speed_step.py.

Tolerances (float32): losses 1e-4 relative; gradients 1e-2 of the largest
gradient; BN running statistics 1e-4; the queue and the kNN bank (unit
vectors) 1e-3 of 1, the pointer equal. The port's summed per-clip BYOL
gradients equal its batched symmetric loss's within 1e-4 of the largest
(the same arithmetic in another order). The speed step at lr 1e-3: what
each tensor moved within 5e-2 of JAX's move plus 1e-6 of the tree's
largest value (see the test for why not 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine import contrastive as jc
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine import contrastive as tc
from advise_tpu_torch.engine import steps as tsteps
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_contrastive_train_step, make_train_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.norm import commit_bn_stats
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import batch_stats_to_torch, params_to_torch

from torch_port_common import (
    CON_B,
    SPEED_B,
    SPEED_K,
    SPEED_S,
    SPEED_T,
    contrastive_cfg,
    contrastive_clips,
    contrastive_setup,
    moved_within,
    on_mesh,
    port_contrastive,
    speed_cfg,
    speed_variables,
)

torch.set_num_threads(1)

BYOL = {"CONTRASTIVE.PREDICTOR_DEPTHS": [2], "MODEL.DROPOUT_RATE": 0.0}
SEQ = {"CONTRASTIVE.SEQUENTIAL": True}


def _jax_sequential(jcfg, params, batch_stats, ssl, x, infos):
    jcfg = jcfg.clone()
    jcfg.TPU.PARTITION_MODE = "auto"
    jm = jbuild_model(jcfg, sync_axes=())
    views = [jnp.asarray(x[:, i]) for i in range(x.shape[1])]
    out = jax.jit(lambda p, s: jc.sequential_contrastive_grads(jcfg, jm, p, batch_stats, s, views, infos,
                                                                jax.random.PRNGKey(0)))(params, ssl)
    return jax.device_get(out)


def _check(model, tssl, g_t, g_j, bs_j, ssl_j, names):
    g_ref = params_to_torch(g_j)
    assert set(g_t) == set(g_ref)
    top = max(float(v.abs().max()) for v in g_ref.values())
    for k, v in g_ref.items():
        assert float((g_t[k] - v).abs().max()) <= 1e-2 * top, k
    commit_bn_stats(model)
    own = model.state_dict()
    for k, v in batch_stats_to_torch(bs_j).items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
    commit_bn_stats(tssl["ema_model"])
    ema = tssl["ema_model"].state_dict()
    for k, v in batch_stats_to_torch(ssl_j["ema_batch_stats"]).items():
        np.testing.assert_allclose(ema[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
    for name in names:
        assert float((tssl[name] - torch.from_numpy(np.array(ssl_j[name]))).abs().max()) <= 1e-3, name


@pytest.mark.parametrize("n_clips", [2, 3])
def test_sequential_byol_grads_match_jax(n_clips):
    """BYOL under CONTRASTIVE.SEQUENTIAL with 2 and 3 clips: the summed
    gradients, loss_partial (the summed loss / 2n), the online model's BN
    statistics chained clip by clip, the momentum encoder's from the keys,
    and the kNN bank holding the LAST clip's projection."""
    over = {**BYOL, **SEQ, "DATA.NUM_CLIP": n_clips}
    jcfg, tcfg, params, batch_stats, ssl = contrastive_setup("byol", **over)
    x = contrastive_clips(1, k=n_clips)
    infos = {"item_id": np.arange(CON_B, dtype=np.int32) * 2 + 1}
    g_j, loss_j, bs_j, ssl_j, stats_j = _jax_sequential(jcfg, params, batch_stats, ssl, x, infos)
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    tinfos = {"item_id": torch.from_numpy(infos["item_id"]).long()}
    g_t, tssl, stats = tc.sequential_contrastive_grads(
        tcfg, model, tssl, torch.from_numpy(x).transpose(0, 1), tinfos, torch.Generator().manual_seed(0))
    assert set(stats) == {"loss_byol"}
    assert abs(float(stats["loss_byol"]) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    _check(model, tssl, g_t, g_j, bs_j, ssl_j, ["knn_mem"])
    # the bank's rows are the last clip's projection, not the first's
    proj_last = tc.l2_normalize(tc._proj(model(torch.from_numpy(x[:, -1]))))
    np.testing.assert_allclose(tssl["knn_mem"][tinfos["item_id"]].detach().numpy(),
                               proj_last.detach().numpy(), atol=1e-3)


def test_sequential_byol_equals_the_batched_gradient():
    """With 2 clips the summed per-clip gradients are the batched symmetric
    loss's (TPU.VMAP_VIEWS off, no dropout), and loss_partial is the
    batched loss / 4 (the reference's logging scale)."""
    _, tcfg, params, batch_stats, ssl = contrastive_setup("byol", **BYOL, **{"TPU.VMAP_VIEWS": False})
    x = torch.from_numpy(contrastive_clips(2)).transpose(0, 1)
    infos = {"item_id": torch.arange(CON_B)}
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    g_seq, _, stats = tc.sequential_contrastive_grads(tcfg, model, tssl, x, infos, None)
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    loss, _, _ = tc.byol_loss(tcfg, model, tssl, x, infos, None)
    g_bat = dict(zip(dict(model.named_parameters()), torch.autograd.grad(loss, list(model.parameters()))))
    top = max(float(v.abs().max()) for v in g_bat.values())
    assert all(float((g_seq[k] - v).abs().max()) <= 1e-4 * top for k, v in g_bat.items())
    assert float(stats["loss_byol"]) == pytest.approx(loss.item() / 4.0, rel=1e-5)


def test_sequential_moco_matches_jax():
    """MoCo under CONTRASTIVE.SEQUENTIAL: the summed gradients over
    [positive, queue] logits, the enqueue after the loop (view 0's keys at
    the pointer), the pointer, and the last clip's kNN write. BN.NORM_TYPE
    batchnorm: JAX's loss outside shard_map has no shuffle-BN, and its keys
    then run as one vmapped batch (the momentum encoder's running
    statistics averaged over the views), as the port's do without it."""
    jcfg, tcfg, params, batch_stats, ssl = contrastive_setup("moco", **SEQ, **{"BN.NORM_TYPE": "batchnorm"})
    assert not tc.shuffle_bn_on(tcfg)
    x = contrastive_clips(3)
    infos = {"item_id": np.arange(CON_B, dtype=np.int32) * 3}
    g_j, loss_j, bs_j, ssl_j, stats_j = _jax_sequential(jcfg, params, batch_stats, ssl, x, infos)
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    g_t, tssl, stats = tc.sequential_contrastive_grads(
        tcfg, model, tssl, torch.from_numpy(x).transpose(0, 1),
        {"item_id": torch.from_numpy(infos["item_id"]).long()}, torch.Generator().manual_seed(0))
    assert set(stats) == {"loss_nce"}
    assert abs(float(stats["loss_nce"]) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert int(tssl["ptr"]) == int(ssl_j["ptr"]) == CON_B
    _check(model, tssl, g_t, g_j, bs_j, ssl_j, ["queue_x", "knn_mem"])


def test_contrastive_sequential_step_runs_with_the_same_dropout_masks(monkeypatch):
    """The contrastive step under SEQUENTIAL with head dropout: every clip's
    query forward starts from the same generator state (JAX reuses one
    key), the step moves the model, and its stats are finite."""
    _, tcfg, params, batch_stats, ssl = contrastive_setup("byol", **{**BYOL, **SEQ, "MODEL.DROPOUT_RATE": 0.5})
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    states = []
    forward = type(model).forward

    def recording(self, x, views=1, generator=None):
        if torch.is_grad_enabled():
            states.append(generator.get_state().clone())
        return forward(self, x, views, generator)

    monkeypatch.setattr(type(model), "forward", recording)
    named = dict(model.named_parameters())
    bundle = build_tx(tcfg, named)
    state = TrainState(model, bundle.tx.init(named), 0, tssl)
    before = {k: v.clone() for k, v in named.items()}
    stats = make_train_step(tcfg, bundle, None)(state, torch.from_numpy(contrastive_clips(4)),
                                                {"item_id": torch.arange(CON_B)}, torch.Generator().manual_seed(1),
                                                1e-2, 0.5)
    assert len(states) == 2 and torch.equal(states[0], states[1])
    assert all(bool(torch.isfinite(v)) for v in stats.values()) and set(stats) == {"loss_byol", "grad_norm"}
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())


@pytest.mark.parametrize("ctype", ["simclr", "swav", "mem"])
def test_sequential_refused_for_other_types(ctype):
    """CONTRASTIVE.SEQUENTIAL with simclr, swav or mem: both configs refuse
    it, as JAX's does; a config that skipped the check is refused by the
    step."""
    for mod in (jconfig, tconfig):
        with pytest.raises(AssertionError, match="SEQUENTIAL"):
            contrastive_cfg(mod, ctype, **SEQ)
    cfg = contrastive_cfg(tconfig, ctype)
    cfg.CONTRASTIVE.SEQUENTIAL = True
    with pytest.raises(ValueError, match="SEQUENTIAL"):
        make_contrastive_train_step(cfg, None, None)


SEQ_B = 4  # videos: a clip of 2 alone leaves res5's BN 8 values, where float32 strays 0.5 % from float64


def _clips(i, b=SPEED_B):
    return np.random.default_rng(400 + i).standard_normal(
        (b, SPEED_K, SPEED_T, SPEED_S, SPEED_S, 3)).astype(np.float32)


def _labels(i, b=SPEED_B):
    return np.random.default_rng(500 + i).integers(0, 4, (b, SPEED_K)).astype(np.int32)


def test_train_sequential_speed_step_matches_jax():
    """TRAIN.SEQUENTIAL on the speed step (REMAT on) against JAX's
    sequential step, 4 videos x 2 clips: each clip alone with its slice of
    spd_label, the gradients summed and divided by K, the BN statistics
    chained, the stats averaged over the clips: the loss and accuracy, the
    grad norm, what each parameter, BN statistic and momentum buffer
    moved, within 5e-2 of JAX's move (the trajectories' bound). One step:
    with one clip of 4 videos a BN, JAX's float32 gradients on XLA-CPU are
    up to 3.2e-2 (the stem) from a float64 run of the port, whose own
    float32 run stays within 1.1e-5 of it, and a trajectory grows that
    (ROADMAP.md §C)."""
    over = {"TRAIN.SEQUENTIAL": True, "TPU.REMAT": True}
    jcfg, tcfg = speed_cfg(jconfig, **over), speed_cfg(tconfig, **over)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    params, batch_stats = speed_variables(jbuild_model(jcfg, sync_axes=()))
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32)), mesh)
    model = build_model(tcfg, "cpu")
    model.load_state_dict({**params_to_torch(params), **batch_stats_to_torch(batch_stats)})
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    lr = float(np.float32(1e-3))
    clips, labels = _clips(0, SEQ_B), _labels(0, SEQ_B)
    jstate, jstats = jstep(jstate, jnp.asarray(clips), {"spd_label": labels}, jax.random.PRNGKey(0),
                           jnp.float32(lr))
    tstats = make_train_step(tcfg, tbundle, None)(tstate, torch.from_numpy(clips),
                                                  {"spd_label": torch.from_numpy(labels)},
                                                  torch.Generator().manual_seed(0), lr)
    assert set(tstats) == {"loss_spd", "acc_spd", "grad_norm"}
    for k in ("loss_spd", "acc_spd"):
        assert abs(tstats[k].item() - float(jstats[k])) <= 1e-4, k
    assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
    jstate = jax.device_get(jstate)
    own = model.state_dict()
    trace = [s for s in jstate.opt_state if hasattr(s, "trace")][0].trace
    p0 = params_to_torch(params)
    assert not moved_within(own, params_to_torch(jstate.params), p0)
    assert not moved_within(own, batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(batch_stats))
    assert not moved_within(tstate.opt_state["trace"], params_to_torch(trace),
                            {k: torch.zeros_like(v) for k, v in p0.items()})


def test_train_sequential_draws_the_same_dropout_masks(monkeypatch):
    """With head dropout every clip's loss starts from the same generator
    state (after the aug's draws), as JAX reuses one key for every clip;
    the per-clip infos are [B, 1] slices."""
    tcfg = speed_cfg(tconfig, **{"TRAIN.SEQUENTIAL": True, "MODEL.DROPOUT_RATE": 0.5})
    seen = []
    loss = tsteps.TASK_LOSSES["speed"]

    def recording(cfg, model, clips, infos, generator):
        seen.append((generator.get_state().clone(), tuple(infos["spd_label"].shape), clips.shape[1]))
        return loss(cfg, model, clips, infos, generator)

    monkeypatch.setitem(tsteps.TASK_LOSSES, "speed", recording)
    model = build_model(tcfg, "cpu")
    named = dict(model.named_parameters())
    bundle = build_tx(tcfg, named)
    state = TrainState(model, bundle.tx.init(named), 0)
    stats = make_train_step(tcfg, bundle, None)(state, torch.from_numpy(_clips(0)),
                                                {"spd_label": torch.from_numpy(_labels(0))},
                                                torch.Generator().manual_seed(0), 1e-3)
    assert len(seen) == SPEED_K and all(torch.equal(s[0], seen[0][0]) for s in seen)
    assert all(s[1:] == ((SPEED_B, 1), 1) for s in seen)
    assert all(bool(torch.isfinite(v)) for v in stats.values())
