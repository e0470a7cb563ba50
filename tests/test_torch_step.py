"""The port's contrastive train step (advise_tpu_torch/engine/steps.py)
against the JAX package's ``make_contrastive_train_step`` on a one-device
mesh: a 3-step float32 trajectory with TPU.REMAT on and the augmentation
held apart (``device_aug=None`` on both sides), from the same initial
state passed through the param bridge. JAX runs its Pallas stem in
interpret mode.

Tolerances. The JAX reference is not exact in float32: XLA-CPU reduces
sequentially, and its BN statistics (mean of squares minus squared mean)
and conv gradients carry up to ~5e-3 relative error per tensor, measured
against a float64 run of the port (the port's own float32 error is ~5e-5).
At 4 clips per view the step is steep (grad norm ~2e3 at CONTRASTIVE.T
0.07), and a trajectory amplifies such differences, so the test uses a small
lr (1e-4) and compares what each tensor MOVED: |port - jax| <= 5e-2 of
max|jax - initial| (measured 2.3e-2) plus 1e-6 of the tree's largest
value, the float32 rounding of the stored values (measured 1e-4 of the move for the BN running
statistics, which a double update under REMAT would move by 100%). The loss
lies in [-2/T, 2/T] and is held to 1e-3 of 2/T (measured 1.3e-4 of it), the
grad norm to 1e-2 relative (measured 3e-3), the kNN bank to 5e-3 of its
largest entry (measured 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu import config as jconfig
from advise_tpu.engine.contrastive import init_ssl_state as jinit_ssl
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, ingest_geometry
from advise_tpu_torch.engine.contrastive import init_ssl_state
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_train_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.ops import stem_conv
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import (
    batch_stats_to_torch,
    convert_train_state,
    params_to_torch,
)

from torch_port_common import B, S, T, jax_variables, on_mesh, rel_err, small_cfg

torch.set_num_threads(1)

LR = float(np.float32(1e-4))
EPOCH = 1.0
STEPS = 3


def _moved_err(got, want, init, top):
    """max|got - want| and its bound: 5e-2 of what the tensor moved, plus
    1e-6 of ``top``, the largest value of its tree (float32 rounding)."""
    got, want, init = (np.asarray(a, np.float32) for a in (got, want, init))
    bound = 5e-2 * np.abs(want - init).max() + 1e-6 * top
    return float(np.abs(got - want).max()), float(bound)


def _clips(i):
    rng = np.random.default_rng(100 + i)
    return rng.standard_normal((B, 2, T, S, S, 3)).astype(np.float32)


def _item_ids(i):
    return np.arange(B, dtype=np.int32) * 5 + i


def _port_state(tcfg, params, batch_stats, ssl):
    conv = convert_train_state(params, batch_stats, ssl=ssl)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(conv["model"])
    tssl = init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    tssl["ema_model"].load_state_dict(conv["ema"])
    tssl["knn_mem"] = conv["knn_mem"].clone()
    bundle = build_tx(tcfg, dict(model.named_parameters()))
    state = TrainState(model, bundle.tx.init(dict(model.named_parameters())), 0, tssl)
    return state, bundle


def test_three_step_trajectory_matches_jax():
    jcfg = small_cfg(jconfig, remat=True)
    tcfg = small_cfg(tconfig, remat=True)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    params, batch_stats = jax_variables(jbuild_model(jcfg, sync_axes=()))
    ssl = jinit_ssl(jcfg, params, batch_stats, jax.random.PRNGKey(7))
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl=ssl), mesh)
    tstate, tbundle = _port_state(tcfg, params, batch_stats, jax.device_get(ssl))

    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tstep = make_train_step(tcfg, tbundle, None)
    loss_scale = 2.0 / tcfg.CONTRASTIVE.T
    for i in range(STEPS):
        infos = {"item_id": _item_ids(i), "time_idx": np.zeros(B, np.float32)}
        with pltpu.force_tpu_interpret_mode():
            jstate, jstats = jstep(jstate, jnp.asarray(_clips(i)), infos,
                                   jax.random.PRNGKey(i), jnp.float32(LR), jnp.float32(EPOCH))
        tstats = tstep(tstate, torch.from_numpy(_clips(i)),
                       {"item_id": torch.from_numpy(_item_ids(i)).long()}, None, LR, EPOCH)
        assert abs(tstats["loss_byol"].item() - float(jstats["loss_byol"])) <= 1e-3 * loss_scale, i
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-2)
    assert tstate.step == int(jstate.step) == STEPS

    jstate = jax.device_get(jstate)
    own = tstate.model.state_dict()
    ema = tstate.ssl["ema_model"].state_dict()
    trace = [s for s in jstate.opt_state if hasattr(s, "trace")][0].trace
    p0, bs0 = params_to_torch(params), batch_stats_to_torch(jax.device_get(batch_stats))
    zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
    checks = [
        (own, params_to_torch(jstate.params), p0),
        (own, batch_stats_to_torch(jstate.batch_stats), bs0),
        (ema, params_to_torch(jstate.ssl["ema_params"]), p0),
        (ema, batch_stats_to_torch(jstate.ssl["ema_batch_stats"]), bs0),
        (tstate.opt_state["trace"], params_to_torch(trace), zeros),
    ]
    for got, want, init in checks:
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            err, bound = _moved_err(got[k].detach(), v, init[k], top)
            assert err <= bound, (k, err, bound)
    assert rel_err(tstate.ssl["knn_mem"], jstate.ssl["knn_mem"]) <= 5e-3


def test_bn_statistics_move_once_per_step_under_remat():
    """torch.utils.checkpoint recomputes the forward in the backward; the
    running statistics must still move once: the same step with REMAT on and
    off leaves the same state."""
    results = []
    for remat in (False, True):
        tcfg = small_cfg(tconfig, remat=remat)
        model = build_model(tcfg, "cpu", seed=3)
        ssl = init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
        bundle = build_tx(tcfg, dict(model.named_parameters()))
        state = TrainState(model, bundle.tx.init(dict(model.named_parameters())), 0, ssl)
        make_train_step(tcfg, bundle, None)(
            state, torch.from_numpy(_clips(0)), {"item_id": torch.arange(B)}, None, LR, EPOCH)
        results.append(model.state_dict())
    off, on = results
    for k in off:
        torch.testing.assert_close(on[k], off[k], rtol=1e-5, atol=1e-6, msg=k)
    m = 0.1  # one momentum-0.1 update from the initial (0, 1)
    mean = off["backbone.s1_fast.bn.running_mean"]
    assert float(mean.abs().max()) > 0
    assert float((off["backbone.s1_fast.bn.running_var"] - (1 - m)).min()) > 0


def test_step_with_device_aug_on_cpu():
    """The whole slice at a tiny size: uint8 clips at the 'aa' ingest
    geometry through build_device_aug and two steps; finite loss and grad
    norm, and no kernel launch on the CPU."""
    tcfg = small_cfg(tconfig, remat=True)
    w, h = ingest_geometry(tcfg, "train")
    assert (w, h) == (S * 4 // 3, S)
    model = build_model(tcfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    ssl = init_ssl_state(tcfg, model, gen)
    bundle = build_tx(tcfg, dict(model.named_parameters()))
    state = TrainState(model, bundle.tx.init(dict(model.named_parameters())), 0, ssl)
    step = make_train_step(tcfg, bundle, build_device_aug(tcfg, "train"))
    clips = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (B, 2, T, h, w, 3), dtype=np.uint8))
    launches = (stem_conv.stem_conv_fwd.launches, stem_conv.stem_conv_wgrad.launches)
    for _ in range(2):
        stats = step(state, clips, {"item_id": torch.arange(B)}, gen, LR, EPOCH)
        assert torch.isfinite(stats["loss_byol"]) and torch.isfinite(stats["grad_norm"])
    assert state.step == 2
    assert (stem_conv.stem_conv_fwd.launches, stem_conv.stem_conv_wgrad.launches) == launches
