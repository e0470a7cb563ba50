"""The port's speed train step (advise_tpu_torch/engine/steps.py
``make_train_step`` for MODEL_NAME ResNet, TASK speed) against the JAX
package's ``make_train_step`` on a one-device mesh: a 3-step float32
trajectory of the Slow R10 speed preset with TPU.REMAT on, head dropout 0
and the augmentation held apart (``device_aug=None`` on both sides), from
the same initial state passed through the param bridge.

Tolerances. As in tests/test_torch_step.py the step compares what each
tensor MOVED: |port - jax| <= 1e-2 of max|jax - initial| plus 1e-6 of the
tree's largest value (float32 rounding of the stored values); measured
7.1e-4. The JAX float32 reference on XLA-CPU reduces sequentially, and a
trajectory amplifies that: at lr 1e-2 JAX drifts from a float64 run of
the port by 35 % of a tensor's move within 3 steps, while the port's
float32 run stays within 1.2e-4 of it. So the test runs at lr 1e-3, where
JAX stays within 1.3e-3. The loss (a BCE of order 1) and the accuracy are
held to 1e-4 absolute (measured 4e-6), the grad norm to 1e-3 relative
(measured 1e-5).

Dropout is held to its statistics (the torch generator cannot give JAX's
bits): over 2^16 values the kept share is within 0.01 of 1 - r (4 standard
deviations of the sampling noise are 0.007), every kept value is scaled by
exactly 1 / (1 - r), and eval mode is the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu.solver import lr_policy as jlr
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, ingest_geometry
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_train_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.heads import ResNetBasicHead
from advise_tpu_torch.ops import fused_aug
from advise_tpu_torch.solver import lr_policy as tlr
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import batch_stats_to_torch, params_to_torch

from torch_port_common import (
    SPEED_B,
    SPEED_K,
    SPEED_S,
    SPEED_T,
    on_mesh,
    speed_cfg,
    speed_variables,
)

torch.set_num_threads(1)

LR = float(np.float32(1e-3))
STEPS = 3


def _clips(i):
    rng = np.random.default_rng(200 + i)
    return rng.standard_normal((SPEED_B, SPEED_K, SPEED_T, SPEED_S, SPEED_S, 3)).astype(np.float32)


def _labels(i):
    return np.random.default_rng(300 + i).integers(0, 4, (SPEED_B, SPEED_K)).astype(np.int32)


def _port_state(tcfg, params, batch_stats):
    model = build_model(tcfg, "cpu")
    model.load_state_dict({**params_to_torch(params), **batch_stats_to_torch(batch_stats)})
    named = dict(model.named_parameters())
    bundle = build_tx(tcfg, named)
    return TrainState(model, bundle.tx.init(named), 0), bundle


def test_three_step_trajectory_matches_jax():
    jcfg = speed_cfg(jconfig, **{"TPU.REMAT": True})
    tcfg = speed_cfg(tconfig, **{"TPU.REMAT": True})
    mesh = build_mesh(jcfg, jax.devices()[:1])
    params, batch_stats = speed_variables(jbuild_model(jcfg, sync_axes=()))
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32)), mesh)
    tstate, tbundle = _port_state(tcfg, params, batch_stats)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tstep = make_train_step(tcfg, tbundle, None)
    for i in range(STEPS):
        jstate, jstats = jstep(jstate, jnp.asarray(_clips(i)), {"spd_label": _labels(i)},
                               jax.random.PRNGKey(i), jnp.float32(LR))
        tstats = tstep(tstate, torch.from_numpy(_clips(i)),
                       {"spd_label": torch.from_numpy(_labels(i))}, None, LR)
        assert set(tstats) == {"loss_spd", "acc_spd", "grad_norm"}
        for k in ("loss_spd", "acc_spd"):
            assert abs(tstats[k].item() - float(jstats[k])) <= 1e-4, (i, k)
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
    assert tstate.step == int(jstate.step) == STEPS
    assert tstate.ssl == {}

    jstate = jax.device_get(jstate)
    own = tstate.model.state_dict()
    trace = [s for s in jstate.opt_state if hasattr(s, "trace")][0].trace
    p0 = params_to_torch(params)
    checks = [
        (own, params_to_torch(jstate.params), p0),
        (own, batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(batch_stats)),
        (tstate.opt_state["trace"], params_to_torch(trace), {k: torch.zeros_like(v) for k, v in p0.items()}),
    ]
    for got, want, init in checks:
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            g, w, i0 = (np.asarray(a, np.float32) for a in (got[k].detach(), v, init[k]))
            err, bound = np.abs(g - w).max(), 1e-2 * np.abs(w - i0).max() + 1e-6 * top
            assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_head_dropout_statistics(rate):
    head = ResNetBasicHead(64, 4, dropout_rate=rate, act_func="none")
    x = torch.rand(1024, 64, 1, 1, 1) + 0.5
    pooled = x.mean(dim=(2, 3, 4))
    seen = {}

    def hook(module, inputs, output):
        seen["x"] = inputs[0]

    head.projection.register_forward_hook(hook)
    head.train()
    head([x], generator=torch.Generator().manual_seed(0))
    y = seen["x"]
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    torch.testing.assert_close(y[kept], (pooled / (1 - rate))[kept], rtol=0, atol=0)
    with pytest.raises(ValueError):
        head([x])  # a mask needs an explicit generator
    head.eval()
    head([x])
    assert torch.equal(seen["x"], pooled)


@pytest.mark.parametrize("after_warmup", [False, True])
def test_lr_policy_copy_matches_jax(after_warmup):
    """The port's lr policy is its own copy of the JAX package's: equal
    values over the warm-up and the cosine of two presets, with and without
    SOLVER.COSINE_AFTER_WARMUP, and over steps_with_relative_lrs."""
    for preset in ("configs/pretrain/SpeedPro_R50.yaml", "configs/pretrain/SlowFast_R50_K400.yaml"):
        jcfg, tcfg = jconfig.get_cfg(), tconfig.get_cfg()
        for cfg in (jcfg, tcfg):
            cfg.merge_from_file(preset)
            cfg.SOLVER.COSINE_AFTER_WARMUP = after_warmup
        for epoch in np.linspace(0.0, float(jcfg.SOLVER.MAX_EPOCH), 37):
            assert tlr.get_lr_at_epoch(tcfg, float(epoch)) == jlr.get_lr_at_epoch(jcfg, float(epoch))
    # steps_with_relative_lrs, under the same warm-up
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
        cfg.SOLVER.STEPS = [0, 60, 120]
        cfg.SOLVER.LRS = [1.0, 0.1, 0.01]
    for epoch in np.linspace(0.0, float(jcfg.SOLVER.MAX_EPOCH), 37):
        assert tlr.get_lr_at_epoch(tcfg, float(epoch)) == jlr.get_lr_at_epoch(jcfg, float(epoch))


def test_speed_step_with_device_aug_on_cpu():
    """The whole slice at a tiny size with SpeedPro's head dropout and
    REMAT: uint8 clips at the 'simple' ingest geometry through
    build_device_aug, the lr from the port's lr policy, two steps; finite
    stats, a moving model, and no kernel launch on the CPU."""
    tcfg = speed_cfg(tconfig, **{"TPU.REMAT": True, "MODEL.DROPOUT_RATE": 0.2})
    w, h = ingest_geometry(tcfg, "train")
    assert (w, h) == tuple(tcfg.AUG.RESIZE)
    model = build_model(tcfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    named = dict(model.named_parameters())
    bundle = build_tx(tcfg, named)
    state = TrainState(model, bundle.tx.init(named), 0)
    step = make_train_step(tcfg, bundle, build_device_aug(tcfg, "train"))
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.integers(0, 256, (SPEED_B, SPEED_K, SPEED_T, h, w, 3), dtype=np.uint8))
    infos = {"spd_label": torch.from_numpy(_labels(0))}
    gen = torch.Generator().manual_seed(0)
    launches = fused_aug.fused_simple_aug.launches
    lr = tlr.get_lr_at_epoch(tcfg, 0.5)
    for _ in range(2):
        stats = step(state, clips, infos, gen, lr)
        assert all(bool(torch.isfinite(v)) for v in stats.values())
    assert state.step == 2
    assert fused_aug.fused_simple_aug.launches == launches
    after = model.state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in before)
    assert callable(make_train_step(speed_cfg(tconfig, **{"TRAIN.SEQUENTIAL": True}), bundle, None))
