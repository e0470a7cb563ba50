"""The port's AdViSe step (advise_tpu_torch/engine/steps.py
``make_tmodeling_train_step``) against the JAX package's
``make_tmodeling_train_step`` on a one-device mesh: 3-step float32
trajectories of AdViSe.yaml cut to CPU size (tests/torch_port_common.py
``tm_cfg``: the R3D temporal ResStage with BN, the MLP heads), from the same
initial state passed through the param bridge, the augmentation held apart
(``device_aug=None`` on both sides). Cases: SSL.TASK speed and speed_byol,
SSL.BN_MLP on and off, TM.FROM_SCRATCH on and off.

What is held, after every step:

- the stats (loss_spd, acc_spd, loss_byol) to 1e-4 absolute, the grad norm
  to 1e-3 relative;
- the BN running statistics to 1e-4 of their largest magnitude: with
  BN_MLP the projector's and predictor's statistics move twice a step
  (view 0, then view 1 on top), as JAX threads its batch_stats; a single
  commit of the last call would miss the first move by ~m * |batch - old|,
  above the bound;
- the frozen tower (FROM_SCRATCH off) bit-identical to its initial values
  on both sides.

After the 3 steps, the parameters and the BYOL twins compare what each
tensor MOVED, at lr 1e-4: ||port - jax|| <= 5e-2 ||jax - initial|| plus
1e-6 of the tree's largest value per element (float32 rounding of the
stored values; the twins move by 1 - m = 0.007 of the online moves, near
that floor), in the 2-norm over the tensor: AdamW's direction mu / sqrt(nu)
turns a small gradient element's float32 noise into a step of its own, so
single elements stray further (the largest measured: 0.56 of the tensor's
largest move) while the 2-norm holds (measured <= 0.033). Four kinds of
tensor have a gradient that is zero in exact arithmetic, so both sides
step on float32 noise: an attention key's bias (softmax cancels the shift
it adds to a query's logits), the tower's ln_post bias (the train-mode BN
after the temporal ResStage's first convs removes a constant shift of the
tokens), with BN_MLP, the projector's last bias (the predictor's first
Linear and BN remove it; its twin copies it) and, with BN_MLP under the
video_swin head, its last block's MLP bias (it shifts every token alike,
and each head's first Linear and BN remove the shift). Those are held to
the step's own bound: each side moved by at most 2 STEPS lr.

Four videos a view: BN over two samples (B 2) makes the heads' gradient
scale with 1 / |a - b| per channel, which turns float32 noise into a 0.4 %
grad norm difference within 3 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import init_tmodeling_ssl as jinit_ssl
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import init_tmodeling_ssl, make_train_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import batch_stats_to_torch, flax_to_state_dict, params_to_torch

from torch_port_common import TM_B, TM_K, TM_S, TM_SWIN, TM_T, on_mesh, tm_cfg, tm_variables

torch.set_num_threads(1)

LR = float(np.float32(1e-4))
STEPS = 3


def _clips(i, t=TM_T, s=TM_S):
    """Noise clips, each scaled and offset on its own, so that their pooled
    features differ from clip to clip as videos' do."""
    rng = np.random.default_rng(500 + i)
    x = rng.standard_normal((TM_B, TM_K, t, s, s, 3))
    x = x * rng.uniform(0.25, 2.0, (TM_B, TM_K, 1, 1, 1, 1)) + rng.standard_normal((TM_B, TM_K, 1, 1, 1, 3))
    return x.astype(np.float32)


def _labels(i):
    return np.random.default_rng(600 + i).integers(0, 4, (TM_B, TM_K)).astype(np.int32)


_ZERO_GRAD = ("attn.key.bias", "spatial_encoder.ln_post.bias")


def _moved_ok(got, want, init, lr, zero_grad=()):
    """(name, error, bound) of the tensors outside the trajectory bound
    (module docstring); ``zero_grad`` names more tensors of the zero-gradient
    kind."""
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    bad = []
    for k, v in want.items():
        g, w, i0 = (np.asarray(a, np.float64) for a in (got[k].detach(), v, init[k]))
        if k.endswith(_ZERO_GRAD + tuple(zero_grad)):
            err = max(np.abs(g - i0).max(), np.abs(w - i0).max())
            bound = 2 * STEPS * lr
        else:
            err = np.linalg.norm(g - w)
            bound = 5e-2 * np.linalg.norm(w - i0) + 1e-6 * top * np.sqrt(w.size)
        if err > bound:
            bad.append((k, float(err), float(bound)))
    return bad


@pytest.mark.parametrize("from_scratch", [False, True])
@pytest.mark.parametrize("bn_mlp", [True, False])
@pytest.mark.parametrize("task", ["speed", "speed_byol"])
def test_three_step_trajectory_matches_jax(task, bn_mlp, from_scratch):
    _trajectory(task, bn_mlp, from_scratch)


def test_video_swin_speed_byol_trajectory_matches_jax():
    """The same 3 steps with the video_swin temporal head (TM_SWIN: its
    windows pad and shift), SSL.TASK speed_byol with the preset's BN heads
    (SSL.BN_MLP on), so the BYOL twin of the Swin layer runs through
    functional_call; the bounds above."""
    _trajectory("speed_byol", True, False, TM_SWIN)


def _trajectory(task, bn_mlp, from_scratch, extra=None):
    over = {"SSL.TASK": task, "SSL.BN_MLP": bn_mlp, "TM.FROM_SCRATCH": from_scratch, **(extra or {})}
    jcfg, tcfg = tm_cfg(jconfig, **over), tm_cfg(tconfig, **over)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    t, s = tcfg.DATA.NUM_FRAMES, tcfg.AUG.TARGET_SIZE
    params, batch_stats = tm_variables(jbuild_model(jcfg, sync_axes=()), t=t, s=s)
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl=jinit_ssl(jcfg, params)), mesh)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(flax_to_state_dict(params, batch_stats))
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0, init_tmodeling_ssl(tcfg, model))
    tower0 = {k: v.clone() for k, v in model.spatial_encoder.state_dict().items()}
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tstep = make_train_step(tcfg, tbundle, None)
    keys = ({"loss_spd", "acc_spd"} if "speed" in task else set()) | (
        {"loss_byol"} if "byol" in task else set())
    for i in range(STEPS):
        jstate, jstats = jstep(jstate, jnp.asarray(_clips(i, t, s)), {"spd_label": _labels(i)},
                               jax.random.PRNGKey(i), jnp.float32(LR))
        tstats = tstep(tstate, torch.from_numpy(_clips(i, t, s)),
                       {"spd_label": torch.from_numpy(_labels(i))}, None, LR)
        assert set(tstats) == set(keys) | {"grad_norm"}
        for k in keys:
            assert abs(tstats[k].item() - float(jstats[k])) <= 1e-4, (i, k)
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
        want_bs = batch_stats_to_torch(jax.device_get(jstate.batch_stats))
        own = model.state_dict()
        top = max((float(v.abs().max()) for v in want_bs.values()), default=0.0)
        for k, v in want_bs.items():
            assert float((own[k] - v).abs().max()) <= 1e-4 * top, (i, k)
    assert tstate.step == int(jstate.step) == STEPS

    jstate = jax.device_get(jstate)
    p0 = params_to_torch(params)
    last_bias = f"head_projector.mlp.fc{tcfg.SSL.NUM_MLP_LAYERS - 1}.bias"
    zero_grad = (last_bias,) if bn_mlp and "byol" in task else ()
    if bn_mlp and tcfg.TM.TEMPORAL_ARCH == "video_swin":
        zero_grad += (f"temporal_encoder.layer.blocks_{tcfg.TM.NUM_BLOCKS - 1}.mlp.fc2.bias",)
    bad = _moved_ok(model.state_dict(), params_to_torch(jstate.params), p0, LR, zero_grad)
    assert not bad, bad
    if "byol" in task:
        for twin, name in (("ema_temporal", "temporal_encoder"), ("ema_projector", "head_projector")):
            init = params_to_torch(params[name])
            want = params_to_torch(jstate.ssl[twin])
            assert set(tstate.ssl[twin]) == set(want)
            bad = _moved_ok(tstate.ssl[twin], want, init, LR,
                            tuple(z.split(".", 1)[1] for z in zero_grad if z.startswith(name)))
            assert not bad, (twin, bad)
            assert any(not torch.equal(tstate.ssl[twin][k], init[k]) for k in init)  # the twins moved
    else:
        assert tstate.ssl == {}
    tower = model.spatial_encoder.state_dict()
    if not from_scratch:
        for k, v in tower0.items():
            assert torch.equal(tower[k], v), k
        jt = params_to_torch(jstate.params["spatial_encoder"])
        for k, v in params_to_torch(params["spatial_encoder"]).items():
            assert torch.equal(jt[k], v), k
    else:
        assert any(not torch.equal(tower[k], v) for k, v in tower0.items())


def test_bn_called_twice_commits_both_in_order():
    """A SyncBatchNorm called twice in one step folds both records, in call
    order; a forward recomputed under torch.utils.checkpoint records
    nothing."""
    from torch.utils.checkpoint import checkpoint

    from advise_tpu_torch.models.layers.norm import SyncBatchNorm, commit_bn_stats

    bn = SyncBatchNorm(3).train()
    x0, x1 = torch.randn(8, 3) * 2 + 1, torch.randn(8, 3) - 1
    y = checkpoint(bn, x0.requires_grad_(), use_reentrant=False)
    (y.sum() + bn(x1).sum()).backward()
    assert len(bn.pending) == 2
    commit_bn_stats(bn)
    m = bn.momentum
    want = torch.zeros(3)
    for x in (x0, x1):
        want = (1 - m) * want + m * x.detach().mean(0)
    torch.testing.assert_close(bn.running_mean, want, rtol=1e-6, atol=1e-7)
    assert bn.pending == []
