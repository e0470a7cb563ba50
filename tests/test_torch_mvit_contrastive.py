"""ContrastiveModel over MViT in the port against the JAX package: LARS
over a reversible MViT's stacked segments, the model's forward, and one
contrastive step under LARS-SGD.

Tolerances: the LARS direction within 1e-5 of optax's, relative to each
tensor's largest value (the same float32 norms summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from advise_tpu import config as jconfig
from advise_tpu_torch import config as tconfig
from torch_port_common import MVC_B, MVC_S, MVC_T, mvit_con_cfg, rel_err

torch.set_num_threads(1)


def _jax_params(cfg, seed=0):
    from advise_tpu.models import build_model as jbuild_model

    model = jbuild_model(cfg, sync_axes=())
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, MVC_T, MVC_S, MVC_S, 3), jnp.float32), train=False))()
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def test_lars_over_reversible_mvit_matches_optax():
    """One LARS-SGD direction (wd, trust ratio, momentum) on a reversible
    MViT's tree: JAX stacks each segment's blocks on one leaf, so the norms
    run over the stack and the stacked LayerNorm scales get a ratio; the
    port's per-block parameters must give optax's direction."""
    from advise_tpu.solver import build_tx as jbuild_tx
    from advise_tpu_torch.solver.optimizer import build_tx
    from advise_tpu_torch.utils.convert import params_to_torch

    jcfg, tcfg = mvit_con_cfg(jconfig), mvit_con_cfg(tconfig)
    params, _ = _jax_params(jcfg)
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32), params)
    bundle = jbuild_tx(jcfg, params)
    state = bundle.tx.init(params)
    for _ in range(2):
        direction, state = bundle.tx.update(grads, state, params)
    want = params_to_torch(jax.device_get(direction))
    tparams, tgrads = params_to_torch(params), params_to_torch(grads)
    tbundle = build_tx(tcfg, tparams)
    tstate = tbundle.tx.init(tparams)
    for _ in range(2):
        got, tstate = tbundle.tx.update(tgrads, tstate, tparams)
    assert set(got) == set(want)
    assert any(".rev_seg0_f.1." in n for n in want)  # a segment of 2 blocks
    bad = {n: rel_err(got[n].numpy(), want[n].numpy()) for n in want}
    assert max(bad.values()) <= 1e-5, sorted(bad.items(), key=lambda kv: -kv[1])[:5]


def test_contrastive_mvit_forward_matches_jax():
    """ContrastiveModel over the reversible MViT in training, two views of 2
    videos: JAX applies each view alone (its head's BN statistics over that
    view), the port takes both with ``views=2``; the projections agree to
    1e-4 of the largest value."""
    from advise_tpu.models import build_model as jbuild_model
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.utils.convert import flax_to_state_dict

    jcfg, tcfg = mvit_con_cfg(jconfig), mvit_con_cfg(tconfig)
    params, batch_stats = _jax_params(jcfg)
    x = np.random.default_rng(2).standard_normal((2, MVC_B, MVC_T, MVC_S, MVC_S, 3)).astype(np.float32)
    jm = jbuild_model(jcfg, sync_axes=())
    apply = jax.jit(lambda v: jm.apply({"params": params, "batch_stats": batch_stats}, v, train=True,
                                       mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})[0])
    want = np.concatenate([np.asarray(apply(jnp.asarray(x[i]))) for i in range(2)])
    model = build_model(tcfg, "cpu")
    assert type(model.backbone).__name__ == "MViT" and hasattr(model.backbone, "rev_seg0_f")
    model.load_state_dict(flax_to_state_dict(params, batch_stats))
    got = model.train()(torch.from_numpy(x.reshape(2 * MVC_B, *x.shape[2:])), 2, torch.Generator().manual_seed(0))
    assert got.shape == (2 * MVC_B, 16)
    assert rel_err(got.detach().numpy(), want) <= 1e-4


def test_moco_step_over_reversible_mvit_under_lars_matches_jax():
    """One contrastive step of the BYOL preset's recipe (LARS-SGD, 2 views,
    the momentum encoder) over the reversible MViT, the augmentation held
    apart, against JAX's jitted step at lr 1e-4 (tests/test_torch_step.py's
    scheme): the loss and grad norm, and what each parameter, BN statistic
    and the momentum encoder moved, within 5e-2 of JAX's move. BYOL itself
    needs a predictor, which neither package's MViT head carries (JAX's
    ``byol_loss`` asserts, the port's raises), so the step runs MoCo, the
    other algorithm with a momentum encoder."""
    import pytest

    from advise_tpu.engine import contrastive as jc
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.solver.optimizer import build_tx
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine import contrastive as tc
    from advise_tpu_torch.utils.convert import batch_stats_to_torch, params_to_torch
    from torch_port_common import contrastive_step_pair, moved_within

    lr = float(np.float32(1e-4))
    jcfg, tcfg = mvit_con_cfg(jconfig, **{"CONTRASTIVE.TYPE": "moco"}), mvit_con_cfg(tconfig, **{"CONTRASTIVE.TYPE": "moco"})
    params, batch_stats = _jax_params(jcfg)
    ssl = jax.device_get(jc.init_ssl_state(jcfg, params, batch_stats, jax.random.PRNGKey(3)))
    jstep, jstate, tstep, tstate = contrastive_step_pair(jcfg, tcfg, params, batch_stats, ssl)
    x = np.random.default_rng(4).standard_normal((MVC_B, 2, MVC_T, MVC_S, MVC_S, 3)).astype(np.float32)
    ids = np.arange(MVC_B, dtype=np.int32)
    jstate, jstats = jstep(jstate, jnp.asarray(x), {"item_id": ids}, jax.random.PRNGKey(0),
                           jnp.float32(lr), jnp.float32(0.5))
    tstats = tstep(tstate, torch.from_numpy(x), {"item_id": torch.from_numpy(ids).long()},
                   torch.Generator().manual_seed(0), lr, 0.5)
    assert abs(tstats["loss_nce"].item() - float(jstats["loss_nce"])) <= 1e-4 * abs(float(jstats["loss_nce"]))
    assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
    jstate = jax.device_get(jstate)
    own = tstate.model.state_dict()
    p0 = params_to_torch(params)
    assert not moved_within(own, params_to_torch(jstate.params), p0)
    assert not moved_within(own, batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(batch_stats))
    assert not moved_within(tstate.ssl["ema_model"].state_dict(), params_to_torch(jstate.ssl["ema_params"]), p0)

    byol = mvit_con_cfg(tconfig)
    assert byol.CONTRASTIVE.TYPE == "byol"
    model = build_model(byol, "cpu")
    named = dict(model.named_parameters())
    bundle = build_tx(byol, named)
    state = TrainState(model, bundle.tx.init(named), 0, tc.init_ssl_state(byol, model, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="PREDICTOR_DEPTHS"):
        make_train_step(byol, bundle, None)(state, torch.from_numpy(x), {"item_id": torch.from_numpy(ids).long()},
                                            torch.Generator().manual_seed(0), lr, 0.5)
