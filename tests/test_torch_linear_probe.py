"""The port's linear-probe protocol (advise_tpu_torch: ``action_task_loss``
in the task step, LINEAR_PROBING, ``load_pretrained``, ContrastiveModel
over a ResNet3D backbone, the trainer, ``inference`` and the entry point's
eval-state loading) against the JAX package's on the CPU.

- ``action_task_loss`` on a Slow R3D-10 probe model (the backbone of
  configs/smoke/byol_r10_synth.yaml with a linear head of 10 classes), the
  JAX params passed through the param bridge, float32, 3 videos x 2 clips:
  loss within 1e-5 relative, acc@1 and acc@5 EQUAL, the gradients within
  1e-4 (``grads_agree``) and the BN running statistics the step commits
  within 1e-5 of their largest value.
- A 3-step linear-probe trajectory under simple_sgd (lr 0.1) against JAX's
  ``make_train_step``: every frozen parameter stays bit-identical to its
  start on both sides; the head, the BN running statistics (which move in
  train mode, as JAX's ``batch_stats`` do) and the momentum trace follow
  JAX within 1e-3 of what the tensor moved plus 1e-6 of the tree's largest
  value; the loss and the accuracies within 1e-4.
- BYOL on ContrastiveModel over that Slow R3D-10: a 2-step trajectory of
  the contrastive step against JAX's, with the tolerances of
  tests/test_torch_step.py (loss 1e-3 of 2/T, grad norm 1e-2, what each
  tensor moved 5e-2); the ARCHs that are not ported still raise, naming
  their ROADMAP item.
- The flow of tests/test_linear_probe.py through the port's trainer: BYOL
  pretrain of byol_r10_synth.yaml for one epoch, a linear probe with
  RESUME at its checkpoint (the non-head parameters bit-identical to the
  pretrain's backbone, the head trained, the BN buffers moved), then
  inference over 4 videos. The probe takes DATA.SYNTHETIC_NUM_CLASSES 4 so
  that the synthetic labels fit its 4 classes.
- ``tools.run``'s ``_load_eval_state``: an eval-only pipeline restores
  Model_Best (MODELDATA and RESUME first), and without a checkpoint warns
  and keeps the random weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine.contrastive import init_ssl_state as jinit_ssl
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import action_task_loss as jaction_task_loss
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine import checkpoint as ck
from advise_tpu_torch.engine.contrastive import init_ssl_state
from advise_tpu_torch.engine.inference import inference
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import action_task_loss, make_train_step
from advise_tpu_torch.engine.train import build_train_state, trainer
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.norm import commit_bn_stats
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.tools.run import _load_eval_state
from advise_tpu_torch.utils.convert import (
    batch_stats_to_torch,
    convert_train_state,
    flax_to_state_dict,
    params_to_torch,
)

from torch_port_common import _override, grads_agree, on_mesh

torch.set_num_threads(1)

BYOL_SMOKE = "configs/smoke/byol_r10_synth.yaml"
B, K, T, S = 3, 2, 2, 16  # videos, clips per video, frames, crop
LR = 0.1


def _cfg(mod, logdir=None, **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file(BYOL_SMOKE)
    _override(cfg, {"NUM_GPUS": 1, "TPU.MESH_SYNC": 1, "BN.NUM_SYNC_DEVICES": 1, "TPU.DONATE": False,
                    **overrides})
    if logdir is not None:
        cfg.LOGDIR = str(logdir)
    cfg.RANK = 0
    return mod.assert_and_infer_cfg(cfg)


PROBE = {"TASK": "action_recog", "MODEL.MODEL_NAME": "ResNet", "MODEL.NUM_CLASSES": 10,
         "LINEAR_PROBING": True, "SSL.NUM_MLP_LAYERS": 1, "DATA.NUM_CLIP": K}


def _variables(cfg, seed=0):
    model = jbuild_model(cfg, sync_axes=())
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, T, S, S, 3), jnp.float32), train=False))()
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def _clips(i, views=K):
    return np.random.default_rng(40 + i).standard_normal((B, views, T, S, S, 3)).astype(np.float32)


def _cls(i):
    return np.random.default_rng(50 + i).integers(0, 10, (B,)).astype(np.int32)


def _probe_models():
    jcfg, tcfg = _cfg(jconfig, **PROBE), _cfg(tconfig, **PROBE)
    params, batch_stats = _variables(jcfg)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(flax_to_state_dict(params, batch_stats))
    return jcfg, tcfg, params, batch_stats, model


def test_action_task_loss_matches_jax():
    jcfg, tcfg, params, batch_stats, model = _probe_models()
    jmodel = jbuild_model(jcfg, sync_axes=())
    clips, cls_id = _clips(0), _cls(0)

    def loss_fn(p):
        return jaction_task_loss(jcfg, jmodel, p, batch_stats, jnp.asarray(clips),
                                 {"cls_id": jnp.asarray(cls_id)}, jax.random.PRNGKey(0))

    (jloss, (jbs, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model.train()
    loss, stats = action_task_loss(tcfg, model, torch.from_numpy(clips),
                                   {"cls_id": torch.from_numpy(cls_id)}, None)
    names = dict(model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, list(names.values()))))
    commit_bn_stats(model)
    assert set(stats) == {"loss_cls", "acc@1", "acc@5"}
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in ("acc@1", "acc@5"):
        assert stats[k].item() == float(jstats[k]), k
    assert 0.0 < stats["acc@5"].item() < 1.0
    want = params_to_torch(jax.device_get(jgrads))
    assert not grads_agree({k: v.detach() for k, v in grads.items()}, want, 1e-4)
    bs = batch_stats_to_torch(jax.device_get(jbs))
    own = model.state_dict()
    top = max(float(v.abs().max()) for v in bs.values())
    for k, v in bs.items():
        assert float((own[k] - v).abs().max()) <= 1e-5 * top, k


def test_linear_probe_trajectory_matches_jax():
    jcfg, tcfg, params, batch_stats, model = _probe_models()
    mesh = build_mesh(jcfg, jax.devices()[:1])
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32)), mesh)
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tstep = make_train_step(tcfg, tbundle, None)
    p0 = {k: v.detach().clone() for k, v in named.items()}
    for i in range(3):
        jstate, jstats = jstep(jstate, jnp.asarray(_clips(i)), {"cls_id": _cls(i)},
                               jax.random.PRNGKey(i), jnp.float32(LR))
        tstats = tstep(tstate, torch.from_numpy(_clips(i)), {"cls_id": torch.from_numpy(_cls(i))},
                       None, LR)
        assert set(tstats) == {"loss_cls", "acc@1", "acc@5", "grad_norm"}
        for k in ("loss_cls", "acc@1", "acc@5"):
            assert abs(tstats[k].item() - float(jstats[k])) <= 1e-4, (i, k)
    jstate = jax.device_get(jstate)
    jparams = params_to_torch(jstate.params)
    frozen = [k for k in named if "head" not in k]
    assert frozen and len(frozen) < len(named)
    for k in frozen:
        assert torch.equal(named[k].detach(), p0[k]), k
        assert torch.equal(jparams[k], p0[k]), k
    trace = [s for s in jstate.opt_state if hasattr(s, "trace")][0].trace
    own = model.state_dict()
    checks = [
        (own, {k: v for k, v in jparams.items() if "head" in k}, p0),
        (own, batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(batch_stats)),
        (tstate.opt_state["trace"], params_to_torch(trace), {k: torch.zeros_like(v) for k, v in p0.items()}),
    ]
    for got, want, init in checks:
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            g, w, i0 = (np.asarray(a, np.float32) for a in (got[k].detach(), v, init[k]))
            moved = np.abs(w - i0).max()
            err, bound = np.abs(g - w).max(), 1e-3 * moved + 1e-6 * top
            assert err <= bound, (k, err, bound)
    moved_stats = [k for k, v in batch_stats_to_torch(jstate.batch_stats).items()
                   if not torch.equal(own[k], batch_stats_to_torch(batch_stats)[k])]
    assert moved_stats  # BN statistics move in the probe's train mode


def test_byol_over_resnet3d_matches_jax():
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    params, batch_stats = _variables(jcfg)
    ssl = jinit_ssl(jcfg, params, batch_stats, jax.random.PRNGKey(7))
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl=ssl), mesh)
    conv = convert_train_state(params, batch_stats, ssl=jax.device_get(ssl))
    model = build_model(tcfg, "cpu")
    assert type(model.backbone).__name__ == "ResNet3D"
    model.load_state_dict(conv["model"])
    tssl = init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    tssl["ema_model"].load_state_dict(conv["ema"])
    tssl["knn_mem"] = conv["knn_mem"].clone()
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0, tssl)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tstep = make_train_step(tcfg, tbundle, None)
    lr, scale = float(np.float32(1e-4)), 2.0 / tcfg.CONTRASTIVE.T
    for i in range(2):
        ids = np.arange(B, dtype=np.int32) * 4 + i
        jstate, jstats = jstep(jstate, jnp.asarray(_clips(i)), {"item_id": ids, "time_idx": np.zeros(B, np.float32)},
                               jax.random.PRNGKey(i), jnp.float32(lr), jnp.float32(0.5))
        tstats = tstep(tstate, torch.from_numpy(_clips(i)), {"item_id": torch.from_numpy(ids).long()},
                       None, lr, 0.5)
        assert abs(tstats["loss_byol"].item() - float(jstats["loss_byol"])) <= 1e-3 * scale, i
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-2)
    jstate = jax.device_get(jstate)
    p0, bs0 = params_to_torch(params), batch_stats_to_torch(batch_stats)
    for got, want, init in ((model.state_dict(), params_to_torch(jstate.params), p0),
                            (model.state_dict(), batch_stats_to_torch(jstate.batch_stats), bs0),
                            (tssl["ema_model"].state_dict(), params_to_torch(jstate.ssl["ema_params"]), p0)):
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            g, w, i0 = (np.asarray(a, np.float32) for a in (got[k], v, init[k]))
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w - i0).max() + 1e-6 * top, k

    assert type(build_model(_cfg(tconfig, **{"MODEL.ARCH": "mvit"}), "cpu").backbone).__name__ == "MViT"
    assert type(build_model(_cfg(tconfig, **{"MODEL.ARCH": "swin"}), "cpu").backbone).__name__ == "SwinTransformer3D"
    assert type(build_model(_cfg(tconfig, **{"MODEL.ARCH": "x3d"}), "cpu").backbone).__name__ == "X3D"


def test_pretrain_then_probe_then_infer(tmp_path):
    pre_cfg = _cfg(tconfig, tmp_path / "pretrain", **{"SOLVER.MAX_EPOCH": 1})
    pre = trainer(pre_cfg, device="cpu")
    ckpt = os.path.join(pre_cfg.LOGDIR, "checkpoints", "Model_Epoch_0000")
    assert os.path.isdir(ckpt) and pre.step == 16
    saved = torch.load(os.path.join(ckpt, ck.STATE_FILE), weights_only=False)["model"]

    probe_cfg = _cfg(tconfig, tmp_path / "probe", **{
        **PROBE, "MODEL.NUM_CLASSES": 4, "DATA.SYNTHETIC_NUM_CLASSES": 4, "DATA.NUM_CLIP": 1,
        "RESUME": ckpt, "SOLVER.MAX_EPOCH": 1, "INFER.NUM_CLIPS": 2, "INFER.NUM_CROPS": 1,
        "INFER.NUM_FRAMES": 2, "INFER.RES": 24, "INFER.SEED": 0})
    record = {}
    probe = trainer(probe_cfg, device="cpu", record=record)
    assert probe.step == 16
    assert all(np.isfinite(st["loss_cls"]) for st in record["stats"])
    named = dict(probe.model.named_parameters())
    frozen = [k for k in named if "head" not in k]
    assert frozen
    for k in frozen:  # loaded from the pretrain ('backbone.' stripped) and frozen
        assert torch.equal(named[k].detach(), saved["backbone." + k]), k
    fresh, _ = build_train_state(probe_cfg, "cpu")
    fresh_head = dict(fresh.model.named_parameters())
    assert any(not torch.allclose(named[k], fresh_head[k]) for k in named if "head" in k)
    buffers = dict(probe.model.named_buffers())
    assert any(not torch.equal(v, saved["backbone." + k]) for k, v in buffers.items())

    acc, correct, total = inference(probe_cfg, probe.model, probe, device="cpu", max_videos=4)
    assert total == 4 and 0.0 <= acc <= 1.0 and acc == correct / total


def test_eval_only_pipeline_loads_model_best(tmp_path, caplog):
    over = {**PROBE, "PIPELINE": ["action_infer"]}
    cfg = _cfg(tconfig, tmp_path / "run", **over)
    state, _ = build_train_state(cfg, "cpu")
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ck.CheckpointManager(cfg).save(state, 0, {"loss_cls": 1.0})
    best = os.path.join(cfg.LOGDIR, "checkpoints", "Model_Best")
    assert os.path.isdir(best)
    want = ck.tensors_digest(state.model.state_dict())
    assert ck.tensors_digest(_load_eval_state(cfg, "cpu").model.state_dict()) == want

    other = _cfg(tconfig, tmp_path / "other", **over)
    ck.CheckpointManager(other).save(build_train_state(other, "cpu")[0], 0, {"loss_cls": 1.0})
    cfg.MODELDATA = os.path.join(other.LOGDIR, "checkpoints", "Model_Best")
    cfg.RESUME = best  # MODELDATA comes first
    assert ck.tensors_digest(_load_eval_state(cfg, "cpu").model.state_dict()) != want
    cfg.MODELDATA = None
    assert ck.tensors_digest(_load_eval_state(cfg, "cpu").model.state_dict()) == want

    empty = _cfg(tconfig, tmp_path / "empty", **over)
    with caplog.at_level("WARNING"):
        state = _load_eval_state(empty, "cpu")
    assert "no checkpoint at" in caplog.text and state.step == 0
