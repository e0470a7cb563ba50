"""Shared set-up of the port's TPU.PARTITION_MODE 'auto' tests
(tests/test_torch_auto_shard.py, test_torch_auto_contrastive.py): the
cases' configurations through both packages' config modules, their inputs,
JAX's auto step over 4 devices, and the spawn of the port's 4 gloo ranks
(``tests/torch_dist_workers.py``)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine import contrastive as jc
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import auto_shard as jauto
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine.checkpoint import CheckpointManager, module_state, tensors_digest
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.models import MODEL_REGISTRY, build_model, compute_dtype
from advise_tpu_torch.models.layers.norm import get_norm
from advise_tpu_torch.parallel import auto_shard as tauto
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import batch_stats_to_torch, convert_train_state, params_to_torch

import torch_dist_workers as workers
from torch_port_common import _override, contrastive_cfg, loader_masks, masked_cfg, moved_within, speed_cfg

WORLD = 4
DEADLINE_S = 300.0
LR = float(np.float32(1e-4))
FSDP_MIN = 256
AUTO = {"TPU.PARTITION_MODE": "auto", "TPU.MESH_MODEL": 2, "TPU.FSDP": True, "NUM_GPUS": WORLD,
        "BN.NUM_SYNC_DEVICES": 1, "TPU.MESH_SYNC": 1}
SLOW = {"MODEL.ARCH": "slow", "RESNET.TRANS_FUNC": "basic_transform",
        "RESNET.NUM_BLOCK_TEMP_KERNEL": [[1], [1], [1], [1]], "CONTRASTIVE.NUM_MLP_LAYERS": 2,
        "DATA.NUM_CLIP": 2, "DATA.TRAIN_CROP_NUM_TEMPORAL": 2}


def swin_cfg(mod, **overrides):
    cfg = mod.get_cfg()
    _override(cfg, {"TASK": "contrastive", "MODEL.MODEL_NAME": "ContrastiveModel", "MODEL.ARCH": "swin",
                    "CONTRASTIVE.TYPE": "moco", "CONTRASTIVE.DIM": 16, "CONTRASTIVE.MLP_DIM": 32,
                    "CONTRASTIVE.NUM_MLP_LAYERS": 2, "CONTRASTIVE.QUEUE_LEN": 16, "CONTRASTIVE.LENGTH": 32,
                    "CONTRASTIVE.KNN_ON": False, "SWIN.EMBED_DIM": 8, "SWIN.DEPTHS": [1, 1],
                    "SWIN.NUM_HEADS": [2, 4], "SWIN.PATCH_SIZE": [1, 2, 2], "SWIN.WINDOW_SIZE": [2, 4, 4],
                    "SWIN.DROP_PATH_RATE": 0.0,
                    "TPU.COMPUTE_DTYPE": "float32", "TPU.DONATE": False, "DATA.NUM_CLIP": 2,
                    "DATA.NUM_FRAMES": 2, "AUG.TARGET_SIZE": 16, "DATA.BATCHSIZE_PER_GPU": 2, **overrides})
    return mod.assert_and_infer_cfg(cfg)


def con_cfg(mod, ctype, **overrides):
    extra = {"CONTRASTIVE.PREDICTOR_DEPTHS": [2] if ctype == "byol" else [],
             "CONTRASTIVE.SWAV_QEUE_LEN": 8 if ctype == "swav" else 0}
    return contrastive_cfg(mod, ctype, **SLOW, **extra, **overrides)


# name -> (config of a config module with overrides, global batch, frames, crop, clips a video, kind)
CASES = {
    "masked": (lambda m, **o: masked_cfg(m, **{"TPU.FLASH_ATTENTION": False, **o}), 4, 4, 28, 2, "masked"),
    "speed": (lambda m, **o: speed_cfg(m, **o), 4, 4, 32, 2, "speed"),
    "swin_moco": (swin_cfg, 8, 2, 16, 2, "contrastive"),
    "byol": (lambda m, **o: con_cfg(m, "byol", **o), 8, 4, 32, 2, "contrastive"),
    "simclr": (lambda m, **o: con_cfg(m, "simclr", **o), 8, 4, 32, 2, "contrastive"),
    "swav": (lambda m, **o: con_cfg(m, "swav", **o), 8, 4, 32, 2, "contrastive"),
}
EPOCH = {"swav": 15.5}  # SwAV's queue joins the codes from epoch 15


def jax_counts(jcfg, params, n_data):
    mesh = build_mesh(jcfg, jax.devices()[:n_data * 2])
    specs = jauto.param_specs(params, mesh, fsdp=bool(jcfg.TPU.FSDP))
    head = jauto.describe_sharding(params, specs).splitlines()[0]
    model, data, rep = map(int, re.match(r"auto-shard: (\d+) tensor-parallel, (\d+) fsdp, (\d+) replicated", head)
                           .groups())
    return {"model": model, "data": data, "replicated": rep}


def port_counts(tcfg, n_data):
    with torch.device("meta"):
        model = MODEL_REGISTRY[tcfg.MODEL.MODEL_NAME](tcfg, get_norm(tcfg), compute_dtype(tcfg))
    specs = tauto.param_specs(dict(model.named_parameters()), 2, n_data if tcfg.TPU.FSDP else 1)
    return tauto.describe_sharding(specs)[0]


def jax_shapes(jcfg, t, s):
    """JAX's parameter tree of ``jcfg`` as shapes only."""
    model = jbuild_model(jcfg, sync_axes=())
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    return jax.eval_shape(lambda: model.init(rngs, jnp.zeros((1, t, s, s, 3)), train=False))["params"]


def _drop_key(step):
    """The key JAX's auto step hands the loss at ``step``."""
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(step), step))[1]


def _inputs(name, jcfg, tcfg, step):
    _, n, t, s, k, kind = CASES[name]
    rng = np.random.default_rng(3000 + 100 * step + len(name))
    clips = rng.standard_normal((n, k, t, s, s, 3)).astype(np.float32)
    rank_infos = {}
    if kind == "contrastive":
        infos = {"item_id": (np.arange(n, dtype=np.int32) * 3 + step) % jcfg.CONTRASTIVE.LENGTH}
        if jcfg.CONTRASTIVE.TYPE == "moco":
            perm = torch.from_numpy(np.array(jax.random.permutation(jax.random.fold_in(_drop_key(step), 0), n)))
            rank_infos = {"shuffle_perm": [[perm.long()]] * 2}
    elif kind == "speed":
        infos = {"spd_label": rng.integers(0, 4, (n, k)).astype(np.int32)}
    else:
        masks = loader_masks(tcfg, n * k, seed=step)
        infos = {"mask": masks.reshape(n, k, *masks.shape[1:])}
    return {"clips": clips, "infos": infos, "rank_infos": rank_infos}


def _jax_auto_run(name, jcfg, params, bs, ssl, steps, epoch):
    mesh = build_mesh(jcfg, jax.devices()[:WORLD])
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    bundle = jbuild_tx(jcfg, params)
    jstate = JState(params=params, batch_stats=bs, opt_state=bundle.tx.init(params),
                    step=jnp.zeros((), jnp.int32), ssl=ssl)
    jstate, _ = jauto.shard_train_state(jcfg, mesh, jstate, bundle)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    stats = []
    for i, inp in enumerate(steps):
        args = [jstate, jnp.asarray(inp["clips"]), {k: jnp.asarray(v) for k, v in inp["infos"].items()},
                jax.random.PRNGKey(i), jnp.float32(LR)]
        if CASES[name][5] == "contrastive":
            args.append(jnp.float32(epoch))
        jstate, st = jstep(*args)
        stats.append({k: float(v) for k, v in st.items()})
    return jax.device_get(jstate), stats


def _initial(jcfg, t, s, kind):
    init = jbuild_model(jcfg, sync_axes=())
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    v = jax.device_get(jax.jit(lambda: init.init(rngs, jnp.zeros((1, t, s, s, 3), jnp.float32), train=False))())
    params, bs = v["params"], v.get("batch_stats", {})
    ssl = jax.device_get(jc.init_ssl_state(jcfg, params, bs, jax.random.PRNGKey(3))) if kind == "contrastive" else {}
    return params, bs, ssl


def plain_checkpoint(tmp, tcfg, model_sd):
    """A plain process's state (no process group) saved by the
    CheckpointManager, with moments made non-zero: its digests."""
    model = build_model(tcfg, "cpu")
    model.load_state_dict(model_sd)
    named = dict(model.named_parameters())
    opt = build_tx(tcfg, named).tx.init(named)
    opt["mu"] = {n: torch.full_like(p, 0.5) * p.detach() for n, p in named.items()}
    state = TrainState(model, opt, 3)
    cfg = tcfg.clone()
    cfg.LOGDIR, cfg.TRAIN.SAVE_FREQ, cfg.SOLVER.MAX_EPOCH = str(tmp / "plain"), 1, 1
    CheckpointManager(cfg).save(state, 0, {"loss_mask": 1.0})
    return (str(tmp / "plain" / "checkpoints" / "Model_Epoch_0000"), tensors_digest(module_state(model)),
            tensors_digest(opt["mu"]))


def run_cases(tmp, names, extra=None):
    """JAX's auto trajectories of ``names`` (FSDP's threshold lowered on
    its side), their cases saved for the ranks, the cases ``extra()``
    returns ({name: case}, made after those are saved) beside them, then
    one spawn of the 4 ranks over all of them. Returns
    ({name: (JAX state, JAX stats, initial (params, batch_stats, ssl))},
    {name: each rank's output})."""
    saved = jauto._FSDP_MIN_ELEMENTS
    jauto._FSDP_MIN_ELEMENTS = FSDP_MIN
    refs = {}
    try:
        for name in names:
            build, _, t, s, _, kind = CASES[name]
            jcfg, tcfg = build(jconfig, **AUTO), build(tconfig, **AUTO)
            params, bs, ssl = _initial(jcfg, t, s, kind)
            steps = [_inputs(name, jcfg, tcfg, i) for i in range(2)]
            epoch = EPOCH.get(name, 0.5)
            conv = convert_train_state(params, bs, ssl=ssl) if ssl else {}
            model = conv["model"] if ssl else {**params_to_torch(params), **batch_stats_to_torch(bs)}
            ssl_t = {k: conv[k] for k in ("knn_mem", "queue_x", "ptr", "queue_swav", "swav_started") if k in conv}
            torch.save({"kind": "steps", "cfg": tcfg, "model": model, "ema": conv.get("ema", {}), "ssl": ssl_t,
                        "jax_params": params, "jax_batch_stats": bs, "steps": steps, "lr": LR, "epoch": epoch,
                        "fsdp_min": FSDP_MIN}, tmp / f"case_{name}.pt")
            refs[name] = (*_jax_auto_run(name, jcfg, params, bs, ssl, steps, epoch), (params, bs, ssl))
    finally:
        jauto._FSDP_MIN_ELEMENTS = saved
    more = extra() if extra is not None else {}
    for name, case in more.items():
        torch.save(case, tmp / f"case_{name}.pt")
    every = list(names) + list(more)
    workers.spawn_ranks(workers.model_parallel_worker, WORLD, (str(tmp), every), DEADLINE_S)
    return refs, {name: [torch.load(tmp / f"out_{name}_{r}.pt", weights_only=False) for r in range(WORLD)]
                  for name in every}


def check_trajectory(refs, outs, name):
    """The case's first rank against JAX's auto step (the module docstring's
    tolerances), and every rank bit for bit the first."""
    jstate, jstats, (params, bs, ssl) = refs[name]
    first = outs[name][0]
    for st_t, st_j in zip(first["stats"], jstats):
        for k, v in st_j.items():
            tol = 1e-2 if k == "grad_norm" else 1e-3
            assert abs(st_t[k] - v) <= tol * max(abs(v), 1.0), (k, st_t[k], v)
    assert not moved_within(first["model"], params_to_torch(jstate.params), params_to_torch(params))
    if bs:
        assert not moved_within(first["model"], batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(bs))
    if "ema_params" in jstate.ssl:
        assert not moved_within(first["ema"], params_to_torch(jstate.ssl["ema_params"]),
                                params_to_torch(ssl["ema_params"]))
    for key in ("queue_x", "knn_mem", "queue_swav"):
        if key in jstate.ssl:
            diff = float((first["ssl"][key] - torch.from_numpy(np.array(jstate.ssl[key]))).abs().max())
            assert diff <= 1e-3, (key, diff)
    if "ptr" in jstate.ssl:
        assert int(first["ssl"]["ptr"]) == int(jstate.ssl["ptr"])
    for out in outs[name][1:]:
        for part in ("model", "ema", "ssl"):
            for k in first[part]:
                assert torch.equal(out[part][k], first[part][k]), (part, k)
