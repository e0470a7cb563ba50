"""The port's data-parallel steps at 4 gloo ranks with BN sync groups of 2
against the JAX package's steps on a 4-device ``('data', 'sync')`` mesh,
data 2 x sync 2 (``build_mesh(jcfg, jax.devices()[:4])``), from the same
initial state passed through the param bridge.

Both sides get the same global batch: rank r takes rows r*b:(r+1)*b,
shard_map's split. The augmentation is held apart (``device_aug=None`` on
both sides, as the single-device step tests do), and what JAX draws per
replica from the step's key (``fold_in(fold_in(key, replica), step)``,
split, its second half) is handed to each rank: MoCo's shuffle-BN
permutations and the memory bank's random rows and times. The cases, 2
steps each at small widths: BYOL (configs/smoke/byol_r10_synth.yaml),
MoCo with shuffle-BN within the sync group and across the world
(CONTRASTIVE.LOCAL_SHUFFLE_BN both ways) and its queue, SimCLR with the
gathered negatives, SwAV with the distributed Sinkhorn and an 8-row queue
that opens in the second step, the 2-D memory bank, the speed task and
MaskMViT's joint NT-Xent with the gathered projections.

Tolerances (float32), the scheme of tests/test_torch_step.py: lr 1e-4 and
what each parameter and BN running statistic MOVED, within 5e-2 of JAX's
move plus 1e-6 of the tree's largest value (the momentum encoder the
same); each step's stats within 1e-3 of max(|JAX's|, 1), its grad norm
within 1e-2 of it;
the queue's, SwAV queue's, bank's and kNN bank's rows (unit vectors) within
1e-3; MoCo's pointer and SwAV's swav_started equal. Every rank must end
with the same model and SSL state bit for bit. One more case: a world of 1
under gloo gives, bit for bit, what no process group gives.

The ranks run in one spawn per world size (tests/torch_dist_workers.py),
each joining through a ``file://`` rendezvous in the tmp dir, with a
process-group timeout and a join deadline: a hung collective fails the
test instead of the suite's time limit.
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
from advise_tpu_torch.utils.convert import batch_stats_to_torch, convert_train_state, params_to_torch

import torch_dist_workers as workers
from torch_port_common import _override, contrastive_cfg, masked_cfg, moved_within, on_mesh, speed_cfg

WORLD = 4
SYNC = {"BN.NUM_SYNC_DEVICES": 2, "TPU.MESH_SYNC": 2, "NUM_GPUS": 4}
LR = float(np.float32(1e-4))
STEPS = 2
DEADLINE_S = 300.0


def byol_cfg(mod):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/smoke/byol_r10_synth.yaml")
    _override(cfg, {**SYNC, "DATA.NUM_FRAMES": 4, "AUG.TARGET_SIZE": 32, "DATA.BATCHSIZE_PER_GPU": 2,
                    "TPU.DONATE": False, "CONTRASTIVE.LENGTH": 32})
    return mod.assert_and_infer_cfg(cfg)


MOCO_QUEUE = {"CONTRASTIVE.QUEUE_LEN": 24, "DATA.BATCHSIZE_PER_GPU": 2}  # 3 global batches of 8 keys
# name -> (its config from a config module, per-rank batch, frames, crop, clips a video, kind)
CASES = {
    "byol": (byol_cfg, 2, 4, 32, 2, "contrastive"),
    "moco_local": (lambda m: contrastive_cfg(m, "moco", **SYNC, **MOCO_QUEUE), 2, 4, 32, 2, "contrastive"),
    "moco_global": (lambda m: contrastive_cfg(m, "moco", **SYNC, **MOCO_QUEUE,
                                              **{"CONTRASTIVE.LOCAL_SHUFFLE_BN": False}), 2, 4, 32, 2, "contrastive"),
    "simclr": (lambda m: contrastive_cfg(m, "simclr", **SYNC), 2, 4, 32, 2, "contrastive"),
    "swav": (lambda m: contrastive_cfg(m, "swav", **SYNC, **{"CONTRASTIVE.SWAV_QEUE_LEN": 8}),
             2, 4, 32, 2, "contrastive"),
    "mem": (lambda m: contrastive_cfg(m, "mem", **SYNC, **{"CONTRASTIVE.MEM_TYPE": "2d", "CONTRASTIVE.DURATION": 4,
                                                            "CONTRASTIVE.INTERP_MEMORY": True}),
            2, 4, 32, 2, "contrastive"),
    "speed": (lambda m: speed_cfg(m, **SYNC), 2, 4, 32, 2, "speed"),
    "masked": (lambda m: masked_cfg(m, **SYNC, **{"TPU.FLASH_ATTENTION": False}), 1, 4, 28, 2, "masked"),
}
EPOCH = {"swav": 15.5}  # SwAV's queue joins the codes from epoch 15


def _replica_drop_key(step: int, replica: int):
    """The key the JAX step hands the loss on ``replica`` at ``step``."""
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(step), replica), step)
    return jax.random.split(rng)[1]


def _rank_infos(name, jcfg, step, b):
    """What JAX draws per replica from its step key, for the port's ranks."""
    if name.startswith("moco"):
        total = b * (2 if jcfg.CONTRASTIVE.LOCAL_SHUFFLE_BN else WORLD)
        return {"shuffle_perm": [[torch.from_numpy(np.array(jax.random.permutation(
            jax.random.fold_in(_replica_drop_key(step, r), 0), total))).long()] for r in range(WORLD)]}
    if name == "mem":
        k, length, duration = jcfg.CONTRASTIVE.QUEUE_LEN, jcfg.CONTRASTIVE.LENGTH, jcfg.CONTRASTIVE.DURATION
        out = {"mem_index": [], "mem_time": []}
        for r in range(WORLD):
            r_ind, r_time = jax.random.split(_replica_drop_key(step, r))
            out["mem_index"].append(torch.from_numpy(np.array(jax.random.randint(r_ind, (b, k + 1), 0, length))))
            out["mem_time"].append(torch.from_numpy(np.array(jax.random.uniform(
                r_time, (b, k + 1), minval=0.0, maxval=float(duration - 1)))))
        return out
    return {}


def _inputs(name, jcfg, tcfg, step):
    _, b, t, s, k, kind = CASES[name]
    n = b * WORLD
    rng = np.random.default_rng(1000 * step + len(name))
    clips = rng.standard_normal((n, k, t, s, s, 3)).astype(np.float32)
    if kind == "contrastive":
        infos = {"item_id": (np.arange(n, dtype=np.int32) * 3 + step) % jcfg.CONTRASTIVE.LENGTH}
        if name == "mem":
            infos["time_idx"] = rng.uniform(0, 1, n).astype(np.float32)
    elif kind == "speed":
        infos = {"spd_label": rng.integers(0, 4, (n, k)).astype(np.int32)}
    else:
        from torch_port_common import loader_masks

        masks = loader_masks(tcfg, n * k, seed=step)
        infos = {"mask": masks.reshape(n, k, *masks.shape[1:])}
    return {"clips": clips, "infos": infos, "rank_infos": _rank_infos(name, jcfg, step, b)}


def _initial(name, jcfg):
    """The JAX model's initial params, batch statistics and SSL state."""
    _, _, t, s, _, kind = CASES[name]
    init = jbuild_model(jcfg, sync_axes=())
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    v = jax.device_get(jax.jit(lambda: init.init(rngs, jnp.zeros((1, t, s, s, 3), jnp.float32), train=False))())
    params, bs = v["params"], v.get("batch_stats", {})
    ssl = {}
    if kind == "contrastive":
        ssl = jax.device_get(jc.init_ssl_state(jcfg, params, bs, jax.random.PRNGKey(3)))
    return params, bs, ssl


def _jax_run(name, jcfg, params, bs, ssl, steps, epoch):
    mesh = build_mesh(jcfg, jax.devices()[:WORLD])
    assert dict(mesh.shape) == {"data": 2, "sync": 2}
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=bs, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl=ssl), mesh)
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


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every case through JAX's 4-device step and the port's 4 ranks (one
    spawn): {name: (JAX state, JAX stats, initial state, the ranks' outputs)}."""
    tmp = tmp_path_factory.mktemp("dist4")
    refs = {}
    for name, (build, *_rest) in CASES.items():
        jcfg, tcfg = build(jconfig), build(tconfig)
        params, bs, ssl = _initial(name, jcfg)
        steps = [_inputs(name, jcfg, tcfg, i) for i in range(STEPS)]
        epoch = EPOCH.get(name, 0.5)
        conv = convert_train_state(params, bs, ssl=ssl) if ssl else {}
        model = conv["model"] if ssl else {**params_to_torch(params), **batch_stats_to_torch(bs)}
        ssl_t = {k: conv[k] for k in ("knn_mem", "queue_x", "ptr", "queue_swav", "swav_started", "memory")
                 if k in conv}
        torch.save({"cfg": tcfg, "model": model, "ema": conv.get("ema", {}), "ssl": ssl_t, "steps": steps,
                    "lr": LR, "epoch": epoch}, tmp / f"case_{name}.pt")
        jstate, jstats = _jax_run(name, jcfg, params, bs, ssl, steps, epoch)
        refs[name] = (jstate, jstats, (params, bs, ssl))
    workers.spawn_ranks(workers.cases_worker, WORLD, (str(tmp), list(CASES)), DEADLINE_S)
    return {name: (*refs[name], [torch.load(tmp / f"out_{name}_{r}.pt", weights_only=False)
                                 for r in range(WORLD)]) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_ranks_match_the_four_device_mesh(four_ranks, name):
    jstate, jstats, (params, bs, ssl), outs = four_ranks[name]
    first = outs[0]
    for st_t, st_j in zip(first["stats"], jstats):
        assert set(st_t) == set(st_j) | ({"swav_gate"} if name == "swav" else set())
        for k, v in st_j.items():
            tol = 1e-2 if k == "grad_norm" else 1e-3
            assert abs(st_t[k] - v) <= tol * max(abs(v), 1.0), (k, st_t[k], v)
    p0 = params_to_torch(params)
    assert not moved_within(first["model"], params_to_torch(jstate.params), p0)
    if bs:
        assert not moved_within(first["model"], batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(bs))
    if "ema_params" in jstate.ssl:
        assert not moved_within(first["ema"], params_to_torch(jstate.ssl["ema_params"]),
                                params_to_torch(ssl["ema_params"]))
        assert not moved_within(first["ema"], batch_stats_to_torch(jstate.ssl["ema_batch_stats"]),
                                batch_stats_to_torch(ssl["ema_batch_stats"]))
    for key in ("queue_x", "knn_mem", "memory", "queue_swav"):
        if key in jstate.ssl:
            diff = float((first["ssl"][key] - torch.from_numpy(np.array(jstate.ssl[key]))).abs().max())
            assert diff <= 1e-3, (key, diff)
    if "ptr" in jstate.ssl:
        assert int(first["ssl"]["ptr"]) == int(jstate.ssl["ptr"]) == STEPS * 8
    if name == "swav":
        assert bool(first["ssl"]["swav_started"]) == bool(jstate.ssl["swav_started"]) is True
        assert [st["swav_gate"] for st in first["stats"]] == [0.0, 1.0]
    for out in outs[1:]:
        for part in ("model", "ema", "ssl"):
            assert out[part].keys() == first[part].keys()
            for k in first[part]:
                assert torch.equal(out[part][k], first[part][k]), (part, k)
        assert out["stats"] == first["stats"]


def test_world_of_one_under_gloo_is_no_process_group(tmp_path):
    """MoCo (shuffle-BN, the queue and kNN gathers, SyncBN) and the masked
    joint loss with a gloo group of one rank, and with none: the same
    stats, model, momentum encoder and SSL state bit for bit."""
    for name in ("moco_local", "masked"):
        build, b, *_ = CASES[name]
        jcfg, tcfg = build(jconfig), build(tconfig)
        params, bs, ssl = _initial(name, jcfg)
        steps = [dict(_inputs(name, jcfg, tcfg, i), rank_infos={}) for i in range(STEPS)]
        conv = convert_train_state(params, bs, ssl=ssl) if ssl else {}
        model = conv["model"] if ssl else params_to_torch(params)
        ssl_t = {k: conv[k] for k in ("knn_mem", "queue_x", "ptr") if k in conv}
        torch.save({"cfg": tcfg, "model": model, "ema": conv.get("ema", {}), "ssl": ssl_t, "steps": steps,
                    "lr": LR, "epoch": 0.5}, tmp_path / f"case_{name}.pt")
    workers.spawn_ranks(workers.world_one_worker, 1, (str(tmp_path), ["moco_local", "masked"]), DEADLINE_S)
    out = torch.load(tmp_path / "world_one.pt", weights_only=False)
    for name in ("moco_local", "masked"):
        alone, grouped = out["alone"][name], out["grouped"][name]
        assert alone["stats"] == grouped["stats"]
        for part in ("model", "ema", "ssl"):
            assert alone[part].keys() == grouped[part].keys()
            for k in alone[part]:
                assert torch.equal(alone[part][k], grouped[part][k]), (name, part, k)
