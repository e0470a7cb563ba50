"""The port's process layout (advise_tpu_torch/parallel/mesh.py), its
data-parallel loader and its checkpoints across ranks, against the JAX
package:

- ``mesh_shape``, ``bn_axis_names``, ``batch_device_count`` and
  ``local_batch_size`` equal JAX's pure functions for every device count
  from 1 to 32 under BN.GLOBAL_SYNC, BN.NUM_SYNC_DEVICES, TPU.MESH_SYNC and
  TPU.MESH_DATA (JAX's ValueError cases raise the same), and the port's
  sync groups are the rows of JAX's ``build_mesh`` device grid, its groups
  over 'seq', 'pipe', 'model', 'data' and the batch axes JAX's mesh's
  lines through each device under TPU.MESH_SEQ, MESH_PIPE and
  PARTITION_MODE 'auto';
- ``build_loader`` at rank r of N yields the items of JAX's
  ``ClipLoader(rank=r, world=N)``, through 3 gloo ranks (the epoch padded
  to a multiple of the world) and at every (r, N) up to 4 with the world
  stubbed;
- the trainer at 2 gloo ranks (tests/torch_dist_workers.py, a
  ``file://`` rendezvous, deadlines): only rank 0 writes checkpoints, a run
  cut after its first epoch and resumed ends bit for bit where the
  straight run ends, and the digests agree across the ranks.
"""

import types

import jax
import numpy as np
import pytest

from advise_tpu import config as jconfig
from advise_tpu.data import build_dataset as jbuild_dataset
from advise_tpu.data.loader import ClipLoader as JClipLoader
from advise_tpu.parallel import mesh as jmesh
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.parallel import mesh as tmesh

import torch_dist_workers as workers
from torch_port_common import _override, contrastive_run_cfg

DEADLINE_S = 150.0
# (overrides) of the BYOL preset (NUM_SYNC_DEVICES 8, MESH_SYNC 8)
LAYOUTS = [
    {},
    {"BN.GLOBAL_SYNC": True},
    {"TPU.MESH_SYNC": -1, "BN.NUM_SYNC_DEVICES": 4},
    {"TPU.MESH_SYNC": 0, "BN.NUM_SYNC_DEVICES": 3},
    {"TPU.MESH_SYNC": 2},
    {"TPU.MESH_SYNC": 5},
    {"TPU.MESH_SYNC": 2, "TPU.MESH_DATA": 2},
    {"TPU.MESH_SYNC": 1, "TPU.MESH_DATA": 4},
    {"BN.NORM_TYPE": "batchnorm", "TPU.MESH_SYNC": 4},
]


def _cfgs(overrides):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_cfg()
        cfg.merge_from_file("configs/pretrain/SlowFast_R50_K400.yaml")
        _override(cfg, overrides)
        out.append(cfg)
    return out


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("n", range(1, 33))
def test_layout_functions_equal_jax(n):
    for overrides in LAYOUTS:
        jcfg, tcfg = _cfgs(overrides)
        want = _outcome(jmesh.mesh_shape, jcfg, n)
        assert _outcome(tmesh.mesh_shape, tcfg, n) == want, (n, overrides)
        assert tmesh.bn_axis_names(tcfg) == jmesh.bn_axis_names(jcfg)
        assert tmesh.batch_device_count(tcfg, n) == jmesh.batch_device_count(jcfg, n)
        fake_mesh = types.SimpleNamespace(devices=np.empty(n, object))
        assert tmesh.local_batch_size(tcfg, n) == jmesh.local_batch_size(jcfg, fake_mesh)
        if isinstance(want, tuple) and want[0] != "ValueError":
            groups = tmesh.sync_groups(tcfg, n)
            assert [len(g) for g in groups] == [want[1]] * want[0]
            assert sorted(r for g in groups for r in g) == list(range(n))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_sync_groups_are_the_jax_mesh_rows(n):
    """Rank r stands for jax.devices()[r]: each sync group holds the devices
    of one row of JAX's ('data', 'sync') grid."""
    jcfg, tcfg = _cfgs({"TPU.MESH_SYNC": 2})
    mesh = jmesh.build_mesh(jcfg, jax.devices()[:n])
    ids = {d.id: i for i, d in enumerate(jax.devices()[:n])}
    rows = [[ids[d.id] for d in row] for row in np.asarray(mesh.devices).reshape(mesh.shape["data"], -1)]
    assert tmesh.sync_groups(tcfg, n) == rows
    # the model-parallel layouts: rank r's group over each axis holds the
    # devices JAX's mesh lays along that axis through device r
    for overrides in ({"TPU.PARTITION_MODE": "auto", "TPU.MESH_MODEL": 2}, {"TPU.MESH_SEQ": 2},
                      {"TPU.MESH_PIPE": 2}):
        if n % 2:
            continue
        jcfg, tcfg = _cfgs({"TPU.MESH_SYNC": 1, **overrides})
        mesh = jmesh.build_mesh(jcfg, jax.devices()[:n])
        grid = np.vectorize(lambda d: ids[d.id])(np.asarray(mesh.devices))
        groups = tmesh.layout_groups(tcfg, n)
        assert tuple(a for a, _ in tmesh.mesh_axes(tcfg, n)) == mesh.axis_names
        for axis in mesh.axis_names:
            if (axis,) in groups:
                moved = np.moveaxis(grid, mesh.axis_names.index(axis), -1).reshape(-1, mesh.shape[axis])
                assert sorted(groups[(axis,)]) == sorted(moved.tolist()), (overrides, axis)
        batch = [i for i, a in enumerate(mesh.axis_names) if a in ("data", "sync")]
        moved = np.moveaxis(grid, batch, range(-len(batch), 0))
        size = int(np.prod([grid.shape[i] for i in batch]))
        assert sorted(groups[tmesh.BATCH_AXES]) == sorted(moved.reshape(-1, size).tolist()), overrides
        assert tmesh.batch_device_count(tcfg, n) == jmesh.batch_device_count(jcfg, n)


def _loader_cfgs():
    over = {"DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_SIZE": 14, "DATA.SYNTHETIC_RES": 32,
            "DATA.NUM_FRAMES": 4, "DATA.BATCHSIZE_PER_GPU": 2, "DATA.WORKERS": 2, "AUG.TARGET_SIZE": 24,
            "TPU.MESH_SYNC": 1, "BN.NUM_SYNC_DEVICES": 1}
    jcfg, tcfg = _cfgs(over)
    return jconfig.assert_and_infer_cfg(jcfg), tconfig.assert_and_infer_cfg(tcfg)


def _jax_items(jcfg, rank, world):
    loader = JClipLoader(jbuild_dataset(jcfg, "train"), batch_size=jcfg.DATA.BATCHSIZE_PER_GPU, shuffle=True,
                         seed=jcfg.TRAIN.SEED, num_workers=2, drop_last=True, rank=rank, world=world)
    return list(loader.epoch(0))


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_build_loader_takes_the_rank_stride(monkeypatch, world):
    """At every rank r of N (the world stubbed): the batch is the global batch
    over N and the items are JAX's ClipLoader(rank=r, world=N)'s."""
    from advise_tpu_torch.data import build_loader

    jcfg, tcfg = _loader_cfgs()
    for rank in range(world):
        monkeypatch.setattr(tmesh, "world", lambda: (rank, world))
        loader = build_loader(tcfg, "train")
        assert (loader.rank, loader.world, loader.batch_size) == (rank, world, 2)
        want = JClipLoader(jbuild_dataset(jcfg, "train"), batch_size=2, seed=jcfg.TRAIN.SEED, rank=rank,
                           world=world)
        assert np.array_equal(loader.epoch_indices(0), want.epoch_indices(0))


def test_build_loader_at_three_gloo_ranks(tmp_path):
    """Three ranks' loaders over 14 videos (padded to 15, 5 a rank, 2
    batches of 2): each rank's item ids and first batch equal JAX's."""
    jcfg, tcfg = _loader_cfgs()
    workers.spawn_ranks(workers.loader_worker, 3, (str(tmp_path), tcfg), DEADLINE_S)
    for rank in range(3):
        got = np.load(tmp_path / f"loader_{rank}.npz")
        want = _jax_items(jcfg, rank, 3)
        assert got["ids"].shape == (2, 2)
        assert np.array_equal(got["ids"], np.stack([infos["item_id"] for _, infos in want]))
        assert np.array_equal(got["clips"], want[0][0])


def test_checkpoint_and_resume_at_two_ranks(tmp_path):
    """MoCo (shuffle-BN over the 2 ranks' sync group, the queue, the kNN
    probe) through the trainer at 2 gloo ranks: a straight 2-epoch run, then
    its epoch-0 checkpoint alone in another directory, resumed. Only rank 0
    saves; the resumed run starts from the saved state and ends where the
    straight run ends, bit for bit; both ranks agree on every digest."""
    import shutil

    import torch

    over = {"TPU.MESH_SYNC": 2, "BN.NUM_SYNC_DEVICES": 2, "NUM_GPUS": 2, "SOLVER.MAX_EPOCH": 2}
    straight = contrastive_run_cfg(tmp_path / "straight", "moco", **over)
    for run in ("straight", "cut"):
        (tmp_path / f"ranks_{run}").mkdir()  # each spawn's rendezvous file and records
    workers.spawn_ranks(workers.trainer_worker, 2, (str(tmp_path / "ranks_straight"), [straight]), DEADLINE_S)
    kept = tmp_path / "cut" / "checkpoints"
    kept.mkdir(parents=True)
    for name in ("Model_Epoch_0000", "Model_Epoch_0000.meta.npy"):
        src = tmp_path / "straight" / "checkpoints" / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, kept / name)
    resumed = contrastive_run_cfg(tmp_path / "cut", "moco", **over, **{"TRAIN.AUTO_RESUME": True})
    workers.spawn_ranks(workers.trainer_worker, 2, (str(tmp_path / "ranks_cut"), [resumed]), DEADLINE_S)
    saved = torch.load(kept / "Model_Epoch_0000" / "state.pt", weights_only=False)
    rec = [[torch.load(tmp_path / f"ranks_{run}" / f"record_0_{r}.pt", weights_only=False) for r in range(2)]
           for run in ("straight", "cut")]
    for a, b in rec:
        assert (a["rank"], a["world"], b["rank"], b["world"]) == (0, 2, 1, 2)
        for key in ("model_sha256", "ssl_sha256", "model_sha256_end", "ssl_sha256_end"):
            assert a[key] == b[key], key
        assert a["stats"] == b["stats"]
        assert a["saves"] and not b["saves"]
    (s0, _), (r0, _) = rec
    assert len(s0["stats"]) == 2 and len(r0["stats"]) == 1  # 8 videos, 4 a rank: one step an epoch
    assert (r0["start_epoch"], r0["start_step"]) == (1, 1) and saved["step"] == 1
    assert r0["stats"] == s0["stats"][1:]
    assert r0["model_sha256_end"] == s0["model_sha256_end"] and r0["ssl_sha256_end"] == s0["ssl_sha256_end"]
    assert (tmp_path / "cut" / "checkpoints" / "Model_Epoch_0001" / "state.pt").is_file()
