"""The port's engine around the step (advise_tpu_torch/engine: checkpoint,
meters, train, the kNN probe; solver: the plateau policy and
adjust_base_lr; tools/run.py) on the CPU.

- Checkpoint: a save/restore round trip of the whole state is bit-exact;
  auto_resume takes the newest epoch; load_pretrained strips ``backbone.``,
  drops ``head`` and skips a shape mismatch.
- PlateauController, adjust_base_lr and the plateau warm-up EQUAL the JAX
  package's.
- knn_probe and knn_labels_from_dataset against the JAX package's on the
  same bank, features and labels: the same accuracy (the vote weights
  exp(s / 0.07) are float32 sums in another order, so the features are
  drawn apart enough that no vote is near a tie).
- The trainer on the small BYOL preset (tests/torch_port_common.py, depth
  10) with the synthetic backend: 2 epochs x 2 iterations, the checkpoints,
  then a resume to 3 epochs that starts at epoch 2, step 4, with the saved
  model bit for bit. Its first-step loss EQUALS one call of the ported step
  on the same batch and the same generator (the same code on the same
  inputs). A 3-epoch run cut after epoch 1 and resumed EQUALS the same run
  uncut, in every iteration's loss and grad norm and in the end state.
- The trainer on the AdViSe smoke preset (configs/smoke/advise_tm_synth.yaml,
  4 synthetic videos): one epoch, then a resume to 2 epochs that EQUALS the
  same run never cut, the BYOL twins included.
- The trainer on the speed preset (SpeedPro_R50 cut to RESNET.DEPTH 10 and
  narrow widths, tests/torch_port_common.py ``slow_r10``; TASK speed, the
  fused simple aug) with the synthetic backend: one epoch of 2 iterations,
  whose first loss_spd and grad norm EQUAL one call of the ported speed
  step on the loader's first batch with the generator of (SEED, 0, 0).
"""

import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine import contrastive as jcontrastive
from advise_tpu.solver import lr_policy as jlr
from advise_tpu.solver import optimizer as joptim
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, build_loader
from advise_tpu_torch.engine import checkpoint as ck
from advise_tpu_torch.engine import contrastive as tcontrastive
from advise_tpu_torch.engine.meters import AverageMeter, busy_ms
from advise_tpu_torch.engine.steps import make_train_step
from advise_tpu_torch.engine.train import (
    build_train_state,
    check_ported,
    seeded_generator,
    select_infos,
    spatial_checkpoint,
    trainer,
)
from advise_tpu_torch.solver import lr_policy as tlr
from advise_tpu_torch.solver import optimizer as toptim
from advise_tpu_torch.utils import storage

from torch_port_common import small_cfg, speed_cfg

torch.set_num_threads(1)

RUN = {"DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_SIZE": 8, "DATA.SYNTHETIC_RES": 48,
       "DATA.WORKERS": 2, "TRAIN.SAVE_FREQ": 1, "CONTRASTIVE.KNN_EVAL_BATCHES": 1,
       "CONTRASTIVE.LENGTH": 16}


def _run_cfg(logdir, **overrides):
    cfg = small_cfg(tconfig, **{**RUN, **overrides})
    cfg.LOGDIR = str(logdir)
    return cfg


def _state(cfg, seed_shift=0):
    cfg = cfg.clone()
    cfg.TRAIN.SEED += seed_shift
    state, bundle = build_train_state(cfg, "cpu")
    return state, bundle


def _all_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state.ssl["ema_model"].state_dict().items()})
    out["knn_mem"] = state.ssl["knn_mem"]
    out.update({f"trace.{k}": v for k, v in state.opt_state["trace"].items()})
    return out


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cfg = _run_cfg(tmp_path)
    state, bundle = _state(cfg)
    step = make_train_step(cfg, bundle, None)
    clips = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 2, 8, 32, 32, 3)).astype(np.float32))
    step(state, clips, {"item_id": torch.arange(4)}, None, 1e-3, 0.5)
    mgr = ck.CheckpointManager(cfg)
    mgr.save(state, 0, {"loss_byol": 3.0})
    meta = np.load(tmp_path / "checkpoints" / "Model_Epoch_0000.meta.npy", allow_pickle=True)[0]
    assert meta == {"epoch": 0, "summary": {"loss_byol": 3.0}}
    fresh, _ = _state(cfg, seed_shift=1)
    assert not all(torch.equal(a, b) for a, b in zip(_all_tensors(fresh).values(),
                                                      _all_tensors(state).values()))
    mgr.restore(str(tmp_path / "checkpoints" / "Model_Epoch_0000"), fresh)
    want, got = _all_tensors(state), _all_tensors(fresh)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert fresh.step == state.step == 1
    assert ck.tensors_digest(fresh.model.state_dict()) == ck.tensors_digest(state.model.state_dict())
    saved = torch.load(tmp_path / "checkpoints" / "Model_Epoch_0000" / ck.STATE_FILE, weights_only=False)
    assert saved["epoch"] == 0 and saved["step"] == 1


def test_save_policy_and_auto_resume_take_the_newest_epoch(tmp_path):
    cfg = _run_cfg(tmp_path, **{"TRAIN.SAVE_FREQ": 2, "SOLVER.MAX_EPOCH": 6})
    state, _ = _state(cfg)
    mgr = ck.CheckpointManager(cfg)
    for epoch, loss in enumerate([5.0, 4.0, 4.5, 3.0, 3.5, 3.8]):
        mgr.save(state, epoch, {"loss_byol": loss, "grad_norm": 1.0})
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["Model_Best", "Model_Best.meta.npy", "Model_Epoch_0001", "Model_Epoch_0001.meta.npy",
                     "Model_Epoch_0003", "Model_Epoch_0003.meta.npy", "Model_Epoch_0005",
                     "Model_Epoch_0005.meta.npy"]
    best = np.load(tmp_path / "checkpoints" / "Model_Best.meta.npy", allow_pickle=True)[0]
    assert best["epoch"] == 3 and best["best"] == 3.0
    assert ck.CheckpointManager(cfg).best == 3.0  # the sidecar survives a restart
    assert ck.default_criteria({"grad_norm": 1.0, "loss_b": 2.0, "loss_a": 4.0}) == 4.0
    cfg.TRAIN.AUTO_RESUME = True
    _, start, resumed = ck.auto_resume(cfg, mgr, state)
    assert (start, resumed) == (6, True)
    cfg.TRAIN.RESUME = str(tmp_path / "checkpoints" / "Model_Epoch_0003")
    assert ck.auto_resume(cfg, mgr, state)[1:] == (4, True)
    cfg.TRAIN.RESUME, cfg.TRAIN.AUTO_RESUME = None, False
    assert ck.auto_resume(cfg, mgr, state)[1:] == (0, False)
    cfg.TRAIN.SAVE_FREQ = 0
    ck.CheckpointManager(cfg).save(state, 9, {"loss_byol": 0.0})
    assert not (tmp_path / "checkpoints" / "Model_Epoch_0009").exists()
    cfg.TRAIN.CHECKPOINT_REMOTE = "memory://test_torch_trainer/run"
    ck.CheckpointManager(cfg).save(state, 9, {"loss_byol": 0.0})  # SAVE_FREQ 0: no mirror either
    assert not storage.smart_exists(cfg.TRAIN.CHECKPOINT_REMOTE)


def test_load_pretrained_strips_backbone_and_drops_head(tmp_path, caplog):
    """A ContrastiveModel-style checkpoint (keys under ``backbone.``, a
    projector under ``head``) into a model with the bare keys."""
    cfg = _run_cfg(tmp_path)
    target, _ = _state(cfg)
    source, _ = _state(cfg, seed_shift=5)
    sd = {f"backbone.{k}": v.clone() for k, v in source.model.state_dict().items()}
    bare = [k for k in source.model.state_dict() if "head" not in k]
    wrong = bare[0]
    sd[f"backbone.{wrong}"] = torch.zeros(3, 3)
    (tmp_path / "pre").mkdir()
    torch.save({"model": sd}, tmp_path / "pre" / ck.STATE_FILE)
    before = {k: v.clone() for k, v in target.model.state_dict().items()}
    with caplog.at_level("WARNING"):
        _, loaded, skipped = ck.load_pretrained(str(tmp_path / "pre"), target)
    after = target.model.state_dict()
    assert wrong in caplog.text
    assert set(loaded) == set(bare) - {wrong}
    for k in after:
        if k in loaded:
            assert torch.equal(after[k], source.model.state_dict()[k]), k
        else:
            assert torch.equal(after[k], before[k]), k
    assert any("head" in s and "dropped" in s for s in skipped)
    assert any(s.startswith(wrong) and "shape" in s for s in skipped)
    assert target.step == 0


def test_plateau_and_adjust_base_lr_equal_jax():
    metrics = [5.0, 4.0, 4.0, 4.1, 3.9996, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
               2.9999, 3.1]
    jp, tp = jlr.PlateauController(0.4), tlr.PlateauController(0.4)
    for m in metrics:
        assert tp.step(m) == jp.step(m)
        assert (tp.lr, tp.best, tp.num_bad) == (jp.lr, jp.best, jp.num_bad)
    assert tp.lr < 0.4
    for preset in ("configs/pretrain/SlowFast_R50_K400.yaml", "configs/pretrain/SpeedPro_R50.yaml"):
        jcfg, tcfg = jconfig.get_cfg(), tconfig.get_cfg()
        for cfg in (jcfg, tcfg):
            cfg.merge_from_file(preset)
            cfg.NUM_WORLDS = 3
        joptim.adjust_base_lr(jcfg)
        toptim.adjust_base_lr(tcfg)
        for key in ("BASE_LR", "COSINE_END_LR", "WARMUP_START_LR"):
            assert tcfg.SOLVER[key] == jcfg.SOLVER[key]
        jcfg.SOLVER.LR_POLICY = tcfg.SOLVER.LR_POLICY = "plateau"
        for epoch in np.linspace(0.0, 2 * jcfg.SOLVER.WARMUP_EPOCHS, 23):
            assert tlr.get_lr_at_epoch(tcfg, float(epoch)) == jlr.get_lr_at_epoch(jcfg, float(epoch))


@pytest.mark.parametrize("knn_k", [3, 200])
def test_knn_probe_matches_jax(knn_k):
    import jax.numpy as jnp

    rng = np.random.default_rng(knn_k)
    centers = rng.standard_normal((4, 16)).astype(np.float32) * 3
    bank_cls = rng.integers(0, 4, 40)
    bank = centers[bank_cls] + rng.standard_normal((40, 16)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    labels = np.where(np.arange(40) < 32, bank_cls, -1).astype(np.int32)  # 8 rows with no vote
    q_cls = rng.integers(0, 4, 40)
    q = centers[q_cls] + 5 * rng.standard_normal((40, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = jcontrastive.knn_probe(None, {"knn_mem": jnp.asarray(bank)}, jnp.asarray(labels),
                                  jnp.asarray(q), jnp.asarray(q_cls), knn_k=knn_k, t=0.07)
    got = tcontrastive.knn_probe(None, {"knn_mem": torch.from_numpy(bank)}, torch.from_numpy(labels),
                                 torch.from_numpy(q), torch.from_numpy(q_cls), knn_k=knn_k, t=0.07)
    assert 0.0 < float(want) < 1.0
    assert float(got) == float(want)

    class _DS:
        items = [(f"v{i}", i % 5) for i in range(7)]

    np.testing.assert_array_equal(tcontrastive.knn_labels_from_dataset(_DS, 10).numpy(),
                                  np.asarray(jcontrastive.knn_labels_from_dataset(_DS, 10)))


def test_trainer_runs_saves_resumes_and_matches_one_step(tmp_path, monkeypatch):
    cfg = _run_cfg(tmp_path, **{"SOLVER.MAX_EPOCH": 2})
    # the first step's inputs, as the trainer draws them: the loader's first
    # batch of epoch 0 and the generator of (SEED, 0, 0), on a state built
    # from the same seeds
    ref_cfg = cfg.clone()
    ref_cfg.NUM_WORLDS = 1
    toptim.adjust_base_lr(ref_cfg)
    clips, infos = next(iter(build_loader(ref_cfg).epoch(0)))
    state, bundle = build_train_state(ref_cfg, "cpu")
    state.ssl["knn_labels"] = torch.arange(16) % 4
    ref_step = make_train_step(ref_cfg, bundle, build_device_aug(ref_cfg, "train"))
    lr = tlr.get_lr_at_epoch(ref_cfg, 0.5)
    want = ref_step(state, torch.from_numpy(clips),
                    {k: torch.from_numpy(v) for k, v in select_infos(ref_cfg, infos).items()},
                    seeded_generator("cpu", ref_cfg.TRAIN.SEED, 0, 0), lr, 0.5)

    record = {}
    trainer(cfg, device="cpu", record=record)
    assert record["stats"][0]["loss_byol"] == float(want["loss_byol"])
    assert record["stats"][0]["grad_norm"] == float(want["grad_norm"])
    assert (record["start_epoch"], record["start_step"], len(record["iter_s"])) == (0, 0, 4)
    assert all(np.isfinite(v) for st in record["stats"] for v in st.values())
    # the input pipeline's stages: 2 epochs x (2 batches + 1 probe batch) of 4
    # (the probe's lookahead may start more items than it takes)
    host = record["host_s"]
    assert host["collate"][1] == 6 and host["wait_items"][1] == 6 * 4
    assert host["item"][1] >= host["wait_items"][1] and host["resize"][1] == host["item"][1]
    assert all(s >= 0 for s, _ in host.values())
    ckpts = tmp_path / "checkpoints"
    for name in ("Model_Epoch_0000", "Model_Epoch_0001", "Model_Best"):
        assert (ckpts / name / ck.STATE_FILE).is_file() and (ckpts / f"{name}.meta.npy").is_file()
    saved = torch.load(ckpts / "Model_Epoch_0001" / ck.STATE_FILE, weights_only=False)
    assert saved["step"] == 4 and ck.tensors_digest(saved["model"]) == record["model_sha256_end"]

    resumed = {}
    trainer(_run_cfg(tmp_path, **{"SOLVER.MAX_EPOCH": 3, "TRAIN.AUTO_RESUME": True}), device="cpu",
            record=resumed)
    assert (resumed["start_epoch"], resumed["start_step"], len(resumed["iter_s"])) == (2, 4, 2)
    assert resumed["model_sha256"] == record["model_sha256_end"]
    assert (ckpts / "Model_Epoch_0002" / ck.STATE_FILE).is_file()

    # a 3-epoch run cut after epoch 1 and resumed EQUALS the same run never
    # cut: the same batches, generators, lr, EMA momentum and state (the lr
    # and momentum schedules run to MAX_EPOCH, so both runs have 3)
    straight, cut = {}, {}
    trainer(_run_cfg(tmp_path / "straight", **{"SOLVER.MAX_EPOCH": 3}), device="cpu", record=straight)
    kept = tmp_path / "cut" / "checkpoints"
    kept.mkdir(parents=True)
    for name in ("Model_Epoch_0001", "Model_Epoch_0001.meta.npy"):
        (tmp_path / "straight" / "checkpoints" / name).rename(kept / name)
    trainer(_run_cfg(tmp_path / "cut", **{"SOLVER.MAX_EPOCH": 3, "TRAIN.AUTO_RESUME": True}),
            device="cpu", record=cut)
    assert (cut["start_epoch"], cut["start_step"], len(cut["stats"])) == (2, 4, 2)
    assert cut["stats"] == straight["stats"][4:]
    assert cut["model_sha256_end"] == straight["model_sha256_end"]


def test_trainer_runs_the_speed_preset_and_matches_one_step(tmp_path):
    cfg = speed_cfg(tconfig, "slow_r10", **{
        "DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_SIZE": 4, "DATA.SYNTHETIC_RES": 48,
        "DATA.WORKERS": 2, "TRAIN.SAVE_FREQ": 1, "SOLVER.MAX_EPOCH": 1})
    cfg.LOGDIR = str(tmp_path)
    assert cfg.TASK == "speed" and cfg.AUG.TYPE == "simple" and cfg.TPU.PALLAS_AUG
    ref_cfg = cfg.clone()
    ref_cfg.NUM_WORLDS = 1
    toptim.adjust_base_lr(ref_cfg)
    clips, infos = next(iter(build_loader(ref_cfg).epoch(0)))
    state, bundle = build_train_state(ref_cfg, "cpu")
    ref_step = make_train_step(ref_cfg, bundle, build_device_aug(ref_cfg, "train"))
    lr = tlr.get_lr_at_epoch(ref_cfg, 0.5)
    want = ref_step(state, torch.from_numpy(clips),
                    {k: torch.from_numpy(v) for k, v in select_infos(ref_cfg, infos).items()},
                    seeded_generator("cpu", ref_cfg.TRAIN.SEED, 0, 0), lr)

    record = {}
    trainer(cfg, device="cpu", record=record)
    assert record["stats"][0]["loss_spd"] == float(want["loss_spd"])
    assert record["stats"][0]["grad_norm"] == float(want["grad_norm"])
    assert (record["start_epoch"], record["start_step"], len(record["iter_s"])) == (0, 0, 2)
    assert all(np.isfinite(v) for st in record["stats"] for v in st.values())
    assert (tmp_path / "checkpoints" / "Model_Epoch_0000" / ck.STATE_FILE).is_file()
    # the step's spans, each once an iteration
    host = record["host_s"]
    assert {name: host[name][1] for name in host if name.startswith("step")} == {
        name: 2 for name in ("step", "step.aug", "step.forward", "step.backward", "step.bn_commit",
                             "step.optimizer")}


def _tm_run_cfg(logdir, **overrides):
    """configs/smoke/advise_tm_synth.yaml (TemporalModel, a tiny CLIP tower
    trained from scratch, conv3d head, speed + BYOL, the XLA simple aug with
    a real hue) on 4 synthetic videos: 4 iterations an epoch."""
    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/smoke/advise_tm_synth.yaml")
    cfg.DATA.SYNTHETIC_SIZE = 4
    cfg.TRAIN.SAVE_FREQ = 1
    cfg.AUG.REFERENCE_EXACT_HUE = False
    for key, value in overrides.items():
        sec, leaf = key.split(".")
        cfg[sec][leaf] = value
    cfg = tconfig.assert_and_infer_cfg(cfg)
    cfg.LOGDIR = str(logdir)
    return cfg


def test_trainer_runs_advise_tm_synth_and_resumes_bit_exactly(tmp_path):
    """The AdViSe smoke preset through the trainer: its one epoch (4
    iterations) saves the model, the optimizer and the BYOL twins. A 2-epoch
    run cut after epoch 0 and resumed EQUALS the same run never cut, in
    every iteration's stats, the end model and the twins (the lr schedule
    runs to MAX_EPOCH, so both runs have 2)."""
    one = {}
    trainer(_tm_run_cfg(tmp_path / "one"), device="cpu", record=one)
    assert len(one["stats"]) == 4
    assert all(set(st) == {"loss_spd", "acc_spd", "loss_byol", "grad_norm"} for st in one["stats"])
    assert all(np.isfinite(v) for st in one["stats"] for v in st.values())
    saved = torch.load(tmp_path / "one" / "checkpoints" / "Model_Epoch_0000" / ck.STATE_FILE,
                       weights_only=False)
    assert set(saved["ssl"]) == {"ema_temporal", "ema_projector"} and saved["step"] == 4
    assert ck.tensors_digest(saved["model"]) == one["model_sha256_end"]

    straight, cut = {}, {}
    state = trainer(_tm_run_cfg(tmp_path / "straight", **{"SOLVER.MAX_EPOCH": 2}), device="cpu",
                    record=straight)
    assert set(state.ssl) == {"ema_temporal", "ema_projector"}
    kept = tmp_path / "cut" / "checkpoints"
    kept.mkdir(parents=True)
    for name in ("Model_Epoch_0000", "Model_Epoch_0000.meta.npy"):
        (tmp_path / "straight" / "checkpoints" / name).rename(kept / name)
    resumed = trainer(_tm_run_cfg(tmp_path / "cut", **{"SOLVER.MAX_EPOCH": 2, "TRAIN.AUTO_RESUME": True}),
                      device="cpu", record=cut)
    assert (cut["start_epoch"], cut["start_step"], len(cut["stats"])) == (1, 4, 4)
    assert cut["stats"] == straight["stats"][4:]
    assert cut["model_sha256_end"] == straight["model_sha256_end"]
    for twin in ("ema_temporal", "ema_projector"):
        assert ck.tensors_digest(resumed.ssl[twin]) == ck.tensors_digest(state.ssl[twin]), twin


def test_trainer_pieces():
    cfg = small_cfg(tconfig)
    infos = {"item_id": 1, "time_idx": 2, "cls_id": 3, "length": 4}
    assert select_infos(cfg, infos) == {"item_id": 1, "time_idx": 2, "cls_id": 3}
    a, b = seeded_generator("cpu", 0, 1, 2), seeded_generator("cpu", 0, 1, 2)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=seeded_generator("cpu", 0, 1, 3)),
                           torch.rand(4, generator=seeded_generator("cpu", 0, 2, 2)))
    bad = cfg.clone()
    bad.TPU.PARTITION_MODE = "auto"
    check_ported(bad)  # 'auto' is ported (tests/test_torch_auto_shard.py)
    bad = cfg.clone()
    bad.VIS_MASK.ENABLE = True
    check_ported(bad)  # the VIS_MASK dump is ported (tests/test_torch_mae.py)
    bad = cfg.clone()
    bad.MODEL.SPATIAL_MODEL_PATH = "no_such_clip_checkpoint"
    check_ported(bad)  # the CLIP tower loads now; a missing checkpoint raises where it is read
    with pytest.raises(FileNotFoundError, match="no_such_clip_checkpoint"):
        spatial_checkpoint(bad.MODEL.SPATIAL_MODEL_PATH)
    m = AverageMeter(window=2)
    for v in (1.0, 2.0, 6.0):
        m.update(v)
    assert (m.avg, m.local_avg, m.val) == (3.0, 4.0, 6.0)
    assert busy_ms([(0, 1000), (500, 1500), (3000, 4000)]) == 2.5


def test_run_needs_a_card(tmp_path):
    """The CLI parses its arguments and then refuses to run without a card:
    it has no CPU switch."""
    from advise_tpu_torch.tools import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA card"):
        run.main(["--cfg", "configs/pretrain/SlowFast_R50_K400.yaml", "--output", str(tmp_path),
                  "SOLVER.MAX_EPOCH", "1"])
    assert (tmp_path / "log.txt").is_file()


def _preset_run_cfg(yaml, logdir, **overrides):
    cfg = tconfig.get_cfg()
    cfg.merge_from_file(yaml)
    for key, value in {"NUM_GPUS": 1, "TPU.MESH_SYNC": 1, "BN.NUM_SYNC_DEVICES": 1,
                       "TPU.COMPUTE_DTYPE": "float32", "DATA.DECODE_BACKEND": "synthetic",
                       "DATA.SYNTHETIC_RES": 48, "DATA.WORKERS": 2, "DATA.NUM_FRAMES": 4,
                       "TRAIN.SAVE_FREQ": 1, "TRAIN.AUTO_RESUME": False, **overrides}.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    cfg = tconfig.assert_and_infer_cfg(cfg)
    cfg.LOGDIR = str(logdir)
    return cfg


def test_trainer_runs_the_x3d_preset(tmp_path):
    """X3D_M_K400.yaml at DEPTH_FACTOR 0.5 through the trainer: the speed
    task on the XLA simple aug with REMAT, one epoch of 2 iterations, its
    first loss EQUAL to one call of the ported step on the loader's first
    batch with the generator of (SEED, 0, 0), and its checkpoint."""
    cfg = _preset_run_cfg("configs/pretrain/X3D_M_K400.yaml", tmp_path, **{
        "X3D.DEPTH_FACTOR": 0.5, "X3D.DIM_C5": 32, "AUG.RESIZE": [40, 36], "AUG.TARGET_SIZE": 32,
        "DATA.BATCHSIZE_PER_GPU": 2, "DATA.NUM_CLIP": 2, "DATA.SYNTHETIC_SIZE": 4, "SOLVER.MAX_EPOCH": 1})
    assert cfg.MODEL.MODEL_NAME == "X3D" and cfg.TASK == "speed" and cfg.TPU.REMAT
    ref_cfg = cfg.clone()
    ref_cfg.NUM_WORLDS = 1
    toptim.adjust_base_lr(ref_cfg)
    clips, infos = next(iter(build_loader(ref_cfg).epoch(0)))
    state, bundle = build_train_state(ref_cfg, "cpu")
    want = make_train_step(ref_cfg, bundle, build_device_aug(ref_cfg, "train"))(
        state, torch.from_numpy(clips), {k: torch.from_numpy(v) for k, v in select_infos(ref_cfg, infos).items()},
        seeded_generator("cpu", ref_cfg.TRAIN.SEED, 0, 0), tlr.get_lr_at_epoch(ref_cfg, 0.5))
    record = {}
    trainer(cfg, device="cpu", record=record)
    assert record["stats"][0]["loss_spd"] == float(want["loss_spd"])
    assert (record["start_epoch"], len(record["iter_s"])) == (0, 2)
    assert all(np.isfinite(v) for st in record["stats"] for v in st.values())
    assert (tmp_path / "checkpoints" / "Model_Epoch_0000" / ck.STATE_FILE).is_file()


def _moco_run_cfg(logdir, **overrides):
    """configs/chip/moco_knn_minik400cc.yaml (MoCo, the rbyol aug,
    shuffle-BN, KNN_BATCH_STATS) cut to a Slow R10 of width 8 on 8
    synthetic videos of 4 frames at 24^2: 2 iterations an epoch and a kNN
    probe batch; QUEUE_LEN 8 wraps the pointer every 2 iterations."""
    return _preset_run_cfg("configs/chip/moco_knn_minik400cc.yaml", logdir, **{
        "RESNET.DEPTH": 10, "RESNET.WIDTH_PER_GROUP": 8, "CONTRASTIVE.DIM": 16, "CONTRASTIVE.MLP_DIM": 32,
        "CONTRASTIVE.QUEUE_LEN": 8, "CONTRASTIVE.LENGTH": 16, "CONTRASTIVE.KNN_EVAL_BATCHES": 1,
        "AUG.TARGET_SIZE": 24, "DATA.BATCHSIZE_PER_GPU": 4, "DATA.SYNTHETIC_SIZE": 8, **overrides})


def test_trainer_runs_moco_and_resumes_queue_and_pointer_bit_exactly(tmp_path):
    """A 2-epoch MoCo run cut after epoch 0 and resumed EQUALS the same run
    never cut: every iteration's stats, the model, the momentum encoder,
    the queue and its pointer, bit for bit; the kNN probe on batch
    statistics leaves the running statistics to the train steps."""
    straight, cut = {}, {}
    state = trainer(_moco_run_cfg(tmp_path / "straight", **{"SOLVER.MAX_EPOCH": 2}), device="cpu",
                    record=straight)
    assert set(state.ssl) == {"ema_model", "queue_x", "ptr", "knn_mem", "knn_labels"}
    assert len(straight["stats"]) == 4 and int(state.ssl["ptr"]) == 0
    assert all(set(st) == {"loss_nce", "acc_ins", "grad_norm"} for st in straight["stats"])
    assert all(np.isfinite(v) for st in straight["stats"] for v in st.values())
    saved = torch.load(tmp_path / "straight" / "checkpoints" / "Model_Epoch_0000" / ck.STATE_FILE,
                       weights_only=False)
    assert {"queue_x", "ptr", "ema_model"} <= set(saved["ssl"]) and saved["ssl"]["ptr"].dtype == torch.int64
    kept = tmp_path / "cut" / "checkpoints"
    kept.mkdir(parents=True)
    for name in ("Model_Epoch_0000", "Model_Epoch_0000.meta.npy"):
        (tmp_path / "straight" / "checkpoints" / name).rename(kept / name)
    resumed = trainer(_moco_run_cfg(tmp_path / "cut", **{"SOLVER.MAX_EPOCH": 2, "TRAIN.AUTO_RESUME": True}),
                      device="cpu", record=cut)
    assert (cut["start_epoch"], cut["start_step"], len(cut["stats"])) == (1, 2, 2)
    assert cut["stats"] == straight["stats"][2:]
    assert cut["model_sha256_end"] == straight["model_sha256_end"]
    assert ck.tensors_digest(resumed.ssl["ema_model"].state_dict()) == ck.tensors_digest(
        state.ssl["ema_model"].state_dict())
    for name in ("queue_x", "ptr", "knn_mem"):
        assert torch.equal(resumed.ssl[name], state.ssl[name]), name


def test_compare_steps_times_the_moco_step_on_cpu(tmp_path):
    """tools/compare_steps.py's step_run and time_steps (the step timing
    of chip_smoke.py's X3D, MoCo and AdViSe phases) on the small MoCo
    preset: three steps with per-step item ids, the first EQUAL to one
    call of the ported step built by hand on the same clips, ids and
    generator; the pointer where three steps leave it; launches counted
    from 0; the median of the timed steps."""
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    cfg = _moco_run_cfg(tmp_path)
    run = step_run(cfg, torch.device("cpu"), 4, 0.5)
    b = cfg.DATA.BATCHSIZE_PER_GPU
    state, bundle = build_train_state(cfg, "cpu")
    want = make_train_step(cfg, bundle, build_device_aug(cfg, "train"))(
        state, run.clips, {"item_id": torch.arange(b)}, torch.Generator().manual_seed(0), run.lr, 0.5)

    def counter():  # a kernel wrapper's launch count
        pass

    counter.launches = 7
    seen = []
    median, step_ms, peak, launches = time_steps(
        run, 1, 2, (counter,), infos_fn=lambda i: {"item_id": torch.arange(b) + i * b},
        after_step=lambda i, vals, ms: seen.append(vals))
    assert seen[0] == {name: float(v) for name, v in want.items()}
    assert len(seen) == len(step_ms) == 3 and median == float(np.median(step_ms[1:]))
    assert run.state.step == 3 and int(run.state.ssl["ptr"]) == 3 * b % cfg.CONTRASTIVE.QUEUE_LEN
    assert peak is None and launches == {"counter": 0}


def test_compare_steps_infer_batch_on_cpu():
    """compare_steps.infer_run, action_infer's batch, on a narrow Slow R10:
    one video's NUM_CLIPS x NUM_CROPS views through the eval step give the
    argmax of the views' mean logits of the same eval step called by hand
    with INFER.SEED's generator."""
    from advise_tpu_torch.data import ingest_geometry
    from advise_tpu_torch.engine.steps import make_eval_step
    from advise_tpu_torch.tools.compare_steps import infer_run, time_steps

    cfg = speed_cfg(tconfig)
    cfg.INFER.NUM_CLIPS, cfg.INFER.NUM_CROPS, cfg.INFER.RES, cfg.INFER.NUM_FRAMES = 2, 2, 24, 4
    run = infer_run(cfg, torch.device("cpu"), 1)
    _, step_ms, _, _ = time_steps(run, 0, 1)
    w, h = ingest_geometry(cfg, "action")
    videos = np.random.default_rng(1).integers(0, 256, (4, 4, h, w, 3), dtype=np.uint8)
    logits = make_eval_step(cfg, build_device_aug(cfg, "action"))(
        run.model, torch.from_numpy(videos[:, None]), seeded_generator("cpu", cfg.INFER.SEED, 0))
    assert len(step_ms) == 1
    assert int(run.call()["pred0"]) == int(torch.argmax(logits.reshape(1, 4, -1).float().mean(dim=1)))


def test_device_events_read_the_raw_profile():
    """``device_events`` keeps the device events of a stopped profiler window
    (none from a CPU-only window) as (name, start, end) in microseconds from
    the first of them, exactly, whatever the clock's origin; the ranges kineto
    draws over the operations of a ``record_function`` are left out."""
    import types

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from advise_tpu_torch.engine.meters import device_events

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.randn(8).sum()
    assert device_events(prof) == []

    def event(name, kind, start, dur, annotation=False):
        return types.SimpleNamespace(name=lambda: name, device_type=lambda: kind, start_ns=lambda: start,
                                     duration_ns=lambda: dur, is_user_annotation=lambda: annotation,
                                     correlation_id=lambda: 0)

    t0 = 1_792_289_219_969_229_546  # a kineto timestamp: ns since the epoch
    raw = [event("k1", DeviceType.CUDA, t0 + 1_500, 2_000), event("cpu", DeviceType.CPU, t0, 10),
           event("k0", DeviceType.CUDA, t0 + 1_000, 1_000),
           event("step", DeviceType.CUDA, t0 + 500, 9_000, annotation=True)]
    fake = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    assert device_events(fake) == [("k1", 0.5, 2.5), ("k0", 0.0, 1.0)]
    assert busy_ms((s, e) for _, s, e in device_events(fake)) == 0.0025
