"""The port's evaluation path (advise_tpu_torch: the speed_val and inference
samplers and datasets, the eval augs, ``make_eval_step``, ``validation``
and ``inference``) against the JAX package's on the CPU.

- The samplers of modes 'speed' and 'action' from both factories give
  EQUAL stamps and infos from the same numpy generators; the ingest
  geometry of every mode is EQUAL.
- The augs hold jitted JAX (the program JAX's eval step runs), with the
  boxes and crop offsets that JAX's own calls drew from the keys its eval
  step derives (``fold_in(PRNGKey(seed), 0)``, then a split per clip): the
  inference crop EQUAL; the speed_val RandomResizedCrop within 1e-4
  absolute after normalisation (measured 1.5e-5; values are O(1)): jitted
  JAX rounds its resize weights and sums in an order the port does not
  emulate (ROADMAP.md C); tests/test_torch_masked.py holds the OnlyCrop
  aug to the same bound.
- ``make_eval_step`` on configs/smoke/speed_r18_synth.yaml with JAX's
  params through utils/convert.py, float32: logits within 1e-4 of their
  largest value.
- ``validation`` over the synthetic set of that config and ``inference``
  over the synthetic set of tests/test_inference.py's config, with JAX's
  crops handed to the port: every chunk's logits within the same bound;
  each clip's (each video's) prediction EQUAL to JAX's wherever JAX's
  top-two margin exceeds the bound, and so the confusion matrix,
  ``Metrics.csv`` (byte for byte) and acc/correct/total.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.data import build_dataset as jbuild_dataset
from advise_tpu.data import build_sampler as jbuild_sampler
from advise_tpu.data import device_aug as jaug
from advise_tpu.engine import inference as jinference_mod
from advise_tpu.engine import validate as jvalidate_mod
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_eval_step as jmake_eval_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import build_mesh
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_dataset, build_device_aug, build_sampler, ingest_geometry
from advise_tpu_torch.data import device_aug as taug
from advise_tpu_torch.engine import inference as tinference_mod
from advise_tpu_torch.engine import validate as tvalidate_mod
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_eval_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.utils.convert import flax_to_state_dict

from torch_port_common import _override, rel_err

torch.set_num_threads(1)

SPEED_SMOKE = "configs/smoke/speed_r18_synth.yaml"
TOL = 1e-4  # logits, relative to their largest value


def speed_val_cfg(mod, **overrides):
    """speed_r18_synth on one device, 3 clips a val chunk (so the chunks'
    clips crop differently and the last chunk is padded)."""
    cfg = mod.get_cfg()
    cfg.merge_from_file(SPEED_SMOKE)
    _override(cfg, {"NUM_GPUS": 1, "TPU.MESH_SYNC": 1, "BN.NUM_SYNC_DEVICES": 1,
                    "VAL.BATCHSIZE_PER_GPU": 3, **overrides})
    return mod.assert_and_infer_cfg(cfg)


def infer_cfg(mod, **overrides):
    """tests/test_inference.py's configuration on one device."""
    cfg = mod.get_cfg()
    _override(cfg, {
        "NUM_GPUS": 1, "TASK": "action_recog", "MODEL.MODEL_NAME": "ResNet", "MODEL.ARCH": "slow",
        "MODEL.NUM_CLASSES": 5, "MODEL.HEAD_ACT": "none", "SSL.NUM_MLP_LAYERS": 1,
        "RESNET.DEPTH": 10, "RESNET.TRANS_FUNC": "basic_transform", "RESNET.WIDTH_PER_GROUP": 8,
        "RESNET.NUM_BLOCK_TEMP_KERNEL": [[1], [1], [1], [1]], "BN.NORM_TYPE": "batchnorm",
        "BN.NUM_SYNC_DEVICES": 1, "TPU.COMPUTE_DTYPE": "float32", "TPU.MESH_SYNC": 1,
        "DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_SIZE": 4, "DATA.SYNTHETIC_LENGTH": 100,
        "DATA.SYNTHETIC_NUM_CLASSES": 5, "DATA.WORKERS": 2, "INFER.NUM_CLIPS": 2,
        "INFER.NUM_CROPS": 2, "INFER.NUM_FRAMES": 4, "INFER.STRIDE": 2, "INFER.RES": 32,
        "INFER.BATCHSIZE_PER_GPU": 1, **overrides})
    return mod.assert_and_infer_cfg(cfg)


def jax_variables(cfg, t, s, seed=0):
    model = jbuild_model(cfg, sync_axes=())
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, t, s, s, 3), jnp.float32), train=False))()
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def both_models(jcfg, tcfg, t, s):
    """The JAX model's state (its init) and the port's model with the same
    weights through the param bridge."""
    params, batch_stats = jax_variables(jcfg, t, s)
    jstate = JState(params=params, batch_stats=batch_stats, opt_state=(), step=jnp.zeros((), jnp.int32))
    model = build_model(tcfg, "cpu")
    model.load_state_dict(flax_to_state_dict(params, batch_stats))
    return jstate, model


def eval_key(seed):
    """The key JAX's eval step gives the aug: its seed folded with replica 0."""
    return jax.random.fold_in(jax.random.PRNGKey(seed), 0)


def jax_rrc_boxes(key, n, h, w, scale, ratio):
    """The boxes make_rrc_aug draws for n clips under ``key``, jitted."""
    def one(k):
        return jnp.stack(jaug.sample_rrc_box(jax.random.split(k)[0], h, w, scale, ratio))

    return torch.from_numpy(np.array(jax.jit(jax.vmap(one))(jax.random.split(key, n)), np.float32))


def jax_crop_offsets(key, n, h, w, size):
    """The offsets random_crop_clip draws for n clips under ``key``, jitted."""
    def one(k):
        k1, k2 = jax.random.split(k)
        top = jnp.where(h == size, 0, jax.random.randint(k1, (), 0, max(h - size, 1)))
        left = jnp.where(w == size, 0, jax.random.randint(k2, (), 0, max(w - size, 1)))
        return top, left

    tops, lefts = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    return {"tops": torch.from_numpy(np.array(tops, np.int32)),
            "lefts": torch.from_numpy(np.array(lefts, np.int32))}


def _clips(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("mode,method", [("speed", "uniform"), ("action", "uniform"),
                                         ("action", "random")])
@pytest.mark.parametrize("length", [40, 250])
def test_eval_samplers_equal_jax(mode, method, length):
    over = {"INFER.SAMPLE_METHOD": method, "INFER.JITTER": 0.1, "VAL.JITTER": 0.2, "VAL.STRIDE": 2}
    want_s = jbuild_sampler(speed_val_cfg(jconfig, **over), mode)
    got_s = build_sampler(speed_val_cfg(tconfig, **over), mode)
    assert type(got_s).__name__ == type(want_s).__name__
    for seed in range(3):
        got = got_s(np.random.default_rng(seed), length, {"item_id": 0})
        want = want_s(np.random.default_rng(seed), length, {"item_id": 0})
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].keys() == want[1].keys()
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k])


@pytest.mark.parametrize("path", [SPEED_SMOKE, "configs/eval/linear_probe_ucf.yaml",
                                  "configs/pretrain/SpeedPro_R50.yaml"])
def test_ingest_geometry_and_datasets_equal_jax(path):
    """Every mode's ingest geometry; the eval datasets' items (the dense
    sweep's labels, the views of a video) EQUAL JAX's."""
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_cfg()
        cfg.merge_from_file(path)
        _override(cfg, {"DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_SIZE": 2,
                        "DATA.SYNTHETIC_LENGTH": 60, "DATA.SYNTHETIC_RES": 32, "INFER.NUM_CLIPS": 2})
        cfgs.append(mod.assert_and_infer_cfg(cfg))
    jcfg, tcfg = cfgs
    for mode in ("train", "speed", "action"):
        assert ingest_geometry(tcfg, mode) == jaug.ingest_geometry(jcfg, mode), mode
    for mode in ("speed", "action"):
        want = jbuild_dataset(jcfg, mode).get(1, np.random.default_rng(5))
        got = build_dataset(tcfg, mode).get(1, np.random.default_rng(5))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].keys() == want[1].keys()
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k])


def test_speed_val_aug_holds_jitted_jax():
    """The speed_val RRC (VAL.TARGET_SIZE, scale (VAL.MIN_AREA, 1),
    VAL.RAND_CROP_RATIO) with JAX's boxes, against jitted JAX; then the
    flip of ``random_flip`` against JAX's hflip with its draws; then
    DATA.REVERSE_INPUT_CHANNEL."""
    jcfg, tcfg = speed_val_cfg(jconfig), speed_val_cfg(tconfig)
    w, h = ingest_geometry(tcfg, "speed")
    assert (w, h) == (42, 32)
    batch = _clips((5, 1, 4, h, w, 3), 3)
    key = eval_key(0)
    want = np.asarray(jax.jit(jaug.build_device_aug(jcfg, "speed"))(jnp.asarray(batch), key))
    boxes = jax_rrc_boxes(key, 5, h, w, (jcfg.VAL.MIN_AREA, 1.0), tuple(jcfg.VAL.RAND_CROP_RATIO))
    assert len({tuple(b.tolist()) for b in boxes}) == 5  # the clips crop differently
    aug = build_device_aug(tcfg, "speed")
    got = aug.apply(torch.from_numpy(batch), {"box": boxes}).numpy()
    assert got.shape == want.shape == (5, 1, 4, 32, 32, 3)
    assert float(np.abs(got - want).max()) <= 1e-4

    # random_flip: JAX flips a clip where uniform(k_flip) < 0.5
    jflip = jaug.make_rrc_aug(jcfg, target_size=32, scale=(jcfg.VAL.MIN_AREA, 1.0),
                              ratio=jcfg.VAL.RAND_CROP_RATIO, random_flip=True)
    want = np.asarray(jax.jit(jflip)(jnp.asarray(batch), key))
    flips = jax.jit(jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], ()) < 0.5))(
        jax.random.split(key, 5))
    flips = torch.from_numpy(np.array(flips))
    assert 0 < int(flips.sum()) < 5
    tflip = taug.RRCAug(tcfg, size=32, scale=(tcfg.VAL.MIN_AREA, 1.0), ratio=tcfg.VAL.RAND_CROP_RATIO,
                        random_flip=True)
    got = tflip.apply(torch.from_numpy(batch), {"box": boxes, "flip": flips}).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4

    rev = build_device_aug(speed_val_cfg(tconfig, **{"DATA.REVERSE_INPUT_CHANNEL": True}), "speed")
    x = torch.from_numpy(batch)
    assert torch.equal(rev(x, torch.Generator().manual_seed(1)), aug(x.flip(-1), torch.Generator().manual_seed(1)))


def test_infer_aug_equals_jitted_jax():
    """The inference crop at INFER.RES with JAX's offsets: EQUAL to jitted
    JAX; the offsets the port draws stay in [0, dim - size)."""
    jcfg, tcfg = infer_cfg(jconfig, **{"INFER.RES": 24}), infer_cfg(tconfig, **{"INFER.RES": 24})
    w, h = ingest_geometry(tcfg, "action")
    assert (w, h) == (32, 24)
    batch = _clips((2, 4, 4, h + 6, w, 3), 4)  # rows to spare too
    key = eval_key(jcfg.INFER.SEED)
    want = np.asarray(jax.jit(jaug.build_device_aug(jcfg, "action"))(jnp.asarray(batch), key))
    offsets = jax_crop_offsets(key, 8, h + 6, w, 24)
    assert int(offsets["tops"].max()) > 0 and int(offsets["lefts"].max()) > 0
    got = build_device_aug(tcfg, "action").apply(torch.from_numpy(batch), offsets).numpy()
    assert got.shape == want.shape == (2, 4, 4, 24, 24, 3)
    np.testing.assert_array_equal(got, want)

    drawn = taug.sample_crop_offsets(4096, 30, 24, 24, torch.Generator().manual_seed(0))
    assert set(drawn["tops"].tolist()) == set(range(6)) and set(drawn["lefts"].tolist()) == {0}


def test_eval_step_logits_match_jax():
    """make_eval_step of speed_r18_synth (the speed_val aug, eval-mode
    forward) with JAX's boxes: logits [B, 1, 4] within 1e-4; the forward
    records no BN statistics and leaves the buffers alone."""
    jcfg, tcfg = speed_val_cfg(jconfig), speed_val_cfg(tconfig)
    jstate, model = both_models(jcfg, tcfg, 4, 32)
    w, h = ingest_geometry(tcfg, "speed")
    batch = _clips((3, 1, 4, h, w, 3), 7)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    jstep = jmake_eval_step(jcfg, mesh, jbuild_model(jcfg), jaug.build_device_aug(jcfg, "speed"))
    want = np.asarray(jstep(jstate.params, jstate.batch_stats, jnp.asarray(batch), {}, jax.random.PRNGKey(0)))
    boxes = jax_rrc_boxes(eval_key(0), 3, h, w, (jcfg.VAL.MIN_AREA, 1.0), tuple(jcfg.VAL.RAND_CROP_RATIO))
    aug = build_device_aug(tcfg, "speed")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_eval_step(tcfg, lambda x, g: aug.apply(x, {"box": boxes}))
    model.train()
    got = step(model, torch.from_numpy(batch), None)
    assert not model.training and got.shape == want.shape == (3, 1, 4)
    assert rel_err(got, want) <= TOL
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert all(not getattr(m, "pending", []) for m in model.modules())


def _capture(monkeypatch, module, out):
    """Record every logits array the eval step of ``module`` returns."""
    make = module.make_eval_step

    def wrapped(*args):
        step = make(*args)

        def run(*a):
            logits = step(*a)
            out.append(np.asarray(logits.detach() if torch.is_tensor(logits) else logits, np.float32))
            return logits

        return run

    monkeypatch.setattr(module, "make_eval_step", wrapped)


def _check_logits(got, want):
    """Each batch's logits within TOL; the flattened JAX logits."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g, w) <= TOL
    return np.concatenate([w.reshape(w.shape[0], -1, w.shape[-1]) for w in want])


def _decided(logits):
    """Rows whose top-two margin exceeds TOL of the largest logit."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > TOL * np.abs(logits).max()


def test_validation_matches_jax(tmp_path, monkeypatch):
    """validation over 2 synthetic videos (16 clips each, chunks of 3, the
    last padded), JAX's boxes handed to the port's aug: the confusion
    matrix and Metrics.csv as JAX's."""
    jcfg = speed_val_cfg(jconfig, **{"DATA.WORKERS": 2})
    tcfg = speed_val_cfg(tconfig, **{"DATA.WORKERS": 2})
    jcfg.LOGDIR, tcfg.LOGDIR = str(tmp_path / "jax"), str(tmp_path / "port")
    jstate, model = both_models(jcfg, tcfg, 4, 32)
    w, h = ingest_geometry(tcfg, "speed")
    boxes = jax_rrc_boxes(eval_key(0), 3, h, w, (jcfg.VAL.MIN_AREA, 1.0), tuple(jcfg.VAL.RAND_CROP_RATIO))
    monkeypatch.setattr(taug.RRCAug, "sample", lambda self, n, *shape: {"box": boxes[:n]})
    jlogits, tlogits = [], []
    _capture(monkeypatch, jvalidate_mod, jlogits)
    _capture(monkeypatch, tvalidate_mod, tlogits)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    want = jvalidate_mod.validation(jcfg, jbuild_model(jcfg), jstate, mesh=mesh, max_videos=2)
    record = {}
    got = tvalidate_mod.validation(tcfg, model, TrainState(model, {}, 0), device="cpu", max_videos=2,
                                   record=record)
    assert len(tlogits) == 11  # 32 clips in chunks of 3
    flat = _check_logits(tlogits, jlogits)[:32, 0]
    ours = np.concatenate(tlogits)[:32, 0]
    decided = _decided(flat)
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(ours.argmax(-1)[decided], flat.argmax(-1)[decided])
    if decided.all():
        np.testing.assert_array_equal(got, want)
        assert (tmp_path / "port" / "Metrics.csv").read_bytes() == (tmp_path / "jax" / "Metrics.csv").read_bytes()
    assert got.sum() == 32 and record["clips"] == 32 and record["batches"] == 11
    assert record["confusion"] == got.tolist() and record["acc"] == pytest.approx(np.trace(got) / 32)


def test_inference_matches_jax(monkeypatch):
    """inference over tests/test_inference.py's 4 synthetic videos (2 clips x
    2 crops each), JAX's crop offsets handed to the port's aug: acc,
    correct and total as JAX's."""
    jcfg, tcfg = infer_cfg(jconfig), infer_cfg(tconfig)
    jstate, model = both_models(jcfg, tcfg, 4, 32)
    w, h = ingest_geometry(tcfg, "action")
    offsets = jax_crop_offsets(eval_key(jcfg.INFER.SEED), 4, h, w, 32)
    assert int(offsets["lefts"].max()) > 0
    monkeypatch.setattr(taug.InferAug, "sample", lambda self, n, *shape: offsets)
    jlogits, tlogits = [], []
    _capture(monkeypatch, jinference_mod, jlogits)
    _capture(monkeypatch, tinference_mod, tlogits)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    want = jinference_mod.inference(jcfg, jbuild_model(jcfg), jstate, mesh=mesh, max_videos=4)
    record = {}
    got = tinference_mod.inference(tcfg, model, TrainState(model, {}, 0), device="cpu", max_videos=4,
                                   record=record)
    flat = _check_logits(tlogits, jlogits)  # [4 videos, 4 views, 5]
    ours = np.concatenate(tlogits).reshape(flat.shape)
    decided = _decided(flat.mean(axis=1))
    np.testing.assert_array_equal(ours.mean(axis=1).argmax(-1)[decided], flat.mean(axis=1).argmax(-1)[decided])
    if decided.all():
        assert got == want
    assert got[2] == 4 and record["views"] == 16 and record["batches"] == 4
