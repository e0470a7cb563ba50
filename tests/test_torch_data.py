"""The port's data pipeline (advise_tpu_torch/data: sampling, video_io,
dataset, loader, prefetch and the factory) against the JAX package's.

- The samplers are the port's copy of ``advise_tpu/data/sampling.py``:
  equal stamps and infos from the same numpy generators.
- The resize states cv2's INTER_LINEAR uint8 arithmetic (the note in
  advise_tpu_torch/data/video_io.py). Downscales, the smoke configs'
  64 -> 24 x 20 among them, and upscales, the BYOL preset's 128 -> 298 x
  224 ingest among them, are held EQUAL to cv2.
- The loader on configs/smoke/byol_r10_synth.yaml with the synthetic
  backend yields uint8 batches and infos EQUAL to ``advise_tpu.data.
  build_loader``'s for two epochs (the JAX loader's batch is per-device
  batch x jax.device_count(); the port's is per-card batch x n_devices).
"""

import json

import cv2
import jax
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.data import build_loader as jbuild_loader
from advise_tpu.data import sampling as jspl
from advise_tpu.data.dataset import ClipDataset as JClipDataset
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_dataset, build_loader, sampling as tspl
from advise_tpu_torch.data.dataset import ClipDataset, parse_label_list
from advise_tpu_torch.data.prefetch import device_put_batch, prefetch_to_device
from advise_tpu_torch.data.video_io import ArrayReader, SyntheticReader, resize_bilinear_u8

torch.set_num_threads(1)

SMOKE = "configs/smoke/byol_r10_synth.yaml"


def _cfg(mod, path=SMOKE, **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file(path)
    for key, value in overrides.items():
        node = cfg
        *path_, leaf = key.split(".")
        for p in path_:
            node = node[p]
        node[leaf] = value
    return mod.assert_and_infer_cfg(cfg)


SAMPLERS = {
    "speed": lambda m: m.SpeedClipSampler(num_clips=4, num_frames=8, stride=2,
                                          speed_range=[1, 2, 4, 8], jitter=0.2),
    "uniform": lambda m: m.UniformClipSampler(num_clips=2, num_frames=16, stride=2),
    "tmodeling": lambda m: m.TemporalModelingSampler(num_clips=3, num_frames=8, stride=2,
                                                     speed_range=[1, -2, 4], jitter=0.1),
    "speed_val": lambda m: m.SpeedValSampler(num_frames=8, stride=2, speed_range=[1, 2, 4],
                                             jitter=0.0, fps=25),
    "inference": lambda m: m.InferenceClipSampler(num_clips=3, num_crops=2, num_frames=8,
                                                  stride=2, jitter=0.1),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
@pytest.mark.parametrize("length", [40, 250])
def test_sampler_copy_matches_jax(name, length):
    for seed in range(3):
        got = SAMPLERS[name](tspl)(np.random.default_rng(seed), length, {"item_id": 0})
        want = SAMPLERS[name](jspl)(np.random.default_rng(seed), length, {"item_id": 0})
        if want[0] is None:
            assert got == (None, None)
            continue
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].keys() == want[1].keys()
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k])


@pytest.mark.parametrize("src,dst", [((64, 64), (24, 20)), ((128, 128), (42, 32)),
                                     ((120, 160), (80, 60)), ((128, 128), (64, 64)),
                                     ((101, 77), (33, 50))])
def test_resize_downscale_equals_cv2(src, dst):
    """Downscales (the 2x case is cv2's INTER_AREA shortcut, which the
    linear arithmetic equals too) and a mixed one (upscale in one axis)."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    frames = rng.integers(0, 256, (3, *src, 3), dtype=np.uint8)
    got = resize_bilinear_u8(frames, dst)
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g, cv2.resize(f, dst, interpolation=cv2.INTER_LINEAR))


def test_resize_upscale_within_one_of_cv2():
    """128 -> 298 x 224 (the BYOL preset's synthetic ingest): equal to cv2 on
    every pixel, the first and last output rows among them (their vertical
    taps keep the fraction and both read the edge row, as cv2's do)."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    got = resize_bilinear_u8(frames, (298, 224))
    want = np.stack([cv2.resize(f, (298, 224), interpolation=cv2.INTER_LINEAR) for f in frames])
    np.testing.assert_array_equal(got, want)


def test_synthetic_reader_matches_jax():
    """The same procedural frames, resized at the ingest geometry of the
    smoke config and the BYOL preset's (an upscale): equal."""
    from advise_tpu.data.video_io import SyntheticReader as JReader

    idx = [0, 5, 77, 200]
    for res, wh in ((64, (24, 20)), (128, (298, 224)), (96, None)):
        got = SyntheticReader(seed=3, res=res, cls_id=2, class_coded=True).get_frames(idx, wh)
        want = JReader(seed=3, res=res, cls_id=2, class_coded=True).get_frames(idx, wh)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_loader_matches_jax_for_two_epochs():
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    jl = jbuild_loader(jcfg, "train")
    tl = build_loader(tcfg, "train", n_devices=jax.device_count())
    assert tl.batch_size == jl.batch_size and len(tl.dataset) == len(jl.dataset)
    for epoch in (0, 1):
        assert tl.steps_per_epoch(epoch) == jl.steps_per_epoch(epoch) == 2
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) == 2
        for (gc, gi), (wc, wi) in zip(got, want):
            assert gc.dtype == np.uint8 and gc.shape == wc.shape == (8, 2, 2, 20, 24, 3)
            np.testing.assert_array_equal(gc, wc)
            assert gi.keys() == wi.keys() == {"item_id", "cls_id", "length", "time_idx"}
            for k in wi:
                assert gi[k].dtype == wi[k].dtype, k
                np.testing.assert_array_equal(gi[k], wi[k])
    gc, gi = tl.take_one(5)
    wc, wi = jl.take_one(5)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gi["item_id"], wi["item_id"])


def test_speed_and_masked_items_match_jax():
    """The speed task's SpeedClipSampler labels and the masked task's block
    masks come out of the dataset as in JAX."""
    from advise_tpu.data import build_dataset as jbuild_dataset

    for preset, over, key in (
            ("configs/pretrain/SpeedPro_R50.yaml", {"AUG.RESIZE": [24, 20]}, "spd_label"),
            ("configs/pretrain/MViT_L_32x312_joint.yaml",
             {"DATA.NUM_FRAMES": 4, "AUG.TARGET_SIZE": 32, "DATA.TRAIN_CROP_SIZE": 32,
              "DATA.TEST_CROP_SIZE": 32}, "mask")):
        over = {"DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_RES": 40, **over}
        tds = build_dataset(_cfg(tconfig, preset, **over))
        jds = jbuild_dataset(_cfg(jconfig, preset, **over))
        for idx in (0, 3):
            got = tds.get(idx, np.random.default_rng(idx))
            want = jds.get(idx, np.random.default_rng(idx))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1][key], want[1][key])


def test_label_lists_and_retry_policy_match_jax(tmp_path):
    """A kinetics split file whose videos are .npy archives, two of them
    missing: both datasets parse the same list and replace a failing item
    with the same random substitute (the 10-retry policy)."""
    rng = np.random.default_rng(0)
    lines = []
    for i in range(6):
        if i not in (1, 4):
            np.save(tmp_path / f"v{i}.npy", rng.integers(0, 256, (30, 20, 24, 3), dtype=np.uint8))
        lines.append(f"v{i}.npy {i % 3}")
    (tmp_path / "train.csv").write_text("\n".join(lines) + "\n")
    (tmp_path / "ssv2.json").write_text(json.dumps([{"id": "7", "template": "Put [sth]"}]))
    (tmp_path / "something-something-v2-labels.json").write_text(json.dumps({"Put sth": 3}))
    assert parse_label_list("something", str(tmp_path), "ssv2.json") == [("7.avi", 3)]
    kw = dict(name="kinetics", data_dir=str(tmp_path), label_dir=str(tmp_path),
              split_name="train.csv", sampler=tspl.UniformClipSampler(2, 4, 2), ingest_wh=(24, 20))
    tds = ClipDataset(**kw)
    jds = JClipDataset(**{**kw, "sampler": jspl.UniformClipSampler(2, 4, 2)})
    assert tds.items == jds.items == [(f"v{i}.npy", i % 3) for i in range(6)]
    for idx in range(6):
        got = tds.get(idx, np.random.default_rng(idx))
        want = jds.get(idx, np.random.default_rng(idx))
        np.testing.assert_array_equal(got[0], want[0])
        assert {k: int(v) if np.ndim(v) == 0 else v for k, v in got[1].items() if k != "time_idx"} == \
            {k: int(v) if np.ndim(v) == 0 else v for k, v in want[1].items() if k != "time_idx"}
    dead = ClipDataset(**{**kw, "split_name": "train.csv", "retries": 3})
    dead.items = [("v1.npy", 0), ("v4.npy", 1)]
    with pytest.raises(RuntimeError, match="After 3 retries"):
        dead.get(0, np.random.default_rng(0))
    assert ArrayReader(tmp_path / "v0.npy").get_frames([0, 3]).shape == (2, 20, 24, 3)


def test_factory_raises_for_what_is_not_ported():
    """TPU.DEVICE_AUG False takes the host aug for AUG.TYPE 'simple' and,
    as in JAX, raises for the other types; mode 'knn' and remote paths are
    not ported."""
    from advise_tpu_torch.data.host_aug import SimpleHostAug

    assert isinstance(build_dataset(_cfg(tconfig, **{"TPU.DEVICE_AUG": False})).host_aug, SimpleHostAug)
    with pytest.raises(NotImplementedError, match="host aug only supports AUG.TYPE='simple'"):
        build_dataset(_cfg(tconfig, **{"TPU.DEVICE_AUG": False, "AUG.TYPE": "aa"}))
    with pytest.raises(NotImplementedError, match="mode=knn"):
        build_dataset(_cfg(tconfig), mode="knn")
    from advise_tpu_torch.utils import storage

    with pytest.raises(NotImplementedError, match="remote path"):
        storage.local_path("s3://bucket/video.mp4")
    assert storage.local_path("file:///tmp/x.npy") == "/tmp/x.npy"


def test_prefetch_on_cpu_keeps_order_and_values():
    """On the CPU the prefetch wraps the arrays as tensors, in order, with no
    copy event; every size in flight gives the same batches."""
    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (2, 1, 3, 4, 5, 3), dtype=np.uint8),
             {"item_id": np.arange(2) + 2 * i, "time_idx": np.float32([0.5, 0.25])}) for i in range(5)]
    clips, infos, event = device_put_batch(*host[0], "cpu")
    assert event is None and clips.dtype == torch.uint8 and infos["item_id"].dtype == torch.int64
    for size in (1, 2, 4):
        out = list(prefetch_to_device(iter(host), "cpu", size=size))
        assert len(out) == len(host)
        for (c, i), (hc, hi) in zip(out, host):
            np.testing.assert_array_equal(c.numpy(), hc)
            np.testing.assert_array_equal(i["item_id"].numpy(), hi["item_id"])
            np.testing.assert_array_equal(i["time_idx"].numpy(), hi["time_idx"])
