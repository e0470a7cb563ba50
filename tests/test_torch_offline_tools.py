"""The port's offline tools (advise_tpu_torch/utils/visualization.py
clips2videos, get_features, cam_heatmaps; advise_tpu_torch/tools/run_tsne.py)
against the JAX package's, on the CPU:

- ``cam_heatmaps`` EQUAL to JAX's on both branches: cv2's resize to the
  frame, and the token grid where cv2 does not import (the port's cv2 made
  to look absent, JAX's ``_HAS_CV2`` off);
- ``get_features`` over a Slow R3D-10 backbone built with
  ``include_head=False`` (JAX's variables through the param bridge) on the
  same augmented clips (the train aug stubbed to the identity on both
  sides): the features within 1e-4 of JAX's largest, labels and ids equal;
- ``clips2videos``: the frames decoded back from the port's .mp4 files
  EQUAL to those decoded from JAX's;
- ``run_tsne``'s embedding at the same seed within 1e-5 of JAX's, and
  ``main`` writes a PNG;
- the raises where cv2, scikit-learn or matplotlib does not import.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advise_tpu import config as jconfig
from advise_tpu.config.node import CfgRef
from advise_tpu.models.layers.norm import get_norm as jget_norm
from advise_tpu.models.resnet3d import ResNet3D as JResNet3D
from advise_tpu.tools import run_tsne as jtsne
from advise_tpu.utils import visualization as jvis
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models.layers.norm import get_norm
from advise_tpu_torch.models.resnet3d import ResNet3D
from advise_tpu_torch.tools import run_tsne as ttsne
from advise_tpu_torch.utils import visualization as tvis
from advise_tpu_torch.utils.convert import flax_to_state_dict

from torch_port_common import SPEED_S, SPEED_T, speed_cfg

cv2 = pytest.importorskip("cv2")
MEAN, STD = [0.45, 0.45, 0.45], [0.225, 0.225, 0.225]


def _tokens(seed=0, n=3, grid=7, dim=16):
    return np.random.default_rng(seed).standard_normal((n, grid * grid, dim)).astype(np.float32)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_cam_heatmaps_equal_jax(monkeypatch, with_cv2):
    if not with_cv2:
        monkeypatch.setattr(tvis, "_cv2", lambda: None)
        monkeypatch.setattr(jvis, "_HAS_CV2", False)
    got = tvis.cam_heatmaps(_tokens(), 7, 32)
    want = jvis.cam_heatmaps(_tokens(), 7, 32)
    assert got.shape == ((3, 32, 32) if with_cv2 else (3, 7, 7))
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


class _Loader:
    """Two batches of already-augmented clips [2, 2, T, S, S, 3]."""

    def epoch(self, epoch):
        for i in range(2):
            rng = np.random.default_rng(10 + i)
            clips = rng.standard_normal((2, 2, SPEED_T, SPEED_S, SPEED_S, 3)).astype(np.float32)
            yield clips, {"cls_id": np.array([i, i + 1]), "item_id": np.array([2 * i, 2 * i + 1])}


def test_get_features_equal_jax(tmp_path, monkeypatch):
    import advise_tpu.data as jdata
    import advise_tpu_torch.data as tdata

    monkeypatch.setattr(jdata, "build_device_aug", lambda cfg, mode: (lambda clips, rng: clips))
    monkeypatch.setattr(tdata, "build_device_aug", lambda cfg, mode: (lambda clips, gen: clips))
    jcfg, tcfg = speed_cfg(jconfig), speed_cfg(tconfig)
    jm = JResNet3D(cfg=CfgRef(jcfg), norm=jget_norm(jcfg, ()), dtype=jnp.float32, include_head=False)
    v = jax.device_get(jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, SPEED_T, SPEED_S, SPEED_S, 3)), train=False))())
    tm = ResNet3D(tcfg, get_norm(tcfg), include_head=False)
    tm.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    state = type("S", (), {"params": v["params"], "batch_stats": v["batch_stats"]})()
    jvis.get_features(jcfg, jm, state, _Loader(), str(tmp_path / "jax.npz"))
    out = tvis.get_features(tcfg, tm, None, _Loader(), str(tmp_path / "port.npz"), device="cpu")
    got, want = np.load(out), np.load(tmp_path / "jax.npz")
    assert got["features"].shape == want["features"].shape and want["features"].shape[0] == 4
    assert np.abs(got["features"] - want["features"]).max() <= 1e-4 * np.abs(want["features"]).max()
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["item_ids"], want["item_ids"])


def _decoded(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("labels", [None, [1, 4]])
def test_clips2videos_equal_jax(tmp_path, labels):
    clips = np.random.default_rng(3).standard_normal((2, 5, 24, 32, 3)).astype(np.float32)
    got = tvis.clips2videos(clips, str(tmp_path / "port"), MEAN, STD, labels=labels, fps=4)
    want = jvis.clips2videos(clips, str(tmp_path / "jax"), MEAN, STD, labels=labels, fps=4)
    assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want] == [
        "clip_0000.mp4", "clip_0001.mp4"]
    for a, b in zip(got, want):
        frames = _decoded(a)
        assert frames.shape == (5, 24, 32, 3)
        np.testing.assert_array_equal(frames, _decoded(b))


def test_clips2videos_names_cv2_when_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setattr(tvis, "_cv2", lambda: None)
    with pytest.raises(ImportError, match="cv2"):
        tvis.clips2videos(np.zeros((1, 2, 8, 8, 3), np.float32), str(tmp_path), MEAN, STD)


def _features(tmp_path, n=24):
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    path = tmp_path / "feats.npz"
    np.savez(path, features=feats, labels=labels, item_ids=np.arange(n))
    return feats, labels, path


def test_run_tsne_equal_jax_and_main_writes_a_png(tmp_path):
    feats, labels, path = _features(tmp_path)
    got = ttsne.run_tsne(feats, labels, 30.0, seed=0)
    want = jtsne.run_tsne(feats, labels, 30.0, seed=0)
    assert got.shape == (24, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    out = ttsne.main(["--features", str(path), "--output", str(tmp_path / "tsne.png"), "--max-points", "20"])
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("module,package", [("sklearn.manifold", "scikit-learn"), ("matplotlib", "matplotlib")])
def test_run_tsne_names_a_missing_package(tmp_path, monkeypatch, module, package):
    _, _, path = _features(tmp_path)
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=package):
        ttsne.main(["--features", str(path), "--output", str(tmp_path / "tsne.png")])
