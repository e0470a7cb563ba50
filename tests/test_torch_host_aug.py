"""The port's host aug (TPU.DEVICE_AUG False, ``data/host_aug.py``, numpy)
against the JAX package's, which runs PIL: equal bit for bit, on frames
that take the resize branch and frames that do not, over random sizes,
seeds and AUG.COLOR. The port imports no PIL; Pillow is reached here only
through the JAX package."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from advise_tpu import config as jconfig
from advise_tpu.data.host_aug import SimpleHostAug as JSimpleHostAug
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import host_aug as thost


def _cfg(mod, resize, size, color):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/SpeedPro_R50.yaml")
    cfg.TPU.DEVICE_AUG = False
    cfg.AUG.RESIZE = list(resize)
    cfg.AUG.TARGET_SIZE = size
    cfg.AUG.COLOR = list(color)
    return cfg


def _frames(seed, t, h, w):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    x[:, : h // 2] = np.clip(x[:, : h // 2] // 3 + 80, 0, 255)  # a low-contrast band
    return x


_COLOR = st.tuples(st.floats(0.0, 1.0), st.floats(0.0, 0.9), st.floats(0.0, 0.9),
                   st.floats(0.0, 0.9), st.floats(0.0, 0.5))


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2**31 - 2), t=st.integers(1, 3), h=st.integers(12, 40), w=st.integers(12, 40),
       rw=st.integers(10, 36), rh=st.integers(10, 36), color=_COLOR, same=st.booleans())
def test_simple_host_aug_equals_pil(seed, t, h, w, rw, rh, color, same):
    """A clip of t frames at h x w (or, with ``same``, already at AUG.RESIZE),
    resized to (rw, rh), cropped to a square of at most that size,
    jittered and normalized: the port's output equals PIL's bit for bit."""
    if same:
        h, w = rh, rw
    size = min(rw, rh) - seed % 3
    clip = _frames(seed, t, h, w)
    want = JSimpleHostAug(_cfg(jconfig, (rw, rh), size, color))(clip, seed)
    got = thost.SimpleHostAug(_cfg(tconfig, (rw, rh), size, color))(clip, seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_wh,out_wh", [((341, 256), (320, 256)), ((298, 224), (320, 256)),
                                          ((64, 48), (21, 37)), ((17, 23), (80, 9))])
def test_pil_resize_bilinear_equals_pil(in_wh, out_wh):
    """The two-pass resample alone, shrinking and growing each axis."""
    from PIL import Image

    w, h = in_wh
    frame = _frames(3, 1, h, w)[0]
    want = np.asarray(Image.fromarray(frame).resize(out_wh, resample=Image.BILINEAR))
    got = thost.pil_resize_bilinear(frame[None], out_wh)[0]
    np.testing.assert_array_equal(got, want)


def test_build_host_aug_types():
    """Only 'simple' runs on the host, as in JAX."""
    cfg = _cfg(tconfig, (40, 32), 24, (0.8, 0.4, 0.4, 0.4, 0.2))
    assert isinstance(thost.build_host_aug(cfg), thost.SimpleHostAug)
    cfg.AUG.TYPE = "aa"
    with pytest.raises(NotImplementedError, match="simple"):
        thost.build_host_aug(cfg)


def _speed_cfgs(**overrides):
    from torch_port_common import speed_cfg

    over = {"TPU.DEVICE_AUG": False, "DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_SIZE": 4,
            "DATA.SYNTHETIC_RES": 48, "DATA.WORKERS": 2, **overrides}
    return speed_cfg(jconfig, **over), speed_cfg(tconfig, **over)


def test_speed_step_on_host_aug_clips_matches_jax():
    """The speed preset with TPU.DEVICE_AUG False: the loader's items (the
    synthetic frames through the host aug, one seed per clip from the
    item's generator) equal the JAX loader's bit for bit, and one speed
    step on them without a device aug matches JAX's at
    tests/test_torch_speed_step.py's tolerance: each tensor within 1e-2 of
    what JAX's moved plus 1e-6 of the tree's largest value, the loss within
    1e-4."""
    import jax
    import jax.numpy as jnp
    import torch

    from advise_tpu.data import build_dataset as jbuild_dataset
    from advise_tpu.engine.state import TrainState as JState
    from advise_tpu.engine.steps import make_train_step as jmake_step
    from advise_tpu.models import build_model as jbuild_model
    from advise_tpu.parallel import build_mesh
    from advise_tpu.solver import build_tx as jbuild_tx
    from advise_tpu_torch.data import build_dataset
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.solver.optimizer import build_tx
    from advise_tpu_torch.utils.convert import batch_stats_to_torch, params_to_torch
    from torch_port_common import SPEED_S, SPEED_T, moved_within, on_mesh, speed_variables

    jcfg, tcfg = _speed_cfgs()
    jds, tds = jbuild_dataset(jcfg, "train"), build_dataset(tcfg, "train")
    items = []
    for idx in range(2):
        jclips, jinfo = jds.get(idx, np.random.default_rng(idx))
        tclips, tinfo = tds.get(idx, np.random.default_rng(idx))
        assert tclips.dtype == np.float32 and tclips.shape == (2, SPEED_T, SPEED_S, SPEED_S, 3)
        np.testing.assert_array_equal(tclips, jclips)
        np.testing.assert_array_equal(tinfo["spd_label"], jinfo["spd_label"])
        items.append((tclips, tinfo["spd_label"]))
    clips = np.stack([c for c, _ in items])
    labels = np.stack([lab for _, lab in items]).astype(np.int32)

    mesh = build_mesh(jcfg, jax.devices()[:1])
    params, batch_stats = speed_variables(jbuild_model(jcfg, sync_axes=()))
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32)), mesh)
    jstate, jstats = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)(
        jstate, jnp.asarray(clips), {"spd_label": labels}, jax.random.PRNGKey(0), jnp.float32(1e-3))
    model = build_model(tcfg, "cpu")
    model.load_state_dict({**params_to_torch(params), **batch_stats_to_torch(batch_stats)})
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0)
    tstats = make_train_step(tcfg, tbundle, None)(
        tstate, torch.from_numpy(clips), {"spd_label": torch.from_numpy(labels)}, None, float(np.float32(1e-3)))
    assert abs(tstats["loss_spd"].item() - float(jstats["loss_spd"])) <= 1e-4
    want = params_to_torch(jax.device_get(jstate.params))
    got = {k: v.detach() for k, v in model.named_parameters()}
    assert not moved_within(got, want, params_to_torch(params), tol=1e-2)


def test_trainer_runs_speed_with_host_aug(tmp_path):
    """The speed preset through the trainer with TPU.DEVICE_AUG False: the
    loader's host aug makes the clips (its seconds in the run record's
    ``host_s``), the step takes them as they are (no K3 launch), and the
    first iteration equals a step on the loader's first batch."""
    import torch

    from advise_tpu_torch.data import build_loader
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.engine.train import build_train_state, seeded_generator, select_infos, trainer
    from advise_tpu_torch.ops import fused_aug
    from advise_tpu_torch.solver import lr_policy as tlr
    from advise_tpu_torch.solver import optimizer as toptim

    _, cfg = _speed_cfgs(**{"TRAIN.SAVE_FREQ": 1, "SOLVER.MAX_EPOCH": 1})
    cfg.LOGDIR = str(tmp_path)
    assert cfg.TPU.PALLAS_AUG and not cfg.TPU.DEVICE_AUG
    ref_cfg = cfg.clone()
    ref_cfg.NUM_WORLDS = 1
    toptim.adjust_base_lr(ref_cfg)
    clips, infos = next(iter(build_loader(ref_cfg).epoch(0)))
    assert clips.dtype == np.float32
    state, bundle = build_train_state(ref_cfg, "cpu")
    want = make_train_step(ref_cfg, bundle, None)(
        state, torch.from_numpy(clips), {k: torch.from_numpy(v) for k, v in select_infos(ref_cfg, infos).items()},
        seeded_generator("cpu", ref_cfg.TRAIN.SEED, 0, 0), tlr.get_lr_at_epoch(ref_cfg, 0.5))
    record = {}
    fused_aug.fused_simple_aug.launches = 0
    trainer(cfg, device="cpu", record=record)
    assert fused_aug.fused_simple_aug.launches == 0
    assert record["stats"][0]["loss_spd"] == float(want["loss_spd"])
    assert len(record["iter_s"]) == 2 and all(np.isfinite(v) for st in record["stats"] for v in st.values())
    seconds, calls = record["host_s"]["host_aug"]
    assert calls == 4 and seconds > 0
