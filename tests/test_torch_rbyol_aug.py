"""The port's 'rbyol' aug (advise_tpu_torch/data/device_aug.py RByolAug, the
MoCo-v2 / BYOL stack) against the JAX package's ``make_rbyol_aug`` under
``jax.jit``, op by op and whole, with the parameters JAX draws from its
key handed to the port.

Held EQUAL: grayscale (the PIL luma of float images), the flip, the motion
shift's per-frame boxes (b1 (1 - a) + b2 a floored; XLA contracts it into
one fused multiply-add, and the port does the same). Within a bound:

- the per-frame resized crops, 2e-3 absolute on [0, 255] values (jitted
  XLA takes 1 / scale as box size times float32(1 / size), sums the
  weight columns in windows and contracts the sample positions: ~1e-6 of
  a sample position, times neighbours up to 255 apart in these random
  pixels when a box is upscaled; measured 6.9e-4);
- the Gaussian blur, 1e-4 absolute on [0, 255] (the 9 taps' exp and the
  sums rounded apart; measured below 4e-5);
- the whole aug, normalized, bf16 out: the crop's difference reaches the
  colour ops' rounding to uint8 levels, so a value may sit a level apart
  (1 / (255 std) ~ 0.0175 in the output; the blur spreads it, and the bf16
  store rounds it by up to 0.0156): at most 0.07 absolute, at most 0.5 %
  of the values more than 0.02 apart, and a mean difference at most 2e-4
  (measured: 0.0547, 0.082 % and 7.1e-5 over the 12 draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.data import device_aug as jaug
from advise_tpu.data import erasing as jerasing
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, ingest_geometry
from advise_tpu_torch.data import device_aug as taug
from advise_tpu_torch.data import erasing as terasing

torch.set_num_threads(1)

MOCO = "configs/chip/moco_knn_minik400.yaml"  # AUG.COLOR (0.8, 0.4, 0.4, 0.4, 0.2), GRAYSCALE 0.2
MOCO_CC = "configs/chip/moco_knn_minik400cc.yaml"  # (0.6, 0.4, 0.4, 0.2, 0.05), GRAYSCALE 0.1
SIZE, T = 24, 3


def _cfgs(preset, **overrides):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_cfg()
        cfg.merge_from_file(preset)
        cfg.AUG.TARGET_SIZE = SIZE
        for key, value in overrides.items():
            sec, leaf = key.split(".")
            cfg[sec][leaf] = value
        out.append(mod.assert_and_infer_cfg(cfg))
    return out


def jax_params(cfg, key, n, t, h, w):
    """What ``make_rbyol_aug`` draws from ``key`` for n clips, as tensors."""
    p, b, c, s, hue = cfg.AUG.COLOR
    scale, ratio = (cfg.AUG.MIN_AREA, 1.0), tuple(cfg.AUG.RAND_CROP_RATIO)

    def one(k):
        k_box, k_col, k_gray, k_blur, k_bp, k_flip = jax.random.split(k, 6)
        if cfg.AUG.TRAIN_JITTER_MOTION_SHIFT:
            box = jaug.motion_shift_boxes(k_box, t, h, w, scale, ratio)
        else:
            box = jnp.stack(jaug.sample_rrc_box(k_box, h, w, scale, ratio))
        k_apply, k_b, k_c, k_s, k_h, k_perm = jax.random.split(k_col, 6)
        return (box,
                jax.random.uniform(k_b, (), minval=max(0.0, 1.0 - b), maxval=1.0 + b),
                jax.random.uniform(k_c, (), minval=max(0.0, 1.0 - c), maxval=1.0 + c),
                jax.random.uniform(k_s, (), minval=max(0.0, 1.0 - s), maxval=1.0 + s),
                jax.random.uniform(k_h, (), minval=-hue, maxval=hue),
                jax.random.permutation(k_perm, 4),
                (jax.random.uniform(k_apply, ()) < p).astype(jnp.int32),
                jax.random.uniform(k_gray, ()) < cfg.AUG.GRAYSCALE,
                jax.random.uniform(k_blur, (), minval=cfg.AUG.SSL_BLUR_SIGMA_MIN[1],
                                   maxval=cfg.AUG.SSL_BLUR_SIGMA_MAX[1]),
                jax.random.uniform(k_bp, ()) < 0.5,
                jax.random.uniform(k_flip, ()) < 0.5)

    drawn = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    names = ("boxes" if cfg.AUG.TRAIN_JITTER_MOTION_SHIFT else "box", "bfac", "cfac", "sfac", "hfac",
             "order", "apply", "gray", "sigma", "blur", "flip")
    return {k: torch.from_numpy(np.array(v)) for k, v in zip(names, drawn)}


def _float_clips(shape, seed):
    """Float clips in [0, 255] that are not on the integer grid (the crop's
    output), with a gray left third."""
    x = np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)
    x[..., : shape[-2] // 3, :] = x[..., : shape[-2] // 3, :1]
    return x


def _keys(n, seed):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def test_grayscale_and_flip_equal_jax():
    x = _float_clips((6, T, 10, 12, 3), 0)
    keys = _keys(6, 0)
    want = np.asarray(jax.jit(jax.vmap(lambda c, k: jaug.grayscale_clip(c, k, 0.5)))(jnp.asarray(x), keys))
    gray = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, ()) < 0.5)(keys)))
    assert 0 < int(gray.sum()) < 6
    np.testing.assert_array_equal(taug.grayscale(torch.from_numpy(x), gray).numpy(), want)
    want = np.asarray(jax.jit(jax.vmap(jaug.hflip_clip))(jnp.asarray(x), keys))
    flip = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, ()) < 0.5)(keys)))
    got = torch.where(flip.view(-1, 1, 1, 1, 1), torch.from_numpy(x).flip(3), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gaussian_blur_within_bound_of_jax():
    """Sigmas over [0.1, 2) of the presets, clips of 10 x 12 (the edge pad
    reaches past the middle)."""
    x = _float_clips((8, T, 10, 12, 3), 1)
    keys = _keys(8, 1)
    want = np.asarray(jax.jit(jax.vmap(lambda c, k: jerasing.gaussian_blur_clip(c, k)))(jnp.asarray(x), keys))
    sigma = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, (), minval=0.1, maxval=2.0))(keys)))
    got = terasing.gaussian_blur_clips(torch.from_numpy(x), sigma).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_motion_shift_boxes_equal_jax():
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.jit(lambda k: jaug.motion_shift_boxes(k, 8, 60, 80, (0.3, 1.0), (0.75, 4 / 3)))(key))
        k1, k2 = jax.random.split(key)
        b1, b2 = (torch.from_numpy(np.array(jnp.stack(jax.jit(
            lambda kk: jaug.sample_rrc_box(kk, 60, 80, (0.3, 1.0), (0.75, 4 / 3)))(k)))) for k in (k1, k2))
        got = taug.motion_boxes(b1[None], b2[None], 8)[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert got.shape == (8, 4) and not np.array_equal(got[0], got[-1])


def test_per_frame_crops_within_bound_of_jax():
    x = _float_clips((3, T, 30, 40, 3), 2)
    boxes = np.asarray([[[0, 0, 30, 40], [2, 3, 20, 25], [5, 9, 13, 31]],
                        [[1, 1, 24, 24], [1, 2, 24, 26], [2, 3, 22, 29]],
                        [[10, 5, 9, 14], [9, 6, 11, 16], [8, 7, 13, 18]]], np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda c, b: jaug.resized_crop_clip_boxes(c, b, (SIZE, SIZE))))(
        jnp.asarray(x), jnp.asarray(boxes)))
    got = taug.resized_crop_clip_boxes(torch.from_numpy(x), torch.from_numpy(boxes), SIZE).numpy()
    assert np.abs(got - want).max() <= 2e-3


@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("preset", [MOCO, MOCO_CC])
def test_rbyol_aug_within_bound_of_jax(preset, motion):
    """The whole aug with JAX's drawn parameters over 3 seeds of 2 videos x
    2 clips, bf16 out (TPU.AUG_COMPUTE_OUT under bf16): every op on and off
    somewhere."""
    jcfg, tcfg = _cfgs(preset, **{"AUG.TRAIN_JITTER_MOTION_SHIFT": motion, "TPU.AUG_COMPUTE_OUT": True})
    w, h = ingest_geometry(tcfg, "train")
    assert (w, h) == (SIZE * 4 // 3, SIZE)
    want_fn = jax.jit(jaug.make_rbyol_aug(jcfg))
    aug = build_device_aug(tcfg, "train")
    assert isinstance(aug, taug.RByolAug)
    seen = {k: [] for k in ("gray", "blur", "flip", "apply")}
    errs, far, mean = [], [], []
    for seed in range(3):
        clips = np.random.default_rng(seed).integers(0, 256, (2, 2, T, h, w, 3), dtype=np.uint8)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(want_fn(jnp.asarray(clips), key), np.float32)
        params = jax_params(jcfg, key, 4, T, h, w)
        got = aug.apply(torch.from_numpy(clips), params)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 2, T, SIZE, SIZE, 3)
        d = np.abs(got.float().numpy() - want)
        errs.append(float(d.max()))
        far.append(float((d > 0.02).mean()))
        mean.append(float(d.mean()))
        for k in seen:
            seen[k] += [int(v) for v in params[k]]
    assert max(errs) <= 0.07 and max(far) <= 0.005 and max(mean) <= 2e-4, (errs, far, mean)
    assert all(0 < sum(v) < len(v) for k, v in seen.items() if k != "apply"), seen


def test_sampler_draws_the_presets_ranges():
    """The port's own draws: 4096 clips' factors, gates and sigmas in the
    preset's ranges, each gate near its probability (within 0.03: over 4
    sd of 4096 draws), boxes inside the frame."""
    _, tcfg = _cfgs(MOCO_CC)
    aug = build_device_aug(tcfg, "train")
    prm = aug.sample(4096, T, SIZE, SIZE * 4 // 3, 3, torch.Generator().manual_seed(0))
    p, b, c, s, hue = tcfg.AUG.COLOR
    for name, lo, hi in (("bfac", 1 - b, 1 + b), ("cfac", 1 - c, 1 + c), ("sfac", 1 - s, 1 + s),
                         ("hfac", -hue, hue), ("sigma", 0.1, 2.0)):
        assert float(prm[name].min()) >= lo and float(prm[name].max()) < hi, name
    for name, prob in (("apply", p), ("gray", tcfg.AUG.GRAYSCALE), ("blur", 0.5), ("flip", 0.5)):
        assert abs(float(prm[name].float().mean()) - prob) < 0.03, name
    top, left, bh, bw = prm["box"].unbind(1)
    assert bool(((top >= 0) & (left >= 0) & (top + bh <= SIZE) & (left + bw <= SIZE * 4 // 3)).all())
