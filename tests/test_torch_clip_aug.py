"""The port's clip_aug (advise_tpu_torch/data/erasing.py
``clip_random_resized_crop``, data/device_aug.py ``ClipAug``) and random
erasing's modes and counts (``RandomErasing``) against the JAX package's,
with JAX's draws handed to the port: for clip_aug the uniforms behind each
of the 10 keys ``clip_random_resized_crop`` splits (the RRC box from its
own four), for erasing each region's five uniforms and its fill.

Tolerances: the crop is within 1e-4 of 255 of jitted JAX, the
RandomResizedCrop's standing bound (ROADMAP.md §C: the resize weights are
within 1.5e-5 of XLA's); the saturation ramp floors the PIL luma of that
crop, so where the luma of a pixel lies within that bound of an integer the
two sides may floor it apart, and that pixel then differs by at most the
ramp's (1 - factor) in a level: such pixels are counted, and must stay
below 0.1 % of the values. Erasing works on the given values and must
agree exactly.
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
from advise_tpu_torch.data import build_device_aug
from advise_tpu_torch.data import erasing as terasing
from advise_tpu_torch.data.device_aug import ClipAug

torch.set_num_threads(1)

T, H, W, SIZE = 4, 48, 64, 32
# the camera dynamics of the tests: every effect on, large enough to move
# the boxes by whole pixels and the colours by whole levels
DYN = {"jitter": 0.05, "shift": 0.3, "zoom": 0.3, "brightness": 0.4, "saturation": 0.5, "white_balance": 0.2}
SCALE, RATIO = (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)


def jax_clip_draws(key, t, h, w, scale=SCALE, ratio=RATIO):
    """The parameters ``ClipAug.apply`` takes, from the uniforms behind the
    10 keys ``clip_random_resized_crop`` splits from ``key``."""
    keys = jax.random.split(key, 10)

    def u(k, shape=()):
        return np.asarray(jax.random.uniform(k, shape), np.float32)

    box = np.asarray(jaug.sample_rrc_box(keys[0], h, w, scale, ratio), np.float32)
    return {"box": box, "shift": np.stack([u(keys[1]), u(keys[2])]), "zoom": u(keys[3]),
            "shake": np.stack([u(keys[4], (t,)), u(keys[5], (t,))]), "bri": u(keys[6]), "sat": u(keys[7]),
            "wb": u(keys[8], (3,))}


def stack_draws(draws):
    return {k: torch.from_numpy(np.stack([d[k] for d in draws])) for k in draws[0]}


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, T, H, W, 3)).astype(np.float32)


def _luma_flips(got, want, tol):
    """The share of values beyond ``tol``, and their largest difference."""
    diff = np.abs(got - want)
    return float((diff > tol).mean()), float(diff.max())


@pytest.mark.parametrize("effects", ["crop", "all"])
def test_clip_random_resized_crop_matches_jax(effects):
    """Per clip: the base box, shift, zoom and shake per frame, the crop,
    then (``all``) the brightness, saturation and white-balance ramps; 8
    clips, each from its own key, against JAX's jitted function."""
    dyn = DYN if effects == "all" else {k: (v if k in ("jitter", "shift", "zoom") else 0.0) for k, v in DYN.items()}
    x = _frames(8)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    fn = jax.jit(jax.vmap(lambda c, k: jerasing.clip_random_resized_crop(c, k, SIZE, SCALE, RATIO, **dyn)))
    want = np.asarray(fn(jnp.asarray(x), keys))
    params = stack_draws([jax_clip_draws(k, T, H, W) for k in keys])
    got = terasing.clip_random_resized_crop(torch.from_numpy(x), params, SIZE, **dyn).numpy()
    assert got.shape == want.shape == (8, T, SIZE, SIZE, 3)
    share, worst = _luma_flips(got, want, 1e-4 * 255)
    if effects == "crop":
        assert share == 0.0, worst
    else:
        assert share <= 1e-3 and worst <= DYN["saturation"] * 1.3 + 1e-4 * 255, (share, worst)


def test_clip_dynamics_boxes_move_as_drawn():
    """The boxes of extreme draws: the shift and zoom reach +-30 % at the
    last frame and none at the first, the shake moves each frame's corner
    by its own draw, and the clamps keep every box inside the frame and at
    least 8 px where the frame leaves room."""
    box = torch.tensor([[10.0, 20.0, 20.0, 30.0]])
    params = {"shift": torch.tensor([[0.0, 1.0 - 2 ** -24]]), "zoom": torch.tensor([1.0 - 2 ** -24]),
              "shake": torch.full((1, 2, T), 0.5)}
    boxes = terasing.clip_dynamics_boxes(box, params, T, H, W, 0.3, 0.3, 0.0)[0]
    assert torch.equal(boxes[0], box[0])
    np.testing.assert_allclose(boxes[-1].numpy(), [10.0 + 0.3 * 20.0, 20.0 - 0.3 * 30.0, 26.0, 39.0], atol=1e-4)
    wild = {"shift": torch.tensor([[1.0 - 2 ** -24] * 2]), "zoom": torch.tensor([1.0 - 2 ** -24]),
            "shake": torch.rand((1, 2, T), generator=torch.Generator().manual_seed(0))}
    boxes = terasing.clip_dynamics_boxes(torch.tensor([[40.0, 50.0, 8.0, 14.0]]), wild, T, H, W, 1.0, 1.0, 0.5)[0]
    assert bool((boxes[:, 0] <= H - 1).all() and (boxes[:, 1] <= W - 1).all())
    assert bool((boxes[:, 0] + boxes[:, 2] <= H + 1e-4).all() and (boxes[:, 1] + boxes[:, 3] <= W + 1e-4).all())


def _clip_cfg(mod):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/SlowFast_R50_K400.yaml")
    cfg.AUG.TYPE = "clip_aug"
    cfg.AUG.TARGET_SIZE = SIZE
    cfg.AUG.CAMERA_SHAKE, cfg.AUG.CAMERA_SHIFT, cfg.AUG.ZOOM = DYN["jitter"], DYN["shift"], DYN["zoom"]
    cfg.AUG.COLOR_BRI, cfg.AUG.COLOR_SAT = DYN["brightness"], DYN["saturation"]
    cfg.AUG.WHITE_BALANCE = DYN["white_balance"]
    cfg.TPU.AUG_COMPUTE_OUT = False
    return mod.assert_and_infer_cfg(cfg)


def test_clip_aug_pipeline_matches_jax():
    """AUG.TYPE clip_aug end to end: uint8 [B, K, T, H, W, 3] -> the crop
    with camera dynamics per clip (each clip's key one of
    ``split(key, B * K)``) -> normalize, against JAX's ``make_clip_aug``
    under jit; the tolerance above over the normalized values (x 1 / std).
    The port's own sampling draws the same kinds of parameters."""
    jcfg, tcfg = _clip_cfg(jconfig), _clip_cfg(tconfig)
    b, k = 2, 2
    batch = np.random.default_rng(1).integers(0, 256, (b, k, T, H, W, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(jaug.make_clip_aug(jcfg))(jnp.asarray(batch), key))
    aug = build_device_aug(tcfg, "train")
    assert isinstance(aug, ClipAug)
    scale = (tcfg.AUG.MIN_AREA, 1.0)
    params = stack_draws([jax_clip_draws(kc, T, H, W, scale, tuple(tcfg.AUG.RAND_CROP_RATIO))
                          for kc in jax.random.split(key, b * k)])
    got = aug.apply(torch.from_numpy(batch), params).numpy()
    assert got.shape == want.shape == (b, k, T, SIZE, SIZE, 3) and got.dtype == np.float32
    share, worst = _luma_flips(got, want, 1e-4 * 255 / (255 * min(tcfg.DATA.STD)))
    assert share <= 1e-3 and worst <= (DYN["saturation"] * 1.3 + 1e-4 * 255) / (255 * min(tcfg.DATA.STD))
    drawn = aug.sample(b * k, T, H, W, 3, torch.Generator().manual_seed(0))
    assert {n: tuple(v.shape) for n, v in drawn.items()} == {n: tuple(v.shape) for n, v in params.items()}
    out = aug(torch.from_numpy(batch), torch.Generator().manual_seed(0))
    assert out.shape == (b, k, T, SIZE, SIZE, 3) and bool(torch.isfinite(out).all())


ERASING = [("pixel", 1), ("pixel", 3), ("rand", 1), ("rand", 3), ("const", 1), ("const", 2)]


@pytest.mark.parametrize("mode,count", ERASING)
def test_erasing_modes_and_counts_match_jax(mode, count):
    """``count`` regions in order, each from its own fold_in key's five
    uniforms, filled per pixel ('pixel', JAX's noise handed over where it
    lands), per channel ('rand') or with zeros ('const'): equal to JAX's
    random_erasing_clip at probability 1 and 0.5."""
    x = _frames(1, seed=2)[0]
    for i, prob in enumerate((1.0, 0.5, 0.5, 0.5)):
        key = jax.random.PRNGKey(40 + i)
        want = np.asarray(jerasing.random_erasing_clip(jnp.asarray(x), key, probability=prob, mode=mode,
                                                       count=count))
        er = terasing.RandomErasing(probability=prob, mode=mode, count=count)
        regions, fills = [], []
        for j in range(count):
            r_apply, r_area, r_asp, r_top, r_left, r_fill = jax.random.split(jax.random.fold_in(key, j), 6)
            u = [torch.tensor([float(jax.random.uniform(k))]) for k in (r_apply, r_area, r_asp, r_top, r_left)]
            region = er.region_from_uniforms(*u, H, W)[0]
            regions.append(region)
            apply, top, left, eh, ew = (int(v) for v in region.tolist())
            if mode == "pixel":
                noise = np.array(jax.random.normal(r_fill, x.shape))[:, top:top + eh, left:left + ew]
            else:
                noise = np.array(jax.random.normal(r_fill, (1, 1, 1, 3))).reshape(3)
            fills.append(torch.from_numpy(noise) if apply and mode != "const" else None)
        params = {"region": torch.stack(regions)[None], "noise": [fills]}
        got = er.apply(torch.from_numpy(x.copy())[None], params)[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_erasing_sample_draws_each_region():
    """``sample`` draws [N, count, 5] regions and per clip one fill per
    region of the mode's shape (None where not applied or 'const');
    regions past the first change the clip where they apply."""
    for mode, shape in (("pixel", None), ("rand", (3,)), ("const", None)):
        er = terasing.RandomErasing(probability=1.0, mode=mode, count=3)
        params = er.sample(2, (T, SIZE, SIZE, 3), torch.Generator().manual_seed(0))
        assert tuple(params["region"].shape) == (2, 3, 5) and len(params["noise"]) == 2
        for clip_regions, fills in zip(params["region"].tolist(), params["noise"]):
            for (_, _, _, eh, ew), fill in zip(clip_regions, fills):
                want = {"pixel": (T, int(eh), int(ew), 3)}.get(mode, shape)
                assert (fill is None) == (want is None) and (fill is None or tuple(fill.shape) == want)
        x = torch.full((2, T, SIZE, SIZE, 3), 77.0)
        out = er.apply(x.clone(), params)
        assert bool((out != 77.0).any())
        if mode == "const":
            assert set(torch.unique(out).tolist()) <= {0.0, 77.0}
    with pytest.raises(ValueError, match="mode"):
        terasing.RandomErasing(mode="blur")
