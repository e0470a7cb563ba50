"""The port's 'aa' augmentation (advise_tpu_torch/data) against the JAX
package's, op by op and end to end, with the parameters the JAX code draws
handed to the port's apply: the RRC box, the RandAugment plan with each
slot's sign recovered from its JAX slot key, the flip and the erasing
region and noise.

Tolerances: the color ops, the gather and the erasing work on the uint8
grid in float32 with the same operation order, so they must agree exactly.
The warp coordinates go through sin/cos, whose float32 results may differ
in the last ulp between XLA and PyTorch: coordinates agree to 1e-4 px and
the end-to-end output exactly except where such an ulp moves a bilinear
sum across a rounding boundary (at most one uint8 level, on at most 0.1%
of the values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.data import device_aug as jaug
from advise_tpu.data import rand_augment as jra
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import device_aug as taug
from advise_tpu_torch.data import rand_augment as tra
from advise_tpu_torch.data.erasing import RandomErasing

torch.set_num_threads(1)

AA = "rand-m7-n4-mstd0.5-inc1"
COLOR_OPS = [0, 1, 2, 4, 5, 6, 7, 8, 9, 10]


def _clips(n=3, t=2, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    # a narrow value range on some clips so autocontrast/equalize stretch
    x = rng.integers(0, 256, size=(n, t, h, w, 3)).astype(np.float32)
    x[0] = np.clip(x[0] // 4 + 60, 0, 255)
    return x


def _sign(key):
    return float(jnp.where(jax.random.bernoulli(key, 0.5), 1.0, -1.0))


@pytest.mark.parametrize("op", COLOR_OPS)
def test_color_op_matches_jax(op):
    """Each color op of the fused RandAugment table, per clip, with the JAX
    slot key's sign and magnitude: exact."""
    mag, _, mstd, inc = jra._parse_ra_config(AA)
    table = jra._color_op_table(mag, mstd, inc)
    x = _clips()
    keys = jax.random.split(jax.random.PRNGKey(op), x.shape[0])
    m = np.asarray([3.0, 7.0, 9.5], np.float32)
    want = np.stack([
        np.asarray(table[op](jnp.asarray(x[i]), keys[i], jnp.float32(m[i])))
        for i in range(x.shape[0])
    ])
    ra = tra.FusedRandAugment(AA)
    sign = torch.tensor([_sign(k) for k in keys])
    got = ra._op(op, torch.from_numpy(x), torch.from_numpy(m), sign)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rrc_box_from_jax_draws():
    """The RRC box from JAX's own uniform draws (the sampling half): exact."""
    scale, ratio = (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)
    for i in range(16):
        key = jax.random.PRNGKey(100 + i)
        h, w = (24, 32) if i % 2 else (224, 298)
        want = np.asarray(jaug.sample_rrc_box(key, h, w, scale, ratio), np.float32)
        ks = jax.random.split(key, 4)
        u = [torch.from_numpy(np.array(jax.random.uniform(k, (10,))))[None] for k in ks]
        got = taug.rrc_box_from_uniforms(*u, h, w, scale, ratio)[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_erasing_region_from_jax_draws():
    """The erasing region from JAX's draws and the injected JAX noise give
    the JAX random_erasing_clip output: exact."""
    from advise_tpu.data.erasing import random_erasing_clip

    x = _clips(n=1, h=16, w=16)[0]
    er = RandomErasing(probability=1.0)
    for i in range(4):
        key = jax.random.PRNGKey(7 + i)
        want = np.asarray(random_erasing_clip(jnp.asarray(x), key, probability=1.0))
        r = jax.random.fold_in(key, 0)
        r_apply, r_area, r_asp, r_top, r_left, r_fill = jax.random.split(r, 6)
        u = [torch.tensor([float(jax.random.uniform(k))])
             for k in (r_apply, r_area, r_asp, r_top, r_left)]
        region = er.region_from_uniforms(*u, 16, 16)
        _, top, left, eh, ew = (int(v) for v in region[0].tolist())
        noise = np.array(jax.random.normal(r_fill, x.shape))
        params = {"region": region[:, None],
                  "noise": [[torch.from_numpy(noise[:, top:top + eh, left:left + ew])]]}
        got = er.apply(torch.from_numpy(x.copy())[None], params)[0].numpy()
        np.testing.assert_array_equal(got, want)


def _jax_params(cfg, key, n, t, h, w):
    """The per-clip parameters make_aa_aug's fused path draws from `key`."""
    size = cfg.AUG.TARGET_SIZE
    plan_fn, _ = jra.make_fused_rand_augment(cfg.AUG.AA_TYPE)
    boxes, plans, flips, regions, noises = [], [], [], [], []
    er = RandomErasing(cfg.AUG.RE_PROB)
    for kc in jax.random.split(key, n):
        k_box, k_ra, k_flip, k_re = jax.random.split(kc, 4)
        boxes.append(np.asarray(jaug.sample_rrc_box(
            k_box, h, w, (cfg.AUG.MIN_AREA, cfg.AUG.MAX_AREA),
            tuple(cfg.AUG.RAND_CROP_RATIO)), np.float32))
        p = plan_fn(k_ra, size)
        plans.append((np.asarray(p["sel"]), np.asarray(p["m_eff"]),
                       np.asarray([_sign(k) for k in p["keys"]], np.float32), p))
        flips.append(bool(jax.random.uniform(k_flip, ()) < 0.5))
        r_apply, r_area, r_asp, r_top, r_left, r_fill = jax.random.split(
            jax.random.fold_in(k_re, 0), 6)
        u = [torch.tensor([float(jax.random.uniform(k))])
             for k in (r_apply, r_area, r_asp, r_top, r_left)]
        region = er.region_from_uniforms(*u, size, size)
        regions.append(region[0])
        apply, top, left, eh, ew = (int(v) for v in region[0].tolist())
        full = np.array(jax.random.normal(r_fill, (t, size, size, 3)))
        noises.append(torch.from_numpy(full[:, top:top + eh, left:left + ew]) if apply else None)
    params = {
        "box": torch.from_numpy(np.stack(boxes)),
        "plan": {
            "sel": torch.from_numpy(np.stack([p[0] for p in plans]).astype(np.int64)),
            "m_eff": torch.from_numpy(np.stack([p[1] for p in plans])),
            "sign": torch.from_numpy(np.stack([p[2] for p in plans])),
        },
        "flip": torch.tensor(flips),
        "erase": {"region": torch.stack(regions)[:, None], "noise": [[fill] for fill in noises]},
    }
    return params, [p[3] for p in plans]


def _cfg(mod):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/SlowFast_R50_K400.yaml")
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.AUG.TARGET_SIZE = 16
    cfg.AUG.RE_PROB = 0.75  # erase most clips of the small batch
    return mod.assert_and_infer_cfg(cfg)


def test_warp_coords_and_gather_match_jax():
    """fused_warp_coords from the JAX plan/box/flip: coordinates to 1e-4 px
    (sin/cos ulps); warp_gather on the JAX coordinates: exact."""
    cfg = _cfg(tconfig)
    x = _clips(n=6, t=2, h=12, w=16, seed=3)
    params, jplans = _jax_params(cfg, jax.random.PRNGKey(5), 6, 2, 12, 16)
    sx, sy, valid = tra.fused_warp_coords(params["plan"], params["box"], params["flip"], 16)
    for i in range(6):
        jsx, jsy, jvalid = jra.fused_warp_coords(
            jplans[i], tuple(jnp.asarray(params["box"][i].numpy())),
            jnp.asarray(bool(params["flip"][i])), 16)
        np.testing.assert_allclose(sx[i].numpy(), np.asarray(jsx), atol=1e-4, rtol=0)
        np.testing.assert_allclose(sy[i].numpy(), np.asarray(jsy), atol=1e-4, rtol=0)
        want = np.asarray(jra.warp_gather(jnp.asarray(x[i]), jsx, jsy, jvalid))
        got = tra.warp_gather(
            torch.from_numpy(x[i:i + 1]), torch.from_numpy(np.array(jsx))[None],
            torch.from_numpy(np.array(jsy))[None], torch.from_numpy(np.array(jvalid))[None],
        )[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_aa_pipeline_matches_jax():
    """The whole 'aa' pipeline (RRC + RandAugment m7-n4 + flip + erasing +
    normalize, float32 out) with the JAX-drawn parameters injected, against
    the jitted JAX pipeline (the program the train step runs)."""
    jcfg = _cfg(jconfig)
    tcfg = _cfg(tconfig)
    jcfg.TPU.AUG_COMPUTE_OUT = tcfg.TPU.AUG_COMPUTE_OUT = False
    b, k, t, h, w = 3, 2, 2, 12, 16
    batch = np.random.default_rng(11).integers(0, 256, (b, k, t, h, w, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax.jit(jaug.make_aa_aug(jcfg))(jnp.asarray(batch), key))
    params, _ = _jax_params(tcfg, key, b * k, t, h, w)
    aug = taug.build_device_aug(tcfg, "train")
    got = aug.apply(torch.from_numpy(batch), params).numpy()
    assert got.shape == want.shape == (b, k, t, 16, 16, 3)
    level = 1.0 / (255.0 * min(tcfg.DATA.STD)) + 1e-5  # one uint8 step, normalized
    diff = np.abs(got - want)
    assert diff.max() <= level
    assert (diff > 1e-5).mean() <= 1e-3


def test_sampling_draws_are_in_range():
    """The sampling half: plans, boxes, flips and erasing regions drawn by
    the port's generator stay in the ranges the JAX samplers produce."""
    cfg = _cfg(tconfig)
    aug = taug.AAAug(cfg)
    g = torch.Generator().manual_seed(0)
    n, t, h, w = 512, 2, 24, 32
    p = aug.sample(n, t, h, w, 3, g)
    sel, m, sign = p["plan"]["sel"], p["plan"]["m_eff"], p["plan"]["sign"]
    assert sel.min() >= 0 and sel.max() <= 14 and len(set(sel.flatten().tolist())) == 15
    assert m.min() >= 0 and m.max() <= 10 and abs(float(m.mean()) - 7.0) < 0.1
    assert set(sign.flatten().tolist()) == {-1.0, 1.0} and abs(float(sign.mean())) < 0.1
    top, left, bh, bw = p["box"].unbind(1)
    assert (top >= 0).all() and (left >= 0).all()
    assert (top + bh <= h).all() and (left + bw <= w).all() and (bh >= 1).all()
    assert 0.4 < float(p["flip"].float().mean()) < 0.6
    region = p["erase"]["region"][:, 0]  # RE_COUNT 1: one region a clip
    assert abs(float(region[:, 0].mean()) - cfg.AUG.RE_PROB) < 0.06
    for (apply, top, left, eh, ew), (noise,) in zip(region.tolist(), p["erase"]["noise"]):
        assert (noise is not None) == bool(apply)
        if apply:
            assert noise.shape == (t, int(eh), int(ew), 3)
            assert top + eh <= 16 and left + ew <= 16
