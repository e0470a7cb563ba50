"""The op-exact RandAugment (AUG.FUSED_RA False) in the port against the
JAX package's ``make_rand_augment`` and ``make_aa_aug``, jitted as the train
step runs them, with the draws JAX makes handed to the port: each op alone
at both interpolations, and the whole 'aa' pipeline on the BYOL preset.

Tolerances. The color ops work on the uint8 grid in float32 in the same
order and must agree exactly. The geometric ops take sin/cos and the
sample positions in float32, where XLA may contract a product and a sum
into one FMA: a value that lands within an ulp of a rounding boundary can
then move one uint8 step, so at most 0.1 % of the values may differ, by
one step (measured: 7 of the 307,200 values of the ten geometric cases,
2.3e-5, in rotate and the bicubic shear). The pipeline's RandomResizedCrop
is within 1.5e-5 of JAX (ROADMAP C), which can flip a later rounding: 1e-4
on at least 99.9 % of the values and one uint8 step over the std
everywhere (measured: none beyond 1e-4, at most 4.8e-7).
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

N, T, H, W = 2, 4, 32, 40
GEO_OPS = list(tra._GEO_IDS)
COLOR_OPS = [op for op in range(tra.NUM_OPS) if op not in GEO_OPS]


def _clips(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(N, T, H, W, 3)).astype(np.float32)
    x[0] = np.clip(x[0] // 4 + 60, 0, 255)  # a narrow range, so autocontrast and equalize stretch
    return x


_DRAWS = {}


def _slot_draws(keys, magnitude, n, mstd):
    """(sel [K, n], m_eff [K, n], sign [K, n]) the op-exact RandAugment draws
    from each of ``keys`` [K, 2], computed jitted as in the step."""

    def draws(rng):
        out = []
        for i in range(n):
            r_sel, r_mag, r_op, rng = jax.random.split(jax.random.fold_in(rng, i), 4)
            m = jnp.float32(magnitude)
            if mstd > 0:
                m = jnp.clip(magnitude + mstd * jax.random.normal(r_mag), 0.0, 10.0)
            out.append((jax.random.randint(r_sel, (), 0, 15), m,
                        jnp.where(jax.random.bernoulli(r_op, 0.5), 1.0, -1.0)))
        return [jnp.stack(v) for v in zip(*out)]

    fn = _DRAWS.setdefault((magnitude, n, mstd), jax.jit(jax.vmap(draws)))
    sel, m, sign = jax.device_get(fn(keys))
    return np.array(sel, np.int64), np.array(m, np.float32), np.array(sign, np.float32)


def _keys_for(op, count, magnitude):
    """``count`` keys [count, 2] whose one-slot plan selects ``op``."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(1000, 1400))
    sel = _slot_draws(keys, magnitude, 1, 0.0)[0][:, 0]
    return keys[np.flatnonzero(sel == op)[:count]]


@pytest.fixture(scope="module")
def ra_apply():
    return {m: jax.jit(jra.make_rand_augment("rand-m8-n1-inc1", interpolation=m))
            for m in ("bilinear", "bicubic")}


@pytest.mark.parametrize("op,interp", [(op, "bilinear") for op in range(15)]
                         + [(op, "bicubic") for op in GEO_OPS])
def test_exact_op_matches_jax(op, interp, ra_apply):
    """One op of the op-exact table on 2 clips of 4 x 32 x 40 at magnitude
    8 with each clip's sign from its key, through JAX's jitted
    ``make_rand_augment`` and the port's ``apply`` with the same plan. The
    interpolation reaches only the geometric ops, which run at both."""
    x = _clips(op)
    keys = _keys_for(op, N, 8.0)
    want = np.stack([np.asarray(ra_apply[interp](jnp.asarray(x[i]), keys[i])) for i in range(N)])
    sel, m, sign = _slot_draws(keys, 8.0, 1, 0.0)
    plan = {"sel": torch.from_numpy(sel), "m_eff": torch.from_numpy(m), "sign": torch.from_numpy(sign)}
    assert (plan["sel"] == op).all()
    got = tra.ExactRandAugment("rand-m8-n1-inc1", interpolation=interp).apply(torch.from_numpy(x), plan).numpy()
    assert got.shape == want.shape
    if op in COLOR_OPS:
        np.testing.assert_array_equal(got, want)
    else:
        diff = np.abs(got - want)
        assert diff.max() <= 1.0
        assert (diff > 0).mean() <= 1e-3


def _cfg(mod, interp):
    """The BYOL preset with AUG.FUSED_RA False on 2 views of 4 frames at a
    32^2 target, float32 out."""
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/SlowFast_R50_K400.yaml")
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.AUG.FUSED_RA = False
    cfg.AUG.INTERPOLATION = interp
    cfg.AUG.TARGET_SIZE = 32
    cfg.AUG.RE_PROB = 0.75  # erase most clips of the small batch
    cfg.TPU.AUG_COMPUTE_OUT = False
    return mod.assert_and_infer_cfg(cfg)


def _jax_params(cfg, key, n, t, h, w):
    """The per-clip parameters ``make_aa_aug``'s op-exact path draws from
    ``key``: the RRC box, the RandAugment plan, the flip, the erasing
    region and its noise."""
    size = cfg.AUG.TARGET_SIZE
    mag, n_ops, mstd, _ = jra._parse_ra_config(cfg.AUG.AA_TYPE)
    er = RandomErasing(cfg.AUG.RE_PROB)
    boxes, flips, regions, noises, ra_keys = [], [], [], [], []
    for kc in jax.random.split(key, n):
        k_box, k_ra, k_flip, k_re = jax.random.split(kc, 4)
        boxes.append(np.asarray(jaug.sample_rrc_box(
            k_box, h, w, (cfg.AUG.MIN_AREA, cfg.AUG.MAX_AREA), tuple(cfg.AUG.RAND_CROP_RATIO)), np.float32))
        ra_keys.append(k_ra)
        flips.append(bool(jax.random.uniform(k_flip, ()) < 0.5))
        r_apply, r_area, r_asp, r_top, r_left, r_fill = jax.random.split(jax.random.fold_in(k_re, 0), 6)
        u = [torch.tensor([float(jax.random.uniform(k))]) for k in (r_apply, r_area, r_asp, r_top, r_left)]
        region = er.region_from_uniforms(*u, size, size)
        regions.append(region[0])
        apply, top, left, eh, ew = (int(v) for v in region[0].tolist())
        full = np.array(jax.random.normal(r_fill, (t, size, size, 3)))
        noises.append(torch.from_numpy(full[:, top:top + eh, left:left + ew]) if apply else None)
    sel, m, sign = _slot_draws(jnp.stack(ra_keys), mag, n_ops, mstd)
    return {
        "box": torch.from_numpy(np.stack(boxes)),
        "plan": {"sel": torch.from_numpy(sel), "m_eff": torch.from_numpy(m), "sign": torch.from_numpy(sign)},
        "flip": torch.tensor(flips),
        "erase": {"region": torch.stack(regions)[:, None], "noise": [[fill] for fill in noises]},
    }


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_exact_aa_pipeline_matches_jax(interp):
    """The whole 'aa' pipeline at AUG.FUSED_RA False (RRC, clip, RandAugment
    m7-n4-mstd0.5-inc1 op by op, flip, erasing, normalize) on 2 videos x 2
    views x 4 frames of 40 x 48 to 32^2, with JAX's draws handed to the
    port's apply, against the jitted JAX pipeline."""
    jcfg, tcfg = _cfg(jconfig, interp), _cfg(tconfig, interp)
    b, k, t, h, w = 2, 2, 4, 40, 48
    batch = np.random.default_rng(11).integers(0, 256, (b, k, t, h, w, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax.jit(jaug.make_aa_aug(jcfg))(jnp.asarray(batch), key))
    params = _jax_params(tcfg, key, b * k, t, h, w)
    aug = taug.build_device_aug(tcfg, "train")
    assert isinstance(aug.ra, tra.ExactRandAugment) and aug.ra.method == interp
    got = aug.apply(torch.from_numpy(batch), params).numpy()
    assert got.shape == want.shape == (b, k, t, 32, 32, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 / (255.0 * min(tcfg.DATA.STD)) + 1e-5  # one uint8 step, normalized
    assert (diff > 1e-4).mean() <= 1e-3
