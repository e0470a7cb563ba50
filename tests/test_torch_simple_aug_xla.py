"""The port's XLA simple aug (advise_tpu_torch/data/device_aug.py, AUG.TYPE
'simple' without TPU.PALLAS_AUG, and AUG.TYPE 'none') against the JAX
package's ``make_simple_train_aug`` and its colour ops, under ``jax.jit``
as the train step runs them.

The port gets the parameters the JAX code draws, re-derived from the JAX
key as ``make_simple_train_aug`` draws them: ``split(key, B*K)``, then per
clip ``(k_crop, k_col) = split(key)``, the crop's two ``randint``s from
``split(k_crop)``, and ``split(k_col, 6)`` for the apply gate, the four
factors and the order (``color_jitter_clip``).

Roundings the port reproduces (each found on XLA-CPU and held here):

- the luma ``x @ LUMA`` is fma(b, 0.114, fma(g, 0.587, r * 0.299)) in
  float32, eagerly and under jit (a product and two sums rounded apart
  differ on 856 of the 2^24 RGB triples);
- under jit each colour blend is one fused multiply-add, and the contrast
  mean is the integer luma sum times float32(1 / (H * W));
- under jit the normalisation's division by the constant std is a
  multiplication by float32(1 / std) (a true division differs on 246 of
  the 256 values of each channel at AdViSe's mean and std);
- in the HSV conversions under jit, h / 6 is h times float32(1 / 6), and
  1 - f s and 1 - (1 - f) s are fused multiply-adds.

Tolerance: none for the uint8 stages and the whole aug: outputs are held
EQUAL, float32 and bf16 out. No half-way tie was left unmatched: the share
of values allowed to differ is 0. On the inputs tried no blend's
contraction decided an output (the K3 tests find seeds where it does for
the same arithmetic), so the contraction is the one XLA emits, kept by
construction. The hue rotation is float32 HSV: ``rgb_to_hsv`` and
``hsv_to_rgb`` are held EQUAL to JAX's under jit, and invert each other to
1e-6 on the uint8 grid; ``adjust_hue`` and the whole aug with
REFERENCE_EXACT_HUE False are held equal too (with the HSV roundings
rounded apart instead, the hue differs by one uint8 level on 0.012 % of
the values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu import config as jconfig
from advise_tpu.data import device_aug as jaug
from advise_tpu.ops.pallas.fused_aug import fused_simple_aug as jfused_simple_aug
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, ingest_geometry
from advise_tpu_torch.data import device_aug as taug
from advise_tpu_torch.ops import fused_aug as fa

torch.set_num_threads(1)

ALL_ON = (1.0, 0.4, 0.4, 0.4, 0.1)  # every clip runs the chain, hue 0.1
PRESET = (0.8, 0.2, 0.2, 0.2, 0.1)  # AdViSe's AUG.COLOR


def _cfgs(**overrides):
    """AdViSe.yaml's aug on one device at a small crop, in both packages."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_cfg()
        cfg.merge_from_file("configs/pretrain/AdViSe.yaml")
        cfg.NUM_WORLDS = 1
        cfg.TPU.MESH_SYNC = 1
        cfg.BN.NUM_SYNC_DEVICES = 1
        cfg.AUG.TARGET_SIZE = 22
        cfg.AUG.RESIZE = [34, 30]
        for key, value in overrides.items():
            sec, leaf = key.split(".")
            cfg[sec][leaf] = value
        out.append(mod.assert_and_infer_cfg(cfg))
    return out


def jax_params(key, n, h, w, size, color, exact_hue):
    """The parameters ``make_simple_train_aug`` (XLA path) draws from ``key``
    for n clips, as tensors."""
    p, b, c, s, hue = color
    if exact_hue:
        hue = 0.0

    def one(k):
        k_crop, k_col = jax.random.split(k)
        k1, k2 = jax.random.split(k_crop)
        top = jnp.where(h == size, 0, jax.random.randint(k1, (), 0, max(h - size, 1)))
        left = jnp.where(w == size, 0, jax.random.randint(k2, (), 0, max(w - size, 1)))
        k_apply, k_b, k_c, k_s, k_h, k_perm = jax.random.split(k_col, 6)
        bf = jax.random.uniform(k_b, (), minval=max(0.0, 1.0 - b), maxval=1.0 + b)
        cf = jax.random.uniform(k_c, (), minval=max(0.0, 1.0 - c), maxval=1.0 + c)
        sf = jax.random.uniform(k_s, (), minval=max(0.0, 1.0 - s), maxval=1.0 + s)
        hf = jax.random.uniform(k_h, (), minval=-hue, maxval=hue)
        order = jax.random.permutation(k_perm, 4)
        apply = (jax.random.uniform(k_apply, ()) < p).astype(jnp.int32)
        return top, left, bf, cf, sf, hf, order, apply

    drawn = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    names = ("tops", "lefts", "bfac", "cfac", "sfac", "hfac", "order", "apply")
    return {k: torch.from_numpy(np.array(v)) for k, v in zip(names, drawn)}


def _clips(shape, seed):
    """Random uint8 clips whose first frame is gray on its left third (gray
    pixels are where the lumas round apart most often)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, np.uint8)
    x[..., 0, :, : shape[-2] // 3, :] = x[..., 0, :, : shape[-2] // 3, :1]
    return x


def test_luma_equals_jax_on_the_rgb_cube():
    """Every (r, g) pair with every third b: 5.6M triples, equal."""
    g = np.arange(256, dtype=np.float32)
    rgb = np.stack(np.meshgrid(g, g, g[::3], indexing="ij"), -1).reshape(-1, 3)
    want = np.asarray(jax.jit(jaug._luma)(jnp.asarray(rgb)))
    np.testing.assert_array_equal(taug._luma(torch.from_numpy(rgb)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jaug._luma(jnp.asarray(rgb))), want)


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation"])
def test_color_op_equals_jax(op):
    """Each op with a factor per clip, under jit (contracted blends) and
    eagerly (the product and the sum rounded apart): equal."""
    x = _clips((6, 3, 20, 24, 3), 1).astype(np.float32)
    fac = np.asarray([0.6, 0.8123457, 0.9312, 1.0, 1.1734, 1.4], np.float32)
    jfn = {"brightness": jaug.adjust_brightness, "contrast": jaug.adjust_contrast,
           "saturation": jaug.adjust_saturation}[op]
    tfn = getattr(taug, f"adjust_{op}")
    f_t = torch.from_numpy(fac).view(-1, 1, 1, 1, 1)
    want = np.asarray(jax.jit(jax.vmap(jfn))(jnp.asarray(x), jnp.asarray(fac)))
    got = tfn(torch.from_numpy(x), f_t, contract=True)
    np.testing.assert_array_equal(got.numpy(), want)
    eager = np.stack([np.asarray(jfn(jnp.asarray(x[i]), jnp.float32(fac[i]))) for i in range(len(fac))])
    np.testing.assert_array_equal(tfn(torch.from_numpy(x), f_t).numpy(), eager)


def test_hsv_round_trip_and_hue():
    g = np.arange(0, 256, 5, dtype=np.float32)
    rgb = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) / 255.0
    hsv_j = np.asarray(jax.jit(jaug.rgb_to_hsv)(jnp.asarray(rgb)))
    hsv_t = taug.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_array_equal(hsv_t.numpy(), hsv_j)
    back = taug.hsv_to_rgb(hsv_t)
    np.testing.assert_allclose(back.numpy(), rgb, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax.jit(jaug.hsv_to_rgb)(jnp.asarray(hsv_j))))
    # hue shifts of both signs, past a whole sextant, on clips [N, T, H, W, 3]
    x = _clips((5, 2, 16, 18, 3), 2).astype(np.float32)
    shift = np.asarray([-25.5, -3.7, 0.0, 7.25, 25.5], np.float32)
    want = np.asarray(jax.jit(jax.vmap(jaug.adjust_hue))(jnp.asarray(x), jnp.asarray(shift)))
    got = taug.adjust_hue(torch.from_numpy(x), torch.from_numpy(shift).view(-1, 1, 1, 1, 1)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got[2], x[2])  # a zero shift is the identity


@pytest.mark.parametrize("exact_hue", [True, False])
@pytest.mark.parametrize("color", ["all_on", "preset"])
def test_simple_aug_equals_jax(exact_hue, color):
    """The whole XLA path with JAX's drawn parameters over 6 seeds: every op
    at every position of the order; with the preset p 0.8, clips with and
    without the chain; hue the identity (REFERENCE_EXACT_HUE) or a real
    rotation. Equal."""
    col = ALL_ON if color == "all_on" else PRESET
    jcfg, tcfg = _cfgs(**{"AUG.COLOR": list(col), "AUG.REFERENCE_EXACT_HUE": exact_hue})
    w, h = ingest_geometry(tcfg, "train")
    shape = (3, 2, 2, h, w, 3)
    want_fn = jax.jit(jaug.make_simple_train_aug(jcfg))
    aug = build_device_aug(tcfg, "train")
    assert not aug.pallas and aug.color[4] == (0.0 if exact_hue else col[4])
    seen, applied = set(), []
    for seed in range(6):
        clips = _clips(shape, seed)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(want_fn(jnp.asarray(clips), key))
        params = jax_params(key, 6, h, w, 22, col, exact_hue)
        got = aug.apply(torch.from_numpy(clips), params)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 2, 2, 22, 22, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        seen |= {(pos, int(op)) for row in params["order"] for pos, op in enumerate(row)}
        applied += params["apply"].tolist()
    assert seen == {(pos, op) for pos in range(4) for op in range(4)}
    if color == "preset":
        assert 0 < sum(applied) < len(applied)


def test_aug_type_none_and_bf16_out():
    """AUG.TYPE 'none' (normalize only) and TPU.AUG_COMPUTE_OUT under bf16
    (the cast after float32 math), each equal to JAX."""
    jcfg, tcfg = _cfgs(**{"AUG.TYPE": "none"})
    clips = _clips((2, 2, 2, 22, 22, 3), 3)
    want = np.asarray(jax.jit(jaug.build_device_aug(jcfg, "train"))(jnp.asarray(clips), jax.random.PRNGKey(0)))
    got = build_device_aug(tcfg, "train")(torch.from_numpy(clips), torch.Generator().manual_seed(0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)

    jcfg, tcfg = _cfgs(**{"TPU.AUG_COMPUTE_OUT": True, "AUG.COLOR": list(ALL_ON)})
    assert tcfg.TPU.COMPUTE_DTYPE == "bfloat16"
    w, h = ingest_geometry(tcfg, "train")
    clips = _clips((2, 2, 2, h, w, 3), 4)
    key = jax.random.PRNGKey(4)
    want = jax.jit(jaug.make_simple_train_aug(jcfg))(jnp.asarray(clips), key)
    assert want.dtype == jnp.bfloat16
    got = build_device_aug(tcfg, "train").apply(torch.from_numpy(clips),
                                                jax_params(key, 4, h, w, 22, ALL_ON, True))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_brightness_before_contrast_paths_differ_as_in_jax():
    """The XLA path takes the contrast mean and the luma from the current
    image, the fused kernel (K3) from the raw crop. On clips whose order puts
    brightness before contrast and saturation, the port's two paths differ
    on exactly the values where JAX's two paths differ, with the same
    parameters on all four (JAX's XLA ops applied in K3's drawn order)."""
    n, t, h, w, size = 8, 2, 26, 30, 22
    clips = _clips((n, t, h, w, 3), 5)
    key = jax.random.PRNGKey(11)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    keys = jax.random.split(key, 6)
    p = {
        "tops": jax.random.randint(keys[0], (n,), 0, h - size, jnp.int32),
        "lefts": jax.random.randint(keys[1], (n,), 0, w - size, jnp.int32),
        "bfac": jax.random.uniform(keys[2], (n,), jnp.float32, 0.6, 1.4),
        "cfac": jax.random.uniform(keys[3], (n,), jnp.float32, 0.6, 1.4),
        "sfac": jax.random.uniform(keys[4], (n,), jnp.float32, 0.6, 1.4),
    }
    with pltpu.force_tpu_interpret_mode():
        want_fused = np.asarray(jax.jit(lambda c, k: jfused_simple_aug(
            c, k, size, color=ALL_ON, mean=mean, std=std))(jnp.asarray(clips), key))
    # K3's own draw (the fused aug test's re-derivation), and JAX's XLA ops
    # run in the order K3 drew
    k3 = {name: np.asarray(v) for name, v in p.items()}
    k3["order"] = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 4))(
        jax.random.split(jax.random.fold_in(keys[5], 2), n))).astype(np.int32)
    brightness_first = k3["order"][:, 0] == 0
    assert brightness_first.any() and not brightness_first.all()

    def jax_xla(c):
        outs = []
        for i in range(n):
            x = jax.lax.dynamic_slice(c[i], (0, int(k3["tops"][i]), int(k3["lefts"][i]), 0),
                                      (t, size, size, 3)).astype(jnp.float32)
            ops = [lambda y: jaug.adjust_brightness(y, k3["bfac"][i]),
                   lambda y: jaug.adjust_contrast(y, k3["cfac"][i]),
                   lambda y: jaug.adjust_saturation(y, k3["sfac"][i]), lambda y: y]
            for code in k3["order"][i]:
                x = ops[int(code)](x)
            outs.append(jaug.normalize(x, mean, std))
        return jnp.stack(outs)

    want_xla = np.asarray(jax.jit(jax_xla)(jnp.asarray(clips)))
    params = {k: torch.from_numpy(v) for k, v in k3.items()}
    params["apply"] = torch.ones(n, dtype=torch.int32)
    params["hfac"] = torch.zeros(n)
    got_fused = fa.fused_simple_aug(torch.from_numpy(clips), params, size, mean, std).numpy()
    win = fa.crop_windows(torch.from_numpy(clips), params["tops"], params["lefts"], size)
    got_xla = taug.normalize(taug.color_jitter(win, params, hue=False), mean, std,
                             by_reciprocal=True).numpy()
    np.testing.assert_array_equal(got_fused, want_fused)
    np.testing.assert_array_equal(got_xla, want_xla)
    apart_jax = want_fused != want_xla
    np.testing.assert_array_equal(got_fused != got_xla, apart_jax)
    per_clip = apart_jax.reshape(n, -1).any(axis=1)
    assert per_clip[brightness_first].all()  # the paths part where brightness leads


def test_sampler_draws_hue_only_on_the_xla_path():
    """The XLA path's sampler adds the hue shift, uniform on [-h, h) over 4096
    draws (mean within 0.004 of 0: 4 sd of a mean of 4096 uniforms of width
    0.2 is 0.0036), and exactly 0 with REFERENCE_EXACT_HUE; the fused path
    draws none."""
    _, tcfg = _cfgs(**{"AUG.REFERENCE_EXACT_HUE": False})
    aug = build_device_aug(tcfg, "train")
    prm = aug.sample(4096, 2, 256, 320, 3, torch.Generator().manual_seed(0))
    hf = prm["hfac"]
    assert float(hf.min()) >= -0.1 and float(hf.max()) < 0.1 and abs(float(hf.mean())) < 0.004
    _, tcfg = _cfgs()
    prm = build_device_aug(tcfg, "train").sample(64, 2, 256, 320, 3, torch.Generator().manual_seed(0))
    assert torch.equal(prm["hfac"], torch.zeros(64))
    _, tcfg = _cfgs(**{"TPU.PALLAS_AUG": True})
    assert "hfac" not in build_device_aug(tcfg, "train").sample(
        4, 2, 256, 320, 3, torch.Generator().manual_seed(0))
