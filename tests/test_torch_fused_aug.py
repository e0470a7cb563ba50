"""The port's fused simple aug (advise_tpu_torch/ops/fused_aug.py) against
the JAX package's ``fused_simple_aug`` run in Pallas interpret mode, under
``jax.jit`` as the train step runs it.

The port's plain version gets the parameters the JAX code draws, re-derived
from the JAX key as ``fused_simple_aug`` draws them (``split(key, 6)``, the
two ``randint``s, the three ``uniform``s, ``fold_in(keys[5], 1)`` for the
apply gate and ``fold_in(keys[5], 2)`` for the order), and the same uint8
clips.

Tolerance: none. The chain ends in ``floor`` at integer boundaries, and the
port evaluates it as XLA does on the CPU inside one jitted program: each
colour blend one fused multiply-add, the luma that the contrast mean sums
contracted too, the mean a sum times the float32 reciprocal of S^2. So
float32 and bf16 outputs are held EQUAL, and so is the contrast mean
against JAX's ``crop_mean``. (Called eagerly, JAX runs ``crop_mean`` op by
op, rounds its luma separately and returns another mean on some frames;
the train step never calls it so.) The seeds are chosen so that each of
those roundings decides some output: rounded separately, the contrast
blend fails seed 8, the saturation blend the designed clips of
``test_saturation_blend_is_one_fma``, the mean's luma seed 33 and the S 22
seeds 13 and 27, a true division for the mean S 22 seed 13. The brightness
blend decided no output on any input tried.

The torch sampler cannot give JAX's bits; it is held to its ranges and
rates over 4096 draws, with bounds of about four standard deviations of the
sampling noise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu.ops.pallas.fused_aug import fused_simple_aug as jfused_simple_aug
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, ingest_geometry
from advise_tpu_torch.ops import fused_aug as fa

torch.set_num_threads(1)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ALL_ON = (1.0, 0.4, 0.4, 0.4, 0.2)  # every clip runs the chain
PRESET = (0.8, 0.2, 0.2, 0.2, 0.1)  # SpeedPro's AUG.COLOR
LUMA = (0.299, 0.587, 0.114)


def jax_params(key, n, h, w, size, color):
    """The parameters ``fused_simple_aug`` draws from ``key``, as tensors."""
    p, b, cj, s_, _ = color
    keys = jax.random.split(key, 6)
    tops = jax.random.randint(keys[0], (n,), 0, max(h - size, 1), jnp.int32)
    lefts = jax.random.randint(keys[1], (n,), 0, max(w - size, 1), jnp.int32)
    bfac = jax.random.uniform(keys[2], (n,), jnp.float32, max(0.0, 1 - b), 1 + b)
    cfac = jax.random.uniform(keys[3], (n,), jnp.float32, max(0.0, 1 - cj), 1 + cj)
    sfac = jax.random.uniform(keys[4], (n,), jnp.float32, max(0.0, 1 - s_), 1 + s_)
    apply = (jax.random.uniform(jax.random.fold_in(keys[5], 1), (n,)) < p).astype(jnp.int32)
    order = jax.vmap(lambda k: jax.random.permutation(k, 4))(
        jax.random.split(jax.random.fold_in(keys[5], 2), n)).astype(jnp.int32)
    names = ("tops", "lefts", "bfac", "cfac", "sfac", "apply", "order")
    return {k: torch.from_numpy(np.array(v)) for k, v in
            zip(names, (tops, lefts, bfac, cfac, sfac, apply, order))}


def jax_crop_mean(clip, top, left, size):
    """``crop_mean`` of advise_tpu/ops/pallas/fused_aug.py, as written there."""
    t = clip.shape[0]
    win = jax.lax.dynamic_slice(clip, (0, top, left, 0), (t, size, size, 3)).astype(jnp.float32)
    luma = jnp.floor(LUMA[0] * win[..., 0] + LUMA[1] * win[..., 1] + LUMA[2] * win[..., 2])
    return jnp.floor(jnp.mean(luma, axis=(1, 2)) + 0.5)


def _clips(shape, seed):
    """Random uint8 clips whose first frames are gray on their left third,
    where the two lumas of the chain round apart most often."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, np.uint8)
    x[:, 0, :, : shape[3] // 3] = x[:, 0, :, : shape[3] // 3, :1]
    return x


def jax_aug(size, color, out_dtype=jnp.float32):
    """JAX's ``fused_simple_aug`` under jit, as the train step calls it."""
    return jax.jit(functools.partial(jfused_simple_aug, size=size, color=color, mean=MEAN,
                                     std=STD, out_dtype=out_dtype))


# (clip shape, crop, seeds): the ragged case has W*3 = 129 (not a multiple
# of 16), an odd crop and tops in [0, 8), so most are not 8-aligned; at
# crop 22 the float32 reciprocal of S^2 is inexact
CASES = {
    "small": ((2, 3, 40, 48, 3), 32, (0, 1, 2, 3, 8, 33)),
    "ragged": ((3, 2, 37, 43, 3), 29, range(4)),
    "crop22": ((2, 2, 30, 34, 3), 22, (0, 1, 2, 3, 13, 27)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_equals_jax_interpreted(case, out_dtype):
    """Every clip running the chain, over seeds that put each op at each
    position of the order: the port's plain version equals JAX's kernel."""
    shape, size, seeds = CASES[case]
    n, t, h, w, _ = shape
    jdt, tdt = (jnp.float32, torch.float32) if out_dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    aug = jax_aug(size, ALL_ON, jdt)
    seen, tops = set(), []
    for seed in seeds:
        clips = _clips(shape, seed)
        key = jax.random.PRNGKey(seed)
        with pltpu.force_tpu_interpret_mode():
            want = aug(jnp.asarray(clips), key)
        params = jax_params(key, n, h, w, size, ALL_ON)
        got = fa.fused_simple_aug(torch.from_numpy(clips), params, size, MEAN, STD, tdt)
        assert got.dtype == tdt and tuple(got.shape) == (n, t, size, size, 3)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        seen |= {(pos, int(op)) for row in params["order"] for pos, op in enumerate(row)}
        tops += params["tops"].tolist()
    assert seen == {(pos, op) for pos in range(4) for op in range(4)}
    assert any(top % 8 for top in tops)


def test_saturation_blend_is_one_fma():
    """48 clips of two 16 x 16 frames that hold every uint8 value in one
    channel beside random ones: key 7 draws a saturation factor whose blend
    rounds apart when the product and the sum round separately."""
    n, t, size = 48, 2, 16
    frame = np.random.default_rng(5).integers(0, 256, (t, size, size, 3), np.uint8)
    frame[0, :, :, 0] = np.arange(256).reshape(size, size)
    frame[1, :, :, 1] = np.arange(256).reshape(size, size)[::-1]
    clips = np.broadcast_to(frame, (n, t, size, size, 3)).copy()
    key = jax.random.PRNGKey(7)
    with pltpu.force_tpu_interpret_mode():
        want = jax_aug(size, ALL_ON)(jnp.asarray(clips), key)
    params = jax_params(key, n, size, size, size, ALL_ON)
    got = fa.fused_simple_aug(torch.from_numpy(clips), params, size, MEAN, STD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_equals_jax_with_the_preset_color():
    """SpeedPro's AUG.COLOR (p 0.8): clips with the chain and clips without."""
    shape, size = (8, 2, 40, 48, 3), 32
    clips = _clips(shape, 7)
    key = jax.random.PRNGKey(5)
    with pltpu.force_tpu_interpret_mode():
        want = jax_aug(size, PRESET)(jnp.asarray(clips), key)
    params = jax_params(key, shape[0], shape[2], shape[3], size, PRESET)
    assert 0 < int(params["apply"].sum()) < shape[0]
    got = fa.fused_simple_aug(torch.from_numpy(clips), params, size, MEAN, STD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [22, 32, 29])
def test_crop_mean_equals_jax(size):
    """The contrast mean under jit, on random frames and on frames whose
    luma mean is exactly k + 0.5 (at S 22 the float32 reciprocal of S^2
    rounds those apart from a true division; JAX's mean multiplies; on the
    gray frames the contracted luma rounds apart from the separate one)."""
    rng = np.random.default_rng(size)
    frames = [rng.integers(0, 256, (size + 3, size + 5, 3), np.uint8) for _ in range(16)]
    half = size * size // 2
    for k in range(0, 250, 5):
        a = np.full(size * size, k, np.uint8)
        a[:half] += 1  # gray pixels: luma k and k + 1, half each
        frame = np.zeros((size + 3, size + 5, 3), np.uint8)
        frame[1:size + 1, 2:size + 2] = np.repeat(a.reshape(size, size, 1), 3, axis=-1)
        frames.append(frame)
    clip = np.stack(frames)
    want = np.asarray(jax.jit(lambda c: jax_crop_mean(c, 1, 2, size))(clip))
    win = fa.crop_windows(torch.from_numpy(clip)[None], torch.tensor([1]), torch.tensor([2]), size)
    got = fa.crop_mean(win)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_sampler_distribution():
    """4096 draws of the torch sampler: offsets and factors in their ranges,
    every order row a permutation of the four ops, the apply rate within
    4 standard deviations (0.025) of p, and the factors' means within 0.01
    of their ranges' centres (4 sd of a mean of 4096 uniforms of width
    0.4 is 0.007)."""
    n, h, w, size = 4096, 256, 320, 224
    g = torch.Generator().manual_seed(0)
    prm = fa.sample_simple_aug(n, h, w, size, PRESET, g)
    assert prm["tops"].dtype == torch.int32 and prm["order"].shape == (n, 4)
    assert int(prm["tops"].min()) == 0 and int(prm["tops"].max()) == h - size - 1
    assert int(prm["lefts"].min()) == 0 and int(prm["lefts"].max()) == w - size - 1
    for k in ("bfac", "cfac", "sfac"):
        v = prm[k]
        assert float(v.min()) >= 0.8 and float(v.max()) < 1.2, k
        assert abs(float(v.mean()) - 1.0) < 0.01, k
    assert torch.equal(torch.sort(prm["order"], dim=1).values,
                       torch.arange(4, dtype=torch.int32).expand(n, 4))
    assert abs(float(prm["apply"].float().mean()) - PRESET[0]) < 0.025
    # every op reaches every position of the order
    for pos in range(4):
        assert set(prm["order"][:, pos].tolist()) == {0, 1, 2, 3}


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    clips = torch.from_numpy(_clips((2, 2, 20, 24, 3), 1))
    prm = fa.sample_simple_aug(2, 20, 24, 16, ALL_ON, torch.Generator().manual_seed(1))
    launches = fa.fused_simple_aug.launches
    got = fa.fused_simple_aug(clips, prm, 16, MEAN, STD)
    assert torch.equal(got, fa.fused_simple_aug_plain(clips, prm, 16, MEAN, STD))
    assert fa.fused_simple_aug.launches == launches
    with pytest.raises(RuntimeError):
        fa.fused_simple_aug(clips.to("meta"), prm, 16, MEAN, STD)


def _simple_cfg(**overrides):
    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/pretrain/SpeedPro_R50.yaml")
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.AUG.RESIZE = [48, 40]
    cfg.AUG.TARGET_SIZE = 32
    for key, value in overrides.items():
        sec, leaf = key.split(".")
        cfg[sec][leaf] = value
    return tconfig.assert_and_infer_cfg(cfg)


def test_device_aug_simple_pipeline():
    """build_device_aug dispatches AUG.TYPE 'simple' at the ingest geometry
    AUG.RESIZE (W, H); the batch [B, K] is flattened to clips and back;
    REVERSE_INPUT_CHANNEL flips the channels before the aug; without
    TPU.PALLAS_AUG the pipeline takes the XLA path and launches no kernel
    (tests/test_torch_simple_aug_xla.py holds it to JAX); an AUG.TYPE that
    is not ported raises."""
    cfg = _simple_cfg()
    w, h = ingest_geometry(cfg, "train")
    assert (w, h) == (48, 40)
    batch = torch.from_numpy(_clips((2, 3, 4, h, w, 3), 2))
    aug = build_device_aug(cfg, "train")
    out = aug(batch, torch.Generator().manual_seed(5))
    assert out.shape == (2, 3, 4, 32, 32, 3) and out.dtype == torch.float32
    prm = aug.sample(6, 4, h, w, 3, torch.Generator().manual_seed(5))
    flat = fa.fused_simple_aug(batch.reshape(6, 4, h, w, 3), prm, 32, cfg.DATA.MEAN, cfg.DATA.STD)
    assert torch.equal(out, flat.reshape(out.shape))

    rev = build_device_aug(_simple_cfg(**{"DATA.REVERSE_INPUT_CHANNEL": True}), "train")
    assert torch.equal(rev(batch, torch.Generator().manual_seed(5)),
                       aug(batch.flip(-1), torch.Generator().manual_seed(5)))
    bf16 = build_device_aug(_simple_cfg(**{"TPU.AUG_COMPUTE_OUT": True}), "train")
    assert bf16(batch, torch.Generator().manual_seed(5)).dtype == torch.bfloat16
    xla = build_device_aug(_simple_cfg(**{"TPU.PALLAS_AUG": False}), "train")
    launches = fa.fused_simple_aug.launches
    out = xla(batch, torch.Generator().manual_seed(5))
    assert not xla.pallas and out.shape == (2, 3, 4, 32, 32, 3)
    assert fa.fused_simple_aug.launches == launches
    clip_aug = build_device_aug(_simple_cfg(**{"AUG.TYPE": "clip_aug"}), "train")
    assert type(clip_aug).__name__ == "ClipAug"
    assert clip_aug(batch, torch.Generator().manual_seed(5)).shape == out.shape
