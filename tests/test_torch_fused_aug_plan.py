"""The fused simple aug's launch plan (advise_tpu_torch/ops/fused_aug.py
plan()) on the CPU, and plain emulations of what csrc/fused_aug.cu does with
it:

- plan() at SpeedPro's shape, at the ragged shapes of the card tests and at
  every crop S from 1 to 256: the bands cover S exactly, shared memory fits
  in 227 KB, the store width (vector) is the widest that keeps every output
  row aligned, the grid is N*T clusters, a staged row holds the
  16-byte-aligned superset of its bytes at any shift and the last group's
  16-byte read;
- the staging: each CTA's rows copied as the kernel copies them (16-byte
  chunks from the aligned address below each row, byte by byte where a
  chunk reaches outside the tensor, the tensor placed at a shift from a
  16-byte boundary), then read back as the kernel reads a group of 4 pixels
  (4 aligned words funnel-shifted by the offset's low bits), by the work
  walk of the kernel (fixed strides over (row, group)): every window byte
  comes back, each item once;
- the normalisation as the kernel computes it (a product by float32(1 / s)
  and one correction) against float32 division, at every config's DATA.MEAN
  and DATA.STD and at random ones, and the check that finds a wrong
  reciprocal;
- the contrast mean as the kernel forms it (each band's integer luma sum,
  the sums added in rank order, times float32(1 / S^2), + 0.5, floor)
  EQUALS the port's crop_mean and JAX's crop_mean under jit (the model is
  tests/test_torch_fused_aug.py test_crop_mean_equals_jax). Integer sums
  are exact in any order, so this holds the band split and the exchange,
  not a rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu_torch.ops import fused_aug as fa

SPEEDPRO = (32, 8, 256, 320, 224)
# (N, T, H, W, S) of the card tests (tests/test_torch_kernels_cuda.py)
RAGGED = [(3, 2, 37, 43, 29), (1, 1, 40, 52, 38), (2, 3, 50, 61, 45), (2, 2, 36, 45, 32),
          (2, 2, 5, 7, 1), (1, 2, 256, 260, 256), (3, 5, 41, 43, 29)]
LUMA = (0.299, 0.587, 0.114)


def test_plan_at_speedpro_shape():
    """Crop 224 of [32, 8, 256, 320, 3]: 8 CTAs a frame with 28 rows each
    (28 x 56 groups = 1568 items = 7 a thread of 224), rows of 704 bytes
    (672 + the 30 a shift can add, rounded to 16), float4 stores (8 bytes in
    bf16), 2048 CTAs, 7 an SM (shared memory, and the launch bound's 40
    registers a thread: 7 x 7 warps x 1280)."""
    p = fa.plan(*SPEEDPRO)
    assert (p["cluster"], p["band"], p["groups"], p["threads"]) == (8, 28, 56, 224)
    assert p["bands"] == [(28 * k, 28 * k + 28) for k in range(8)]
    assert p["items_per_thread"] == 7 and p["pitch"] == 704 and p["chunks"] == 43
    assert p["smem"] == 28 * 704 and p["smem_total"] == 28 * 704 + 8 * (1536 + 4) + 8
    assert p["vector"] == 4 and p["store_bytes"] == 16
    assert fa.plan(*SPEEDPRO, out_dtype=torch.bfloat16)["store_bytes"] == 8
    assert p["grid"] == (2048, 1, 1) and p["per_sm"] == 7
    assert p["waves"] == 2048 / (132 * 7)
    # more registers: 64 a thread x 224 threads -> 4
    assert fa.plan(*SPEEDPRO, registers=64)["per_sm"] == 4


def _check_plan(n, t, h, w, s, out_dtype=torch.float32):
    p = fa.plan(n, t, h, w, s, out_dtype)
    bands = p["bands"]
    # the bands tile [0, S): in rank order, none empty, none longer than band
    assert bands[0][0] == 0 and bands[-1][1] == s and len(bands) == p["cluster"]
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert all(0 < r1 - r0 <= p["band"] for r0, r1 in bands)
    assert 1 <= p["cluster"] <= fa.MAX_CLUSTER
    assert p["smem_total"] == p["smem"] + fa.static_smem(out_dtype) <= fa.MAX_SMEM_BLOCK
    assert p["smem"] == p["band"] * p["pitch"]
    # the widest store that keeps every row start and every group aligned:
    # row starts are multiples of 3 S elements, groups of 12, a row's last
    # group holds 3 (S % 4) values
    v = p["vector"]
    assert v in (1, 2, 4) and s % v == 0 and (v == 4 or s % (2 * v) != 0)
    assert (3 * s) % v == 0 and 12 % v == 0 and (3 * (s % 4)) % v == 0
    assert p["store_bytes"] == v * (4 if out_dtype == torch.float32 else 2)
    assert p["grid"] == (n * t * p["cluster"], 1, 1)
    assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= fa.MAX_THREADS
    assert p["groups"] == -(-s // 4)
    # a staged row: every chunk of the aligned superset at any shift, and
    # the last group's 4 words at any shift
    assert p["pitch"] % 16 == 0
    for shift in range(16):
        assert p["pitch"] >= 16 * -(-(shift + 3 * s) // 16)
        o = shift + 12 * (p["groups"] - 1)
        assert p["pitch"] >= (o & ~3) + 16
    assert p["chunks"] * 16 >= 15 + 3 * s
    return p


@pytest.mark.parametrize("shape", [SPEEDPRO] + RAGGED)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plan_invariants(shape, out_dtype):
    _check_plan(*shape, out_dtype=out_dtype)


def test_plan_invariants_at_every_crop():
    """S from 1 to 256 (exact while S^2 * 255 < 2^24), N * T = 1 and 12."""
    for s in range(1, 257):
        for n, t in ((1, 1), (3, 4)):
            _check_plan(n, t, s, s + 3, s)
    with pytest.raises(ValueError):
        fa.plan(1, 1, 20, 20, 21)


# -- the kernel's staging and work walk, emulated ----------------------------------


def _stage_band(mem, lo, hi, row_starts, s, pitch):
    """A CTA's staged band: for each row starting at address a, the 16-byte
    chunks from a & ~15 that start before a + 3 s, each copied whole where
    it lies in [lo, hi), else byte by byte inside it."""
    band = np.full((len(row_starts), pitch), 0xEE, np.uint8)  # what was there before
    max_chunks = (3 * s + 30) // 16
    for r, a in enumerate(row_starts):
        for k in range(max_chunks):
            g = (a & ~15) + 16 * k
            if g >= a + 3 * s:
                continue
            for b in range(16):
                if lo <= g + b < hi:
                    band[r, 16 * k + b] = mem[g + b]
    return band


def _read_group(row, o):
    """12 bytes at byte offset o of a staged row: 4 aligned little-endian
    words, funnel-shifted right by 8 (o % 4) bits."""
    words = row[(o & ~3):(o & ~3) + 16].view("<u4").astype(np.uint64)
    sh = 8 * (o & 3)
    out = [((words[i] | (words[i + 1] << np.uint64(32))) >> np.uint64(sh)) & np.uint64(0xFFFFFFFF)
           for i in range(3)]
    return np.array(out, "<u4").view(np.uint8)


def _walk(rows, groups, threads):
    """The (row, group) items each thread takes, as the kernel walks them."""
    dr, dg = threads // groups, threads % groups
    items = []
    for tid in range(threads):
        r, g = tid // groups, tid % groups
        while r < rows:
            items.append((r, g))
            g += dg
            r += dr
            if g >= groups:
                g -= groups
                r += 1
    return items


@pytest.mark.parametrize("shape,tops,lefts,base", [
    ((3, 2, 37, 43, 3), (3, 5, 7), (0, 14, 9), 0),
    ((1, 1, 40, 52, 3), (1,), (5,), 16),
    ((2, 3, 50, 61, 3), (0, 5), (0, 16), 0),      # the window ends on the tensor's last byte
    ((2, 2, 36, 45, 3), (1, 4), (13, 2), 7),      # the tensor 7 bytes past a 16-byte boundary
    ((2, 2, 5, 7, 3), (4, 0), (6, 3), 3),
])
def test_staging_and_walk_return_every_window_byte(shape, tops, lefts, base):
    n, t, h, w, _ = shape
    s = {37: 29, 40: 38, 50: 45, 36: 32, 5: 1}[h]
    p = fa.plan(n, t, h, w, s)
    clips = np.random.default_rng(h).integers(0, 256, shape, np.uint8)
    lo, hi = base, base + clips.size
    mem = np.zeros(hi + 64, np.uint8)
    mem[lo:hi] = clips.reshape(-1)
    for frame in range(n * t):
        c = frame // t
        want = clips[c, frame % t, tops[c]:tops[c] + s, lefts[c]:lefts[c] + s].reshape(s, 3 * s)
        got = np.zeros_like(want)
        seen = np.zeros((s, p["groups"]), np.int64)
        for r0, r1 in p["bands"]:
            starts = [lo + ((frame * h + tops[c] + r) * w + lefts[c]) * 3 for r in range(r0, r1)]
            band = _stage_band(mem, lo, hi, starts, s, p["pitch"])
            for r, g in _walk(r1 - r0, p["groups"], p["threads"]):
                seen[r0 + r, g] += 1
                vals = _read_group(band[r], (starts[r] & 15) + 12 * g)
                k = 3 * min(4, s - 4 * g)
                got[r0 + r, 12 * g:12 * g + k] = vals[:k]
        assert (seen == 1).all()
        np.testing.assert_array_equal(got, want)


# -- the contrast mean by bands ------------------------------------------------------


def _banded_mean(win_u8, bands):
    """[T, S, S, 3] uint8 -> [T]: each band's integer sum of the contracted
    luma floor(fma(b, 0.114, fma(r, 0.299, 0.587 g))) (each fma one float32
    rounding, exact in float64 for these operands), added in rank order;
    then float32(total) * float32(1 / S^2) + 0.5, floored, in float32."""
    s = win_u8.shape[1]
    x = win_u8.astype(np.float64)
    k = [float(np.float32(c)) for c in LUMA]
    g = (x[..., 1] * k[1]).astype(np.float32).astype(np.float64)
    inner = (x[..., 0] * k[0] + g).astype(np.float32).astype(np.float64)
    lm = np.floor((x[..., 2] * k[2] + inner).astype(np.float32)).astype(np.int64)
    total = np.zeros(win_u8.shape[0], np.int64)
    for r0, r1 in bands:
        total += lm[:, r0:r1].sum(axis=(1, 2))
    inv_area = np.float32(1.0) / np.float32(s * s)
    return np.floor(total.astype(np.float32) * inv_area + np.float32(0.5))


def _jax_crop_mean(clip, top, left, size):
    """``crop_mean`` of advise_tpu/ops/pallas/fused_aug.py, as written there."""
    t = clip.shape[0]
    win = jax.lax.dynamic_slice(clip, (0, top, left, 0), (t, size, size, 3)).astype(jnp.float32)
    luma = jnp.floor(LUMA[0] * win[..., 0] + LUMA[1] * win[..., 1] + LUMA[2] * win[..., 2])
    return jnp.floor(jnp.mean(luma, axis=(1, 2)) + 0.5)


@pytest.mark.parametrize("size", [1, 22, 29, 38, 45, 224, 256])
def test_banded_contrast_mean_equals_crop_mean_and_jax(size):
    """Random frames and frames whose luma mean is exactly k + 0.5 (half
    the pixels gray at k, half at k + 1), so the mean's rounding decides."""
    rng = np.random.default_rng(size)
    frames = [rng.integers(0, 256, (size + 3, size + 5, 3), np.uint8) for _ in range(6)]
    half = size * size // 2
    for k in range(0, 250, 25):
        a = np.full(size * size, k, np.uint8)
        a[:half] += 1
        frame = np.zeros((size + 3, size + 5, 3), np.uint8)
        frame[1:size + 1, 2:size + 2] = np.repeat(a.reshape(size, size, 1), 3, axis=-1)
        frames.append(frame)
    clip = np.stack(frames)
    p = fa.plan(1, clip.shape[0], size + 3, size + 5, size)
    got = _banded_mean(clip[:, 1:size + 1, 2:size + 2], p["bands"])
    want_jax = np.asarray(jax.jit(lambda c: _jax_crop_mean(c, 1, 2, size))(clip))
    win = fa.crop_windows(torch.from_numpy(clip)[None], torch.tensor([1]), torch.tensor([2]), size)
    want_port = fa.crop_mean(win)[0].numpy()
    np.testing.assert_array_equal(got, want_port)
    np.testing.assert_array_equal(got, want_jax)


# -- the normalisation --------------------------------------------------------------


def test_reciprocal_normalisation_is_exact():
    """The kernel's (y - m) / s for every y: at the constants of every
    preset that sets them (and the defaults) and at 40 random ones, exact;
    with the reciprocal 2^-10 off (the correction squares a relative error,
    so one ulp off still rounds right), the check finds misses."""
    import glob

    import yaml

    pairs = {((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}
    for path in glob.glob("configs/**/*.yaml", recursive=True):
        data = (yaml.safe_load(open(path)) or {}).get("DATA") or {}
        if "MEAN" in data or "STD" in data:
            pairs.add((tuple(data.get("MEAN", (0.485, 0.456, 0.406))),
                       tuple(data.get("STD", (0.229, 0.224, 0.225)))))
    rng = np.random.default_rng(0)
    pairs |= {(tuple(rng.uniform(0.1, 0.9, 3)), tuple(rng.uniform(0.05, 0.5, 3))) for _ in range(40)}
    for mean, std in pairs:
        m, s = fa.affine_constants(mean, std)
        inv = fa.reciprocals(tuple(float(v) for v in m), tuple(float(v) for v in s))
        for c in range(3):
            assert np.float32(inv[c]) == np.float32(1.0) / s[c]
            assert fa.reciprocal_misses(m[c], s[c], np.float32(inv[c])) == []
    m, s = fa.affine_constants((0.45,) * 3, (0.225,) * 3)
    off = np.float32(1.0) / s[0] * np.float32(1 + 2.0 ** -10)
    assert len(fa.reciprocal_misses(m[0], s[0], off)) > 0
