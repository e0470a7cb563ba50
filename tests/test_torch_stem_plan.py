"""The launch plans of the stem kernels (advise_tpu_torch/ops/stem_conv.py
plan()) and of K4's float32 pair (ops/flash_attention.py f32_plan(),
route()), on the CPU, and a plain emulation of the stem kernels' arithmetic
(csrc/stem_conv.cu) held to the port's plain versions and to the JAX
package's Pallas stem (TPU interpret mode, as tests/test_pallas_stem.py
runs it) and its XLA s2d conv.

The emulation follows the kernels step by step, in float32:
- the clip is staged as 2x2 space-to-depth cells of 16 channels, (ph, pw,
  c) then 4 zeros, each tile's cells with a halo of 2 before and 1 after;
- the weight becomes the kernel's 1280-tap [kt, 4, 4, 16, 8] B operand by
  the formula its fragment builder uses (held to JAX's s2d_remap_kernel);
- each persistent block of plan() takes its contiguous range of (clip,
  tile, frame) work items; the forward's output tile is the implicit GEMM
  of the tile's im2col with that weight, the weight gradient's partial the
  sum over the block's items of im2col^T x g;
- the reduce sums the partials as the reduce kernel does (8 strided shares
  in order, then the shares in order) and collapses the s2d taps back to
  [kt, 7, 7, 3, 8], dropping the zero taps.
Tolerances: float32 sums of the same products in other orders, 1e-4 of the
largest entry (the forward's entries are O(1), dW's O(100)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu.models.layers.stem import s2d_conv, s2d_remap_kernel, s2d_repack_input
from advise_tpu.ops.flash_attention import flash_mha as jflash_mha
from advise_tpu.ops.pallas.stem_conv import pallas_s2d_stem
from advise_tpu_torch.ops import flash_attention as fl
from advise_tpu_torch.ops import stem_conv as sc

torch.set_num_threads(1)

TW, CW = sc.TILE_W, sc.TILE_W + 3
RED_ROWS = 8  # threads of the reduce kernel summing one weight's partials


# -- plan() ----------------------------------------------------------------------


def test_plan_at_the_byol_stem_shape():
    """[32,32,224,224,3], kt 5: tiles of 56 x 16 outputs (112 = 2 x 56 = 7 x
    16), one persistent block on each of 132 SMs (one wave), 109 work items
    a block, a ring of 5 frames (K1) and 5 + 1 (K2: the next frame's copy has
    its own slot), one partial a K2 block."""
    p = sc.plan(32, 32, 224, 224, 5)
    assert p["out"] == (112, 112)
    for name, warps, smem, ring in (("fwd", 8, 199840, 5), ("wgrad", 10, 229568, 6)):
        k = p[name]
        assert k["tile"] == (56, 16) and k["warps"] == warps and k["smem"] == smem
        assert k["grid"] == (132, 1, 1) and k["waves"] == 1.0
        assert k["tiles"] == 14 and k["items"] == 32 * 14 * 32 and k["items_per_block"] == 109
        assert k["ring"] == ring
    assert p["wgrad"]["groups"] == 1 and p["wgrad"]["taps_per_group"] == 5
    assert p["wgrad"]["partials"] == 132


# the card tests' stem shapes (tests/test_torch_kernels_cuda.py): ragged
# tiles, B = 1, kt 1, 3 and 7, T < kt, and more items than blocks
CARD_SHAPES = [((2, 7, 37, 45), 5), ((2, 8, 64, 64), 5), ((1, 4, 33, 70), 1), ((1, 6, 50, 36), 3),
               ((2, 5, 30, 42), 7), ((2, 2, 40, 34), 5), ((1, 3, 24, 24), 7), ((2, 40, 64, 70), 5),
               ((32, 32, 224, 224), 5), ((6, 5, 40, 48), 5)]


@pytest.mark.parametrize("shape,kt", CARD_SHAPES)
def test_plan_invariants(shape, kt):
    b, t, h, w = shape
    p = sc.plan(b, t, h, w, kt)
    ho, wo = sc.out_hw(h, w)
    for name in ("fwd", "wgrad"):
        k = p[name]
        th, tw = k["tile"]
        assert tw == TW and th % sc.WARP_ROWS == 0 and k["smem"] <= sc.SMEM_LIMIT
        assert k["tiles"] == -(-ho // th) * -(-wo // tw)
        assert k["items"] == b * k["tiles"] * t
        assert k["grid"][0] == min(sc.SMS, k["items"]) and k["waves"] <= 1.0 * k["grid"][1]
        assert k["items_per_block"] * k["grid"][0] >= k["items"]
    assert p["fwd"]["warps"] * sc.WARP_ROWS == p["fwd"]["tile"][0]
    assert p["fwd"]["ring"] == kt and p["fwd"]["smem"] == sc.fwd_smem(p["fwd"]["tile"][0], kt)
    g = p["wgrad"]
    assert g["groups"] * g["taps_per_group"] >= kt > (g["groups"] - 1) * g["taps_per_group"]
    assert g["taps_per_group"] <= sc.WGRAD_MAX_TAPS and g["warps"] == 2 * g["taps_per_group"]
    assert g["grid"][1] == g["groups"] and g["partials"] == g["grid"][0]


@pytest.mark.parametrize("kt,fwd_rows,groups", [(1, 56, 1), (3, 56, 1), (5, 56, 1), (7, 28, 2),
                                                (9, 28, 2), (11, 14, 3)])
def test_plan_rows_and_groups_follow_kt(kt, fwd_rows, groups):
    """K1's ring holds kt frames, so its tile shrinks as kt grows; K2 splits
    kt into groups of at most 5 taps, one grid row each."""
    p = sc.plan(2, 8, 64, 64, kt)
    assert p["fwd"]["tile"][0] == fwd_rows
    assert p["wgrad"]["groups"] == groups


def test_plan_refuses_an_even_kt():
    with pytest.raises(ValueError):
        sc.plan(1, 4, 16, 16, 4)


# -- the emulation ---------------------------------------------------------------


def s2d_cells(x: np.ndarray) -> np.ndarray:
    """[B,T,H,W,3] -> [B,T,Ho,Wo,16]: 2x2 cells, channels (ph, pw, c), then 4
    zeros; a ragged H or W is zero past the edge."""
    b, t, h, w, c = x.shape
    ho, wo = sc.out_hw(h, w)
    xp = np.zeros((b, t, 2 * ho, 2 * wo, c), np.float32)
    xp[:, :, :h, :w] = x
    cells = xp.reshape(b, t, ho, 2, wo, 2, c).transpose(0, 1, 2, 4, 3, 5, 6).reshape(b, t, ho, wo, 4 * c)
    return np.concatenate([cells, np.zeros((b, t, ho, wo, 16 - 4 * c), np.float32)], -1)


def weight_taps(w: np.ndarray) -> np.ndarray:
    """[kt,7,7,3,8] -> the kernels' [kt,4,4,16,8] operand, by the fragment
    builder's formula: channel ch = 6 ph + 3 pw + c of tap (ah, aw) is w[dt,
    2 ah + ph - 1, 2 aw + pw - 1, c], zero for ch >= 12 and for dy or dx = -1."""
    kt = w.shape[0]
    out = np.zeros((kt, 4, 4, 16, 8), np.float32)
    for ah in range(4):
        for aw in range(4):
            for ch in range(12):
                ph, pw, c = ch // 6, (ch // 3) & 1, ch % 3
                dy, dx = 2 * ah + ph - 1, 2 * aw + pw - 1
                if dy >= 0 and dx >= 0:
                    out[:, ah, aw, ch] = w[:, dy, dx, c]
    return out


def _im2col(cells, b, t, i0, j0, th, kt):
    """The A operand of one work item: [th * 16 positions, kt * 16 taps *
    16 channels] from the tile's staged frames (halo 2 before, 1 after)."""
    _, tt, ho, wo, _ = cells.shape
    h = kt // 2
    staged = np.zeros((kt, th + 3, CW, 16), np.float32)
    for dt in range(kt):
        ts = t + dt - h
        if not 0 <= ts < tt:
            continue  # temporal zero padding: the kernels skip the tap
        r0, r1 = max(i0 - 2, 0), min(i0 + th + 1, ho)
        c0, c1 = max(j0 - 2, 0), min(j0 + TW + 1, wo)
        staged[dt, r0 - (i0 - 2):r1 - (i0 - 2), c0 - (j0 - 2):c1 - (j0 - 2)] = cells[b, ts, r0:r1, c0:c1]
    a = np.empty((th, TW, kt, 4, 4, 16), np.float32)
    for ah in range(4):
        for aw in range(4):
            a[:, :, :, ah, aw] = staged[:, ah:ah + th, aw:aw + TW].transpose(1, 2, 0, 3)
    return a.reshape(th * TW, -1)


def _items(k: dict, t: int, tiles_x: int):
    """Each block's work items (b, t, i0, j0), in its range's order."""
    th = k["tile"][0]
    nblk = k["grid"][0]
    for blk in range(nblk):
        begin, end = k["items"] * blk // nblk, k["items"] * (blk + 1) // nblk
        out = []
        for it in range(begin, end):
            seg, tt = divmod(it, t)
            b, tile = divmod(seg, k["tiles"])
            out.append((b, tt, (tile // tiles_x) * th, (tile % tiles_x) * TW))
        yield out


def emulate_fwd(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    b, t, h, wd, _ = x.shape
    kt = w.shape[0]
    k = sc.plan(b, t, h, wd, kt)["fwd"]
    ho, wo = sc.out_hw(h, wd)
    th, tiles_x = k["tile"][0], -(-wo // TW)
    cells, wt = s2d_cells(x), weight_taps(w).reshape(-1, 8)
    y = np.zeros((b, t, ho, wo, 8), np.float32)
    seen = 0
    for items in _items(k, t, tiles_x):
        for bb, tt, i0, j0 in items:
            tile = (_im2col(cells, bb, tt, i0, j0, th, kt) @ wt).reshape(th, TW, 8)
            ni, nj = min(th, ho - i0), min(TW, wo - j0)
            y[bb, tt, i0:i0 + ni, j0:j0 + nj] = tile[:ni, :nj]
            seen += 1
    assert seen == k["items"]
    return y


def emulate_wgrad(x: np.ndarray, g: np.ndarray, kt: int):
    """(dW [kt,7,7,3,8], the summed [kt,4,4,16,8] s2d gradient)."""
    b, t, h, wd, _ = x.shape
    k = sc.plan(b, t, h, wd, kt)["wgrad"]
    ho, wo = sc.out_hw(h, wd)
    th, tiles_x = k["tile"][0], -(-wo // TW)
    cells = s2d_cells(x)
    partials = []
    for items in _items(k, t, tiles_x):
        part = np.zeros((kt * 4 * 4 * 16, 8), np.float32)
        for bb, tt, i0, j0 in items:
            gt = np.zeros((th, TW, 8), np.float32)
            ni, nj = min(th, ho - i0), min(TW, wo - j0)
            gt[:ni, :nj] = g[bb, tt, i0:i0 + ni, j0:j0 + nj]
            part += _im2col(cells, bb, tt, i0, j0, th, kt).T @ gt.reshape(-1, 8)
        partials.append(part)
    assert len(partials) == k["partials"]
    shares = [np.sum(partials[r::RED_ROWS], axis=0, dtype=np.float32) if partials[r::RED_ROWS]
              else np.zeros_like(partials[0]) for r in range(RED_ROWS)]
    total = np.sum(shares, axis=0, dtype=np.float32).reshape(kt, 4, 4, 16, 8)
    dw = np.zeros((kt, 7, 7, 3, 8), np.float32)
    for dy in range(7):
        for dx in range(7):
            ah, ph, aw, pw = (dy + 1) >> 1, (dy + 1) & 1, (dx + 1) >> 1, (dx + 1) & 1
            dw[:, dy, dx] = total[:, ah, aw, 6 * ph + 3 * pw:6 * ph + 3 * pw + 3]
    return dw, total


def _data(shape, kt, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, 3)).astype(np.float32)
    w = (rng.standard_normal((kt, 7, 7, 3, 8)) * 0.1).astype(np.float32)
    return x, w, rng


def _close(a, ref, rel=1e-4):
    return float(np.abs(a - ref).max()) <= rel * float(np.abs(ref).max())


def test_weight_taps_are_jax_s2d_remap():
    """The fragment builder's formula equals JAX's s2d_remap_kernel (its 12
    channels), with the 4 pad channels zero."""
    _, w, _ = _data((1, 1, 2, 2), 5)
    want = np.asarray(s2d_remap_kernel(jnp.asarray(w), 5))
    got = weight_taps(w)
    np.testing.assert_array_equal(got[..., :12, :], want)
    assert not got[..., 12:, :].any()


EMULATED = [((2, 3, 20, 34), 5), ((1, 2, 19, 37), 5), ((2, 4, 24, 18), 3), ((1, 3, 26, 20), 7),
            ((2, 2, 16, 16), 1), ((1, 40, 16, 40), 5)]


@pytest.mark.parametrize("shape,kt", EMULATED)
def test_emulated_kernels_match_the_plain_versions(shape, kt):
    """Ragged tiles (odd H, W), T < kt, kt 1, 3, 5 and 7, and a clip whose
    work items outnumber the blocks (several items a block, their ranges
    crossing clips): the emulated forward and weight gradient against the
    port's plain conv and its weight gradient, and the zero taps of the s2d
    gradient (the pad channels) exactly zero."""
    x, w, rng = _data(shape, kt)
    want = sc.stem_conv_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    got = emulate_fwd(x, w)
    assert got.shape == want.shape and _close(got, want)
    g = rng.standard_normal(want.shape).astype(np.float32)
    dw, total = emulate_wgrad(x, g, kt)
    dref = sc.stem_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g), kt).numpy()
    assert _close(dw, dref)
    assert not total[..., 12:, :].any()


def test_emulated_kernels_match_jax_pallas_and_s2d_conv():
    """At a shape JAX's Pallas stem takes (s2d width a multiple of 16): the
    emulated forward against pallas_s2d_stem (interpret mode) and s2d_conv on
    the repacked clip, and the emulated dW against the Pallas custom VJP's
    weight gradient mapped back through the remap."""
    kt = 5
    x, w, rng = _data((2, 6, 32, 64), kt)
    x2, w2 = s2d_repack_input(jnp.asarray(x)), s2d_remap_kernel(jnp.asarray(w), kt)
    g = rng.standard_normal((2, 6, 16, 32, 8)).astype(np.float32)

    def stem(ww):
        return pallas_s2d_stem(x2, s2d_remap_kernel(ww, kt), kt)

    with pltpu.force_tpu_interpret_mode():
        y_pallas, vjp = jax.vjp(stem, jnp.asarray(w))
        (dw_pallas,) = vjp(jnp.asarray(g))
    y_xla = np.asarray(s2d_conv(x2, w2, kt))
    got = emulate_fwd(x, w)
    assert _close(got, np.asarray(y_pallas)) and _close(got, y_xla)
    dw, _ = emulate_wgrad(x, g, kt)
    assert _close(dw, np.asarray(dw_pallas))


# -- K4's routing and its float32 pair's plan -------------------------------------


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 72, "wgmma"), (torch.bfloat16, 576, "wgmma"), (torch.bfloat16, 577, "wgmma"),
    (torch.bfloat16, 768, "wgmma"), (torch.bfloat16, 769, "f32"), (torch.float32, 8, "f32"),
    (torch.float32, 288, "f32"), (torch.float32, 576, "f32"), (torch.float32, 1100, "f32"),
    (torch.float16, 72, TypeError), (torch.float64, 72, TypeError), (torch.float16, 768, TypeError),
])
def test_flash_route(dtype, d, kernel):
    """bf16 up to head dim 768 takes the tensor-core kernels, float32 at any
    head dim and bf16 above 768 the float32 pair; any other dtype raises."""
    if kernel is TypeError:
        with pytest.raises(TypeError):
            fl.route(dtype, d)
    else:
        assert fl.route(dtype, d) == kernel


@pytest.mark.parametrize("shape", [(4, 6400, 1600, 288), (4, 1600, 1600, 576), (2, 500, 300, 800),
                                   (1, 40, 33, 1100), (3, 777, 555, 640), (1, 1, 1, 8)])
def test_flash_f32_plan(shape):
    """The float32 pair's plan: a warp 16 rows (dK/dV: wc warps sharing 16
    keys, each 1/wc of the columns); the output tiles' float32 accumulators
    within 144 registers a thread; up to head dim 288 one block holds all
    of d, above it grid z splits d into parts of at most 288 and the
    contraction streams in chunks (fl.F32_DC); at MViT-L's shapes the dK/dV
    grid with its query-range splits fills the card's SMs; shared memory
    within a block's limit."""
    bh, nq, nk, d = shape
    bf16 = d == 800  # what a bf16 input above 768 takes
    p = fl.f32_plan(bh, nq, nk, d, bf16)
    d8 = -(-d // 8) * 8
    for name, n in (("fwd", nq), ("dq", nq), ("dkdv", nk)):
        k = p[name]
        assert k["rows"] * k["wc"] == 16 * k["warps"] and k["warps"] <= 8
        # float32 output accumulators, 4 registers per 8 columns (dK/dV: two
        # tiles), within 144 of a thread's 255
        assert (2 if name == "dkdv" else 1) * k["cw"] // 2 <= 144
        assert k["cols"] % 8 == 0 and k["cols"] <= k["cw"] * k["wc"]
        assert k["stream"] == (d8 > fl.F32_RES_MAX) and k["kc"] == (fl.F32_DC[name] if k["stream"] else d8)
        assert k["parts"] == -(-d // fl.F32_RES_MAX) if k["stream"] else k["parts"] == 1
        assert d <= k["cols"] * k["parts"] < d + 8 * k["parts"]
        splits = p["splits"] if name == "dkdv" else 1
        assert k["grid"] == (-(-n // k["rows"]), bh, k["parts"] * splits)
        assert k["smem"] <= fl.SMEM_LIMIT
    gx, gy, gz = p["dkdv"]["grid"]
    assert 1 <= p["splits"] <= min(fl.MAX_SPLITS, -(-nq // p["dkdv"]["bk"]))
    if nq >= 1600:  # MViT-L's shapes: enough blocks for the card's SMs
        assert gx * gy * gz >= fl.SMS
    assert p["scratch_bytes"] == (2 * p["splits"] * bh * nk * d * 4 if p["splits"] > 1 else 0)
    assert p["bwd_pre"]["grid"][0] * 8 >= bh * nq


@pytest.mark.parametrize("dtype,d", [(torch.float32, 600), (torch.bfloat16, 800)])
def test_flash_f32_pair_on_the_cpu_is_the_plain_version(dtype, d):
    """On the CPU the float32 pair's wrappers run the plain versions and
    count no launch; flash_mha takes them for what the tensor-core kernels
    do not take and agrees with JAX's flash_mha (interpret mode) on the same
    values in float32, 1e-5 as tests/test_torch_flash.py holds it."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((1, 2, 40, d), (1, 2, 24, d), (1, 2, 24, d)))
    scale = d ** -0.5
    launches = (fl.flash_f32_fwd.launches, fl.flash_f32_bwd.launches,
                fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches)
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = fl.flash_mha(*ts, scale)
    o.float().sum().backward()
    assert o.dtype == dtype and all(t.grad.dtype == dtype for t in ts)
    o2, lse = fl.flash_f32_fwd(*(t.detach() for t in ts), scale)
    assert torch.equal(o2, o.detach())
    assert (fl.flash_f32_fwd.launches, fl.flash_f32_bwd.launches, fl.flash_mha_fwd.launches,
            fl.flash_mha_bwd.launches) == launches
    if dtype == torch.float32:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jflash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
        assert float(np.abs(o.detach().numpy() - want).max()) < 1e-5
