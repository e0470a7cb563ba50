"""K4's launch plan and its split backward, on the CPU.

The dK/dV kernel of advise_tpu_torch/csrc/flash_attention.cu runs one block
per (key tile, slice, split), each split walking a contiguous range of query
tiles and writing float32 partial dK and dV that a reduce kernel sums in
split order. ``plan`` (plain arithmetic, which the wrappers call) chooses
the splits; these tests read it at the ten attention shapes of MViT-L
32x312 (both views as one batch) and hold a plain emulation of the split
schedule, ``split_backward``, to the unsplit ``flash_bwd_plain``
(float32, 1e-5 of the largest entry: the same sums in another order) and to
the gradients of the JAX package's ``flash_mha`` (its Pallas kernel in TPU
interpret mode), within 1e-5 as tests/test_torch_flash.py holds the unsplit
backward.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu.ops.flash_attention import flash_mha as jflash_mha
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

SMS = 132
# (b * h, nq, nk, d) of MViT-L 32x312's attention, 2 views as one batch:
# the blocks that run each, and the splits and scratch bytes the plan gives
MVIT_L = {
    (4, 6400, 1600, 288): (34, 5, 73_728_000),
    (4, 24336, 1600, 144): (4, 5, 36_864_000),
    (4, 1600, 1600, 576): (3, 1, 0),
    (4, 97344, 1600, 72): (1, 5, 18_432_000),
    (4, 97344, 1600, 144): (1, 13, 95_846_400),
    (8, 24336, 6400, 72): (1, 6, 176_947_200),
    (4, 24336, 1600, 288): (1, 5, 73_728_000),
    (8, 6400, 6400, 144): (1, 2, 117_964_800),
    (4, 6400, 1600, 576): (1, 3, 88_473_600),
    (8, 1600, 6400, 288): (1, 1, 0),
}


def split_rows(nq: int, bq: int, splits: int):
    """The query rows [start, stop) each dK/dV split walks, as the kernel
    divides them (csrc/flash_attention.cu t_begin, t_end): contiguous runs of
    whole BQ-row tiles, split z taking tiles z * T // splits up to (z + 1) *
    T // splits of the T = ceil(nq / bq)."""
    ntq = math.ceil(nq / bq)
    return [(z * ntq // splits * bq, min(nq, (z + 1) * ntq // splits * bq)) for z in range(splits)]


def split_backward(q, k, v, o, lse, do, scale: float, splits: int):
    """fa.flash_bwd_plain on the dK/dV kernel's schedule: dk and dv summed
    in float32 over the query ranges of split_rows (the plan's tiles), one
    partial per range, in range order; dq as unsplit."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    delta = torch.sum(gf * o.float(), dim=-1, keepdim=True)
    bq = fa.TILES[fa.padded_dim(q.shape[-1])]["dkdv"][1]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dq = None
    for start, stop in split_rows(q.shape[-2], bq, splits):
        rows = slice(start, stop)
        s = torch.matmul(qf[..., rows, :], kf.transpose(-1, -2)) * scale
        p = torch.exp2(s * fa.LOG2E - lse[..., rows, None])
        ds = p * (torch.matmul(gf[..., rows, :], vf.transpose(-1, -2)) - delta[..., rows, :])
        dv = dv + torch.matmul(p.transpose(-1, -2), gf[..., rows, :])
        dk = dk + torch.matmul(ds.transpose(-1, -2), qf[..., rows, :])
        part = torch.matmul(ds, kf) * scale
        dq = part if dq is None else torch.cat([dq, part], dim=-2)
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def test_the_shapes_are_mvit_l_32x312s():
    """MVIT_L is the port's own block schedule of the masked preset."""
    from advise_tpu_torch.models.mvit import mvit_block_schedule, patch_grid, pooled_thw

    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/pretrain/MViT_L_32x312_joint.yaml")
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg = tconfig.assert_and_infer_cfg(cfg)
    thw = patch_grid(cfg)
    schedule, _ = mvit_block_schedule(cfg, thw)
    views = cfg.DATA.NUM_CLIP * cfg.DATA.BATCHSIZE_PER_GPU
    shapes = []
    for spec in schedule[: cfg.MASK.PRETRAIN_DEPTH[-1] + 1]:
        q_thw = pooled_thw(thw, spec["kernel_q"], spec["stride_q"])
        kv_thw = pooled_thw(thw, spec["kernel_kv"], spec["stride_kv"])
        shapes.append((views * spec["num_heads"], math.prod(q_thw), math.prod(kv_thw),
                       spec["dim_out"] // spec["num_heads"]))
        thw = q_thw
    assert {sh: shapes.count(sh) for sh in shapes} == {sh: v[0] for sh, v in MVIT_L.items()}


@pytest.mark.parametrize("shape", list(MVIT_L))
def test_split_count_and_scratch_at_mvit_l_shapes(shape):
    bh, nq, nk, d = shape
    _, splits, scratch = MVIT_L[shape]
    p = fa.plan(bh, nq, nk, d)
    assert (p["splits"], p["scratch_bytes"]) == (splits, scratch)
    assert p["scratch_bytes"] == (2 * splits * bh * nk * d * 4 if splits > 1 else 0)
    # the dK/dV grid with its splits fills the card's SMs at least once
    gx, gy, gz = p["dkdv"]["grid"]
    assert (gx, gy, gz) == (math.ceil(nk / p["dkdv"]["rows"]), bh, splits)
    assert gx * gy * gz >= SMS
    # every split has query tiles to walk, and every kernel fits shared memory
    assert 1 <= splits <= math.ceil(nq / p["dkdv"]["bq"])
    assert max(p[k]["smem"] for k in ("fwd", "dq", "dkdv")) <= fa.SMEM_LIMIT
    assert p["dp"] >= d and p["dp"] % 16 == 0


def _reg_cap(warps: int) -> int:
    """Registers a thread may hold in a block of ``warps`` warps, one block
    an SM: 65,536 over its threads in steps of 8, at most 255."""
    return min(255, 65536 // (32 * warps) // 8 * 8)


@pytest.mark.parametrize("dp", sorted(fa.TILES))
def test_tiles_fit_and_split_the_warps(dp):
    """Each template width's tiles: whole k-steps of 16; the forward's and
    dQ's warpgroups (two of 64 rows each, all of d, at DSPLIT 1; else
    DSPLIT of them sharing 64 rows, each a whole number of 32-column atoms
    of d, at most 256 columns, one wgmma, where S's contraction is shared
    too) with their float32 O accumulators and 32 more registers within a
    thread's share; 8 dK/dV warps, each with whole n-tiles of its S^T and
    dP^T query columns or, under 8 a warp (16 keys a block), one n-tile over
    an equal share of d, and the dQ GEMM on dS exactly there; shared memory
    within the 227 KB a block may use."""
    t = fa.TILES[dp]
    assert t["fwd"][1] == t["dq"][1]
    dsplit = t["fwd"][1]
    rows, warps = fa.block_rows(dsplit), fa.block_warps(dsplit)
    if dsplit == 1:
        assert (rows, warps) == (128, 8)
        cols = dp  # a warpgroup's O columns
    else:
        assert (rows, warps) == (64, 4 * max(2, dsplit)) and (dp // dsplit) % 32 == 0
        cols = dp // dsplit
        assert dsplit <= 2 or cols <= 256
    assert cols // 2 + 32 <= _reg_cap(warps)  # 64 x cols float32 over a warpgroup's 128 threads
    for name, smem in (("fwd", fa.fwd_smem), ("dq", fa.dq_smem)):
        bk = t[name][0]
        assert bk % 16 == 0 and (dsplit <= 2 or name == "fwd" or bk % 32 == 0)  # whole dS atoms
        assert smem(dp, bk, dsplit) <= fa.SMEM_LIMIT
    bkv, bq, wc = t["dkdv"]
    assert (bkv // 16) * wc == fa.MAX_WARPS and bq % 16 == 0 and (dp // wc) % 8 == 0
    assert dp // wc <= 192  # dK and dV: 2 x 16 keys x dp / wc float32 over a warp
    qw = bq // wc
    if qw >= 8:
        assert qw % 8 == 0
    else:
        tiles = 2 * (bq // 8)  # S^T and dP^T n-tiles of the block's 16 keys
        assert bkv == 16 and fa.MAX_WARPS % tiles == 0 and dp % (16 * (fa.MAX_WARPS // tiles)) == 0
    assert (dsplit > 2) == (qw < 8)  # dS is written where dQ is its GEMM
    assert fa.dkdv_smem(dp, bkv, bq, wc) <= fa.SMEM_LIMIT


# path (c)'s head-dim-768 attentions (chip_smoke.py path_c_shapes: ContrastiveModel
# over the reversible MViT-S, one view's 16 clips a call) and their plans
PATH_C_768 = {
    (16, 1568, 392, 768): {"fwd": (396, 25, 496), "splits": 1, "ds_bytes": 2 * 16 * 1568 * 400},
    (16, 392, 392, 768): {"fwd": (112, 1, 112), "splits": 1, "ds_bytes": 2 * 16 * 392 * 400},
}


@pytest.mark.parametrize("shape", list(PATH_C_768))
def test_plan_at_path_c_width_768_shapes(shape):
    """Width 768: the forward's 64-row tiles whole on a 1-D grid up to the
    last full wave of 132 blocks, the rest each split over key ranges (one
    a 16-key tile at most) with float32 partials; dQ the GEMM on a bf16 dS
    of the queries x the dK/dV kernel's 16-key tiles; the dK/dV grid and
    splits; every kernel within a block's shared memory."""
    bh, nq, nk, d = shape
    want = PATH_C_768[shape]
    p = fa.plan(bh, nq, nk, d)
    f = p["fwd"]
    assert p["dp"] == 768 and (f["rows"], f["bk"], f["dsplit"], f["warps"]) == (64, 16, 3, 12)
    tiles = bh * math.ceil(nq / 64)
    whole, ksplit, blocks = want["fwd"]
    assert (f["whole"], f["ksplit"], f["grid"]) == (whole, ksplit, (blocks, 1, 1))
    assert whole + (tiles - whole) * ksplit == blocks and (tiles <= SMS or whole % SMS == 0)
    assert ksplit <= math.ceil(nk / 16)
    assert f["part_bytes"] == 4 * (tiles - whole) * ksplit * (64 * 768 + 128)
    assert p["dq"]["grid"] == (math.ceil(nq / 64), bh, 1) and p["dq"]["warps"] == 12
    assert p["ds_bytes"] == want["ds_bytes"] == 2 * bh * nq * math.ceil(nk / 16) * 16
    assert p["dkdv"]["grid"] == (math.ceil(nk / 16), bh, want["splits"]) and p["splits"] == want["splits"]
    assert p["scratch_bytes"] == (2 * p["splits"] * bh * nk * d * 4 if p["splits"] > 1 else 0)
    assert max(p[k]["smem"] for k in ("fwd", "dq", "dkdv")) <= fa.SMEM_LIMIT


def split_forward(q, k, v, scale: float, whole: int, ksplit: int):
    """fa.flash_fwd_plain on width 768's schedule: the 64-row query tiles
    (slice-major) from ``whole`` on, each over ``ksplit`` contiguous ranges
    of 16-key tiles, one float32 partial a range (O unnormalized, the row
    max of the scaled scores and the row sum of 2^(s - max)), combined in
    range order as the combine kernel does; the tiles before ``whole`` as
    the unsplit forward."""
    o, lse = fa.flash_fwd_plain(q, k, v, scale)
    o, lse = o.float().clone(), lse.clone()
    bh, nq, nk = q.shape[0] * q.shape[1], q.shape[2], k.shape[2]
    qf, kf, vf = (t.float().reshape(bh, -1, t.shape[-1]) for t in (q, k, v))
    of, lf = o.reshape(bh, nq, -1), lse.reshape(bh, nq)
    tq, nkt = math.ceil(nq / 64), math.ceil(nk / 16)
    for t in range(whole, bh * tq):
        s, rows = t // tq, slice((t % tq) * 64, min(nq, (t % tq) * 64 + 64))
        parts = []
        for z in range(ksplit):
            keys = slice(z * nkt // ksplit * 16, min(nk, (z + 1) * nkt // ksplit * 16))
            x = torch.matmul(qf[s, rows], kf[s, keys].T) * scale * fa.LOG2E
            m = x.max(dim=-1).values
            p = torch.exp2(x - m[:, None])
            parts.append((torch.matmul(p, vf[s, keys]), m, p.sum(dim=-1)))
        m = torch.stack([pm for _, pm, _ in parts]).max(dim=0).values
        w = [torch.exp2(pm - m) for _, pm, _ in parts]
        total = sum(wz * pl for wz, (_, _, pl) in zip(w, parts))
        of[s, rows] = sum(wz[:, None] * po for wz, (po, _, _) in zip(w, parts)) / total[:, None]
        lf[s, rows] = m + torch.log2(total)
    return o.to(q.dtype), lse


@pytest.mark.parametrize("bh,nq,nk,seed", [(140, 64, 100, 0), (136, 40, 200, 1), (4, 1568, 392, 2)])
def test_split_forward_equals_the_whole_one(bh, nq, nk, seed):
    """The forward's split tiles, combined from their key ranges' float32
    partials, give the unsplit forward's O and lse within float32 rounding
    (1e-5 of the largest entry; lse 1e-5): the same sums in another order.
    The plan's split where it has one (more than 132 tiles), else 4 ranges
    of the last tile."""
    d = 48  # the split's arithmetic does not depend on d; width 768's plan does
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(bh, nq, nk, d, seed))
    f = fa.plan(bh, nq, nk, 768)["fwd"]
    whole, ksplit = (f["whole"], f["ksplit"]) if f["ksplit"] > 1 else (bh * math.ceil(nq / 64) - 1, 4)
    assert ksplit > 1 and whole < bh * math.ceil(nq / 64)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, d ** -0.5)
    o, lse = split_forward(q, k, v, d ** -0.5, whole, ksplit)
    assert float((o - want_o).abs().max()) <= 1e-5 * float(want_o.abs().max())
    assert float((lse - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize("d,dp", [(1, 64), (36, 64), (64, 64), (72, 80), (96, 144), (144, 144),
                                  (192, 192), (200, 288), (288, 288), (576, 576), (600, 768),
                                  (768, 768)])
def test_padded_dim(d, dp):
    assert fa.padded_dim(d) == dp


def test_padded_dim_raises_above_the_widest_kernel():
    with pytest.raises(ValueError):
        fa.padded_dim(769)


@pytest.mark.parametrize("nq,bq,splits", [(1, 64, 1), (100, 64, 2), (1001, 64, 16), (6400, 32, 5),
                                          (97344, 64, 13), (65, 32, 3)])
def test_split_rows_cover_the_queries_in_whole_tiles(nq, bq, splits):
    ranges = split_rows(nq, bq, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == nq
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c and a % bq == 0 and a < b
    assert ranges[-1][0] < nq


def _inputs(bh, nq, nk, d, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((2, bh // 2, nq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, bh // 2, nk, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("bh,nq,nk,d,splits", [
    (4, 300, 100, 72, 5), (2, 1001, 77, 72, 16), (4, 200, 130, 144, 4), (2, 150, 110, 288, 5),
    (2, 100, 90, 576, 3), (2, 700, 50, 576, 12), (4, 130, 98, 48, 3)])
def test_split_backward_equals_the_unsplit_one(bh, nq, nk, d, splits):
    """The split schedule sums the same float32 partial products in query
    tile order: within float32 rounding of the unsplit backward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(bh, nq, nk, d))
    scale = d ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, scale)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, scale)
    got = split_backward(q, k, v, o, lse, do, scale, splits)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max()), name


class _SplitFlash(torch.autograd.Function):
    """flash_mha's plain forward with the split schedule's backward at the
    plan's split count."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = fa.flash_fwd_plain(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, h, nq, d = q.shape
        splits = fa.plan(b * h, nq, k.shape[2], d)["splits"]
        return (*split_backward(q, k, v, o, lse, do, ctx.scale, splits), None)


@pytest.mark.parametrize("nq,nk,d", [(392, 98, 48), (256, 128, 192), (400, 40, 288), (300, 36, 576),
                                    (300, 36, 768)])
def test_split_backward_matches_jax_flash(nq, nk, d):
    import jax

    q, k, v, _ = _inputs(4, nq, nk, d)
    scale = 1.0 / np.sqrt(d)
    assert fa.plan(4, nq, nk, d)["splits"] > 1

    def loss(q, k, v):
        o = jflash_mha(q, k, v, scale)
        return jnp.sum(o * jnp.cos(o))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(loss, (0, 1, 2)))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = _SplitFlash.apply(*ts, scale)
    torch.sum(o * torch.cos(o)).backward()
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        assert float(np.abs(t.grad.numpy() - np.asarray(w)).max()) < 1e-5, name
