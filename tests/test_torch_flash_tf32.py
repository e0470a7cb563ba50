"""K4's float32 pair in 3xTF32, emulated on the CPU.

The kernels of advise_tpu_torch/csrc/flash_attention_f32.cu take every
product on the tensor cores as mma.sync m16n8k8 TF32: each float32 operand x
is split into big = tf32(x) and small = tf32(x - big) (round to nearest,
ties away, to a 10-bit mantissa), and a b accumulates in float32 as a_small
b_big + a_big b_small + a_big b_big. P and dS feed the next product from
their accumulator registers (ops/flash_attention.py F32_ACC_TO_A) against B
rows read in the matching order (F32_B_ROWS).

``emulate_forward`` and ``emulate_backward`` repeat that arithmetic in numpy
on the kernels' schedule (f32_plan's tiles and dK/dV splits, the online
softmax in base 2, k-steps of 8 in order, each MMA an exact sum rounded once
to float32, each tile's output product summed from zero and then added to
the running total), with the fragment mapping applied lane by lane. They are held
to the JAX package's flash_mha and its gradients (the Pallas kernel in TPU
interpret mode) on the same numpy inputs at 1e-5 of the largest entry, at
head dims 72, 144, 288 and 600 (the three resident tiers and the streamed
one) with ragged nq and nk. The same emulation with one TF32 product (1xTF32)
exceeds that bound, and a wrong fragment mapping fails it: the test tells
the arithmetic apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from advise_tpu.ops.flash_attention import flash_mha as jflash_mha
from advise_tpu_torch.ops import flash_attention as fa

F32 = np.float32
TOL = 1e-5  # of the largest entry


def tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (cvt.rna.tf32.f32): the float32 bit pattern with
    its low 13 bits rounded away, to nearest, ties away from zero."""
    bits = np.asarray(x, dtype=F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x: np.ndarray):
    big = tf32(x)
    return big, tf32((x - big).astype(F32))


def mma_steps(c, a, b, terms=3):
    """c + a @ b over k-steps of 8 in order, each m16n8k8 MMA an exact sum
    rounded once to float32: 3xTF32 (small x big, big x small, big x big)
    or 1xTF32 (big x big)."""
    c = np.array(c, dtype=F32)
    for k0 in range(0, a.shape[1], 8):
        ak, bk = a[:, k0:k0 + 8], b[k0:k0 + 8]
        ab, as_ = split(ak)
        bb, bs = split(bk)
        pairs = [(as_, bb), (ab, bs), (ab, bb)] if terms == 3 else [(ab, bb)]
        for x, y in pairs:
            c = (c.astype(np.float64) + x.astype(np.float64) @ y.astype(np.float64)).astype(F32)
    return c


def _fragment_maps(acc_to_a, b_rows):
    """Where each entry of a 16 x 8 A operand and an 8-row B operand comes
    from, lane by lane (g = lane // 4, t = lane % 4): A register i holds (g
    + 8 (i % 2), t + 4 (i // 2)) and is accumulator register r = acc_to_a[i],
    which holds (g + 8 (r // 2), 2 t + r % 2); B register j holds row t + 4 j
    and reads row b_rows[j][t] of the slab."""
    src_r, src_c = np.zeros((16, 8), int), np.zeros((16, 8), int)
    krow = np.zeros(8, int)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, r in enumerate(acc_to_a):
            src_r[g + 8 * (i % 2), t + 4 * (i // 2)] = g + 8 * (r // 2)
            src_c[g + 8 * (i % 2), t + 4 * (i // 2)] = 2 * t + r % 2
        for j in range(2):
            krow[t + 4 * j] = b_rows[j][t]
    return src_r, src_c, krow


def mma_from_acc(c, acc, y, maps, terms=3):
    """c + (accumulator tile acc [R, K] as A) @ (rows of y [K, N] as B), the
    A operand taken from acc's registers and B's rows read as the kernels
    do, 8 columns of acc (rows of y) a k-step."""
    src_r, src_c, krow = maps
    rows = acc.shape[0]
    pad = -rows % 16
    acc = np.pad(acc, ((0, pad), (0, 0)))
    for k0 in range(0, acc.shape[1], 8):
        tile = acc[:, k0:k0 + 8].reshape(-1, 16, 8)
        a = tile[:, src_r, src_c].reshape(-1, 8)[:rows]
        c = mma_steps(c, a, y[k0 + krow], terms)
    return c


def _pad_rows(x, n):
    return np.pad(x, ((0, n - x.shape[0]), (0, 0)))


def _pad_cols(x, n):
    return np.pad(x, ((0, 0), (0, n - x.shape[1])))


def emulate_forward(q, k, v, scale, bk, maps, terms=3):
    """One slice (q [nq, d], k and v [nk, d]) through the forward kernel's
    arithmetic: key tiles of bk, S = Q K^T, the online softmax in base 2
    (keys past nk -inf before the row max), O += P V from P's registers.
    Returns (o, lse in base 2)."""
    nq, d = q.shape
    nk = k.shape[0]
    d8 = -(-d // 8) * 8
    q, k, v = (_pad_cols(x, d8) for x in (q, k, v))
    sl = F32(scale * fa.LOG2E)
    m = np.full(nq, np.finfo(F32).min, F32)
    l = np.zeros(nq, F32)
    o = np.zeros((nq, d8), F32)
    for j0 in range(0, nk, bk):
        kt, vt = _pad_rows(k[j0:j0 + bk], bk), _pad_rows(v[j0:j0 + bk], bk)
        s = mma_steps(np.zeros((nq, bk), F32), q, kt.T, terms)
        s[:, np.arange(j0, j0 + bk) >= nk] = -np.inf
        mx = np.maximum(m, s.max(axis=1))
        alpha = np.exp2((m - mx) * sl).astype(F32)
        p = np.exp2((s * sl - mx[:, None] * sl).astype(F32)).astype(F32)
        l = (l * alpha + p.sum(axis=1, dtype=F32)).astype(F32)
        pv = mma_from_acc(np.zeros_like(o), p, vt, maps, terms)
        o = (o * alpha[:, None] + pv).astype(F32)
        m = mx
    lse = (m * sl + np.log2(l)).astype(F32)
    return (o / l[:, None]).astype(F32)[:, :d], lse


def emulate_backward(q, k, v, o, lse, do, scale, plan, maps, terms=3):
    """One slice through the backward kernels' arithmetic: D = rowsum(dO o
    O); dK/dV over the plan's query tiles, each split's range in tile order
    (S^T = K Q^T, dP^T = V dO^T, P^T and dS^T from the registers into dV +=
    P^T dO and dK += dS^T Q), the splits' partials summed in split order;
    dQ over key tiles (S, dP, dS, dQ += dS K)."""
    nq, d = q.shape
    nk = k.shape[0]
    d8 = -(-d // 8) * 8
    q, k, v, do, o = (_pad_cols(x, d8) for x in (q, k, v, do, o))
    sl = F32(scale * fa.LOG2E)
    delta = np.sum(do * o, axis=1, dtype=F32)
    bq, splits = plan["dkdv"]["bk"], plan["splits"]
    ntq = -(-nq // bq)
    dk = np.zeros((nk, d8), F32)
    dv = np.zeros((nk, d8), F32)
    for z in range(splits):
        pk = np.zeros((nk, d8), F32)
        pv = np.zeros((nk, d8), F32)
        for t in range(z * ntq // splits, (z + 1) * ntq // splits):
            rows = slice(t * bq, (t + 1) * bq)
            qt, gt = _pad_rows(q[rows], bq), _pad_rows(do[rows], bq)
            lt = np.pad(lse[rows], (0, bq - len(lse[rows])))
            dt = np.pad(delta[rows], (0, bq - len(delta[rows])))
            st = mma_steps(np.zeros((nk, bq), F32), k, qt.T, terms)
            dpt = mma_steps(np.zeros((nk, bq), F32), v, gt.T, terms)
            p = np.exp2((st * sl - lt[None, :]).astype(F32)).astype(F32)
            p[:, np.arange(t * bq, (t + 1) * bq) >= nq] = 0.0
            ds = (p * (dpt - dt[None, :])).astype(F32)
            pv = (pv + mma_from_acc(np.zeros_like(pv), p, gt, maps, terms)).astype(F32)
            pk = (pk + mma_from_acc(np.zeros_like(pk), ds, qt, maps, terms)).astype(F32)
        dk, dv = (dk + pk).astype(F32), (dv + pv).astype(F32)
    bk = plan["dq"]["bk"]
    dq = np.zeros((nq, d8), F32)
    for j0 in range(0, nk, bk):
        kt, vt = _pad_rows(k[j0:j0 + bk], bk), _pad_rows(v[j0:j0 + bk], bk)
        s = mma_steps(np.zeros((nq, bk), F32), q, kt.T, terms)
        dp = mma_steps(np.zeros((nq, bk), F32), do, vt.T, terms)
        p = np.exp2((s * sl - lse[:, None]).astype(F32)).astype(F32)
        p[:, np.arange(j0, j0 + bk) >= nk] = 0.0
        ds = (p * (dp - delta[:, None])).astype(F32)
        dq = (dq + mma_from_acc(np.zeros_like(dq), ds, kt, maps, terms)).astype(F32)
    return ((dq * F32(scale))[:, :d].astype(F32), (dk * F32(scale))[:, :d].astype(F32),
            dv[:, :d])


@np.errstate(over="ignore")
def emulate(q, k, v, do, scale, maps, terms=3):
    """[b, h, n, d] inputs through both emulations, slice by slice, on the
    plan the wrappers launch: (o, dq, dk, dv)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    plan = fa.f32_plan(b * h, nq, nk, d)
    outs = [np.zeros_like(q), np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)]
    for i in range(b):
        for j in range(h):
            o, lse = emulate_forward(q[i, j], k[i, j], v[i, j], scale, plan["fwd"]["bk"], maps, terms)
            grads = emulate_backward(q[i, j], k[i, j], v[i, j], o, lse, do[i, j], scale, plan, maps, terms)
            for out, x in zip(outs, (o, *grads)):
                out[i, j] = x
    return outs


KERNEL_MAPS = _fragment_maps(fa.F32_ACC_TO_A, fa.F32_B_ROWS)
SHAPES = [(130, 70, 72), (100, 90, 144), (97, 65, 288), (70, 45, 600)]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's flash_mha (Pallas, TPU interpret mode) and its gradients under
    the cotangent do, per shape: (inputs, (o, dq, dk, dv))."""
    cache = {}

    def get(nq, nk, d):
        if (nq, nk, d) not in cache:
            rng = np.random.default_rng(d)
            q, do = (rng.standard_normal((1, 2, nq, d)).astype(F32) for _ in range(2))
            k, v = (rng.standard_normal((1, 2, nk, d)).astype(F32) for _ in range(2))
            scale = float(d ** -0.5)

            def run(q, k, v, do):
                o, vjp = jax.vjp(lambda *x: jflash_mha(*x, scale), q, k, v)
                return (o, *vjp(do))

            with pltpu.force_tpu_interpret_mode():
                want = jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, do)))
            cache[(nq, nk, d)] = ((q, k, v, do, scale), [np.asarray(w) for w in want])
        return cache[(nq, nk, d)]

    return get


def _errors(got, want):
    return {name: float(np.abs(g - w).max()) / float(np.abs(w).max())
            for name, g, w in zip(("o", "dq", "dk", "dv"), got, want)}


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna.tf32: 10 mantissa bits kept, the 13 cut bits
    rounded to nearest with ties away from zero, sign by sign."""
    one = np.uint32(0x3F800000)
    cases = {0x0FFF: 0x0000, 0x1000: 0x2000, 0x1001: 0x2000, 0x2FFF: 0x2000, 0x3000: 0x4000}
    for low, up in cases.items():
        for sign in (0, 0x80000000):
            x = np.array([one | low | sign], np.uint32).view(F32)
            assert tf32(x).view(np.uint32)[0] == (one | up | sign)
    x = np.random.default_rng(0).standard_normal(1000).astype(F32)
    big, small = split(x)
    assert np.all(big.view(np.uint32) & 0x1FFF == 0) and np.all(small.view(np.uint32) & 0x1FFF == 0)
    # big + small keeps 22 of the 24 bits: within 2^-21 of x
    assert np.all(np.abs(big.astype(np.float64) + small - x) <= 2.0 ** -21 * np.abs(x))


@pytest.mark.parametrize("nq,nk,d", SHAPES)
def test_3xtf32_flash_matches_jax(jax_reference, nq, nk, d):
    """The kernels' 3xTF32 arithmetic agrees with JAX's float32 flash
    attention, forward and gradients, within 1e-5 of the largest entry."""
    (q, k, v, do, scale), want = jax_reference(nq, nk, d)
    got = emulate(q, k, v, do, scale, KERNEL_MAPS)
    errs = _errors(got, want)
    assert all(e <= TOL for e in errs.values()), errs


@pytest.mark.parametrize("nq,nk,d", SHAPES)
def test_1xtf32_exceeds_the_bound(jax_reference, nq, nk, d):
    """One TF32 product (inputs rounded to 10 mantissa bits) misses the same
    bound: the float32 contract needs the split."""
    (q, k, v, do, scale), want = jax_reference(nq, nk, d)
    errs = _errors(emulate(q, k, v, do, scale, KERNEL_MAPS, terms=1), want)
    assert all(e > 10 * TOL for e in errs.values()), errs


@pytest.mark.parametrize("acc_to_a,b_rows", [
    ((0, 1, 2, 3), fa.F32_B_ROWS),         # accumulator registers in order: mixes rows g, g + 8
    (fa.F32_ACC_TO_A, ((0, 1, 2, 3), (4, 5, 6, 7))),  # B rows unpermuted: keys out of step with P
])
def test_wrong_fragment_mapping_fails(jax_reference, acc_to_a, b_rows):
    """A mapping of P's registers to the A operand that does not match the
    B rows' order gives a wrong output and wrong gradients."""
    (q, k, v, do, scale), want = jax_reference(*SHAPES[0])
    errs = _errors(emulate(q, k, v, do, scale, _fragment_maps(acc_to_a, b_rows)), want)
    assert all(e > 1e-2 for e in errs.values()), errs
