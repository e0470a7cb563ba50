"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the stem kernels (advise_tpu_torch/csrc/stem_conv.cu) on their three
launch schedules (one launch, per batch chunk, wgrad-only), the fused
simple aug (advise_tpu_torch/csrc/fused_aug.cu), flash attention, forward
and backward (advise_tpu_torch/csrc/flash_attention.cu) with its float32
pair in 3xTF32 (advise_tpu_torch/csrc/flash_attention_f32.cu), and the window
gather of the nine Mosaic probes (advise_tpu_torch/csrc/window_probe.cu),
SyncBatchNorm's train mode (advise_tpu_torch/csrc/batch_norm.cu); and the
AdViSe and X3D-M models' bf16 forwards on the card against the CPU.
Every test here needs an NVIDIA card and nvcc, and skips without a card.

This file imports no JAX, so a machine without it runs the file without the
repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: the stem forward accumulates in float32 and rounds once to
bf16, so it is held to one bf16 ulp of the largest output of the float32
plain conv on the same bf16 inputs (TF32 off); the weight gradient is a
float32 sum in another order, held to 1e-3 of its largest entry. The fused
aug states every rounding of its chain (the note in fused_aug.cu), so it is
held EQUAL to its plain version, in float32 and in bf16. Flash attention's
tensor-core kernels take bf16 q, k, v and are held against the float32 dense
chain on the same bf16 values: the forward rounds the probabilities to bf16 for P V and the
output once, so it is held to 2^-7 of the largest output; the backward
rounds P, dS and its outputs to bf16, and D comes from the bf16 output, so
dq, dk and dv are held to 2^-6 of their largest entries (chip_smoke.py
phase 3 measured 2.0e-3 to 3.2e-3 of the largest output and 2.8e-3 to
6.1e-3 of the largest gradient at MViT-L's shapes on the H100). The window
gather moves and
casts values (P1 adds two float32 values), so it is held EQUAL. The batch
norm kernels' tolerances are stated in their tests: float32 sums in a fixed
order against float64 (1e-5), one rounding of y from the fold's rounded w
and b (one ulp), and a closed-form backward against float64 autograd of the
chain it replaced, through bf16 (2^-7 of the largest entry).
"""

import math

import pytest
import torch

from advise_tpu_torch.ops import flash_attention as fl
from advise_tpu_torch.ops import fused_aug as fa
from advise_tpu_torch.ops import stem_conv as sc
from advise_tpu_torch.ops import window_probe as wp

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, kt, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, device=device, generator=g).bfloat16()
    w = (torch.randn((kt, 7, 7, 3, 8), device=device, generator=g) * 0.1).bfloat16()
    return x, w, g


def _bf16_ulp(top: float) -> float:
    return 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kt", [
    ((2, 7, 37, 45, 3), 5),   # ragged: partial tiles in both directions, odd W
    ((2, 8, 64, 64, 3), 5),
    ((1, 4, 33, 70, 3), 1),   # B = 1, odd height, the slow stem's kt
    ((1, 6, 50, 36, 3), 3),   # B = 1, kt 3
    ((2, 5, 30, 42, 3), 7),   # kt 7: K1 tiles of 28 rows, K2 in two tap groups
    ((2, 2, 40, 34, 3), 5),   # T < kt
    ((1, 3, 24, 24, 3), 7),   # T < kt at kt 7
    ((2, 40, 64, 70, 3), 5),  # 240 items on 132 blocks: the ring's steady state
])
def test_kernels_match_plain(cuda, shape, kt):
    x, w, g = _inputs(shape, kt, cuda)
    launches = (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches)
    y = sc.stem_conv_fwd(x, w)
    ref = sc.stem_conv_plain(x.float(), w.float())
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    top = float(ref.abs().max())
    assert float((y.float() - ref).abs().max()) <= _bf16_ulp(top)

    gy = torch.randn(y.shape, device=cuda, generator=g).bfloat16()
    dw = sc.stem_conv_wgrad(x, gy, kt)
    dref = sc.stem_wgrad_plain(x, gy, kt)
    assert dw.dtype == torch.float32
    assert float((dw - dref).abs().max()) <= 1e-3 * float(dref.abs().max())
    assert torch.equal(dw, sc.stem_conv_wgrad(x, gy, kt))  # no atomics: deterministic
    torch.cuda.synchronize()
    assert (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches) == (
        launches[0] + 1, launches[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("th,kt", [(56, 5), (28, 7), (56, 1), (14, 3)])
def test_stem_plan_matches_compiled(cuda, th, kt):
    """plan()'s shared memory per block is the source's own arithmetic."""
    lib = sc._library()
    assert lib.stem_fwd_smem(th, kt) == sc.fwd_smem(th, kt)
    assert lib.stem_wgrad_smem(th, kt) == sc.wgrad_smem(th, kt)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [2, 4, 16])
def test_chunked_schedules_match_plain(cuda, chunk):
    """K1' and K2': K1 and K2 once per chunk of the largest divisor of B <=
    chunk, the forward bit-equal to one K1 launch (each output is computed
    alone), dW held as K2's; and the autograd Functions of the chunked and
    wgrad-only schedules against the plain conv's autograd, as the one-launch schedule's."""
    x, w, g = _inputs((6, 5, 40, 48, 3), 5, cuda)
    cb = sc.largest_divisor(6, chunk)
    launches = (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches)
    y = sc.stem_conv_fwd_chunked(x, w, cb)
    assert torch.equal(y, sc.stem_conv_fwd(x, w))
    gy = torch.randn(y.shape, device=cuda, generator=g).bfloat16()
    dw = sc.stem_conv_wgrad_chunked(x, gy, 5, cb)
    dref = sc.stem_wgrad_plain(x, gy, 5)
    assert float((dw - dref).abs().max()) <= 1e-3 * float(dref.abs().max())
    torch.cuda.synchronize()
    assert (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches) == (
        launches[0] + 6 // cb + 1, launches[1] + 6 // cb)

    xr = x.float().requires_grad_()
    wr = w.float().requires_grad_()
    gf = gy.float()
    torch.sum(sc.stem_conv_plain(xr, wr) * gf).backward()
    for fn in (lambda a, b: sc.stem_conv_chunked(a, b, torch.bfloat16, chunk),
               lambda a, b: sc.stem_conv_wgrad_only(a, b, torch.bfloat16)):
        xk = xr.detach().clone().requires_grad_()
        wk = wr.detach().clone().requires_grad_()
        torch.sum(fn(xk, wk).float() * gf).backward()
        for got, want in ((wk.grad, wr.grad), (xk.grad, xr.grad)):
            assert float((got - want).abs().max()) <= 2 ** -7 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("o", [0, 6, 8, 13])
@pytest.mark.parametrize("name", list(wp.WINDOWS))
def test_window_probe_equals_plain(cuda, name, o):
    """Each Mosaic probe's window through the CUDA gather, equal to its plain
    version; a window out of range raises before any launch."""
    win = wp.WINDOWS[name]
    g = torch.Generator(device=cuda).manual_seed(o)
    if win.dtype == torch.uint8:
        x = torch.randint(0, 256, win.shape, device=cuda, generator=g, dtype=torch.uint8)
    else:
        x = torch.randn(win.shape, device=cuda, generator=g)
    entry = wp.ENTRIES[name]
    before = entry.launches
    if name == "lead_dyn" and o > 6:
        with pytest.raises(IndexError):
            entry(o, x)
        assert entry.launches == before
        return
    got = entry(o, x)
    assert torch.equal(got, wp.window_plain(win, x, (o, o)))
    assert entry.launches == before + 1


@pytest.mark.cuda
def test_autograd_function_on_card(cuda):
    """StemConvChunked at one launch on the card: the kernel forward and weight gradient, the
    input gradient through the plain conv's when asked, against autograd of
    the float32 plain conv on the same bf16-rounded inputs. The gradients
    pass through bf16 (the cotangent and dW are rounded as in the JAX custom
    VJP), so they are held to 2^-7 of their largest entry."""
    x, w, g = _inputs((2, 6, 40, 48, 3), 5, cuda)
    xr = x.float().requires_grad_()
    wr = w.float().requires_grad_()
    xk = xr.detach().clone().requires_grad_()
    wk = wr.detach().clone().requires_grad_()
    gy = torch.randn((2, 6, 20, 24, 8), device=cuda, generator=g)
    torch.sum(sc.stem_conv_plain(xr, wr) * gy).backward()
    torch.sum(sc.stem_conv_chunked(xk, wk, torch.bfloat16, 0).float() * gy).backward()
    for got, want in ((wk.grad, wr.grad), (xk.grad, xr.grad)):
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 2 ** -7 * float(want.abs().max())


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, w, _ = _inputs((1, 3, 16, 16, 3), 5, cuda)
    with pytest.raises(TypeError):
        sc.stem_conv_fwd(x.float(), w.float())
    with pytest.raises(ValueError):
        sc.stem_conv_fwd(x.transpose(2, 3), w)
    with pytest.raises(ValueError):
        sc.stem_conv_fwd(x, w[..., :4].contiguous())


MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


# (clip shape, crop, tops, lefts); fa.plan() gives each its cluster, bands
# and store width (vector)
FUSED_AUG_SHAPES = [
    ((2, 3, 40, 48, 3), 32, None, None),                # 2 bands of 16, float4 stores
    ((3, 2, 37, 43, 3), 29, (3, 5, 7), None),           # W*3 = 129, odd crop (scalar stores),
                                                        # tops not 8-aligned, bands 15 + 14
    ((4, 8, 256, 320, 3), 224, None, None),             # SpeedPro's ingest and crop: 8 bands of 28
    ((1, 1, 40, 52, 3), 38, (1,), (5,)),                # N*T = 1, S % 4 == 2 (float2 stores),
                                                        # bands 13 + 13 + 12
    ((2, 3, 50, 61, 3), 45, (0, 5), (0, 16)),           # left at 0 and at W - S, top at H - S: the
                                                        # window ends on the tensor's last byte
    ((2, 2, 36, 45, 3), 32, (1, 4), (13, 2)),           # W*3 = 135: every row at its own shift
    ((2, 2, 5, 7, 3), 1, (4, 0), (6, 3)),               # one pixel, one band
    ((1, 2, 256, 260, 3), 256, (0,), (4,)),             # the largest exact crop: 8 bands of 32
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size,tops,lefts", FUSED_AUG_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fused_aug_matches_plain(cuda, shape, size, tops, lefts, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    clips = torch.randint(0, 256, shape, generator=g, device=cuda, dtype=torch.uint8)
    clips[:, 0, :, : shape[3] // 3] = clips[:, 0, :, : shape[3] // 3, :1]  # gray
    prm = fa.sample_simple_aug(shape[0], shape[2], shape[3], size, (1.0, 0.4, 0.4, 0.4, 0.2), g)
    for key, offsets in (("tops", tops), ("lefts", lefts)):
        if offsets is not None:
            prm[key] = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    launches = fa.fused_simple_aug.launches
    got = fa.fused_simple_aug(clips, prm, size, MEAN, STD, out_dtype)
    want = fa.fused_simple_aug_plain(clips, prm, size, MEAN, STD, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert fa.fused_simple_aug.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fused_aug_order_rows_that_are_not_permutations_match_plain(cuda, out_dtype):
    """The kernel compiles in the 6 orders of brightness, contrast and
    saturation; other rows of ``order`` (repeats, no hue, codes past 3) run
    their 4 codes as they come, as the plain version does."""
    g = torch.Generator(device=cuda).manual_seed(3)
    clips = torch.randint(0, 256, (6, 2, 40, 44, 3), generator=g, device=cuda, dtype=torch.uint8)
    prm = fa.sample_simple_aug(6, 40, 44, 32, (1.0, 0.4, 0.4, 0.4, 0.2), g)
    prm["order"] = torch.tensor([[0, 0, 2, 1], [3, 3, 3, 3], [2, 1, 0, 5], [1, 2, 2, 2],
                                 [2, 0, 1, 3], [3, 1, 0, 2]], dtype=torch.int32, device=cuda)
    got = fa.fused_simple_aug(clips, prm, 32, MEAN, STD, out_dtype)
    want = fa.fused_simple_aug_plain(clips, prm, 32, MEAN, STD, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_aug_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    clips = torch.zeros((2, 2, 20, 24, 3), dtype=torch.uint8, device=cuda)
    prm = fa.sample_simple_aug(2, 20, 24, 16, (0.8, 0.2, 0.2, 0.2, 0.1),
                               torch.Generator(device=cuda).manual_seed(0))
    with pytest.raises(TypeError):
        fa.fused_simple_aug(clips.float(), prm, 16, MEAN, STD)
    with pytest.raises(ValueError):
        fa.fused_simple_aug(clips.transpose(2, 3), prm, 16, MEAN, STD)
    with pytest.raises(ValueError):
        fa.fused_simple_aug(clips, prm, 21, MEAN, STD)


FLASH_SHAPES = [  # (b, h, nq, nk, d); the dK/dV splits the plan gives in brackets
    (2, 3, 37, 45, 36),       # ragged: partial tiles both ways, d % 8 != 0 (scalar loads) [1]
    (1, 2, 300, 100, 72),     # MViT-L stage 1's head dim, width 80, two m-tiles a warp [5]
    (1, 4, 200, 130, 144),    # [4]
    (1, 2, 150, 110, 288),    # [5]
    (1, 2, 100, 90, 576),     # O split across two warps (DSPLIT 2) [3]
    (2, 2, 130, 98, 48),      # [3]
    (1, 2, 97, 64, 192),      # [2]
    (1, 1, 64, 64, 64),       # whole tiles [1]
    (1, 2, 7, 5, 72),         # nq below one query tile, nk below one key tile [1]
    (1, 1, 5, 3, 288),        # [1]
    (1, 1, 9, 20, 576),       # [1]
    (2, 2, 1001, 77, 72),     # ragged, the most splits [16]
    (1, 2, 3000, 200, 288),   # ragged [16]
    (1, 2, 700, 50, 576),     # ragged [12]
    (1, 2, 40, 3000, 144),    # ragged, many key tiles [1]
    (2, 4, 200, 900, 576),    # ragged, many key tiles [1]
    # width 768: three warpgroups share S (forward), dQ the GEMM on dS,
    # dK/dV 16 keys a block with the S^T and dP^T n-tiles split over d
    (1, 2, 100, 90, 768),     # [2]
    (1, 1, 9, 20, 768),       # nq below one query tile, nk below one key tile [1]
    (1, 2, 700, 50, 768),     # ragged [8]
    (2, 4, 200, 900, 768),    # ragged, many key tiles [1]
    (1, 2, 130, 70, 600),     # d 600 zero-padded to 768 [3]
    (2, 1, 37, 45, 740),      # d % 8 != 0 (scalar loads) [2]
    (2, 70, 64, 100, 768),    # 140 query tiles: the 8 past the first wave as 4 key ranges each [1]
]


def _flash_inputs(shape, device, seed=0):
    b, h, nq, nk, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((b, h, nq, d), device=device, generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn((b, h, nk, d), device=device, generator=g).bfloat16() for _ in range(2))
    return q, k, v, do


def _rel(a, ref):
    return float((a.float() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_matches_plain(cuda, shape):
    q, k, v, do = _flash_inputs(shape, cuda)
    scale = shape[-1] ** -0.5
    launches = (fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches)
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fl.flash_mha(*qk, scale)
    o.backward(do)
    qr = [t.float().requires_grad_() for t in (q, k, v)]
    ref = fl.flash_mha_plain(*qr, scale)
    ref.backward(do.float())
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == ref.shape
    assert _rel(o.detach(), ref.detach()) <= 2 ** -7
    for got, want in zip(qk, qr):
        assert got.grad.dtype == torch.bfloat16
        assert _rel(got.grad, want.grad) <= 2 ** -6
    assert (fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    # no atomics: the backward is deterministic
    o2, lse = fl.flash_mha_fwd(q, k, v, scale)
    again = fl.flash_mha_bwd(q, k, v, o2, lse, do, scale)
    assert all(torch.equal(a, t.grad) for a, t in zip(again, qk))


@pytest.mark.cuda
def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """Neither kernel pair takes float16 or float64, tensors of other
    shapes, or tensors on several devices."""
    q, k, v, _ = _flash_inputs((1, 2, 16, 16, 32), cuda)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            fl.flash_mha_fwd(q.to(dtype), k.to(dtype), v.to(dtype), 0.1)
    with pytest.raises(ValueError):
        fl.flash_mha_fwd(q, k[:, :, :, :16], v, 0.1)
    with pytest.raises(ValueError):
        fl.flash_mha_fwd(q.float(), k[:, :, :, :16].float(), v.float(), 0.1)
    with pytest.raises(ValueError):
        fl.flash_mha_fwd(q, k.cpu(), v, 0.1)


F32_PAIR_CASES = [  # (b, h, nq, nk, d), dtype: what the tensor-core kernels do not take
    ((2, 2, 200, 150, 72), torch.float32),
    ((1, 2, 130, 70, 288), torch.float32),
    ((2, 1, 97, 65, 576), torch.float32),
    ((1, 1, 97, 65, 600), torch.float32),     # d > 576, ragged tiles
    ((1, 1, 40, 33, 1100), torch.float32),    # d above 288: streamed chunks, 4 column parts
    ((1, 2, 500, 300, 800), torch.bfloat16),  # bf16 above 768
    ((1, 1, 70, 45, 900), torch.bfloat16),
    # MViT-L 32x312's float32 shapes at one view: the resident tiers (d 72,
    # 144, 288) with the ring over thousands of keys and split query ranges
    # (nq >= 24336), and d 576 streamed in chunks over two column parts
    ((1, 2, 6400, 1600, 288), torch.float32),
    ((1, 1, 24336, 1600, 144), torch.float32),
    ((1, 1, 24336, 6400, 72), torch.float32),
    ((1, 1, 24336, 1600, 288), torch.float32),
    ((1, 2, 1600, 1600, 576), torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", F32_PAIR_CASES)
def test_flash_f32_pair_matches_plain(cuda, shape, dtype):
    """float32 q, k, v (any head dim) and bf16 above 768 go through
    flash_mha to the float32 pair of csrc/flash_attention_f32.cu, never to
    the tensor-core kernels, and agree with the float32 dense chain (TF32
    off). In float32 every product is taken in 3xTF32 (its operands split
    into two TF32 halves, the small x small term dropped: about 2^-22 of
    each product) and summed in float32 in another order over up to 1100
    columns and 24336 rows, so o, dq, dk and dv are held to 1e-4 of their
    largest entry. In bf16 the output is rounded once (2^-8) and the
    backward's D comes from that bf16 output, so the gradients are held to
    2^-6, as the tensor-core pair's are."""
    b, h, nq, nk, d = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn((b, h, nq, d), device=cuda, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, h, nk, d), device=cuda, generator=g).to(dtype) for _ in range(2))
    scale = d ** -0.5
    tol, gtol = (1e-4, 1e-4) if dtype == torch.float32 else (2 ** -8, 2 ** -6)
    launches = (fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches,
                fl.flash_f32_fwd.launches, fl.flash_f32_bwd.launches)
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fl.flash_mha(*qk, scale)
    o.backward(do)
    qr = [t.float().requires_grad_() for t in (q, k, v)]
    ref = fl.flash_mha_plain(*qr, scale)
    ref.backward(do.float())
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == ref.shape
    assert _rel(o.detach(), ref.detach()) <= tol
    for got, want in zip(qk, qr):
        assert got.grad.dtype == dtype
        assert _rel(got.grad, want.grad) <= gtol
    assert (fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches, fl.flash_f32_fwd.launches,
            fl.flash_f32_bwd.launches) == (launches[0], launches[1], launches[2] + 1, launches[3] + 1)
    o2, lse = fl.flash_f32_fwd(q, k, v, scale)
    ref_o, ref_lse = fl.flash_fwd_plain(q, k, v, scale)
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    again = fl.flash_f32_bwd(q, k, v, o2, lse, do, scale)
    assert all(torch.equal(a, t.grad) for a, t in zip(again, qk))  # no atomics: deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", fl.F32_KERNELS)
@pytest.mark.parametrize("d,bf16", [(8, False), (72, False), (100, False), (144, False), (200, False),
                                    (288, False), (289, False), (576, False), (600, False),
                                    (1100, False), (600, True), (800, True)])
def test_flash_f32_plan_matches_compiled(cuda, kernel, d, bf16):
    """f32_kernel_plan() is the source's make_plan: tiles, warps, column
    parts and shared memory."""
    assert fl.compiled_f32_plan(kernel, d, bf16) == fl.f32_kernel_plan(kernel, d, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("dp", sorted(fl.TILES))
def test_flash_tiles_compiled_are_the_plans(cuda, dp):
    """The tile widths the wrapper plans with (ops/flash_attention.py TILES)
    are the ones csrc/flash_attention.cu compiled."""
    assert fl.compiled_tiles(dp) == fl.TILES[dp]


@pytest.mark.cuda
def test_flash_forward_takes_a_negative_scale(cuda):
    """The kernel orders scores by their raw maximum (scale >= 0); the
    wrapper runs a negative scale as the same softmax of (-q) k^T |scale|."""
    q, k, v, do = _flash_inputs((1, 2, 70, 50, 72), cuda)
    o, lse = fl.flash_mha_fwd(q, k, v, -0.2)
    ref, ref_lse = fl.flash_fwd_plain(q, k, v, -0.2)
    torch.cuda.synchronize()
    assert _rel(o, ref.float()) <= 2 ** -7
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    qr = [t.float().requires_grad_() for t in (q, k, v)]
    fl.flash_mha_plain(*qr, -0.2).backward(do.float())
    for got, want in zip(fl.flash_mha_bwd(q, k, v, o, lse, do, -0.2), qr):
        assert _rel(got, want.grad) <= 2 ** -6


@pytest.mark.cuda
def test_advise_forward_on_the_card_matches_the_cpu(cuda):
    """AdViSe (configs/pretrain/AdViSe.yaml: the ViT-B/16 tower in bf16, the
    R3D temporal head) with 2 layers of the tower, on the card in bf16 under
    autocast against the same weights' float32 forward on the CPU, in eval
    mode: features and logits within 5e-2 of their largest magnitude (bf16
    rounds at 2^-8 a layer); the tower's tokens come back in float32."""
    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.models import build_model

    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/pretrain/AdViSe.yaml")
    cfg.MODEL.TEMPORAL_NUM_LAYERS = 1
    cfg = tconfig.assert_and_infer_cfg(cfg)
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    ref_cfg.TM.ENABLE_BF16 = False
    ref = build_model(ref_cfg, "cpu", seed=0).eval()
    card = build_model(cfg, cuda, seed=0).eval()
    x = torch.randn((2, cfg.DATA.NUM_FRAMES, 224, 224, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want_feat = ref.features(x)
        want = ref.classify(want_feat)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            grid = card.tokens(x.to(cuda).bfloat16())
            got_feat = card.temporal_forward(grid)
            got = card.classify(got_feat)
    assert grid.dtype == torch.float32 and tuple(grid.shape) == (2, cfg.DATA.NUM_FRAMES, 14, 14, 768)
    for a, r in ((got_feat, want_feat), (got, want)):
        assert tuple(a.shape) == tuple(r.shape)
        assert float((a.float().cpu() - r).abs().max() / r.abs().max()) <= 5e-2


@pytest.mark.cuda
def test_probe_eval_step_on_the_card_matches_the_cpu(cuda):
    """The eval step of configs/eval/linear_probe_ucf.yaml (the inference
    crop, the cast, Slow-R50 with a 101-class linear head in eval mode) on
    2 uint8 clips of 8 x 256 x 341 with the same crops: bf16 on the card
    against float32 on the CPU, logits within 5e-2 of their largest
    magnitude; the card's forward records no BN statistics."""
    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.data import build_device_aug, ingest_geometry
    from advise_tpu_torch.engine.steps import make_eval_step
    from advise_tpu_torch.models import build_model

    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/eval/linear_probe_ucf.yaml")
    cfg.NUM_GPUS = cfg.BN.NUM_SYNC_DEVICES = cfg.TPU.MESH_SYNC = 1
    cfg = tconfig.assert_and_infer_cfg(cfg)
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    w, h = ingest_geometry(cfg, "action")
    clips = torch.randint(0, 256, (2, 1, cfg.INFER.NUM_FRAMES, h, w, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    aug = build_device_aug(cfg, "action")
    crops = aug.sample(2, cfg.INFER.NUM_FRAMES, h, w, 3, torch.Generator().manual_seed(1))
    want = make_eval_step(ref_cfg, lambda x, g: aug.apply(x, crops))(build_model(ref_cfg, "cpu", seed=0), clips, None)
    card = build_model(cfg, cuda, seed=0)
    got = make_eval_step(cfg, lambda x, g: aug.apply(x, crops))(card, clips.to(cuda), None)
    assert tuple(got.shape) == tuple(want.shape) == (2, 1, 101)
    assert float((got.float().cpu() - want).abs().max() / want.abs().max()) <= 5e-2
    assert all(not getattr(m, "pending", []) for m in card.modules())


@pytest.mark.cuda
def test_x3d_forward_on_the_card_matches_the_cpu(cuda):
    """X3D-M of configs/pretrain/X3D_M_K400.yaml at full width (4 classes)
    on 2 clips of 16 x 112^2 in eval mode: bf16 on the card (channelwise
    convs, SE in float32) against float32 on the CPU with the same weights,
    logits within 5e-2 of their largest magnitude, as the other bf16
    forwards here."""
    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.models import build_model

    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/pretrain/X3D_M_K400.yaml")
    cfg.NUM_GPUS = cfg.BN.NUM_SYNC_DEVICES = cfg.TPU.MESH_SYNC = 1
    cfg = tconfig.assert_and_infer_cfg(cfg)
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    x = torch.randn((2, cfg.DATA.NUM_FRAMES, 112, 112, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = build_model(ref_cfg, "cpu", seed=0).eval()(x)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = build_model(cfg, cuda, seed=0).eval()(x.to(cuda).bfloat16())
    assert tuple(got.shape) == tuple(want.shape) == (2, 4)
    assert float((got.float().cpu() - want).abs().max() / want.abs().max()) <= 5e-2


# SyncBatchNorm's train mode (csrc/batch_norm.cu): (shape, views,
# num_splits, dtype); the main path's channels-last shapes first
BN_CASES = [
    ((32, 64, 8, 112, 112), 1, 1, torch.bfloat16),  # the stem's BN
    ((32, 256, 8, 56, 56), 1, 1, torch.bfloat16),   # res2
    ((32, 64, 8, 56, 56), 1, 1, torch.bfloat16),
    ((32, 2048, 8, 7, 7), 1, 1, torch.bfloat16),    # res5 c
    ((32, 4096), 1, 1, torch.bfloat16),             # the heads' BN1d
    ((64, 4096), 2, 1, torch.bfloat16),             # two views
    ((16, 512, 8, 14, 14), 2, 2, torch.bfloat16),   # views 2 x num_splits 2
    ((8, 54, 4, 28, 28), 1, 1, torch.bfloat16),     # X3D-M's 54 channels: 4-byte vectors
    ((16, 256, 8, 14, 14), 1, 2, torch.float32),
    ((6, 3, 5, 7, 9), 1, 1, torch.float32),         # odd C: scalar loads
]


def _bn_inputs(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=g, device=dev) * scale + shift
        return (t.movedim(1, -1).contiguous().movedim(-1, 1) if len(shape) > 2 else t).to(dtype)

    x, gy = draw(2.0, 1.0), draw()
    c = shape[1]
    return x, gy, torch.randn(c, generator=g, device=dev), torch.randn(c, generator=g, device=dev)


def _bn_module(c, num_splits, weight, bias):
    from advise_tpu_torch.models.layers.norm import SyncBatchNorm

    m = SyncBatchNorm(c, num_splits=num_splits).to(weight.device)
    with torch.no_grad():
        m.weight.copy_(weight)
        m.bias.copy_(bias)
    return m


def _bn_run(m, x, gy, views):
    """y, dx, dscale, dbias of one train-mode call and its backward."""
    xk = x.clone().requires_grad_(True)
    m.weight.grad = m.bias.grad = None
    y = m(xk, views=views)
    y.backward(gy)
    m.pending = []
    return y.detach(), xk.grad, m.weight.grad.clone(), m.bias.grad.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,views,num_splits,dtype", BN_CASES)
def test_batch_norm_kernels_match_plain(cuda, shape, views, num_splits, dtype):
    """The statistics within 1e-5 of float64 sums (meansq relative to
    itself; the mean relative to the root of meansq: a mean near 0 is a
    cancelling sum whose error follows the size of its terms); y within one
    ulp of x's type at the largest output of the float32 fold on the same
    rounded w and b; dx, dscale and dbias within 2^-7 of their largest entry
    against float64 autograd of the eager chain on the same values (g and x
    pass through x's type, dx is rounded to it once). The wrappers count one
    launch a call; no layout copy."""
    from bn_chain import eager_bn

    from advise_tpu_torch.ops import batch_norm as bn

    x, gy, weight, bias = _bn_inputs(shape, dtype, cuda)
    c, splits, eps = shape[1], views * num_splits, 1e-5
    xs = x.double().movedim(1, -1).reshape(splits, -1, c)
    mean64, meansq64 = xs.mean(1), (xs * xs).mean(1)
    del xs
    counts = [f.launches for f in (bn.bn_stats, bn.bn_apply, bn.bn_grad_stats, bn.bn_dx, bn.channels_last)]
    stats = bn.bn_stats(x, splits)
    assert stats.shape == (2, splits, c) and stats.dtype == torch.float32
    assert float(((stats[1] - meansq64).abs() / meansq64).max()) <= 1e-5
    assert float(((stats[0] - mean64).abs() / meansq64.sqrt()).max()) <= 1e-5

    y = bn.bn_apply(x, stats, weight, bias, eps)
    assert y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
    r = torch.reciprocal(torch.sqrt(stats[1] - stats[0] * stats[0] + eps))
    w = r * weight
    b = -stats[0] * w + bias
    rows = x.movedim(1, -1).reshape(splits, -1, c).float()
    want = rows * w.to(dtype).float()[:, None] + b.to(dtype).float()[:, None]
    top = float(want.abs().max())
    ulp = _bf16_ulp(top) if dtype == torch.bfloat16 else 2.0 ** (math.floor(math.log2(top)) - 23)
    assert float((y.movedim(1, -1).reshape(splits, -1, c).float() - want).abs().max()) <= ulp
    del rows, want

    m = _bn_module(c, num_splits, weight, bias)
    y2, dx, dscale, dbias = _bn_run(m, x, gy, views)
    assert torch.equal(y2, y)
    xr = x.double().requires_grad_(True)
    wr, br = weight.double().requires_grad_(True), bias.double().requires_grad_(True)
    y_ref, _, _ = eager_bn(xr, wr, br, eps, splits)
    y_ref.backward(gy.double())
    del y_ref
    for got, ref in ((dx, xr.grad), (dscale, wr.grad), (dbias, br.grad)):
        assert float((got.double() - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())
    assert dx.dtype == dtype and dx.stride() == x.stride()
    got = [f.launches - n for f, n in zip((bn.bn_stats, bn.bn_apply, bn.bn_grad_stats, bn.bn_dx,
                                           bn.channels_last), counts)]
    assert got == [2, 2, 1, 1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,views,num_splits,dtype", [BN_CASES[0], BN_CASES[5], BN_CASES[6]])
def test_batch_norm_kernels_repeat_bit_for_bit(cuda, shape, views, num_splits, dtype):
    """Two calls on the same inputs: equal outputs and gradients, bit for
    bit (fixed summation orders, no atomics)."""
    x, gy, weight, bias = _bn_inputs(shape, dtype, cuda, seed=1)
    m = _bn_module(shape[1], num_splits, weight, bias)
    first = _bn_run(m, x, gy, views)
    second = _bn_run(m, x, gy, views)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_batch_norm_under_checkpoint_gives_the_same_gradients(cuda):
    """A stage of two BNs and a ReLU under checkpoint(use_reentrant=False),
    as TPU.REMAT runs the models' stages, against the same stage without
    it: equal outputs and gradients, bit for bit."""
    from torch.utils.checkpoint import checkpoint

    x, gy, weight, bias = _bn_inputs((16, 256, 8, 14, 14), torch.bfloat16, cuda, seed=2)
    m1, m2 = _bn_module(256, 1, weight, bias), _bn_module(256, 1, bias, weight)

    def stage(t):
        return m2(torch.relu(m1(t)))

    runs = []
    for remat in (False, True):
        xk = x.clone().requires_grad_(True)
        y = checkpoint(stage, xk, use_reentrant=False) if remat else stage(xk)
        y.backward(gy)
        runs.append([y.detach(), xk.grad] + [p.grad.clone() for p in (*m1.parameters(), *m2.parameters())])
        for p in (*m1.parameters(), *m2.parameters()):
            p.grad = None
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_batch_norm_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from advise_tpu_torch.ops import batch_norm as bn

    x, gy, weight, bias = _bn_inputs((4, 16, 3, 5, 5), torch.bfloat16, cuda)
    stats = bn.bn_stats(x, 1)
    with pytest.raises(TypeError):
        bn.bn_stats(x.half(), 1)
    with pytest.raises(TypeError):
        bn.bn_stats(x.to(torch.int32), 1)
    with pytest.raises(ValueError):
        bn.bn_stats(x[0, 0, 0, 0], 1)  # ndim 1
    with pytest.raises(ValueError):
        bn.bn_stats(x.contiguous(), 1)  # NCDHW: the channel dim is not innermost
    with pytest.raises(ValueError):
        bn.bn_stats(x, 3)  # 4 clips do not split into 3
    with pytest.raises(ValueError):
        bn.bn_apply(x, stats, weight[:8], bias, 1e-5)
    with pytest.raises(ValueError):
        bn.bn_apply(x, stats.double(), weight, bias, 1e-5)
    with pytest.raises(ValueError):
        bn.bn_grad_stats(gy.float(), x, stats, 1e-5)
    with pytest.raises(ValueError):
        bn.bn_dx(gy, x, stats, stats[:, :, :8], weight, 1e-5)
