"""SyncBatchNorm's train mode on the CPU (``models/layers/norm.py`` over
``ops/batch_norm.py``'s plain versions): the closed-form backward against
float64 autograd of the eager chain it replaced (``tests/bn_chain.py``),
the running statistics it records, REMAT, the layout copy, and the kernels'
launch plan. The kernels themselves are held against these plain versions
on the card (``tests/test_torch_kernels_cuda.py``).

Tolerances: the forward's statistics and sums are float32 reductions in
another order than the chain's, each within some 1e-7 of its float64 value
at these sizes; the gradients are held to 1e-5 of their largest entry
against float64 autograd of the chain on the same float32 inputs, and y
to 1e-6 of its largest value.
"""

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from advise_tpu_torch.models.layers.norm import SyncBatchNorm, commit_bn_stats
from advise_tpu_torch.ops import batch_norm as bn
from bn_chain import eager_bn, running_update

torch.set_num_threads(1)


def _inputs(shape, seed, zero_init):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 1
    if len(shape) > 2:  # channels-last, as the models' activations
        x = x.movedim(1, -1).contiguous().movedim(-1, 1)
    gy = torch.randn(shape, generator=g, dtype=torch.float64)
    weight = torch.zeros(shape[1], dtype=torch.float64) if zero_init else torch.randn(
        shape[1], generator=g, dtype=torch.float64)
    return x, gy, weight, torch.randn(shape[1], generator=g, dtype=torch.float64)


def _bn(c, num_splits, weight, bias):
    m = SyncBatchNorm(c, num_splits=num_splits)
    with torch.no_grad():
        m.weight.copy_(weight)
        m.bias.copy_(bias)
    return m


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", [(16, 6), (8, 6, 3, 4, 5)])
@pytest.mark.parametrize("views", [1, 2])
@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("zero_init", [False, True])
def test_closed_form_backward_matches_float64_autograd_of_the_chain(shape, views, num_splits, zero_init):
    x64, gy, weight, bias = _inputs(shape, 3, zero_init)
    splits = views * num_splits
    xr = x64.clone().requires_grad_(True)
    w64, b64 = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    y_ref, _, _ = eager_bn(xr, w64, b64, 1e-5, splits)
    (y_ref * gy).sum().backward()

    m = _bn(shape[1], num_splits, weight, bias)
    x = x64.float().requires_grad_(True)
    y = m(x, views=views)
    (y.double() * gy).sum().backward()
    assert y.dtype == torch.float32 and y.stride() == x.stride()
    assert _rel(y.detach(), y_ref.detach()) <= 1e-6
    assert _rel(x.grad, xr.grad) <= 1e-5
    assert _rel(m.weight.grad, w64.grad) <= 1e-5
    assert _rel(m.bias.grad, b64.grad) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_compose_the_fold_and_its_closed_form(dtype):
    """The four plain functions: y is x * T(w) + T(b) computed in float32
    from w and b rounded to T and rounded once; dx from the grad stats'
    means is the closed form; the totals are the parameters' gradients."""
    x64, gy64, weight, bias = _inputs((6, 16, 2, 3, 3), 5, False)
    x, gy, splits = x64.to(dtype), gy64.to(dtype), 2
    stats = bn.bn_stats(x, splits)
    xs = x.float().movedim(1, -1).reshape(splits, -1, 16)
    torch.testing.assert_close(stats, torch.stack([xs.mean(1), (xs * xs).mean(1)]))
    w, b = bn.fold(stats[0], stats[1] - stats[0] ** 2, weight.float(), bias.float(), 1e-5, dtype)
    y = bn.bn_apply(x, stats, weight.float(), bias.float(), 1e-5)
    want = (xs * w.float()[:, None] + b.float()[:, None]).to(dtype)
    assert torch.equal(y.movedim(1, -1).reshape(splits, -1, 16), want)
    means, totals = bn.bn_grad_stats(gy, x, stats, 1e-5)
    r = bn.rstd(stats, 1e-5)[:, None]
    gs = gy.float().movedim(1, -1).reshape(splits, -1, 16)
    xh = (xs - stats[0][:, None]) * r
    torch.testing.assert_close(means, torch.stack([gs.mean(1), (gs * xh).mean(1)]))
    torch.testing.assert_close(totals, torch.stack([gs.sum((0, 1)), (gs * xh).sum((0, 1))]))
    dx = bn.bn_dx(gy, x, stats, means, weight.float(), 1e-5)
    want = (weight.float() * r * (gs - means[0][:, None] - xh * means[1][:, None])).to(dtype)
    torch.testing.assert_close(dx.movedim(1, -1).reshape(splits, -1, 16), want, rtol=0, atol=0)


@pytest.mark.parametrize("views,num_splits", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_records_and_commit_give_the_chains_running_buffers(views, num_splits):
    """Two train-mode calls a step: each records its batch statistics, and
    commit_bn_stats folds them in call order into the buffers the chain's
    records give; a forward recomputed inside the backward records nothing."""
    x64, gy, weight, bias = _inputs((8, 6, 3, 4, 5), 7, False)
    m = _bn(6, num_splits, weight, bias)
    rm, rv = m.running_mean.clone(), m.running_var.clone()
    count = x64.numel() // (views * num_splits) // 6
    for i in range(2):
        x = (x64 * (i + 1)).float().requires_grad_(True)
        y = checkpoint(lambda t: m(t, views=views), x, use_reentrant=False)
        (y.double() * gy).sum().backward()
        _, mean, var = eager_bn(x.detach(), m.weight.detach(), m.bias.detach(), 1e-5, views * num_splits)
        rm, rv = running_update(rm, rv, mean, var, count)
    assert len(m.pending) == 2
    commit_bn_stats(m)
    assert m.pending == []
    torch.testing.assert_close(m.running_mean, rm, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(m.running_var, rv, rtol=1e-6, atol=1e-7)


def test_checkpointed_stage_gives_the_same_gradients():
    """A conv + BN + ReLU stage under checkpoint(use_reentrant=False) (as
    TPU.REMAT runs the models' stages) against the same stage without it:
    equal outputs and gradients, one record each."""
    torch.manual_seed(0)
    conv = torch.nn.Conv3d(4, 8, 3, padding=1)
    m = SyncBatchNorm(8)
    x = torch.randn(4, 4, 3, 6, 6).requires_grad_(True)

    def stage(t):
        return torch.relu(m(conv(t)))

    grads = []
    for remat in (False, True):
        for p in (*conv.parameters(), *m.parameters(), x):
            p.grad = None
        y = checkpoint(stage, x, use_reentrant=False) if remat else stage(x)
        (y * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        grads.append([y.detach()] + [p.grad.clone() for p in (*conv.parameters(), *m.parameters(), x)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(m.pending) == 2


def test_the_cpu_keeps_any_layout_without_a_copy():
    """Off the card no layout copy is made: y and dx keep x's layout (a
    contiguous NCHW input, an expanded gradient) and equal those of the
    channels-last input."""
    m = SyncBatchNorm(6)
    x = torch.randn(4, 6, 3, 5).requires_grad_(True)  # contiguous NCHW: channels not innermost
    before = bn.channels_last.launches
    y = m(x)
    y.sum().backward()  # the gradient of a sum comes expanded
    assert y.stride() == x.stride() and x.grad.stride() == x.stride()
    xc = x.detach().movedim(1, -1).contiguous().movedim(-1, 1).requires_grad_(True)
    yc = m(xc)
    yc.sum().backward()
    assert bn.channels_last.launches == before
    torch.testing.assert_close(yc, y, rtol=0, atol=0)
    torch.testing.assert_close(xc.grad, x.grad, rtol=0, atol=0)


def test_wrappers_raise_on_a_device_without_a_kernel():
    x = torch.empty(4, 8, device="meta")
    stats = torch.empty(2, 1, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        bn.bn_stats(x, 1)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        bn.bn_apply(x, stats, torch.empty(8, device="meta"), torch.empty(8, device="meta"), 1e-5)


MAIN_SHAPES = [  # rows, C, splits, dtype, pointer alignment
    (32 * 8 * 112 * 112, 64, 1, torch.bfloat16, 16),   # the stem's BN
    (32 * 8 * 56 * 56, 256, 1, torch.bfloat16, 16),    # res2
    (32 * 8 * 56 * 56, 64, 1, torch.bfloat16, 16),
    (32 * 8 * 7 * 7, 2048, 1, torch.bfloat16, 16),     # res5 c
    (32, 4096, 1, torch.bfloat16, 16),                 # the contrastive heads' BN1d
    (64, 4096, 2, torch.bfloat16, 16),                 # two views
    (16 * 8 * 28 * 28, 512, 4, torch.bfloat16, 16),    # views 2 x num_splits 2
    (16 * 4 * 56 * 56, 54, 1, torch.bfloat16, 16),     # X3D-M's 54 channels: 4-byte vectors
    (16 * 4 * 56 * 56, 24, 2, torch.float32, 16),
    (7 * 5, 3, 1, torch.float32, 4),                   # odd C, scalar loads
    (30, 40, 3, torch.bfloat16, 2),                    # a pointer aligned to 2 bytes only
    (12, 2400, 1, torch.float32, 8),                   # C over 256 vectors, uneven tiles
]


def plan_tiles(p: dict) -> list:
    """Each block of plan ``p`` as ((first row, end row), (first channel,
    end channel)), in grid order: what its threads read."""
    out = []
    for s in range(p["splits"]):
        for j in range(p["nb"]):
            r0 = s * p["rows_split"] + j * p["rpb"]
            r1 = min(r0 + p["rpb"], (s + 1) * p["rows_split"])
            for t in range(p["ctiles"]):
                c0 = t * p["ct"] * p["vec"]
                out.append(((r0, r1), (c0, min(c0 + p["ct"] * p["vec"], p["c"]))))
    return out


@pytest.mark.parametrize("rows,c,splits,dtype,align", MAIN_SHAPES)
def test_plan_tiles_cover_every_row_and_channel_once_with_aligned_vectors(rows, c, splits, dtype, align):
    p = bn.plan(rows, c, splits, dtype, align)
    esize = torch.finfo(dtype).bits // 8
    vec = p["vec"]
    assert c % vec == 0 and vec * esize <= bn.VECTOR_BYTES and align % (vec * esize) == 0
    assert vec == next(v for v in (8, 4, 2, 1)
                       if v * esize <= bn.VECTOR_BYTES and c % v == 0 and align % (v * esize) == 0)
    assert 0 < p["threads"] == p["ct"] * p["rpi"] <= bn.MAX_THREADS
    assert p["ct"] * p["ctiles"] * vec >= c > (p["ct"] * p["ctiles"] - p["ct"]) * vec
    assert p["rpb"] % p["rpi"] == 0 and p["grid"] == (p["nb"], p["ctiles"], splits)
    assert p["grid"][1] <= 65535 and p["grid"][2] <= 65535
    blocks = p["nb"] * p["ctiles"] * splits
    assert blocks < bn.BLOCKS + p["ctiles"] * splits
    tiles = plan_tiles(p)
    assert len(tiles) == blocks
    n = rows // splits
    for s in range(splits):  # each split's row blocks tile its range, in order, inside it
        blocks_s = tiles[s * p["nb"] * p["ctiles"]:(s + 1) * p["nb"] * p["ctiles"]]
        ends = sorted({r for r, _ in blocks_s})
        assert ends[0][0] == s * n and ends[-1][1] == (s + 1) * n
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ends, ends[1:]))
        for r in ends:  # each row range's channel tiles tile [0, C)
            chans = sorted(ch for rr, ch in blocks_s if rr == r)
            assert chans[0][0] == 0 and chans[-1][1] == c
            assert all(a[1] == b[0] and a[0] < a[1] and (a[1] - a[0]) % vec == 0
                       for a, b in zip(chans, chans[1:]))


def test_plan_refuses_rows_that_do_not_split():
    with pytest.raises(ValueError, match="do not split"):
        bn.plan(10, 8, 3, torch.bfloat16)
