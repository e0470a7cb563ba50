"""The port's stem conv (advise_tpu_torch/ops/stem_conv.py) against the JAX
Pallas stem kernel (ops/pallas/stem_conv.py) run in TPU interpret mode, as
tests/test_pallas_stem.py runs it.

On the CPU the port's wrappers take their plain versions (F.conv3d and its
weight gradient); the CUDA kernels run only on the card, in
tests/test_torch_kernels_cuda.py and in chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu.models.layers.stem import s2d_remap_kernel, s2d_repack_input
from advise_tpu.ops.pallas.stem_conv import pallas_s2d_stem
from advise_tpu_torch.ops import stem_conv as sc

torch.set_num_threads(1)


def _data(b=2, t=6, h=32, w=32, kt=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, w, 3)).astype(np.float32)
    wt = (rng.standard_normal((kt, 7, 7, 3, 8)) * 0.1).astype(np.float32)
    return x, wt


def _jax_stem(x, w, kt):
    return pallas_s2d_stem(s2d_repack_input(x), s2d_remap_kernel(w, kt), kt)


@pytest.mark.parametrize("kt", [5, 1])
def test_stem_forward_matches_pallas(kt):
    """Forward, float32: the two sum the same 5x7x7x3 products in another
    order, so they agree to float32 rounding (1e-4 at |y| ~ 1)."""
    x, w = _data(kt=kt)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_jax_stem(jnp.asarray(x), jnp.asarray(w), kt))
    got = sc.StemConvChunked.apply(torch.from_numpy(x), torch.from_numpy(w), 0)
    assert got.shape == want.shape == (2, 6, 16, 16, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_stem_weight_grad_matches_pallas():
    """Weight gradient through the autograd Function against the JAX custom
    VJP (the Pallas wgrad kernel, mapped back through the s2d remap), and
    the input gradient through the plain conv's. Float32 sums over
    2*6*16*16 positions: 1e-4 relative to the largest entry."""
    x, w = _data()

    def loss(xx, ww):
        y = _jax_stem(xx, ww, 5)
        return jnp.sum(y * jnp.cos(y))

    with pltpu.force_tpu_interpret_mode():
        gx_j, gw_j = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = sc.StemConvChunked.apply(xt, wt, 0)
    torch.sum(y * torch.cos(y)).backward()
    for got, want in ((wt.grad, gw_j), (xt.grad, gx_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_stem_input_grad_only_when_asked():
    """On the main path the stem input is the aug output: no input grad."""
    x, w = _data(b=1, t=3)
    wt = torch.from_numpy(w).requires_grad_()
    y = sc.StemConvChunked.apply(torch.from_numpy(x), wt, 0)
    gx, = torch.autograd.grad(y.sum(), [wt])
    assert gx.shape == wt.shape


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, w = _data(b=1, t=3, h=9, w=13)
    before = (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches)
    y = sc.stem_conv_fwd(torch.from_numpy(x), torch.from_numpy(w))
    assert y.shape == (1, 3, 5, 7, 8)  # Ho = (H - 1) // 2 + 1
    g = torch.ones_like(y)
    dw = sc.stem_conv_wgrad(torch.from_numpy(x), g, 5)
    assert dw.shape == (5, 7, 7, 3, 8) and dw.dtype == torch.float32
    assert (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches) == before


def test_kernel_eligibility():
    assert sc.kernel_eligible(3, 8)          # the SlowFast fast stem
    assert not sc.kernel_eligible(3, 64)     # the slow stem stays a plain conv
    assert not sc.kernel_eligible(4, 8)
