"""K4, the port's flash attention (advise_tpu_torch/ops/flash_attention.py),
on the CPU against the JAX package's ``flash_mha`` (JAX's library Pallas
flash attention, run in TPU interpret mode as tests/test_flash_attention.py
runs it) and against JAX's dense einsum -> softmax -> einsum chain: the
forward and dq, dk, dv of sum(o * cos(o)).

On the CPU the port's ``flash_mha`` runs its autograd.Function with the
kernels' plain versions: the forward returns the base-2 row log-sum-exp and
the backward recomputes the probabilities from it with D = rowsum(dO * O),
as the CUDA kernels do. Tolerance: 1e-5 absolute in float32, the bound
tests/test_flash_attention.py holds JAX's own flash to against its dense
chain (values and gradients are O(1) here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu.ops.flash_attention import flash_mha as jflash_mha
from advise_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

SHAPES = [(256, 384, 48), (392, 98, 48), (130, 130, 48), (256, 128, 192),
          (64, 40, 288), (48, 36, 576), (40, 30, 768)]


def _inputs(nq, nk, d, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d))]


def _jax_dense(q, k, v, scale):
    a = jax.nn.softmax(jnp.einsum("bhqc,bhkc->bhqk", q * scale, k), axis=-1).astype(v.dtype)
    return jnp.einsum("bhqk,bhkc->bhqc", a, v)


def _jax_grads(fn, q, k, v, scale):
    def loss(q, k, v):
        o = fn(q, k, v, scale)
        return jnp.sum(o * jnp.cos(o)), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, (0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in (o, *g)]


def _port_grads(fn, q, k, v, scale):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fn(*ts, scale)
    torch.sum(o * torch.cos(o)).backward()
    return [a.detach().numpy() for a in (o, *(t.grad for t in ts))]


@pytest.mark.parametrize("nq,nk,d", SHAPES)
def test_flash_mha_matches_jax(nq, nk, d):
    q, k, v = _inputs(nq, nk, d)
    scale = 1.0 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_grads(jflash_mha, q, k, v, scale)
    dense = _jax_grads(_jax_dense, q, k, v, scale)
    got = _port_grads(fa.flash_mha, q, k, v, scale)
    plain = _port_grads(fa.flash_mha_plain, q, k, v, scale)
    for name, a, w, dn, p in zip(("o", "dq", "dk", "dv"), got, want, dense, plain):
        assert a.shape == w.shape, name
        assert float(np.abs(a - w).max()) < 1e-5, f"{name} vs JAX flash"
        assert float(np.abs(a - dn).max()) < 1e-5, f"{name} vs JAX dense"
        assert float(np.abs(p - dn).max()) < 1e-5, f"plain {name} vs JAX dense"


def test_flash_wrappers_on_the_cpu_count_no_launch():
    """On the CPU both wrappers run their plain versions: no launch is
    counted, the base-2 log-sum-exp is log2 of the softmax denominator, and
    the output keeps v's dtype."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(20, 12, 8, b=1, h=1))
    launches = (fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches)
    o, lse = fa.flash_mha_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.5)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    s = (q.bfloat16().float() @ k.bfloat16().float().transpose(-1, -2)) * 0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy() / np.log(2.0),
                               rtol=1e-6, atol=1e-6)
    fa.flash_mha_bwd(q, k, v, o.float(), lse, torch.ones_like(q), 0.5)
    assert (fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches) == launches
