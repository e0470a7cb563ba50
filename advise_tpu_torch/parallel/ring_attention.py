"""Ring attention: exact softmax attention with the token dim sharded over
the 'seq' axis (counterpart of ``advise_tpu/parallel/ring_attention.py``).

Each rank holds its slice of q, k and v ``[B, H, N / n, D]``; k and v go
round the ring to the next rank (:func:`parallel.collectives.shift`, JAX's
``ppermute``) ``n - 1`` times while each rank folds every block into an
online softmax whose state (running max, numerator, denominator) is
float32, so a rank only ever holds ``[N / n, N / n]`` scores. The block
arithmetic is the JAX module's: scores ``q k^T`` in float32 times the
scale, ``exp(s - max)``, the probabilities cast to v's dtype before
``@ v``.

The gradient is a ``torch.autograd.Function``: the backward rotates k and v
round the ring again with the gradients of the block each rank holds,
recomputes each block's probabilities from the saved float32 log-sum-exp,
adds its part to dq, dk and dv, and sends the block's dk and dv home with
one last shift, in float32 throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

from advise_tpu_torch.parallel.collectives import all_gather_dim, shift
from advise_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group


def _block_attn(q, k, v, scale):
    """(max [B, H, Nq, 1], exp-scores @ v [B, H, Nq, D], sums [B, H, Nq, 1]),
    float32, of q against one block of k and v."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    num = torch.matmul(p.to(v.dtype), v).float()
    return m, num, p.sum(dim=-1, keepdim=True)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axes, scale):
        n_dev = axis_group(axes)[1]
        m, num, den = _block_attn(q, k, v, scale)
        k_cur, v_cur = k, v
        for _ in range(n_dev - 1):
            k_cur, v_cur = shift(k_cur, axes), shift(v_cur, axes)
            m_new, num_new, den_new = _block_attn(q, k_cur, v_cur, scale)
            m_tot = torch.maximum(m, m_new)
            a, b = torch.exp(m - m_tot), torch.exp(m_new - m_tot)
            num = num * a + num_new * b
            den = den * a + den_new * b
            m = m_tot
        out = num / den
        ctx.axes, ctx.scale, ctx.n_dev = axes, scale, n_dev
        ctx.save_for_backward(q, k, v, out, m + torch.log(den))
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        axes, scale = ctx.axes, ctx.scale
        qf, do = q.float(), grad.float()
        delta = (do * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        k_cur, v_cur = k, v
        dk_cur = dv_cur = None
        for step in range(ctx.n_dev):
            if step:
                k_cur, v_cur = shift(k_cur, axes), shift(v_cur, axes)
                dk_cur, dv_cur = shift(dk_cur, axes), shift(dv_cur, axes)
            kf, vf = k_cur.float(), v_cur.float()
            p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse)
            ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(ds, kf) * scale
            dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
            dv = torch.matmul(p.transpose(-1, -2), do)
            dk_cur = dk if dk_cur is None else dk_cur + dk
            dv_cur = dv if dv_cur is None else dv_cur + dv
        # the block last held came from the next rank: send its gradients home
        dk_cur, dv_cur = shift(dk_cur, axes), shift(dv_cur, axes)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axes=SEQ_AXIS,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's q slice [B, H, N_local, D] against the
    whole sequence, k and v going round the group over ``axes``; returns
    [B, H, N_local, D], differentiable in q, k and v. Without a process
    group (or a group of one) it is the one block's attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    g = axis_group(axes)
    if g is None or g[1] == 1:
        m, num, den = _block_attn(q, k, v, scale)
        return (num / den).to(q.dtype)
    return _RingAttention.apply(q, k, v, axes, scale)


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               axes=SEQ_AXIS, scale: Optional[float] = None) -> torch.Tensor:
    """Whole [B, H, N, D] arrays in, the same on every rank of ``axes``:
    this rank's slice of the token dim through :func:`ring_attention`, the
    slices gathered back in rank order (JAX's ``shard_map`` wrapper with the
    token dim sharded in and out). The gradient of an input on one rank is
    its slice's, times the group's size (the gather's backward sums the
    cotangents, as JAX transposes ``all_gather``): their mean over the
    group is the gradient of the whole."""
    g = axis_group(axes)
    n_dev, my = (1, 0) if g is None else (g[1], g[2])
    n = q.shape[2] // n_dev

    def mine(t):
        return t[:, :, my * n:(my + 1) * n]

    return all_gather_dim(ring_attention(mine(q), mine(k), mine(v), axes, scale), axes, 2)
