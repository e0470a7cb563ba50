"""O(1)-activation-memory reversible coupling (counterpart of
``advise_tpu/parallel/reversible.py`` ``reversible_block_scan``) as a
``torch.autograd.Function``.

Per block k the forward is

    y1 = x1 + f(k, x2) ;  y2 = x2 + g(k, y1)

and only the segment's outputs are saved. The backward inverts block by
block, ``x2 = y2 - g(k, y1)``, ``x1 = y1 - f(k, x2)``, re-running ``f`` and
``g`` with the graph on to pull the cotangents back, so activation memory is
one block's, whatever the depth. ``f`` and ``g`` must give the same values
when run again: stochastic layers take their randomness from masks drawn
before the segment runs (the counterpart of JAX's key-derived masks), and
the autocast state of the forward is restored for the backward.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

Fn = Callable[[int, torch.Tensor], torch.Tensor]


class _RevBlockScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f: Fn, g: Fn, block_index: Sequence[Sequence[int]], x1, x2, *params):
        """``block_index[k]``: the positions in ``params`` of block k's tensors."""
        ctx.f, ctx.g, ctx.block_index = f, g, block_index
        dev = x1.device.type
        ctx.autocast = (dev, torch.is_autocast_enabled(dev), torch.get_autocast_dtype(dev))
        with torch.no_grad():
            for k in range(len(block_index)):
                x1 = x1 + f(k, x2)
                x2 = x2 + g(k, x1)
        ctx.save_for_backward(x1, x2, *params)
        return x1, x2

    @staticmethod
    def backward(ctx, g1, g2):
        y1, y2, *params = ctx.saved_tensors
        f, g = ctx.f, ctx.g
        grads: List = [None] * len(params)
        if g1 is None:
            g1 = torch.zeros_like(y1)
        if g2 is None:
            g2 = torch.zeros_like(y2)
        dev, enabled, dtype = ctx.autocast
        with torch.autocast(dev, dtype=dtype, enabled=enabled):
            for k in reversed(range(len(ctx.block_index))):
                mine = ctx.block_index[k]
                block = [params[i] for i in mine]
                with torch.enable_grad():
                    y1d = y1.detach().requires_grad_(True)
                    g_val = g(k, y1d)
                x2 = y2 - g_val.detach()
                with torch.enable_grad():
                    x2d = x2.detach().requires_grad_(True)
                    f_val = f(k, x2d)
                x1 = y1 - f_val.detach()
                # pull back through y2 = x2 + g(y1), then y1 = x1 + f(x2)
                gy1, *gp_g = torch.autograd.grad(g_val, [y1d] + block, g2.to(g_val.dtype),
                                                 allow_unused=True)
                g1 = g1 + gy1
                gx2, *gp_f = torch.autograd.grad(f_val, [x2d] + block, g1.to(f_val.dtype),
                                                 allow_unused=True)
                g2 = g2 + gx2
                for i, a, b in zip(mine, gp_g, gp_f):
                    total = a if b is None else (b if a is None else a + b)
                    if total is not None:
                        grads[i] = total if grads[i] is None else grads[i] + total
                y1, y2 = x1, x2
        return (None, None, None, g1, g2, *grads)


def reversible_block_scan(f: Fn, g: Fn, block_params: Sequence[Sequence[torch.Tensor]],
                          x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the coupling over ``len(block_params)`` blocks; ``f(k, x)`` and
    ``g(k, x)`` are block k's attention and MLP sub-blocks (drop path
    included), ``block_params[k]`` the tensors they differentiate. Returns
    (y1, y2), differentiable in x1, x2 and every parameter."""
    flat: List[torch.Tensor] = []
    index: List[List[int]] = []
    for ps in block_params:
        index.append(list(range(len(flat), len(flat) + len(ps))))
        flat.extend(ps)
    return _RevBlockScan.apply(f, g, index, x1, x2, *flat)
