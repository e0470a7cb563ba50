"""The eager chain that SyncBatchNorm's train mode ran before its kernels
(``models/layers/norm.py`` up to the port's first BN kernels), as the
reference of the BN tests on the CPU and on the card. Imports no JAX.

``eager_bn(x, weight, bias, eps, splits)`` over x ``[N, C, *S]``: the
float32 (or, for float64 x, float64) mean and mean of squares of each of
``splits`` batch slices, ``var = meansq - mean^2``, ``w = weight *
rsqrt(var + eps)``, ``b = -mean * w + bias``, ``y = x * w + b`` in x's
dtype; differentiable end to end, so autograd gives the chain's gradients.
"""

import torch


def eager_bn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, splits: int):
    """(y, mean [splits, C], var [splits, C]) of the chain."""
    c = x.shape[1]
    xs = x.reshape(splits, x.shape[0] // splits, *x.shape[1:])
    red = (1,) + tuple(range(3, xs.ndim))
    xf = xs if x.dtype == torch.float64 else xs.float()
    mean = torch.mean(xf, dim=red)
    meansq = torch.mean(torch.square(xf), dim=red)
    var = meansq - torch.square(mean)
    shape = (splits, 1, c) + (1,) * (x.ndim - 2)
    w = torch.rsqrt(var + eps) * weight.to(mean.dtype)
    b = -mean * w + bias.to(mean.dtype)
    y = xs * w.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
    return y.reshape(x.shape), mean, var


def running_update(running_mean, running_var, mean, var, count: int, momentum: float = 0.1):
    """One record of the chain folded into the running buffers: the mean
    over the splits of the batch mean and of the unbiased batch variance."""
    unbiased = var.mean(0) * (count / max(count - 1, 1))
    return ((1 - momentum) * running_mean + momentum * mean.mean(0),
            (1 - momentum) * running_var + momentum * unbiased)
