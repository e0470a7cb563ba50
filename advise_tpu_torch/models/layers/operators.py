"""Squeeze-excitation and HOG features, the MaskFeat regression target
(counterpart of ``advise_tpu/models/layers/operators.py`` ``SE`` and
``hog_features``).

The same vectorized formulation as the JAX package: Sobel gradients by
shifts of the edge-padded frame, ``atan2(gx, gy)`` phase, the Gaussian
window tiled over the frame, floor binning into a one-hot vote, per-cell
sums and a per-cell L2 norm. The ops follow the input dtype as JAX's do:
with bf16 frames the gradients and phase are bf16, and the Gaussian window
(float32) makes the votes and histograms float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import lecun_normal_init
from advise_tpu_torch.models.utils import round_width


class SE(nn.Module):
    """3D squeeze-excitation: the mean over (T, H, W), a 1x1x1 conv ``fc1``
    to ``round_width(dim, ratio, 8, 8)`` channels (the JAX module's
    ``_round_width``), ReLU, a 1x1x1 conv ``fc2`` back
    to ``dim``, and the input scaled by the sigmoid of that.

    The JAX module's convs carry no ``dtype``, so their float32 parameters
    promote the excitation to float32, and with bf16 input the module returns
    float32. Here fc1 and fc2 run in float32 with autocast off, and the
    product is float32 too; the next conv casts back under autocast."""

    def __init__(self, dim: int, ratio: float):
        super().__init__()
        dim_fc = round_width(dim, ratio, min_width=8, divisor=8)
        self.fc1 = nn.Conv3d(dim, dim_fc, 1)
        self.fc2 = nn.Conv3d(dim_fc, dim, 1)
        for conv in (self.fc1, self.fc2):  # Flax's default kernel init, zero bias
            conv.weight_init = lecun_normal_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        with torch.autocast(x.device.type, enabled=False):
            s = self.fc2(F.relu(self.fc1(s.float())))
            return x.float() * torch.sigmoid(s)


def gaussian_kernel2d(size: int, sigma: float, device=None) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (ax / sigma) ** 2)
    k = torch.outer(g, g)
    return k / k.max()


def _edge_pad1(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H + 2, W + 2, C], edge values repeated."""
    _, h, w, _ = x.shape
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    return x[:, rows][:, :, cols]


def hog_features(frames: torch.Tensor, nbins: int = 9, cell_sz: int = 8,
                 gaussian_window: int = 16) -> torch.Tensor:
    """frames [B, H, W, C] -> [B, H // cell, W // cell, C * nbins], each
    cell's histogram L2-normalized over (C, nbins)."""
    b, h, w, c = frames.shape
    x = _edge_pad1(frames)
    gx = ((x[:, :-2, 2:] - x[:, :-2, :-2]) + 2.0 * (x[:, 1:-1, 2:] - x[:, 1:-1, :-2])
          + (x[:, 2:, 2:] - x[:, 2:, :-2]))
    gy = ((x[:, 2:, :-2] - x[:, :-2, :-2]) + 2.0 * (x[:, 2:, 1:-1] - x[:, :-2, 1:-1])
          + (x[:, 2:, 2:] - x[:, :-2, 2:]))
    mag = torch.sqrt(gx ** 2 + gy ** 2 + 1e-12)
    phase = torch.atan2(gx, gy) / math.pi * nbins
    phase = torch.where(phase < 0, phase + nbins, phase)
    if gaussian_window:
        gk = gaussian_kernel2d(gaussian_window, gaussian_window // 2, frames.device)
        reps_h, reps_w = -(-h // gaussian_window), -(-w // gaussian_window)
        mag = mag * gk.repeat(reps_h, reps_w)[:h, :w][None, :, :, None]
    bin_idx = torch.clamp(torch.floor(phase), 0, nbins - 1).long()
    votes = F.one_hot(bin_idx, nbins).to(frames.dtype) * mag[..., None]
    hc, wc = h // cell_sz, w // cell_sz
    hist = votes.reshape(b, hc, cell_sz, wc, cell_sz, c, nbins).sum(dim=(2, 4))
    norm = torch.linalg.vector_norm(hist.reshape(b, hc, wc, -1), dim=-1)
    hist = hist / (norm[..., None, None] + 1e-12)
    return hist.reshape(b, hc, wc, c * nbins)
