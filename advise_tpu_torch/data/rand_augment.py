"""RandAugment (counterpart of ``advise_tpu/data/rand_augment.py``): the
fused path of AUG.FUSED_RA and the op-exact path (AUG.FUSED_RA False).

Every op is split into sampling its parameters (torch, an explicit
generator) and applying them, so tests can hand both sides the same
parameters. A clip's plan holds, per slot, the op index ``sel``, the
magnitude ``m_eff`` and the ``sign`` that the JAX package draws from the
slot key (``_signed``): its geometric ops and its color ops draw the same
sign from the same key, so one sign per slot carries both.

Geometry: every sampled rotate/shear/translate contributes an inverse
affine 3x3; with the RandomResizedCrop box and the flip they compose into
one bilinear gather from the ingest frame (``fused_warp_coords`` and
``warp_gather``), fill 128 where a stage leaves the frame. The color ops
then run in slot order on the warped clip.

The op-exact path (:class:`ExactRandAugment`) runs the sampled ops one
slot after another, as PIL would: each geometric op is its own warp of the
current image (:func:`warp_affine`: bilinear, or at AUG.INTERPOLATION
bicubic PIL's 16-tap transform kernel at a = -1), fill 128 per tap, rounded
to uint8. Where JAX maps a ``lax.switch`` over the clips one by one, the
port gathers, per slot, the clips that chose each op and runs the op once
over them: at most 15 op calls a slot, whatever the batch.

Tensors are float clips in [0, 255], batched as [N, T, H, W, C] with
per-clip parameters of shape [N].
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from advise_tpu_torch.data.device_aug import (
    _round_u8,
    adjust_brightness,
    adjust_contrast,
    adjust_saturation,
)

_LEVEL_DENOM = 10.0

# indices into the 15-op RandAugment table
OP_AUTOCONTRAST, OP_EQUALIZE, OP_INVERT, GEO_ROTATE = 0, 1, 2, 3
OP_POSTERIZE, OP_SOLARIZE, OP_SOLARIZE_ADD = 4, 5, 6
OP_COLOR, OP_CONTRAST, OP_BRIGHTNESS, OP_SHARPNESS = 7, 8, 9, 10
GEO_SHEAR_X, GEO_SHEAR_Y, GEO_TRANS_X, GEO_TRANS_Y = 11, 12, 13, 14
NUM_OPS = 15
_GEO_IDS = (GEO_ROTATE, GEO_SHEAR_X, GEO_SHEAR_Y, GEO_TRANS_X, GEO_TRANS_Y)


def _bc(v: torch.Tensor) -> torch.Tensor:
    """Per-clip [N] -> broadcast over [N, T, H, W, C]."""
    return v.reshape(-1, 1, 1, 1, 1)


# --- color ops: [N, T, H, W, C] float in [0, 255] ---------------------------


def autocontrast(x: torch.Tensor) -> torch.Tensor:
    """Per-frame per-channel min/max stretch (PIL autocontrast, cutoff 0)."""
    lo = torch.amin(x, dim=(2, 3), keepdim=True)
    hi = torch.amax(x, dim=(2, 3), keepdim=True)
    # a true division: `255.0 / t` would multiply by a rounded reciprocal
    scale = torch.full_like(lo, 255.0) / torch.clamp(hi - lo, min=1.0)
    return torch.where(hi > lo, _round_u8((x - lo) * scale), x)


def equalize(x: torch.Tensor) -> torch.Tensor:
    """Histogram equalization per frame and channel (PIL equalize), in exact
    integer arithmetic: a 256-bin histogram per row, the PIL step
    ``(total - last_nonzero_count) // 255``, the lookup table
    ``(cumsum_before + step // 2) // step`` and identity where step is 0."""
    n, t, h, w, c = x.shape
    v = x.clamp(0, 255).to(torch.int64).permute(0, 1, 4, 2, 3).reshape(n * t * c, h * w)
    rows = v.shape[0]
    offs = torch.arange(rows, device=x.device).unsqueeze(1) * 256
    hist = torch.bincount((v + offs).reshape(-1), minlength=rows * 256).reshape(rows, 256)
    last_idx = 255 - torch.argmax((hist > 0).flip(1).to(torch.int8), dim=1)
    last_count = hist.gather(1, last_idx.unsqueeze(1)).squeeze(1)
    step = (h * w - last_count) // 255
    cum_prev = torch.cumsum(hist, dim=1) - hist
    lut = ((cum_prev + (step // 2).unsqueeze(1)) // step.clamp(min=1).unsqueeze(1)).clamp(0, 255)
    out = lut.gather(1, v).to(x.dtype).reshape(n, t, c, h, w).permute(0, 1, 3, 4, 2)
    return torch.where((step > 0).reshape(n, t, 1, 1, c), out, x)


def invert(x: torch.Tensor) -> torch.Tensor:
    return 255.0 - x


def posterize(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Keep the top ``bits`` bits; identity where bits < 1."""
    b = _bc(bits)
    shift = 8 - b.to(torch.int32).clamp(0, 8)
    post = ((x.to(torch.int32) >> shift) << shift).to(x.dtype)
    return torch.where(b >= 1, post, x)


def solarize(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= _bc(thresh), 255.0 - x, x)


def solarize_add(x: torch.Tensor, add: torch.Tensor, thresh: float = 128.0) -> torch.Tensor:
    """timm solarize_add with the integral added constant."""
    return torch.where(x < thresh, torch.clamp(x + _bc(torch.floor(add)), 0, 255), x)


def sharpness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance.Sharpness: blend with the 3x3 smoothing filter
    [[1,1,1],[1,5,1],[1,1,1]]/13, border pixels kept."""
    n, t, h, w, c = x.shape
    k = [[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]
    pad = F.pad(x.reshape(n * t, h, w, c).permute(0, 3, 1, 2), (1, 1, 1, 1),
                mode="replicate").permute(0, 2, 3, 1).reshape(n, t, h + 2, w + 2, c)
    smooth = 0
    for i in range(3):
        for j in range(3):
            smooth = smooth + (k[i][j] / 13.0) * pad[:, :, i:i + h, j:j + w, :]
    inner = torch.zeros((h, w), dtype=torch.bool, device=x.device)
    inner[1:-1, 1:-1] = True
    smooth = torch.where(inner[:, :, None], smooth, x)
    return _round_u8(smooth + _bc(factor) * (x - smooth))


# --- the plan -----------------------------------------------------------------


def parse_ra_config(config_str: str, num_ops: Optional[int] = None):
    """'rand-m7-n4-mstd0.5-inc1' -> (magnitude, n, mstd, inc)."""
    magnitude, n, mstd, inc = 10.0, 2, 0.0, False
    for part in config_str.split("-")[1:]:
        m = re.match(r"([a-z]+)([\d.]+)", part)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if key == "m":
            magnitude = float(val)
        elif key == "n":
            n = int(val)
        elif key == "mstd":
            mstd = float(val)
        elif key == "inc":
            inc = bool(int(val))
    if num_ops is not None:
        n = num_ops
    return magnitude, n, mstd, inc


def _slot_inv_matrix(sel, sign, m_eff, size: int, frac_shear=0.3,
                     frac_trans=0.45, frac_rot=30.0) -> torch.Tensor:
    """Inverse affine [N, 3, 3] per clip for one slot, in target-size pixel
    coordinates; the identity where ``sel`` is a color op."""
    shear_v = sign * m_eff * frac_shear / _LEVEL_DENOM
    trans_v = sign * m_eff * frac_trans / _LEVEL_DENOM * size
    theta = -sign * m_eff * frac_rot / _LEVEL_DENOM * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    ctr = (size - 1) / 2.0
    one, zero = torch.ones_like(m_eff), torch.zeros_like(m_eff)

    def mat(a, b, c, d, e, f):
        return torch.stack([
            torch.stack([a, b, c], -1), torch.stack([d, e, f], -1),
            torch.stack([zero, zero, one], -1),
        ], -2)

    mats = {
        GEO_ROTATE: mat(cos, -sin, ctr - cos * ctr + sin * ctr,
                        sin, cos, ctr - sin * ctr - cos * ctr),
        GEO_SHEAR_X: mat(one, shear_v, zero, zero, one, zero),
        GEO_SHEAR_Y: mat(one, zero, zero, shear_v, one, zero),
        GEO_TRANS_X: mat(one, zero, trans_v, zero, one, zero),
        GEO_TRANS_Y: mat(one, zero, zero, zero, one, trans_v),
    }
    out = mat(one, zero, zero, zero, one, zero)
    for gid, m in mats.items():
        out = torch.where((sel == gid)[:, None, None], m, out)
    return out


class FusedRandAugment:
    """``sample(n, generator)`` -> plan {'sel' [N,n], 'm_eff' [N,n],
    'sign' [N,n]}; ``color_apply(clips, plan)`` runs the color slots in
    order, each op over the clips that sampled it."""

    def __init__(self, config_str: str, num_ops: Optional[int] = None):
        self.magnitude, self.n, self.mstd, self.inc = parse_ra_config(config_str, num_ops)

    def sample(self, n: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        dev = generator.device
        sel = torch.randint(0, NUM_OPS, (n, self.n), generator=generator, device=dev)
        m_eff = torch.full((n, self.n), self.magnitude, device=dev)
        if self.mstd > 0:
            noise = torch.randn((n, self.n), generator=generator, device=dev)
            m_eff = torch.clamp(self.magnitude + self.mstd * noise, 0.0, _LEVEL_DENOM)
        u = torch.rand((n, self.n), generator=generator, device=dev)
        sign = torch.where(u < 0.5, 1.0, -1.0)
        return {"sel": sel, "m_eff": m_eff, "sign": sign}

    def _lvl(self, m, frac):
        return m / _LEVEL_DENOM * frac

    def _enh(self, m, sign):
        return 1.0 + self._lvl(m, 0.9) * sign if self.inc else self._lvl(m, 1.8) + 0.1

    def _op(self, op: int, x, m, sign):
        if op == OP_AUTOCONTRAST:
            return autocontrast(x)
        if op == OP_EQUALIZE:
            return equalize(x)
        if op == OP_INVERT:
            return invert(x)
        if op == OP_POSTERIZE:
            lvl = self._lvl(m, 4.0)
            return posterize(x, torch.floor(4.0 - lvl) if self.inc else torch.floor(lvl))
        if op == OP_SOLARIZE:
            lvl = self._lvl(m, 256.0)
            return solarize(x, 256.0 - lvl if self.inc else lvl)
        if op == OP_SOLARIZE_ADD:
            return solarize_add(x, self._lvl(m, 110.0))
        if op == OP_COLOR:
            return adjust_saturation(x, _bc(self._enh(m, sign)))
        if op == OP_CONTRAST:
            return adjust_contrast(x, _bc(self._enh(m, sign)))
        if op == OP_BRIGHTNESS:
            return adjust_brightness(x, _bc(self._enh(m, sign)))
        if op == OP_SHARPNESS:
            return sharpness(x, self._enh(m, sign))
        return x  # geometric slots: already in the warp

    def _by_slot(self, clips: torch.Tensor, plan: Dict[str, torch.Tensor], op_fn,
                 skip=()) -> torch.Tensor:
        """Slot by slot, each op that some clips chose, run by ``op_fn(op,
        clips, m_eff, sign)`` once over those clips, which are gathered and
        scattered back into one copy of ``clips``."""
        dev = clips.device
        clips = clips.clone()
        sel_host = plan["sel"].tolist()
        m_eff, sign = plan["m_eff"].to(dev), plan["sign"].to(dev)
        for i in range(self.n):
            for op in sorted({row[i] for row in sel_host}):
                if op in skip:
                    continue
                idx = torch.tensor([k for k, row in enumerate(sel_host) if row[i] == op], device=dev)
                sub = op_fn(op, clips.index_select(0, idx), m_eff[idx, i], sign[idx, i])
                clips.index_copy_(0, idx, sub)
        return clips

    def color_apply(self, clips: torch.Tensor, plan: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The color slots in order (the geometric ones are in the warp)."""
        return self._by_slot(clips, plan, self._op, skip=_GEO_IDS)


def fused_warp_coords(plan: Dict[str, torch.Tensor], box: torch.Tensor,
                      flip: torch.Tensor, size: int):
    """Compose flip -> RandAugment geometric slots (reverse order) -> RRC box
    into source coordinates in the ingest frame, with the staged fill mask.
    ``box`` [N, 4] (top, left, height, width), ``flip`` [N] bool. Returns
    (sx, sy, valid), each [N, size, size]; pixel centres follow PIL's resize,
    src = left + (x + 0.5) * bw / size - 0.5."""
    dev = box.device
    n = box.shape[0]
    ar = torch.arange(size, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    cur_x = torch.where(flip[:, None, None], (size - 1) - gx, gx)
    cur_y = gy.expand(n, size, size)
    valid = torch.ones((n, size, size), dtype=torch.bool, device=dev)
    sel, sign, m_eff = plan["sel"], plan["sign"], plan["m_eff"]
    for i in reversed(range(sel.shape[1])):
        m = _slot_inv_matrix(sel[:, i], sign[:, i], m_eff[:, i], size)
        a, b, c = (m[:, 0, k, None, None] for k in range(3))
        d, e, f = (m[:, 1, k, None, None] for k in range(3))
        nx = a * cur_x + b * cur_y + c
        ny = d * cur_x + e * cur_y + f
        cur_x, cur_y = nx, ny
        inb = (nx >= -0.5) & (nx <= size - 0.5) & (ny >= -0.5) & (ny <= size - 0.5)
        is_geo = torch.zeros_like(sel[:, i], dtype=torch.bool)
        for g in _GEO_IDS:
            is_geo |= sel[:, i] == g
        valid &= torch.where(is_geo[:, None, None], inb, True)
    top, left, bh, bw = (box[:, k, None, None] for k in range(4))
    sx = left + (cur_x + 0.5) * (bw / size) - 0.5
    sy = top + (cur_y + 0.5) * (bh / size) - 0.5
    return sx, sy, valid


def warp_gather(clips: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                valid: torch.Tensor, fill: float = 128.0) -> torch.Tensor:
    """One bilinear gather of clips [N, T, H, W, C] (any dtype) at (sy, sx)
    [N, S, S] with edge clamping, and ``fill`` where ``valid`` is False.
    Returns float32 [N, T, S, S, C] rounded to the uint8 grid."""
    n, t, h, w, c = clips.shape
    s1, s2 = sx.shape[1:]
    flat = clips.permute(0, 2, 3, 1, 4).reshape(n * h * w, t * c)
    base = (torch.arange(n, device=clips.device) * (h * w)).reshape(n, 1, 1)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0).reshape(-1, 1)
    wy = (sy - y0).reshape(-1, 1)

    def gather(yi, xi):
        xi = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yi, 0, h - 1).to(torch.int64)
        return flat.index_select(0, (base + yi * w + xi).reshape(-1)).to(torch.float32)

    out = (
        gather(y0, x0) * (1 - wx) * (1 - wy)
        + gather(y0, x0 + 1) * wx * (1 - wy)
        + gather(y0 + 1, x0) * (1 - wx) * wy
        + gather(y0 + 1, x0 + 1) * wx * wy
    )
    out = torch.where(valid.reshape(-1, 1), out, fill)
    out = out.reshape(n, s1, s2, t, c).permute(0, 3, 1, 2, 4)
    return _round_u8(out)


# --- the op-exact path (AUG.FUSED_RA False) ------------------------------------


def cubic_weights(frac: torch.Tensor):
    """PIL's transform bicubic taps at offsets (-1, 0, 1, 2) from the floor
    sample: the Keys cubic at a = -1 (not the resize path's -0.5), with the
    JAX package's float32 operation order (``x ** 3`` as ``x * (x * x)``)."""
    a = -1.0

    def k(x):
        ax = torch.abs(x)
        ax2 = ax * ax
        ax3 = ax * ax2
        near = ((a + 2.0) * ax3 - (a + 3.0) * ax2) + 1.0
        far = ((a * ax3 - (5.0 * a) * ax2) + (8.0 * a) * ax) - 4.0 * a
        return torch.where(ax <= 1.0, near, torch.where(ax < 2.0, far, torch.zeros_like(ax)))

    return [k(frac + 1.0), k(frac), k(frac - 1.0), k(frac - 2.0)]


def warp_affine(clips: torch.Tensor, inv: torch.Tensor, fill: float = 128.0,
                method: str = "bilinear") -> torch.Tensor:
    """PIL ``transform(AFFINE)`` of every frame of clips [N, T, H, W, C] by
    each clip's inverse matrix ``inv`` [N, 2, 3] (output (x, y) samples the
    input at (a x + b y + c, d x + e y + f)): bilinear, or ``'bicubic'``'s
    16 taps summed x inside y, each tap ``fill`` outside the frame, then
    rounded to the uint8 grid. The taps accumulate one at a time, so a
    group holds a few copies of itself, not 16."""
    n, t, h, w, c = clips.shape
    dev = clips.device
    inv = inv.to(dev, torch.float32)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    coef = [inv[:, r, k].view(n, 1, 1) for r in range(2) for k in range(3)]
    sx = (coef[0] * gx + coef[1] * gy) + coef[2]
    sy = (coef[3] * gx + coef[4] * gy) + coef[5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0).reshape(-1, 1), (sy - y0).reshape(-1, 1)
    flat = clips.permute(0, 2, 3, 1, 4).reshape(n * h * w, t * c)
    base = (torch.arange(n, device=dev) * (h * w)).view(n, 1, 1)

    def gather(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).reshape(-1, 1)
        xi = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yi, 0, h - 1).to(torch.int64)
        vals = flat.index_select(0, (base + yi * w + xi).reshape(-1)).to(torch.float32)
        return torch.where(valid, vals, fill)

    if method == "bicubic":
        kx, ky = cubic_weights(wx), cubic_weights(wy)
        out = None
        for j in range(4):
            row = None
            for i in range(4):
                tap = gather(y0 + (j - 1), x0 + (i - 1)) * kx[i]
                row = tap if row is None else row + tap
            term = row * ky[j]
            out = term if out is None else out + term
    else:
        out = (gather(y0, x0) * ((1 - wx) * (1 - wy)) + gather(y0, x0 + 1) * (wx * (1 - wy))
               + gather(y0 + 1, x0) * ((1 - wx) * wy) + gather(y0 + 1, x0 + 1) * (wx * wy))
    return _round_u8(out.reshape(n, h, w, t, c).permute(0, 3, 1, 2, 4))


def geo_inv(op: int, level: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse matrices [N, 2, 3] of a geometric op at its signed
    ``level`` per clip: shear by the level, translate by the level times
    the clip's width (x) or height (y), rotate by the level in degrees about
    ((w - 1) / 2, (h - 1) / 2)."""
    one, zero = torch.ones_like(level), torch.zeros_like(level)
    if op == GEO_ROTATE:
        theta = (-level * math.pi) / 180.0
        cos, sin = torch.cos(theta), torch.sin(theta)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        rows = [(cos, -sin, (cx - cos * cx) - (-sin) * cy), (sin, cos, (cy - sin * cx) - cos * cy)]
    elif op == GEO_SHEAR_X:
        rows = [(one, level, zero), (zero, one, zero)]
    elif op == GEO_SHEAR_Y:
        rows = [(one, zero, zero), (level, one, zero)]
    elif op == GEO_TRANS_X:
        rows = [(one, zero, level * w), (zero, one, zero)]
    else:
        rows = [(one, zero, zero), (zero, one, level * h)]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


_GEO_FRAC = {GEO_ROTATE: 30.0, GEO_SHEAR_X: 0.3, GEO_SHEAR_Y: 0.3, GEO_TRANS_X: 0.45, GEO_TRANS_Y: 0.45}


class ExactRandAugment(FusedRandAugment):
    """The op-exact RandAugment (``make_rand_augment``): the same plan as
    the fused path (``sample``), applied op after op by :meth:`apply`, the
    geometric ops as their own warps at ``interpolation``."""

    def __init__(self, config_str: str, num_ops: Optional[int] = None,
                 interpolation: str = "bilinear"):
        super().__init__(config_str, num_ops)
        self.method = "bicubic" if interpolation in ("bicubic", "cubic") else "bilinear"

    def _exact_op(self, op: int, x: torch.Tensor, m: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
        if op in _GEO_IDS:
            level = self._lvl(m, _GEO_FRAC[op]) * sign
            return warp_affine(x, geo_inv(op, level, x.shape[2], x.shape[3]), method=self.method)
        return self._op(op, x, m, sign)

    def apply(self, clips: torch.Tensor, plan: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Every slot in order on float clips [N, T, H, W, C] in [0, 255]."""
        return self._by_slot(clips, plan, self._exact_op)
