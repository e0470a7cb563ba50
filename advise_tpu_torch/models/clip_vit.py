"""CLIP vision transformer, open_clip's visual tower (counterpart of
``advise_tpu/models/clip_vit.py``): the AdViSe spatial encoder.

conv1 (a patch conv) -> class embedding + positional embedding -> ln_pre
-> ``layers`` pre-LN blocks -> ln_post; ``forward`` returns ``(pooled,
tokens)``: the class token times ``proj`` and the patch tokens at the
encoder's width.

Precision follows the Flax modules' ``dtype``: with ``dtype`` bf16 every
conv and matmul takes its weights cast to bf16, and each LayerNorm computes
its statistics and normalisation in float32 and returns bf16 (autocast's
``layer_norm`` would return float32, so the cast is explicit). The
residual stream then stays bf16, as in JAX. The attention is Flax's
``MultiHeadDotProductAttention`` written out (the query scaled by
1/sqrt(head dim), softmax, weighted sum): it is XLA in the reference, so
it owes no kernel here.

Module and parameter names are the Flax ones (``resblocks_{i}``, ``attn``
with ``query``/``key``/``value``/``out``, ``mlp_fc``, ``mlp_proj``), so
``utils/convert.py`` maps a Flax tree onto this module's ``state_dict``;
:func:`load_openclip_weights` reads an open_clip checkpoint instead.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import dense, lecun_normal_init

logger = logging.getLogger(__name__)


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


def linear(fc: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)``: input and weights cast to ``dtype``."""
    return F.linear(_cast(x, dtype), _cast(fc.weight, dtype), _cast(fc.bias, dtype))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dtype)``: float32 statistics and affine, the
    result in ``dtype`` (float32 when None)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(dtype or torch.float32)


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (self-attention): q, k, v
    projections to ``heads`` x head_dim, softmax(q k^T / sqrt(head_dim)) v,
    the out projection. Linear weights [heads * head_dim, width] hold the
    Flax DenseGeneral kernels [width, heads, head_dim] flattened."""

    def __init__(self, width: int, heads: int, qkv_features: Optional[int] = None,
                 out_features: Optional[int] = None):
        super().__init__()
        qkv = qkv_features or width
        if qkv % heads:
            raise ValueError(f"{qkv} features do not split into {heads} heads")
        self.heads = heads
        self.query = dense(width, qkv, init=lecun_normal_init)
        self.key = dense(width, qkv, init=lecun_normal_init)
        self.value = dense(width, qkv, init=lecun_normal_init)
        self.out = dense(qkv, out_features or width, init=lecun_normal_init)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        b, n, _ = x.shape
        dt = dtype or x.dtype
        q, k, v = (linear(fc, x, dtype).reshape(b, n, self.heads, -1).transpose(1, 2)
                   for fc in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), dim=-1).to(dt)
        y = torch.matmul(w, v).transpose(1, 2).reshape(b, n, -1)
        return linear(self.out, y, dtype)


class ResidualAttentionBlock(nn.Module):
    """ln_1 -> attention -> residual; ln_2 -> Dense 4w -> exact GELU ->
    Dense w -> residual."""

    def __init__(self, width: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = dense(width, width * 4, init=lecun_normal_init)
        self.mlp_proj = dense(width * 4, width, init=lecun_normal_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.ln_1, x, self.dtype), self.dtype)
        y = F.gelu(linear(self.mlp_fc, layer_norm(self.ln_2, x, self.dtype), self.dtype))
        return x + linear(self.mlp_proj, y, self.dtype)


def _normal(std: float):
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.normal_(w, 0.0, std, generator=generator)

    return init


class CLIPViT(nn.Module):
    """open_clip VisionTransformer (ViT-B/16: width 768, 12 layers, 12 heads,
    patch 16, 224^2). Input [B, H, W, 3]; output (pooled [B, output_dim],
    tokens [B, (H/patch)^2, width])."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12, patch_size: int = 16,
                 image_size: int = 224, output_dim: int = 512, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.width = width
        self.patch_size = patch_size
        self.dtype = dtype
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.conv1.weight_init = lecun_normal_init
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        for i in range(layers):
            self.add_module(f"resblocks_{i}", ResidualAttentionBlock(width, heads, dtype))
        self.layers = layers
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, output_dim))
        std = width ** -0.5
        self.param_inits = {"class_embedding": _normal(std), "positional_embedding": _normal(std),
                            "proj": _normal(std)}

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.conv1.weight.to(dt), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, grid^2, width], row-major over the grid
        cls = self.class_embedding.to(dt).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = layer_norm(self.ln_pre, x, dt)
        for i in range(self.layers):
            x = getattr(self, f"resblocks_{i}")(x)
        x = layer_norm(self.ln_post, x, dt)
        pooled = x[:, 0] @ self.proj.to(dt)
        return pooled, x[:, 1:]


def _put(name: str, value: torch.Tensor, sd: Dict[str, torch.Tensor]) -> None:
    want = tuple(sd[name].shape)
    if tuple(value.shape) != want:
        raise ValueError(f"open_clip weight for {name}: shape {tuple(value.shape)}, expected {want}")
    sd[name] = value.float()


@torch.no_grad()
def load_openclip_weights(path: str, module: CLIPViT) -> CLIPViT:
    """Read an open_clip torch checkpoint's visual tower (``visual.*``) into
    ``module`` in place (the reference's ``load_spatial_model``): the
    attention's packed ``in_proj_weight`` [3w, w] splits into query, key and
    value; every shape is checked."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    vis = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    out = module.state_dict()
    for name in ("class_embedding", "positional_embedding", "proj", "conv1.weight"):
        _put(name, vis[name], out)
    for ln in ("ln_pre", "ln_post"):
        for leaf in ("weight", "bias"):
            _put(f"{ln}.{leaf}", vis[f"{ln}.{leaf}"], out)
    layers = len({k.split(".")[2] for k in vis if k.startswith("transformer.resblocks")})
    for i in range(layers):
        src, dst = f"transformer.resblocks.{i}.", f"resblocks_{i}."
        for ln in ("ln_1", "ln_2"):
            for leaf in ("weight", "bias"):
                _put(f"{dst}{ln}.{leaf}", vis[f"{src}{ln}.{leaf}"], out)
        w, bias = vis[src + "attn.in_proj_weight"], vis[src + "attn.in_proj_bias"]
        width = w.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            _put(f"{dst}attn.{name}.weight", w[j * width:(j + 1) * width], out)
            _put(f"{dst}attn.{name}.bias", bias[j * width:(j + 1) * width], out)
        for leaf in ("weight", "bias"):
            _put(f"{dst}attn.out.{leaf}", vis[f"{src}attn.out_proj.{leaf}"], out)
            _put(f"{dst}mlp_fc.{leaf}", vis[f"{src}mlp.c_fc.{leaf}"], out)
            _put(f"{dst}mlp_proj.{leaf}", vis[f"{src}mlp.c_proj.{leaf}"], out)
    module.load_state_dict(out)
    logger.info("ported open_clip visual tower from %s", path)
    return module
