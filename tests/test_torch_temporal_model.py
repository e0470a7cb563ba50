"""The port's AdViSe model (advise_tpu_torch/models/clip_vit.py and
temporal_model.py) against the JAX package's CLIPViT and TemporalModel,
with the JAX initial variables passed through the param bridge
(advise_tpu_torch/utils/convert.py), on AdViSe.yaml cut to CPU size
(tests/torch_port_common.py ``tm_cfg``), float32.

Tolerances: outputs agree to 1e-5 of their largest magnitude (float32
matmul and reduction orders differ; measured <= 4.1e-6). The bf16 tower
(Flax ``dtype=bf16``) agrees with JAX's bf16 tower to 2e-2 of the largest
token (bf16 keeps 8 bits; the two sides round their matmuls' sums
differently; measured 9.2e-3). ``load_openclip_weights`` is held EQUAL to
JAX's loader: both only copy and reshape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models.clip_vit import CLIPViT as JCLIPViT
from advise_tpu.models.clip_vit import load_openclip_weights as jload_openclip
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.clip_vit import CLIPViT, load_openclip_weights
from advise_tpu_torch.models.temporal_model import TemporalModel
from advise_tpu_torch.utils.convert import flax_to_state_dict, params_to_torch

from torch_port_common import TM_S, TM_SWIN, TM_T, rel_err, tm_cfg, tm_variables

torch.set_num_threads(1)

TOL = 1e-5


def _port_model(tcfg, params, batch_stats):
    model = build_model(tcfg, "cpu")
    model.load_state_dict(flax_to_state_dict(params, batch_stats))
    return model


def _clips(n, seed=0, t=TM_T, s=TM_S):
    """Noise clips, each scaled and offset on its own, so that their pooled
    features differ from clip to clip as videos' do (the heads' train-mode
    BN normalises by that spread)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, s, s, 3))
    x = x * rng.uniform(0.25, 2.0, (n, 1, 1, 1, 1)) + rng.standard_normal((n, 1, 1, 1, 3))
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_tower_matches_jax(dtype):
    """Pooled output and tokens of a 2-layer, 2-head tower at 32^2, patch 16."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    jm = JCLIPViT(width=128, layers=2, heads=2, patch_size=16, image_size=32, output_dim=24, dtype=jdt)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))())
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params["params"], jnp.asarray(x))
    tm = CLIPViT(width=128, layers=2, heads=2, patch_size=16, image_size=32, output_dim=24, dtype=tdt)
    tm.load_state_dict(params_to_torch(params["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    tol = 2e-2 if dtype == "bfloat16" else TOL
    for g, w in zip(got, want):
        assert g.dtype == (torch.bfloat16 if tdt else torch.float32)
        assert tuple(g.shape) == tuple(w.shape)
        assert rel_err(g.float().numpy(), np.asarray(w, np.float32)) <= tol


def _both(t_arch, **overrides):
    jcfg = tm_cfg(jconfig, **{"TM.TEMPORAL_ARCH": t_arch, **overrides})
    tcfg = tm_cfg(tconfig, **{"TM.TEMPORAL_ARCH": t_arch, **overrides})
    jm = jbuild_model(jcfg, sync_axes=())
    params, batch_stats = tm_variables(jm, t=tcfg.DATA.NUM_FRAMES, s=tcfg.AUG.TARGET_SIZE)
    return jcfg, tcfg, jm, params, batch_stats


def _check_forward(jm, params, batch_stats, model, byol):
    """Features, logits and (BYOL) projection and prediction, in eval mode
    and in train mode (batch statistics in the BN layers)."""
    x = _clips(4, t=model.cfg.DATA.NUM_FRAMES, s=model.cfg.AUG.TARGET_SIZE)
    variables = {"params": params, "batch_stats": batch_stats}
    for train in (False, True):
        model.train(train)

        def fwd(v, x):
            kw = dict(mutable=["batch_stats"]) if train else {}

            def run(method, inp):
                out = jm.apply(v, inp, train=train, method=method, **kw)
                return out[0] if train else out

            feat = run("features", x)
            outs = [feat, run("classify", feat)]
            if byol:
                proj = run("project", feat)
                outs += [proj, run("predict", proj)]
            return outs

        want = jax.jit(fwd)(variables, jnp.asarray(x))
        with torch.no_grad():
            feat = model.features(torch.from_numpy(x))
            got = [feat, model.classify(feat)]
            if byol:
                proj = model.project(feat)
                got += [proj, model.predict(proj)]
        for i, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == tuple(w.shape)
            assert rel_err(g.numpy(), w) <= TOL, (train, i, rel_err(g.numpy(), w))


ARCH_OVERRIDES = {"video_swin": TM_SWIN}


@pytest.mark.parametrize("t_arch", ["conv3d", "tfmer_enc", "resnet3d", "video_swin"])
def test_temporal_model_matches_jax(t_arch):
    """Each ported temporal arch under SSL.TASK speed_byol (head BN on,
    the AdViSe default); video_swin at TM_SWIN's geometry, where its
    windows pad and shift."""
    _, tcfg, jm, params, batch_stats = _both(t_arch, **{"SSL.TASK": "speed_byol", **ARCH_OVERRIDES.get(t_arch, {})})
    model = _port_model(tcfg, params, batch_stats)
    assert isinstance(model, TemporalModel)
    _check_forward(jm, params, batch_stats, model, byol=True)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(_clips(2, t=tcfg.DATA.NUM_FRAMES, s=tcfg.AUG.TARGET_SIZE)))
    assert tuple(logits.shape) == (2, tcfg.MODEL.NUM_CLASSES)


BRIDGES = {
    "temporal_cat": {"TM.TEMPORAL_CAT": True},
    "temporal_cat_pooled": {"TM.TEMPORAL_CAT": True, "MODEL.TEMPORAL_EMBEDDING_DIM": 8},
    "linear_proj": {"TM.TEMPORAL_CAT": True, "TM.LINEAR_PROJ": True},
    "pools": {"TM.CHANNEL_POOL_DIM": 64, "TM.SPATIAL_POOL_DIM": 1},
    "skip_tm": {"TM.SKIP_TM": True, "SSL.NUM_MLP_LAYERS": 1},
}


@pytest.mark.parametrize("bridge", sorted(BRIDGES))
def test_bridges_match_jax(bridge):
    """TM.TEMPORAL_CAT (t_dim 4 = T, and t_dim 2 pooling 4 frames to 2),
    with TM.LINEAR_PROJ (its channel-major flatten), the channel and spatial
    pools (ks 1 convs over a 1 x 1 grid), and TM.SKIP_TM with a Linear head."""
    t_arch = "tfmer_enc" if bridge == "skip_tm" else "conv3d"
    _, tcfg, jm, params, batch_stats = _both(t_arch, **BRIDGES[bridge])
    model = _port_model(tcfg, params, batch_stats)
    if bridge == "linear_proj":
        assert "bridge_proj.weight" in model.state_dict()
    _check_forward(jm, params, batch_stats, model, byol=False)


def test_video_swin_raises():
    """video_swin keeps the width: a channel pool that differs from
    TEMPORAL_EMBEDDING_DIM raises, where JAX's setup asserts."""
    over = {**TM_SWIN, "TM.CHANNEL_POOL_DIM": 32}
    with pytest.raises(ValueError, match="TEMPORAL_EMBEDDING_DIM"):
        build_model(tm_cfg(tconfig, **over), "cpu")
    with pytest.raises(AssertionError):
        jbuild_model(tm_cfg(jconfig, **over), sync_axes=()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 6, 128, 128, 3)), train=False)


def _openclip_state_dict(rng, width, layers, grid, out):
    """Random weights in open_clip's visual.* state-dict layout."""

    def t(*shape):
        return torch.tensor(rng.normal(0, 0.05, size=shape).astype(np.float32))

    sd = {"visual.class_embedding": t(width), "visual.positional_embedding": t(grid * grid + 1, width),
          "visual.proj": t(width, out), "visual.conv1.weight": t(width, 3, 16, 16)}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"], sd[f"visual.{ln}.bias"] = t(width) + 1.0, t(width)
    for i in range(layers):
        p = f"visual.transformer.resblocks.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = t(width) + 1.0, t(width)
        sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"] = t(3 * width, width), t(3 * width)
        sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"] = t(width, width), t(width)
        sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"] = t(4 * width, width), t(4 * width)
        sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"] = t(width, 4 * width), t(width)
    return sd


def test_load_openclip_weights_matches_jax(tmp_path):
    """A synthetic open_clip checkpoint into both packages' towers (the
    TemporalModel's spatial_encoder: width 128, 2 layers, 2 heads, 32^2,
    proj to 512): the port's loaded tower EQUALS JAX's loaded params through
    the bridge, and a wrong shape raises."""
    tcfg = tm_cfg(tconfig)
    model = build_model(tcfg, "cpu")
    enc = model.spatial_encoder
    sd = _openclip_state_dict(np.random.default_rng(0), 128, 2, 2, 512)
    path = tmp_path / "open_clip_pytorch_model.bin"
    torch.save(sd, path)
    jm = JCLIPViT(width=128, layers=2, heads=2, patch_size=16, image_size=32, output_dim=512)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    want = params_to_torch(jax.device_get(jload_openclip(str(path), jparams)))
    load_openclip_weights(str(path), enc)
    got = enc.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sd["visual.proj"] = sd["visual.proj"][:, :8]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="proj"):
        load_openclip_weights(str(path), enc)
