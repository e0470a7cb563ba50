"""The port's single-pathway 3D ResNet (advise_tpu_torch/models/resnet3d.py)
and speed losses (advise_tpu_torch/models/losses.py) against the JAX
package's, with the JAX initial variables passed through the param bridge.

Presets (tests/torch_port_common.py SPEED_PRESETS): Slow and I3D at
RESNET.DEPTH 10 (bottleneck), and the R18 smoke preset (basic transform),
float32, 4 clips of 4 x 32 x 32.

Tolerances (float32). Eval mode normalizes with the running statistics:
1e-5 relative to the largest logit (measured below 2e-6). Train mode
normalizes the head's BN-MLP over the 4 clips of the batch, which turns
float32 rounding of sums taken in another order into up to 1e-4 of the
largest logit (measured), held to 1e-3. The parameter gradients of a
weighted sum of the logits: 2e-3 of each tensor's largest entry (measured
below 3e-4). BN running statistics: 1e-5 (measured below 5e-6). The losses
are elementwise float32 formulas and reductions of a few hundred terms:
1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models import losses as JL
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models import losses as TL
from advise_tpu_torch.models.layers.norm import commit_bn_stats, get_norm
from advise_tpu_torch.models.resnet3d import ResNet3D
from advise_tpu_torch.utils.convert import batch_stats_to_torch, flax_to_state_dict

from torch_port_common import (
    SPEED_PRESETS,
    SPEED_S,
    SPEED_T,
    rel_err,
    speed_cfg,
    speed_variables,
)

torch.set_num_threads(1)

N_CLIPS = 4


@pytest.fixture(scope="module", params=sorted(SPEED_PRESETS))
def models(request):
    jcfg, tcfg = speed_cfg(jconfig, request.param), speed_cfg(tconfig, request.param)
    jm = jbuild_model(jcfg, sync_axes=())
    params, batch_stats = speed_variables(jm)
    tm = build_model(tcfg, "cpu")
    x = np.random.default_rng(0).standard_normal(
        (N_CLIPS, SPEED_T, SPEED_S, SPEED_S, 3)).astype(np.float32)
    return tcfg, jm, params, batch_stats, tm, x


def test_bridge_maps_every_leaf_and_param_counts_match(models):
    """Every Flax leaf (head/projection/fc*, bn* included) lands on a port
    parameter or buffer of the same shape, nothing of the port is left out,
    and the parameter counts are equal."""
    _, _, params, batch_stats, tm, _ = models
    assert isinstance(tm, ResNet3D)
    sd = flax_to_state_dict(params, batch_stats)
    own = tm.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    assert any(k.startswith("head.projection.bn0.") for k in sd)
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in tm.parameters())


def test_train_forward_and_grads_match_jax(models):
    """Train mode: the logits, the updated running statistics and the
    parameter gradients of sum(logits * w)."""
    tcfg, jm, params, batch_stats, tm, x = models
    wts = np.random.default_rng(1).standard_normal(
        (N_CLIPS, tcfg.MODEL.NUM_CLASSES)).astype(np.float32)

    def jloss(p):
        out, mut = jm.apply({"params": p, "batch_stats": batch_stats}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * wts), (out, mut)

    (_, (out_j, mut)), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm.load_state_dict(flax_to_state_dict(params, batch_stats))
    tm.train()
    tm.zero_grad()
    out_t = tm(torch.from_numpy(x))
    (out_t * torch.from_numpy(wts)).sum().backward()
    commit_bn_stats(tm)
    assert rel_err(out_t.detach().numpy(), out_j) <= 1e-3
    grads = {n: p.grad for n, p in tm.named_parameters()}
    for k, want in flax_to_state_dict(jax.device_get(g_j), {}).items():
        assert rel_err(grads[k].numpy(), want.numpy()) <= 2e-3, k
    own = tm.state_dict()
    for k, want in batch_stats_to_torch(jax.device_get(mut["batch_stats"])).items():
        np.testing.assert_allclose(own[k].numpy(), want.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


def test_full_width_slow_r50_param_count():
    """SpeedPro's Slow R50 with its 2 x 4096 BN-MLP head: the JAX package's
    oracle count (tests/test_models.py), built on the meta device."""
    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/pretrain/SpeedPro_R50.yaml")
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg = tconfig.assert_and_infer_cfg(cfg)
    with torch.device("meta"):
        model = ResNet3D(cfg, get_norm(cfg))
    assert sum(p.numel() for p in model.parameters()) == 40_047_684


def test_eval_forward_matches_jax(models):
    _, jm, params, batch_stats, tm, x = models
    out_j = jm.apply({"params": params, "batch_stats": batch_stats}, x, train=False)
    tm.load_state_dict(flax_to_state_dict(params, batch_stats))
    tm.eval()
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x))
    assert rel_err(out_t.numpy(), out_j) <= 1e-5


def _logits(shape=(12, 4), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3


LOSS_CASES = {
    "cross_entropy": lambda m, lg, lb, oh: m.cross_entropy(lg, lb),
    "soft_cross_entropy": lambda m, lg, lb, oh: m.soft_cross_entropy(lg, oh * 0.9 + 0.025),
    "bce_logit": lambda m, lg, lb, oh: m.bce_logit(lg, oh),
    "bce_logit_smoothed": lambda m, lg, lb, oh: m.bce_logit(lg, oh, smoothing=0.05),
    "top1": lambda m, lg, lb, oh: m.top_k_accuracy(lg, lb, k=1),
    "top3": lambda m, lg, lb, oh: m.top_k_accuracy(lg, lb, k=3),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    logits = _logits()
    labels = np.random.default_rng(1).integers(0, 4, 12)
    onehot = np.eye(4, dtype=np.float32)[labels]
    fn = LOSS_CASES[name]
    want = float(fn(JL, jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(onehot)))
    got = fn(TL, torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(onehot))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_losses_compute_in_float32_from_bf16_logits():
    logits = _logits()
    labels = np.random.default_rng(2).integers(0, 4, 12)
    want = float(JL.cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels)))
    got = TL.cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and float(got) == pytest.approx(want, rel=1e-6)


def test_margin_ranking_intra_matches_jax():
    """x [B, C, T] with the true transform per class: the speed step's
    'margin' metric."""
    x = _logits((3, 4, 5), seed=3)
    target = np.random.default_rng(4).integers(0, 5, (3, 4))
    want = float(JL.margin_ranking_intra(jnp.asarray(x), jnp.asarray(target), 0.5))
    got = TL.margin_ranking_intra(torch.from_numpy(x), torch.from_numpy(target), 0.5)
    assert float(got) == pytest.approx(want, rel=1e-6)
