"""The port's model (advise_tpu_torch/models) against the JAX package's,
module by module, with the JAX initial variables passed through the param
bridge (advise_tpu_torch/utils/convert.py).

Tolerances (float32 unless stated): a layer's output agrees to float32
rounding of sums taken in another order, 1e-5 relative to its largest
value. The whole model normalizes its head MLP over 2 samples per view,
which turns such rounding into up to 2.5e-4 of the output (measured), so
it is held to 1e-3 relative to its largest output. BN running statistics
are held to 1e-5.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu import config as jconfig
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models.layers.heads import ResNetBasicHead as JHead
from advise_tpu.models.layers.norm import SyncBatchNorm as JBN
from advise_tpu.models.layers.resnet import ResBlock as JResBlock
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.heads import ResNetBasicHead
from advise_tpu_torch.models.layers.norm import SyncBatchNorm, commit_bn_stats
from advise_tpu_torch.models.layers.resnet import ResBlock
from advise_tpu_torch.utils.convert import batch_stats_to_torch, flax_to_state_dict

from torch_port_common import both_cfgs, jax_variables, rel_err, views

torch.set_num_threads(1)


def test_config_copy_matches_jax_config():
    """The port carries its own copy of the config surface; it must equal
    the JAX package's, defaults and the inferred preset alike."""
    assert tconfig.get_cfg() == jconfig.get_cfg()
    jcfg, tcfg = both_cfgs()
    assert jcfg == tcfg


@pytest.mark.parametrize("views_n,num_splits", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_batchnorm_matches_jax(views_n, num_splits, dtype):
    """Per-view (vmapped in JAX) and per-split statistics, the FMA in the
    input dtype, the unbiased running variance. bf16 output: one bf16 ulp
    (2^-8 relative) of the largest value."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((views_n, 4, 3, 5, 5, 6)) * 2 + 1).astype(np.float32)
    scale = rng.standard_normal(6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    bn = JBN(num_splits=num_splits)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}}
    apply = functools.partial(bn.apply, train=True, mutable=["batch_stats"])
    y_j, mut = jax.vmap(lambda v: apply(variables, v))(jnp.asarray(x, jdt))
    stats_j = jax.tree_util.tree_map(lambda s: s.mean(0), mut["batch_stats"])

    tbn = SyncBatchNorm(6, num_splits=num_splits)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xt = torch.from_numpy(x).to(tdt).reshape(views_n * 4, 3, 5, 5, 6).permute(0, 4, 1, 2, 3)
    y_t = tbn(xt, views=views_n)
    commit_bn_stats(tbn)
    assert y_t.dtype == tdt
    got = y_t.detach().permute(0, 2, 3, 4, 1).float().reshape(x.shape).numpy()
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    assert rel_err(got, np.asarray(y_j, np.float32)) <= tol
    np.testing.assert_allclose(tbn.running_mean.numpy(), stats_j["mean"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(), stats_j["var"], atol=1e-5, rtol=1e-5)


def test_bottleneck_block_matches_jax():
    """A strided bottleneck ResBlock with a projection shortcut: forward,
    running statistics, and the parameter gradients of sum(y * sin(y))."""
    norm = functools.partial(JBN, sync_axes=())
    jb = JResBlock(dim_in=8, dim_out=16, dim_inner=4, temp_kernel_size=3, stride=2, norm=norm)
    x = np.random.default_rng(2).standard_normal((2, 4, 8, 8, 8)).astype(np.float32)
    v = jb.init(jax.random.PRNGKey(3), jnp.asarray(x), False)

    def jloss(p):
        y, mut = jb.apply({"params": p, "batch_stats": v["batch_stats"]}, x, True,
                          mutable=["batch_stats"])
        return jnp.sum(y * jnp.sin(y)), (y, mut)

    (_, (y_j, mut)), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])

    tb = ResBlock(8, 16, 4, 3, 2, SyncBatchNorm)
    tb.load_state_dict(flax_to_state_dict(jax.device_get(v["params"]),
                                          jax.device_get(v["batch_stats"])))
    y_t = tb(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    torch.sum(y_t * torch.sin(y_t)).backward()
    commit_bn_stats(tb)
    assert rel_err(y_t.detach().permute(0, 2, 3, 4, 1).numpy(), y_j) <= 1e-5
    grads = {n: p.grad for n, p in tb.named_parameters()}
    for k, want in flax_to_state_dict(jax.device_get(g_j), {}).items():
        assert rel_err(grads[k].numpy(), want.numpy()) <= 1e-4, k
    for k, want in batch_stats_to_torch(jax.device_get(mut["batch_stats"])).items():
        np.testing.assert_allclose(tb.state_dict()[k].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_byol_head_matches_jax():
    """Pooled two-pathway features -> 3-layer BN-MLP projector -> 2-layer
    predictor, in training (both outputs returned)."""
    jh = JHead(num_classes=16, act_func="none", num_mlp_layers=3, mlp_dim=32,
               bn_mlp=True, predictor_depths=(2,), predictor_mlp_dim=32, predictor_bn=True)
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((4, 2, 3, 3, c)).astype(np.float32) for c in (24, 8)]
    v = jh.init(jax.random.PRNGKey(5), [jnp.asarray(a) for a in xs], False)
    out_j, _ = jh.apply(v, [jnp.asarray(a) for a in xs], True, mutable=["batch_stats"])
    th = ResNetBasicHead(32, 16, act_func="none", num_mlp_layers=3, mlp_dim=32,
                         bn_mlp=True, predictor_depths=(2,), predictor_mlp_dim=32,
                         predictor_bn=True)
    th.load_state_dict(flax_to_state_dict(jax.device_get(v["params"]),
                                          jax.device_get(v["batch_stats"])))
    with torch.no_grad():
        out_t = th([torch.from_numpy(a).permute(0, 4, 1, 2, 3) for a in xs])
    for a, b in zip(out_t, out_j):
        assert rel_err(a.numpy(), b) <= 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = both_cfgs()
    jm = jbuild_model(jcfg, sync_axes=())
    params, batch_stats = jax_variables(jm)
    tm = build_model(tcfg, "cpu")
    return jm, params, batch_stats, tm


def test_bridge_maps_every_leaf(models):
    """Every Flax leaf lands on a port parameter or buffer of the same size,
    and nothing of the port is left out."""
    _, params, batch_stats, tm = models
    sd = flax_to_state_dict(params, batch_stats)
    own = tm.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k


def test_contrastive_model_forward_matches_jax(models):
    """The whole ContrastiveModel in training, two views with per-view BN,
    JAX with TPU.PALLAS_STEM through the interpreted Pallas stem: outputs
    and updated running statistics."""
    jm, params, batch_stats, tm = models
    x = views()
    with pltpu.force_tpu_interpret_mode():
        out_j, mut = jax.jit(jax.vmap(lambda v: jm.apply(
            {"params": params, "batch_stats": batch_stats}, v, train=True,
            mutable=["batch_stats"])))(jnp.asarray(x))
    stats_j = jax.tree_util.tree_map(lambda s: s.mean(0), mut["batch_stats"])
    tm.load_state_dict(flax_to_state_dict(params, batch_stats))
    tm.train()
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x).reshape(-1, *x.shape[2:]), views=2)
    commit_bn_stats(tm)
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        assert rel_err(a.reshape(b.shape).numpy(), b) <= 1e-3
    own = tm.state_dict()
    for k, want in batch_stats_to_torch(jax.device_get(stats_j)).items():
        np.testing.assert_allclose(own[k].numpy(), want.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("zero_final_bn", [False, True])
def test_initializers_match_jax(zero_final_bn):
    """msra_init, Xavier and fc_init, zero biases and the final-BN zero init
    (RESNET.ZERO_INIT_FINAL_BN): constant tensors equal, random ones with
    the same spread (std within 10 % on tensors of >= 1000 draws, where the
    sampling noise of a std is ~2 %)."""
    jcfg, tcfg = both_cfgs(**{"RESNET.ZERO_INIT_FINAL_BN": zero_final_bn})
    params, _ = jax_variables(jbuild_model(jcfg, sync_axes=()))
    own = {k: p.detach() for k, p in build_model(tcfg, "cpu", seed=1).named_parameters()}
    ref = flax_to_state_dict(params, {})
    assert set(ref) == set(own)
    for k, want in ref.items():
        got = own[k]
        if float(want.std()) == 0.0 or want.numel() < 2:
            torch.testing.assert_close(got, want, msg=k)
        elif want.numel() >= 1000:
            assert abs(float(got.std()) / float(want.std()) - 1.0) < 0.1, k
    final_bn = [k for k in ref if k.endswith("branch2.c_bn.weight")]
    assert final_bn and all(float(own[k].abs().max()) == (0.0 if zero_final_bn else 1.0)
                            for k in final_bn)


def test_port_imports_no_jax():
    """Importing the port (its entry point, trainer, data pipeline and probe
    tool among it) and running a CPU forward and backward of each model
    (MaskMViT through flash_mha's CPU path), the simple and OnlyCrop augs,
    a MaskingGenerator3D draw, one AdViSe step (the TemporalModel with
    its CLIP tower, the XLA simple aug with hue, BYOL twins), the eval
    modules with a speed_val eval step, ContrastiveModel over ResNet3D, an
    X3D speed step (drop-connect on), a MoCo step (the rbyol aug,
    shuffle-BN, the queue) and an MAE step with rel-pos, residual pooling
    and the fixed sin-cos table, then its VIS_MASK dump, the host aug, the
    op-exact 'aa' aug and ContrastiveModel over MViT, and importing the
    data-parallel layout and collectives, the model-parallel modules (ring
    attention, GPipe, the 'auto' layout) and the offline tools (t-SNE,
    clip videos, features), loads no jax, flax, optax, advise_tpu or PIL
    module."""
    code = (
        "import sys, torch\n"
        "from advise_tpu_torch.config import get_cfg, assert_and_infer_cfg\n"
        "from advise_tpu_torch.models import build_model\n"
        "from advise_tpu_torch.data import build_device_aug\n"
        "from advise_tpu_torch.engine.steps import make_train_step\n"
        "from advise_tpu_torch.utils import convert\n"
        "from advise_tpu_torch.ops import fused_aug\n"
        "from advise_tpu_torch.models import resnet3d, losses\n"
        "from advise_tpu_torch.solver import lr_policy\n"
        "import advise_tpu_torch.data\n"
        "from advise_tpu_torch.tools import run, probe_windows, compare_steps\n"
        "from advise_tpu_torch.engine import train, checkpoint, meters\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/pretrain/SlowFast_R50_K400.yaml')\n"
        "cfg.RESNET.DEPTH = 10; cfg.RESNET.WIDTH_PER_GROUP = 16; cfg.SLOWFAST.BETA_INV = 2\n"
        "cfg.CONTRASTIVE.MLP_DIM = 32; cfg.TPU.COMPUTE_DTYPE = 'float32'\n"
        "cfg = assert_and_infer_cfg(cfg)\n"
        "m = build_model(cfg, 'cpu')\n"
        "out = m(torch.zeros(2, 8, 32, 32, 3))\n"
        "out[1].sum().backward()\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/pretrain/SpeedPro_R50.yaml')\n"
        "cfg.RESNET.DEPTH = 10; cfg.RESNET.WIDTH_PER_GROUP = 8; cfg.SSL.MLP_DIM = 32\n"
        "cfg.AUG.RESIZE = [40, 36]; cfg.AUG.TARGET_SIZE = 32; cfg.TPU.COMPUTE_DTYPE = 'float32'\n"
        "cfg = assert_and_infer_cfg(cfg)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "clips = build_device_aug(cfg)(torch.zeros(2, 1, 4, 36, 40, 3, dtype=torch.uint8), g)[:, 0]\n"
        "m = build_model(cfg, 'cpu')\n"
        "logits = m(clips, generator=g)\n"
        "losses.bce_logit(logits, torch.eye(4)[:2]).backward()\n"
        "assert lr_policy.get_lr_at_epoch(cfg, 1.0) > 0\n"
        "import numpy as np\n"
        "from advise_tpu_torch.data.masking import build_mask_generator\n"
        "from advise_tpu_torch.ops import flash_attention\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/pretrain/MViT_L_32x312_joint.yaml')\n"
        "cfg.MVIT.EMBED_DIM = 8; cfg.MVIT.DEPTH = 6; cfg.MVIT.DIM_MUL = [[2, 2.0]]\n"
        "cfg.MVIT.HEAD_MUL = [[2, 2.0]]; cfg.MVIT.POOL_Q_STRIDE = [[2, 1, 2, 2]]\n"
        "cfg.MASK.PRETRAIN_DEPTH = [5]; cfg.CONTRASTIVE.MLP_DIM = 32; cfg.TPU.COMPUTE_DTYPE = 'float32'\n"
        "cfg.DATA.NUM_FRAMES = 4; cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = cfg.AUG.TARGET_SIZE = 32\n"
        "cfg = assert_and_infer_cfg(cfg)\n"
        "mask = build_mask_generator(cfg)(np.random.default_rng(0))\n"
        "clips = build_device_aug(cfg)(torch.zeros(1, 2, 4, 32, 42, 3, dtype=torch.uint8), g)[0]\n"
        "m = build_model(cfg, 'cpu').train()\n"
        "n = [0]\n"
        "plain = flash_attention.flash_fwd_plain\n"
        "def counted(*a):\n"
        "    n[0] += 1\n"
        "    return plain(*a)\n"
        "flash_attention.flash_fwd_plain = counted\n"
        "out = m(clips, loader_mask=torch.from_numpy(np.stack([mask, mask])), generator=g)\n"
        "assert n[0] == 6  # one attention a block\n"
        "(out[0][0].sum() + out[4].sum()).backward()\n"
        "assert all(p.grad is not None for p in m.parameters())\n"
        "from advise_tpu_torch.engine.train import build_train_state\n"
        "from advise_tpu_torch.models import clip_vit, temporal_model\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/smoke/advise_tm_synth.yaml')\n"
        "cfg.AUG.REFERENCE_EXACT_HUE = False; cfg.TM.TEMPORAL_ARCH = 'resnet3d'; cfg.SSL.BN_MLP = True\n"
        "cfg = assert_and_infer_cfg(cfg)\n"
        "state, bundle = build_train_state(cfg, 'cpu')\n"
        "assert isinstance(state.model.spatial_encoder, clip_vit.CLIPViT)\n"
        "step = make_train_step(cfg, bundle, build_device_aug(cfg))\n"
        "clips = torch.randint(0, 256, (2, 2, 4, 36, 40, 3), dtype=torch.uint8)\n"
        "stats = step(state, clips, {'spd_label': torch.zeros(2, 2, dtype=torch.long)}, g, 1e-3)\n"
        "assert set(stats) == {'loss_spd', 'acc_spd', 'loss_byol', 'grad_norm'}\n"
        "assert all(bool(torch.isfinite(v)) for v in stats.values())\n"
        "from advise_tpu_torch.engine import inference, validate\n"
        "from advise_tpu_torch.tools import run\n"
        "from advise_tpu_torch.engine.steps import make_eval_step\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/smoke/byol_r10_synth.yaml')\n"
        "m = build_model(assert_and_infer_cfg(cfg), 'cpu')\n"
        "assert type(m.backbone).__name__ == 'ResNet3D'\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/smoke/speed_r18_synth.yaml')\n"
        "cfg = assert_and_infer_cfg(cfg)\n"
        "logits = make_eval_step(cfg, build_device_aug(cfg, 'speed'))(\n"
        "    build_model(cfg, 'cpu'), torch.zeros(2, 1, 4, 32, 42, 3, dtype=torch.uint8), g)\n"
        "assert logits.shape == (2, 1, 4)\n"
        "from advise_tpu_torch.models import x3d\n"
        "from advise_tpu_torch.parallel import collectives\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/pretrain/X3D_M_K400.yaml')\n"
        "cfg.X3D.DEPTH_FACTOR = 0.5; cfg.X3D.DIM_C5 = 32; cfg.AUG.RESIZE = [40, 36]; cfg.AUG.TARGET_SIZE = 32\n"
        "cfg.TPU.COMPUTE_DTYPE = 'float32'; cfg.MODEL.DROPCONNECT_RATE = 0.2\n"
        "cfg.NUM_WORLDS = 1; cfg.TPU.MESH_SYNC = 1; cfg.BN.NUM_SYNC_DEVICES = 1\n"
        "cfg = assert_and_infer_cfg(cfg)\n"
        "state, bundle = build_train_state(cfg, 'cpu')\n"
        "assert isinstance(state.model, x3d.X3D)\n"
        "stats = make_train_step(cfg, bundle, build_device_aug(cfg))(\n"
        "    state, torch.randint(0, 256, (2, 2, 4, 36, 40, 3), dtype=torch.uint8),\n"
        "    {'spd_label': torch.zeros(2, 2, dtype=torch.long)}, g, 1e-3)\n"
        "assert all(bool(torch.isfinite(v)) for v in stats.values())\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/chip/moco_knn_minik400.yaml')\n"
        "cfg.RESNET.DEPTH = 10; cfg.RESNET.WIDTH_PER_GROUP = 8; cfg.CONTRASTIVE.QUEUE_LEN = 16\n"
        "cfg.AUG.TARGET_SIZE = 24; cfg.DATA.NUM_FRAMES = 4; cfg.TPU.COMPUTE_DTYPE = 'float32'\n"
        "cfg = assert_and_infer_cfg(cfg)\n"
        "state, bundle = build_train_state(cfg, 'cpu')\n"
        "stats = make_train_step(cfg, bundle, build_device_aug(cfg))(\n"
        "    state, torch.randint(0, 256, (4, 2, 4, 24, 32, 3), dtype=torch.uint8),\n"
        "    {'item_id': torch.arange(4)}, g, 1e-3, 0.5)\n"
        "assert set(stats) == {'loss_nce', 'acc_ins', 'grad_norm'} and int(state.ssl['ptr']) == 4\n"
        "assert all(bool(torch.isfinite(v)) for v in stats.values())\n"
        "import tempfile\n"
        "from advise_tpu_torch.models import masked\n"
        "from advise_tpu_torch.utils import visualization\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/chip/mae_vismask_minik400.yaml')\n"
        "cfg.MVIT.EMBED_DIM = 16; cfg.MVIT.DEPTH = 2; cfg.MASK.PRETRAIN_DEPTH = [1]; cfg.MASK.DECODER_EMBED_DIM = 16\n"
        "cfg.MVIT.REL_POS_SPATIAL = True; cfg.MVIT.RESIDUAL_POOLING = True; cfg.MVIT.USE_FIXED_SINCOS_POS = True\n"
        "cfg.DATA.NUM_FRAMES = 4; cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = cfg.AUG.TARGET_SIZE = 32\n"
        "cfg.TPU.COMPUTE_DTYPE = 'float32'; cfg.NUM_WORLDS = 1; cfg = assert_and_infer_cfg(cfg)\n"
        "cfg.LOGDIR = tempfile.mkdtemp()\n"
        "state, bundle = build_train_state(cfg, 'cpu')\n"
        "assert isinstance(state.model, masked.MaskMViT) and state.model.mae\n"
        "aug = build_device_aug(cfg)\n"
        "u8 = torch.randint(0, 256, (2, 1, 4, 32, 42, 3), dtype=torch.uint8)\n"
        "stats = make_train_step(cfg, bundle, aug)(state, u8, {}, g, 1e-3)\n"
        "assert set(stats) == {'loss_mask', 'grad_norm'} and all(bool(torch.isfinite(v)) for v in stats.values())\n"
        "assert visualization.dump_mask_visualization(cfg, state.model, u8, aug, g, 0) is not None\n"
        "from advise_tpu_torch.data import host_aug, rand_augment\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/pretrain/SpeedPro_R50.yaml'); cfg.TPU.DEVICE_AUG = False\n"
        "cfg.AUG.RESIZE = [40, 36]; cfg.AUG.TARGET_SIZE = 32; cfg = assert_and_infer_cfg(cfg)\n"
        "out = host_aug.build_host_aug(cfg)(np.random.default_rng(0).integers(0, 256, (2, 30, 44, 3), dtype=np.uint8), 7)\n"
        "assert out.shape == (2, 32, 32, 3) and out.dtype == np.float32\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/pretrain/SlowFast_R50_K400.yaml')\n"
        "cfg.AUG.FUSED_RA = False; cfg.AUG.TARGET_SIZE = 16; cfg.NUM_WORLDS = 1; cfg = assert_and_infer_cfg(cfg)\n"
        "aug = build_device_aug(cfg)\n"
        "assert isinstance(aug.ra, rand_augment.ExactRandAugment)\n"
        "assert aug(torch.randint(0, 256, (1, 2, 2, 20, 24, 3), dtype=torch.uint8), g).shape == (1, 2, 2, 16, 16, 3)\n"
        "cfg.MODEL.ARCH = 'mvit'; cfg.MVIT.DEPTH = 2; cfg.MVIT.EMBED_DIM = 16; cfg.DATA.NUM_FRAMES = 4\n"
        "cfg.DATA.TRAIN_CROP_SIZE = 32; cfg.CONTRASTIVE.MLP_DIM = 32\n"
        "assert type(build_model(cfg, 'cpu').backbone).__name__ == 'MViT'\n"
        "from advise_tpu_torch.parallel import auto_shard, collectives, mesh, pipeline, ring_attention\n"
        "from advise_tpu_torch.tools import run_tsne\n"
        "assert mesh.mesh_shape(cfg, 4) == (1, 4) and collectives.world_size() == 1 and run_tsne.main\n"
        "assert callable(auto_shard.shard_train_state) and callable(pipeline.gpipe)\n"
        "assert callable(ring_attention.ring_attention)\n"
        "assert callable(visualization.get_features) and callable(visualization.clips2videos)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'advise_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_port_calls_no_library_attention():
    """No source of the port calls PyTorch's fused attention, cuDNN's
    attention or torch.compile: its attention is the flash kernel K4 (or,
    off the flash path, the dense chain written out)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "advise_tpu_torch"
    sources = sorted(root.rglob("*.py")) + sorted(root.rglob("*.cu"))
    assert len(sources) > 20
    for path in sources:
        text = path.read_text()
        for banned in ("scaled_dot_product_attention", "cudnn_attention", "torch.compile",
                       "sdpa_kernel", "flash_attn"):
            assert banned not in text, (str(path), banned)
