"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py):
one small SlowFast BYOL configuration, built the same way through the JAX
package's config and the port's copy of it, and the JAX side's initial
variables passed to the port through the param bridge."""

import jax
import jax.numpy as jnp
import numpy as np

from advise_tpu import config as jconfig
from advise_tpu_torch import config as tconfig

B, T, S = 4, 8, 32  # clips per view, frames, pixels: W/2 % 16 == 0 keeps the Pallas stem eligible


def small_cfg(mod=jconfig, remat=False, **overrides):
    """SlowFast-R50 BYOL preset cut to RESNET.DEPTH 10 and narrow widths,
    float32, one device; the fast stem keeps its 8 channels (16 / BETA_INV 2)."""
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/SlowFast_R50_K400.yaml")
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.REMAT = remat
    cfg.TPU.DONATE = False
    cfg.RESNET.DEPTH = 10
    cfg.RESNET.WIDTH_PER_GROUP = 16
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.SLOWFAST.BETA_INV = 2
    cfg.SLOWFAST.ALPHA = 4
    cfg.CONTRASTIVE.DIM = 16
    cfg.CONTRASTIVE.MLP_DIM = 32
    cfg.CONTRASTIVE.LENGTH = 64
    cfg.DATA.NUM_FRAMES = T
    cfg.DATA.BATCHSIZE_PER_GPU = B
    cfg.AUG.TARGET_SIZE = S
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return mod.assert_and_infer_cfg(cfg)


def both_cfgs(**kw):
    return small_cfg(jconfig, **kw), small_cfg(tconfig, **kw)


def on_mesh(tree, mesh):
    """``tree`` placed replicated on ``mesh``, where the jitted JAX train step
    leaves its outputs: the step then compiles once, not once for the host
    arrays of the first call and again for its own outputs."""
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def jax_variables(model, seed=0):
    """The JAX model's initial params and batch_stats, as numpy trees."""
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, T, S, S, 3), jnp.float32), train=False,
    ))()
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def views(seed=0, n_views=2):
    """Augmented-clip stand-ins [V, B, T, S, S, 3], float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_views, B, T, S, S, 3)).astype(np.float32)


def rel_err(got, want):
    """max|got - want| over max|want|, in float32."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# the speed pretext's presets, cut to CPU size: (yaml, overrides). Slow
# R50 and I3D at RESNET.DEPTH 10 with narrow widths, and the R18 smoke
# preset (basic transform) as it is
SPEED_PRESETS = {
    "slow_r10": ("configs/pretrain/SpeedPro_R50.yaml", {
        "RESNET.DEPTH": 10, "RESNET.WIDTH_PER_GROUP": 8, "SSL.MLP_DIM": 32,
        "RESNET.NUM_BLOCK_TEMP_KERNEL": [[1], [1], [1], [1]]}),
    "i3d_r10": ("configs/pretrain/SpeedPro_R50.yaml", {
        "MODEL.ARCH": "i3d", "RESNET.DEPTH": 10, "RESNET.WIDTH_PER_GROUP": 8,
        "SSL.MLP_DIM": 32, "RESNET.NUM_BLOCK_TEMP_KERNEL": [[1], [1], [1], [1]]}),
    "r18_basic": ("configs/smoke/speed_r18_synth.yaml", {}),
}
SPEED_B, SPEED_K, SPEED_T, SPEED_S = 2, 2, 4, 32  # videos, clips per video, frames, crop


def _override(cfg, overrides):
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value


def speed_cfg(mod=jconfig, preset="slow_r10", **overrides):
    """A speed preset on one device in float32, without head dropout or
    REMAT unless ``overrides`` set them, at SPEED_* sizes."""
    yaml, cut = SPEED_PRESETS[preset]
    cfg = mod.get_cfg()
    cfg.merge_from_file(yaml)
    cfg.NUM_WORLDS = 1
    cfg.NUM_GPUS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.REMAT = False
    cfg.TPU.DONATE = False
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.NUM_FRAMES = SPEED_T
    cfg.DATA.BATCHSIZE_PER_GPU = SPEED_B
    cfg.DATA.NUM_CLIP = SPEED_K
    cfg.AUG.TARGET_SIZE = SPEED_S
    cfg.AUG.RESIZE = [SPEED_S * 3 // 2, SPEED_S * 5 // 4]
    _override(cfg, cut)
    _override(cfg, overrides)
    return mod.assert_and_infer_cfg(cfg)


def speed_variables(model, seed=0):
    """The JAX speed model's initial params and batch_stats, as numpy trees."""
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, SPEED_T, SPEED_S, SPEED_S, 3), jnp.float32), train=False,
    ))()
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


# MViT-L 32x312 joint MaskFeat + NT-Xent, cut to CPU size: 6 blocks at
# width 16 with one dim-doubling transition (block 1), one Q-pooling
# transition (block 2) and uniform reversible segments of length 1 (block 0)
# and 3 (blocks 3-5); 4 frames at 28^2, whose patch grid (2 x 7 x 7) pools
# to 2 x 4 x 4, so the HOG label frames are edge-padded to 32 and the token
# mask max-pooled on a non-tiling grid
MASK_B, MASK_K, MASK_T, MASK_S = 2, 2, 4, 28  # videos, views, frames, crop


def masked_cfg(mod=jconfig, **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/MViT_L_32x312_joint.yaml")
    cfg.NUM_GPUS = 1
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DONATE = False
    cfg.MVIT.EMBED_DIM = 8
    cfg.MVIT.DEPTH = 6
    cfg.MVIT.DIM_MUL = [[2, 2.0]]
    cfg.MVIT.HEAD_MUL = [[2, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[2, 1, 2, 2]]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 4, 4]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MASK.PRETRAIN_DEPTH = [5]
    cfg.CONTRASTIVE.DIM = 16
    cfg.CONTRASTIVE.MLP_DIM = 32
    cfg.DATA.NUM_FRAMES = MASK_T
    cfg.DATA.TRAIN_CROP_SIZE = MASK_S
    cfg.DATA.TEST_CROP_SIZE = MASK_S
    cfg.AUG.TARGET_SIZE = MASK_S
    cfg.DATA.BATCHSIZE_PER_GPU = MASK_B
    _override(cfg, overrides)
    return mod.assert_and_infer_cfg(cfg)


def masked_variables(model, seed=0):
    """The JAX MaskMViT's initial params, as a numpy tree."""
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1),
         "mask": jax.random.PRNGKey(seed + 2)},
        jnp.zeros((1, MASK_T, MASK_S, MASK_S, 3), jnp.float32), train=False,
    ))()
    return jax.device_get(v["params"])


def loader_masks(cfg, n, seed=0):
    """n block masks [n, t, h, w] from the port's MaskingGenerator3D on the
    loader's grid."""
    from advise_tpu_torch.data.masking import build_mask_generator

    gen = build_mask_generator(cfg)
    rng = np.random.default_rng(seed)
    return np.stack([gen(rng) for _ in range(n)]).astype(np.int32)


def grads_agree(got, want, tol):
    """Names of the gradients where |got - want| exceeds ``tol`` of max|want|
    plus ``tol`` / 100 of the largest value of the whole tree: a gradient
    that is zero in exact arithmetic (a key bias under softmax) is float32
    noise on both sides, which only the tree's scale can bound."""
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    bad = []
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[k], np.float32)
        if float(np.abs(g - w).max()) > tol * float(np.abs(w).max()) + tol * 1e-2 * top:
            bad.append(k)
    return bad


# AdViSe (configs/pretrain/AdViSe.yaml: TemporalModel, R3D temporal head,
# speed CE) cut to CPU size: a 2-layer CLIP tower of width 128 (2 heads) at
# 32^2 (a 2 x 2 patch grid), a temporal ResStage of 2 blocks 128 -> 16
# (inner 8), heads of MLP_DIM 16, CONTRASTIVE.DIM 8; float32 without
# TM.ENABLE_BF16
TM_B, TM_K, TM_T, TM_S = 4, 2, 4, 32  # videos, clips per video, frames, crop


def tm_cfg(mod=jconfig, **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/AdViSe.yaml")
    cfg.NUM_GPUS = 1
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DONATE = False
    cfg.TM.ENABLE_BF16 = False
    cfg.MODEL.SPATIAL_EMBEDDING_DIM = 128
    cfg.MODEL.TEMPORAL_NUM_LAYERS = 1
    cfg.MODEL.TEMPORAL_EMBEDDING_DIM = 16
    cfg.MODEL.TEMPORAL_HIDDEN_DIM = 8
    cfg.SSL.MLP_DIM = 16
    cfg.CONTRASTIVE.DIM = 8
    cfg.TM.NUM_BLOCKS = 2
    cfg.TM.NUM_HEADS = 2
    cfg.DATA.NUM_FRAMES = TM_T
    cfg.DATA.NUM_CLIP = TM_K
    cfg.DATA.BATCHSIZE_PER_GPU = TM_B
    cfg.AUG.TARGET_SIZE = TM_S
    cfg.AUG.RESIZE = [TM_S * 5 // 4, TM_S * 9 // 8]
    _override(cfg, overrides)
    return mod.assert_and_infer_cfg(cfg)


# the video_swin temporal head (one Swin BasicLayer, window (4, 7, 7)) at the
# width it keeps (TM.CHANNEL_POOL_DIM = TEMPORAL_EMBEDDING_DIM 16), on 6
# frames at 128^2: the tower's 8 x 8 patch grid and the 6 frames pad to
# (8, 14, 14), and the odd blocks shift by (2, 3, 3) under the mask
TM_SWIN_T, TM_SWIN_S = 6, 128
TM_SWIN = {"TM.TEMPORAL_ARCH": "video_swin", "TM.CHANNEL_POOL_DIM": 16, "DATA.NUM_FRAMES": TM_SWIN_T,
           "AUG.TARGET_SIZE": TM_SWIN_S, "AUG.RESIZE": [TM_SWIN_S * 5 // 4, TM_SWIN_S * 9 // 8]}


def tm_variables(model, seed=0, t=TM_T, s=TM_S):
    """The JAX TemporalModel's initial params and batch_stats (every head
    touched through ``init_all``) for clips of ``t`` frames at ``s``^2, as
    numpy trees."""
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((2, t, s, s, 3), jnp.float32), train=False, method="init_all",
    ))()
    return jax.device_get(v["params"]), jax.device_get(v.get("batch_stats", {}))


# configs/chip/mae_vismask_minik400.yaml (MViT MAE with the VIS_MASK dump)
# cut to CPU size: 2 encoder blocks of width 16 (1 head), a decoder of 2
# blocks 16 wide, 4 frames at 32^2 (a 2 x 8 x 8 patch grid, 32 of its 128
# tokens visible at the preset's ratio 0.75), float32
MAE_B, MAE_T, MAE_S = 2, 4, 32  # clips, frames, crop


def mae_cfg(mod=jconfig, **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/chip/mae_vismask_minik400.yaml")
    cfg.NUM_GPUS = 1
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DONATE = False
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.DEPTH = 2
    cfg.MASK.PRETRAIN_DEPTH = [1]
    cfg.MASK.DECODER_EMBED_DIM = 16
    cfg.MASK.DECODER_DEPTH = 2
    cfg.DATA.NUM_FRAMES = MAE_T
    cfg.DATA.TRAIN_CROP_SIZE = MAE_S
    cfg.DATA.TEST_CROP_SIZE = MAE_S
    cfg.AUG.TARGET_SIZE = MAE_S
    cfg.DATA.BATCHSIZE_PER_GPU = MAE_B
    _override(cfg, overrides)
    return mod.assert_and_infer_cfg(cfg)


def model_variables(model, t, s, seed=0):
    """A JAX MaskMViT's (or MViT's) initial params for clips of ``t``
    frames at ``s``^2, as a numpy tree."""
    v = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1),
         "mask": jax.random.PRNGKey(seed + 2)},
        jnp.zeros((1, t, s, s, 3), jnp.float32), train=False,
    ))()
    return jax.device_get(v["params"])


def record_jax_masks(monkeypatch):
    """Wrap the JAX package's ``models.masked.random_masking`` so that every
    call its programs make appends the (ids_keep, mask, ids_restore) it drew,
    as numpy, to the returned list (read it after ``jax.effects_barrier()``)."""
    from advise_tpu.models import masked as jmasked

    drawn = []
    orig = jmasked.random_masking

    def recording(*args, **kwargs):
        out = orig(*args, **kwargs)
        jax.debug.callback(lambda *v: drawn.append(tuple(np.asarray(a) for a in v)), *out)
        return out

    monkeypatch.setattr(jmasked, "random_masking", recording)
    return drawn


def hand_port_masks(monkeypatch, drawn):
    """Make the port's ``models.masked.random_masking`` return the entries
    of ``drawn`` in order (as torch tensors on the noise's device)."""
    import torch

    from advise_tpu_torch.models import masked as tmasked

    queue = list(drawn)

    def handed(b, thw, mask_ratio, tube=False, per_frame=False, generator=None, noise=None):
        ids_keep, mask, ids_restore = queue.pop(0)
        assert ids_keep.shape[0] == mask.shape[0] == b and mask.shape[1] == thw[0] * thw[1] * thw[2]
        return tuple(torch.from_numpy(np.array(a)) for a in (ids_keep, mask, ids_restore))

    monkeypatch.setattr(tmasked, "random_masking", handed)
    return queue


def optimizer_masks_disagree(jcfg, tcfg, jparams, model):
    """Names of the parameters whose optimizer label or weight decay in the
    port (``solver/optimizer.py classify_params``, ``wd_tree``) differs
    from the JAX package's for the same tree."""
    from advise_tpu.solver import optimizer as jopt
    from advise_tpu_torch.solver import optimizer as topt
    from advise_tpu_torch.utils.convert import _flatten, param_key

    params = dict(model.named_parameters())
    j_labels = {param_key(p): v for p, v in _flatten(jopt.classify_params(jcfg, jparams))}
    j_wd = {param_key(p): v for p, v in _flatten(jopt.wd_tree(jcfg, jparams))}
    assert set(j_labels) == set(params), set(j_labels) ^ set(params)
    t_labels, t_wd = topt.classify_params(tcfg, params), topt.wd_tree(tcfg, params)
    return [n for n in params if t_labels[n] != j_labels[n] or abs(t_wd[n] - float(j_wd[n])) > 1e-12]


# configs/chip/moco_knn_minik400.yaml cut to a Slow R10 (basic transform,
# width 8) with a 16-wide projection, 4 videos x 2 clips of 4 frames at
# 32^2, float32: the contrastive algorithms' parity tests
CON_B, CON_K, CON_T, CON_S = 4, 2, 4, 32  # videos, clips (views), frames, pixels
CON_DIM = 16


def contrastive_cfg(mod=jconfig, ctype="moco", **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/chip/moco_knn_minik400.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DONATE = False
    cfg.NUM_WORLDS = 1
    cfg.RESNET.DEPTH = 10
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.CONTRASTIVE.TYPE = ctype
    cfg.CONTRASTIVE.DIM = CON_DIM
    cfg.CONTRASTIVE.MLP_DIM = 32
    cfg.CONTRASTIVE.QUEUE_LEN = 16
    cfg.CONTRASTIVE.LENGTH = 32
    cfg.DATA.NUM_FRAMES = CON_T
    cfg.DATA.BATCHSIZE_PER_GPU = CON_B
    cfg.AUG.TARGET_SIZE = CON_S
    _override(cfg, overrides)
    return mod.assert_and_infer_cfg(cfg)


def contrastive_clips(seed, k=CON_K):
    """Augmented-clip stand-ins [B, K, T, S, S, 3], float32."""
    return np.random.default_rng(seed).standard_normal((CON_B, k, CON_T, CON_S, CON_S, 3)).astype(np.float32)


def contrastive_setup(ctype, **overrides):
    """(jcfg, tcfg, params, batch_stats, ssl): the JAX model's initial
    variables and SSL state for ``contrastive_cfg(ctype, **overrides)``, as
    numpy trees."""
    from advise_tpu.engine import contrastive as jc
    from advise_tpu.models import build_model as jbuild_model

    jcfg, tcfg = contrastive_cfg(jconfig, ctype, **overrides), contrastive_cfg(tconfig, ctype, **overrides)
    jinit = jbuild_model(jcfg, sync_axes=())
    v = jax.jit(lambda: jinit.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                   jnp.zeros((1, CON_T, CON_S, CON_S, 3), jnp.float32), train=False))()
    params, batch_stats = jax.device_get(v["params"]), jax.device_get(v["batch_stats"])
    ssl = jax.device_get(jc.init_ssl_state(jcfg, params, batch_stats, jax.random.PRNGKey(3)))
    return jcfg, tcfg, params, batch_stats, ssl


def port_contrastive(tcfg, params, batch_stats, ssl):
    """The port's model and SSL state holding the JAX ones (through
    ``utils/convert.py``), in train mode."""
    import torch

    from advise_tpu_torch.engine import contrastive as tc
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.utils.convert import convert_train_state

    conv = convert_train_state(params, batch_stats, ssl=ssl)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(conv["model"])
    tssl = tc.init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    if "ema_model" in tssl:
        tssl["ema_model"].load_state_dict(conv["ema"])
        tssl["ema_model"].train()
    for name in ("knn_mem", "queue_x", "ptr", "queue_swav", "swav_started", "memory"):
        if name in conv:
            tssl[name] = conv[name].clone()
    model.train()
    return model, tssl


def contrastive_step_pair(jcfg, tcfg, params, batch_stats, ssl):
    """The JAX step (jitted, state on a one-device mesh) and the port's over
    the same initial state: (jstep, jstate, tstep, tstate)."""
    from advise_tpu.engine.state import TrainState as JState
    from advise_tpu.engine.steps import make_train_step as jmake_step
    from advise_tpu.models import build_model as jbuild_model
    from advise_tpu.parallel import build_mesh
    from advise_tpu.solver import build_tx as jbuild_tx
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.solver.optimizer import build_tx

    mesh = build_mesh(jcfg, jax.devices()[:1])
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl=ssl), mesh)
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0, tssl)
    return jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None), jstate, make_train_step(tcfg, tbundle, None), tstate


def moved_within(got, want, init, tol=5e-2, floor=1e-6):
    """Names where what a tensor moved from ``init`` disagrees with what
    JAX's moved by more than ``tol`` of JAX's move plus ``floor`` of the
    tree's largest value (the trajectory tests' bound)."""
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    bad = []
    for k, v in want.items():
        g, w, i0 = (np.asarray(a, np.float32) for a in (got[k], v, init[k]))
        if np.abs(g - w).max() > tol * np.abs(w - i0).max() + floor * top:
            bad.append(k)
    return bad


def run_cfg(yaml, logdir, **overrides):
    """The port's config of ``yaml`` for ``trainer(cfg, device='cpu')``: one
    device, float32, synthetic videos of 4 frames at 48^2, a checkpoint an
    epoch, LOGDIR ``logdir``, then ``overrides``."""
    cfg = tconfig.get_cfg()
    cfg.merge_from_file(yaml)
    _override(cfg, {"NUM_GPUS": 1, "TPU.MESH_SYNC": 1, "BN.NUM_SYNC_DEVICES": 1,
                    "TPU.COMPUTE_DTYPE": "float32", "DATA.DECODE_BACKEND": "synthetic",
                    "DATA.SYNTHETIC_RES": 48, "DATA.WORKERS": 2, "DATA.NUM_FRAMES": 4,
                    "TRAIN.SAVE_FREQ": 1, "TRAIN.AUTO_RESUME": False, **overrides})
    cfg = tconfig.assert_and_infer_cfg(cfg)
    cfg.LOGDIR = str(logdir)
    return cfg


def contrastive_run_cfg(logdir, ctype, **overrides):
    """configs/chip/moco_knn_minik400cc.yaml with CONTRASTIVE.TYPE ``ctype``,
    cut to a Slow R10 of width 8 on 8 synthetic videos of 4 frames at
    24^2: 2 iterations an epoch and a kNN probe batch."""
    return run_cfg("configs/chip/moco_knn_minik400cc.yaml", logdir, **{
        "CONTRASTIVE.TYPE": ctype, "RESNET.DEPTH": 10, "RESNET.WIDTH_PER_GROUP": 8, "CONTRASTIVE.DIM": 16,
        "CONTRASTIVE.MLP_DIM": 32, "CONTRASTIVE.QUEUE_LEN": 8, "CONTRASTIVE.LENGTH": 16,
        "CONTRASTIVE.KNN_EVAL_BATCHES": 1, "AUG.TARGET_SIZE": 24, "DATA.BATCHSIZE_PER_GPU": 4,
        "DATA.SYNTHETIC_SIZE": 8, **overrides})


def resume_matches_straight(tmp_path, ctype, names, **overrides):
    """A 2-epoch run from SOLVER.START_EPOCH and the same run cut after its
    first epoch and resumed: returns (straight state, resumed state,
    straight record, cut record, the first epoch's saved state), after
    checking that the resumed run's stats, model and ``names`` of the SSL
    state equal the straight run's bit for bit."""
    import torch

    from advise_tpu_torch.engine import checkpoint as ck
    from advise_tpu_torch.engine.train import trainer

    first = int(overrides.get("SOLVER.START_EPOCH", 0))
    over = {"SOLVER.MAX_EPOCH": first + 2, **overrides}
    straight, cut = {}, {}
    state = trainer(contrastive_run_cfg(tmp_path / "straight", ctype, **over), device="cpu", record=straight)
    assert len(straight["stats"]) == 4
    assert all(np.isfinite(v) for st in straight["stats"] for v in st.values())
    name = f"Model_Epoch_{first:04d}"
    saved = torch.load(tmp_path / "straight" / "checkpoints" / name / ck.STATE_FILE, weights_only=False)
    kept = tmp_path / "cut" / "checkpoints"
    kept.mkdir(parents=True)
    for f in (name, f"{name}.meta.npy"):
        (tmp_path / "straight" / "checkpoints" / f).rename(kept / f)
    resumed = trainer(contrastive_run_cfg(tmp_path / "cut", ctype, **over, **{"TRAIN.AUTO_RESUME": True}),
                      device="cpu", record=cut)
    assert (cut["start_epoch"], cut["start_step"], len(cut["stats"])) == (first + 1, 2, 2)
    assert cut["stats"] == straight["stats"][2:]
    assert cut["model_sha256_end"] == straight["model_sha256_end"]
    assert cut["ssl_sha256_end"] == straight["ssl_sha256_end"]
    for n in names:
        assert torch.equal(resumed.ssl[n], state.ssl[n]), n
    return state, resumed, straight, cut, saved


# ContrastiveModel over MViT: the BYOL preset (configs/pretrain/
# SlowFast_R50_K400.yaml: LARS-SGD, 'aa', 2 views) with MODEL.ARCH mvit and
# MViT_S_rev_masked.yaml's MVIT block cut to 4 blocks 16 wide: a
# dim-doubling transition (block 0), a Q-pooling transition (block 1) and a
# uniform reversible segment of 2 blocks; 4 frames at 32^2 (a 2 x 8 x 8
# patch grid)
MVC_B, MVC_T, MVC_S = 4, 4, 32  # videos, frames, crop
MVC_MVIT = {
    "MODEL.ARCH": "mvit", "MVIT.EMBED_DIM": 16, "MVIT.NUM_HEADS": 1, "MVIT.DEPTH": 4,
    "MVIT.PATCH_KERNEL": [3, 7, 7], "MVIT.PATCH_STRIDE": [2, 4, 4], "MVIT.PATCH_PADDING": [1, 3, 3],
    "MVIT.CLS_EMBED_ON": False, "MVIT.USE_ABS_POS": True, "MVIT.SEP_POS_EMBED": True,
    "MVIT.QKV_BIAS": True, "MVIT.DROPPATH_RATE": 0.0, "MVIT.DIM_MUL": [[1, 2.0]],
    "MVIT.HEAD_MUL": [[1, 2.0]], "MVIT.POOL_KVQ_KERNEL": [3, 3, 3],
    "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 4, 4], "MVIT.POOL_Q_STRIDE": [[1, 1, 2, 2]],
    "MVIT.REV.ENABLE": True,
}


def mvit_con_cfg(mod=jconfig, **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/SlowFast_R50_K400.yaml")
    _override(cfg, {"NUM_WORLDS": 1, "NUM_GPUS": 1, "TPU.MESH_SYNC": 1, "BN.NUM_SYNC_DEVICES": 1,
                    "TPU.COMPUTE_DTYPE": "float32", "TPU.REMAT": False, "TPU.DONATE": False,
                    "TPU.PALLAS_STEM": False, "CONTRASTIVE.DIM": 16, "CONTRASTIVE.MLP_DIM": 32,
                    "CONTRASTIVE.QUEUE_LEN": 8, "CONTRASTIVE.LENGTH": 32, "DATA.NUM_FRAMES": MVC_T,
                    "DATA.TRAIN_CROP_SIZE": MVC_S, "AUG.TARGET_SIZE": MVC_S,
                    "DATA.BATCHSIZE_PER_GPU": MVC_B, **MVC_MVIT})
    _override(cfg, overrides)
    return mod.assert_and_infer_cfg(cfg)
