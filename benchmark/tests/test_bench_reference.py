"""The plain references: their parts against plainly written PyTorch, their
parameters against the program's model, their settings against the
program's resolved config, and the whole train step against the program's
in float32 at a tiny size on the CPU."""

import math

import pytest
import torch
import torch.nn.functional as F

import tiny
from harness import cell, check, inputs, manifest, weights as wmod
from harness.program import Program, port_config
from reference import resnet3d_speed as R
from reference.common import Precision

ROOT = manifest.ROOT
M = manifest.load_manifest(ROOT)


def _ctx(name):
    return manifest.resolve(M, name, ROOT)


def test_bn_is_batch_norm_in_training():
    x = torch.randn(6, 5, 3, 4, 4, dtype=torch.float64).float()
    bn = R.BN(5, 1e-5, Precision())
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    want = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=1e-5)
    torch.testing.assert_close(bn(x), want, rtol=1e-5, atol=1e-5)


def test_bce_is_torch_bce_with_logits():
    logits, labels = torch.randn(12, 4), torch.randint(0, 4, (12,))
    want = F.binary_cross_entropy_with_logits(logits, F.one_hot(labels, 4).float())
    torch.testing.assert_close(R.bce_logit(logits, labels, 4), want)


def test_aug_crops_and_normalises_without_the_chain():
    g = torch.Generator().manual_seed(3)
    clips = torch.randint(0, 256, (3, 2, 10, 12, 3), generator=g, dtype=torch.uint8)
    p = R.sample_aug(3, 10, 12, 6, (0.8, 0.2, 0.2, 0.2, 0.1), g)
    p["apply"] = torch.zeros(3, dtype=torch.int32)
    out = R.apply_aug(clips, p, 6, (0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
    for i in range(3):
        t, l = int(p["tops"][i]), int(p["lefts"][i])
        want = (clips[i, :, t:t + 6, l:l + 6].float() - 127.5) / 63.75
        torch.testing.assert_close(out[i], want)


def test_sgd_matches_torch_sgd_with_nesterov():
    p = torch.randn(7, requires_grad=True)
    q = p.detach().clone().requires_grad_(True)
    opt = R.SGD({"w": 0.01}, 0.9, True)
    state = opt.init({"w": p})
    torch_opt = torch.optim.SGD([q], lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01)
    for _ in range(3):
        g = torch.randn(7)
        state = opt.step({"w": p}, {"w": g}, state, 0.1)
        q.grad = g.clone()
        torch_opt.step()
    torch.testing.assert_close(p.detach(), q.detach())


@pytest.mark.parametrize("name", ["speed_r50.b8x4x8"])
def test_reference_parameters_are_the_programs(name):
    from advise_tpu_torch.models import MODEL_REGISTRY, compute_dtype
    from advise_tpu_torch.models.layers.norm import get_norm

    ctx = _ctx(name)
    cfg = port_config(ctx.spec)
    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg, get_norm(cfg), compute_dtype(cfg))
    program = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref = manifest.reference(ctx.spec["reference"])
    assert ref.param_shapes(ctx.spec["reference_spec"]) == program
    shapes = ref.param_shapes(ctx.spec["reference_spec"])
    wmod.plan(shapes, ctx.spec["weights"])  # every parameter has a rule


def test_speed_reference_spec_is_the_programs_config():
    spec = _ctx("speed_r50.b8x4x8").spec
    cfg, rs = port_config(spec), spec["reference_spec"]
    from advise_tpu_torch.models.resnet3d import TEMPORAL_KERNEL_BASIS
    from advise_tpu_torch.models.slowfast import MODEL_STAGE_DEPTH

    assert list(MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]) == rs["stage_blocks"]
    assert cfg.RESNET.WIDTH_PER_GROUP * cfg.RESNET.NUM_GROUPS == rs["width"]
    assert [k[0] for k in TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH]] == rs["temporal_kernels"]
    assert [k[0] for k in cfg.RESNET.NUM_BLOCK_TEMP_KERNEL] == rs["num_block_temp_kernel"]
    assert [s[0] for s in cfg.RESNET.SPATIAL_STRIDES] == rs["spatial_strides"]
    assert (cfg.SSL.MLP_DIM, cfg.SSL.NUM_MLP_LAYERS, cfg.MODEL.NUM_CLASSES) == (
        rs["mlp_dim"], rs["mlp_layers"], rs["num_classes"])
    assert math.isclose(cfg.MODEL.DROPOUT_RATE, rs["dropout"])
    assert list(cfg.SSL.METRIC)[list(cfg.SSL.STAT).index("loss_spd")] == "bce_logit"
    assert (cfg.AUG.TYPE, cfg.TPU.PALLAS_AUG, cfg.AUG.TARGET_SIZE) == ("simple", True, rs["aug"]["crop"])
    assert not cfg.TPU.AUG_COMPUTE_OUT  # K3's float32 output, as metrics/k3_roofline_pct.py counts it
    assert [float(v) for v in cfg.AUG.COLOR] == rs["aug"]["color"]
    assert list(cfg.DATA.MEAN) == rs["aug"]["mean"] and list(cfg.DATA.STD) == rs["aug"]["std"]
    sol = rs["solver"]
    assert cfg.SOLVER.OPTIMIZING_METHOD == "simple_sgd" and not cfg.SOLVER.LARS_ON
    assert (cfg.SOLVER.MOMENTUM, cfg.SOLVER.NESTEROV, cfg.SOLVER.WEIGHT_DECAY, cfg.BN.WEIGHT_DECAY,
            cfg.SOLVER.ZERO_WD_1D_PARAM, cfg.SOLVER.CLIP_GRAD_NORM) == (
        sol["momentum"], sol["nesterov"], sol["weight_decay"], sol["bn_weight_decay"], sol["zero_wd_1d"],
        sol["clip_grad_norm"])
    assert cfg.TPU.COMPUTE_DTYPE == spec["dtype"] and spec["peak"] == "bf16"
    assert cfg.NUM_GPUS == 1 and cfg.BN.NUM_SYNC_DEVICES == 1 and cfg.TPU.MESH_SYNC == 1
    # the program's own start under RESNET.ZERO_INIT_FINAL_BN is the benchmark's rule
    plan = wmod.plan(R.param_shapes(rs), spec["weights"])
    finals = [n for n in plan if n.endswith("branch2.c_bn.weight")]
    assert cfg.RESNET.ZERO_INIT_FINAL_BN and len(finals) == sum(rs["stage_blocks"])
    assert all(plan[n] == ("zeros", 0.0) for n in finals)


def test_speed_weight_decays_are_the_programs():
    from advise_tpu_torch.solver.optimizer import wd_tree

    spec = tiny.speed_ctx().spec
    cfg = port_config(spec)
    shapes = R.param_shapes(spec["reference_spec"])
    params = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    assert wd_tree(cfg, params) == R.weight_decays(spec["reference_spec"])


@pytest.mark.parametrize("name", ["speed_r50.b8x4x8"])
def test_cell_lr_is_the_policys_at_its_epoch(name):
    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.solver.lr_policy import get_lr_at_epoch
    from advise_tpu_torch.solver.optimizer import adjust_base_lr

    ctx = _ctx(name)
    cfg = tconfig.get_cfg()
    cfg.merge_from_other_cfg(ctx.spec["preset"])
    cfg.NUM_WORLDS = cfg.NUM_GPUS  # the deployment's cards
    cfg = tconfig.assert_and_infer_cfg(cfg)
    adjust_base_lr(cfg)
    assert ctx.traffic["lr"] == get_lr_at_epoch(cfg, ctx.traffic["lr_epoch"])


@pytest.mark.parametrize("seed", [1, 2**33 + 7])
def test_program_and_reference_agree_in_float32_at_a_tiny_size(seed):
    ctx = tiny.speed_ctx()
    spec, traffic = ctx.spec, ctx.traffic
    pool = inputs.make_pool(traffic, seed, "cpu")
    start = wmod.make(R.param_shapes(spec["reference_spec"]), spec["weights"], seed, "cpu")
    prog = Program(spec, traffic, seed, "cpu")
    prog.load(start)
    got = cell.program_readings(prog, pool, spec, start, R.weight_decays(spec["reference_spec"]))
    want = cell.reference_readings(R, spec, traffic, pool, seed, "cpu")
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)
    nums = check.numbers(got, want)
    assert nums["grad1"] < 1e-4 and nums["change"] < 5e-3, nums


def test_the_controls_round_as_stated():
    from reference.common import NAMES, round_fp8, round_int8

    x = torch.tensor([0.5, -1.27, 0.004, 0.0149])
    torch.testing.assert_close(round_int8(x), torch.tensor([0.5, -1.27, 0.0, 0.01]))
    y = round_fp8(torch.tensor([448.0, 1.0, 1.0625, 0.0625]), torch.float8_e4m3fn, 448.0)
    torch.testing.assert_close(y, torch.tensor([448.0, 1.0, 1.0, 0.0625]))  # 3 mantissa bits
    for c in M["configs"]:
        spec = manifest.load_json(ROOT / c["file"])
        assert spec["control"] in NAMES and spec["control"] in ("fp8", "int8") and spec["dtype"] == "bfloat16"


@pytest.mark.parametrize("seed", [5, 2**34 + 1])
def test_sgd_compares_every_leafs_change(seed):
    """Under SGD no leaf is left out of ``change``, also where the branches'
    last BN scales start at 0 and most first gradients are 0."""
    ctx = tiny.speed_ctx()
    pool = inputs.make_pool(ctx.traffic, seed, "cpu")
    want = cell.reference_readings(R, ctx.spec, ctx.traffic, pool, seed, "cpu")
    zero = [n for n, g in want["grad1"].items() if g == 0]
    assert zero and all(n.split(".branch2.")[-1] in ("a.weight", "a_bn.weight", "a_bn.bias", "b.weight",
                                                    "b_bn.weight", "b_bn.bias", "c.weight") for n in zero)
    assert check.moving(want) == list(want["grad1"]) and not check.silent_leaves(want)
