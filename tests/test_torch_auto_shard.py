"""The port's TPU.PARTITION_MODE 'auto' (``parallel/auto_shard.py``: tensor
parallelism over 'model', FSDP over 'data') against the JAX package's
GSPMD step on its CPU mesh (set-up in ``tests/torch_auto_common.py``; the
contrastive cases in tests/test_torch_auto_contrastive.py).

- ``param_specs``: the tensor-parallel, FSDP and replicated leaf counts of
  ``describe_sharding`` equal JAX's for a MaskMViT (reversible, the MViT-L
  joint preset's structure at small width), MViT-L 32x312 itself (JAX's
  tree from ``jax.eval_shape``, the port's on the meta device), a Swin
  MoCo and a Slow-R10 speed model, at data 2 x model 2 with FSDP and at
  data 4 x model 2 without.
- 2-step trajectories at data 2 x model 2 with TPU.FSDP over 4 gloo ranks
  (one spawn: a ``file://`` rendezvous, a process-group timeout, a join
  deadline) against JAX's auto step on 4 devices, from the same initial
  state through the param bridge: MaskMViT's joint masked step (the
  masked MSE over the whole batch's masked tokens, as JAX's global arrays
  count them) and the Slow-R10 speed step. FSDP's threshold is lowered to
  256 elements on both sides (``_FSDP_MIN_ELEMENTS``) so that small tensors
  shard too. Tolerances (float32), those of tests/test_torch_dist.py: lr
  1e-4; what each parameter and BN statistic moved within 5e-2 of JAX's
  move plus 1e-6 of the tree's largest value; stats within 1e-3 of
  max(|JAX's|, 1), grad norm within 1e-2; every rank ends with the same
  whole state bit for bit.
- A plain checkpoint restores under 'auto' (each rank its shards) to the
  same whole-state digest and moments, and the checkpoint the 'auto' run
  writes restores in a plain process to the digest the ranks end with.
"""

import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine.checkpoint import CheckpointManager, module_state, tensors_digest
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.models import build_model
from advise_tpu_torch.solver.optimizer import build_tx

from torch_auto_common import (
    AUTO,
    CASES,
    _override,
    check_trajectory,
    jax_counts,
    jax_shapes,
    plain_checkpoint,
    port_counts,
    run_cases,
)

NAMES = ("masked", "speed")


@pytest.mark.parametrize("layout", [{"TPU.FSDP": True}, {"TPU.FSDP": False, "NUM_GPUS": 8}])
@pytest.mark.parametrize("name", ["masked", "swin_moco", "speed", "mvit_l"])
def test_param_spec_counts_equal_jax(name, layout):
    n_data = 2 if layout["TPU.FSDP"] else 4
    over = {**AUTO, **layout}
    if name == "mvit_l":
        def build(mod, **o):
            cfg = mod.get_cfg()
            cfg.merge_from_file("configs/pretrain/MViT_L_32x312_joint.yaml")
            _override(cfg, {"NUM_GPUS": 1, "TPU.MESH_SYNC": 1, "BN.NUM_SYNC_DEVICES": 1, **o})
            return mod.assert_and_infer_cfg(cfg)
        t, s = 32, 312
    else:
        build, _, t, s, _, _ = CASES[name]
    jcfg, tcfg = build(jconfig, **over), build(tconfig, **over)
    want = jax_counts(jcfg, jax_shapes(jcfg, t, s), n_data)
    assert port_counts(tcfg, n_data) == want, (name, want)


@pytest.fixture(scope="module")
def auto_world(tmp_path_factory):
    """The cases through JAX's auto step and the port's 4 ranks, and the
    checkpoint case, in one spawn."""
    tmp = tmp_path_factory.mktemp("auto4")
    mcfg = CASES["masked"][0](tconfig, **AUTO)
    mcfg.LOGDIR, mcfg.TRAIN.SAVE_FREQ, mcfg.SOLVER.MAX_EPOCH = str(tmp / "auto"), 1, 1
    plain = []

    def checkpoint_case():
        masked = torch.load(tmp / "case_masked.pt", weights_only=False)
        plain.extend(plain_checkpoint(tmp, mcfg, masked["model"]))
        return {"checkpoint": {**masked, "kind": "fn", "fn": "auto_checkpoint_case", "cfg": mcfg,
                               "plain_ckpt": plain[0]}}

    refs, outs = run_cases(tmp, NAMES, extra=checkpoint_case)
    return refs, outs, plain, mcfg, tmp


@pytest.mark.parametrize("name", NAMES)
def test_auto_ranks_match_jax_auto_step(auto_world, name):
    refs, outs, *_ = auto_world
    check_trajectory(refs, outs, name)


def test_auto_checkpoint_restores_both_ways(auto_world):
    _, outs, (path, digest0, moments0), mcfg, tmp = auto_world
    ranks = outs["checkpoint"]
    assert {r["restored"] for r in ranks} == {digest0}
    assert {r["moments"] for r in ranks} == {moments0}
    assert len({r["end"] for r in ranks}) == 1
    cfg = mcfg.clone()
    cfg.TPU.PARTITION_MODE, cfg.TPU.MESH_MODEL, cfg.TPU.FSDP = "shard_map", 1, False
    model = build_model(cfg, "cpu")
    named = dict(model.named_parameters())
    state = TrainState(model, build_tx(cfg, named).tx.init(named), 0)
    CheckpointManager(cfg).restore(str(tmp / "auto" / "checkpoints" / "Model_Epoch_0000"), state)
    assert tensors_digest(module_state(model)) == ranks[0]["end"]
    assert state.step == 4
