"""Rank processes of the port's multi-rank tests (tests/test_torch_dist.py,
tests/test_torch_mesh.py; the model-parallel tests/test_torch_ring_attention.py,
test_torch_pipeline.py, test_torch_auto_shard.py), at module level so that
``spawn`` can import them. They import torch and the port only, never JAX: the parent test
computes the JAX references and hands each rank its inputs in a file.

Every rank joins a gloo group through a ``file://`` rendezvous in the test's
tmp dir (no port to race for) with a process-group timeout, so a collective
that hangs fails its rank, and the parent joins the ranks with a deadline
of its own (:func:`spawn_ranks`).
"""

from __future__ import annotations

import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def spawn_ranks(fn, world: int, args: tuple, deadline_s: float) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes; raise if
    one fails or the ranks are not all done after ``deadline_s`` seconds
    (the survivors are killed first)."""
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks still running after {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def join_group(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)


def _tensors(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


def build_case_state(case):
    """The port's train state of a case: its model holding ``case['model']``,
    the SSL state's tensors and momentum encoder, the optimizer state."""
    from advise_tpu_torch.engine import contrastive as tc
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.solver.optimizer import build_tx

    cfg = case["cfg"]
    if "fsdp_min" in case:  # FSDP's threshold lowered so that small tensors shard
        from advise_tpu_torch.parallel import auto_shard

        auto_shard._FSDP_MIN_ELEMENTS = case["fsdp_min"]
    model = build_model(cfg, "cpu")
    auto = cfg.TPU.PARTITION_MODE == "auto"
    if not auto:
        model.load_state_dict(case["model"])
    ssl = {}
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        ssl = tc.init_ssl_state(cfg, model, torch.Generator().manual_seed(0))
        if "ema_model" in ssl and not auto:
            ssl["ema_model"].load_state_dict(case["ema"])
            ssl["ema_model"].train()
        for name, value in case["ssl"].items():
            ssl[name] = value.clone()
    model.train()
    named = dict(model.named_parameters())
    bundle = build_tx(cfg, named)
    state = TrainState(model, bundle.tx.init(named), 0, ssl)
    if auto:  # split first, then JAX's trees through the bridge into the shards
        from advise_tpu_torch.parallel.auto_shard import layout_of, shard_train_state
        from advise_tpu_torch.utils.convert import flax_to_sharded

        shard_train_state(cfg, state, bundle)
        flax_to_sharded(model, case["jax_params"], case["jax_batch_stats"])
        if "ema_model" in ssl:
            layout_of(ssl["ema_model"]).load_full(case["ema"])
            ssl["ema_model"].train()
    return state, bundle


def run_case(case, rank: int, world: int):
    """The case's steps on this rank's rows of each global batch (batch
    index i of the ranks that carry distinct batches: rows i*b:(i+1)*b,
    shard_map's split; ranks that differ only in 'seq', 'pipe' or 'model'
    take the same rows) with the per-rank extras the parent drew from JAX's
    keys, and a step's ``keeps`` (an MViT encoder's drop-path masks by
    block, from JAX's draws) in place of the encoder's own. Returns the per-step stats, the final model, momentum encoder and
    SSL tensors (whole tensors under 'auto')."""
    from advise_tpu_torch.engine.checkpoint import module_state
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.parallel.collectives import replica_index, world_size

    cfg = case["cfg"]
    state, bundle = build_case_state(case)
    step = make_train_step(cfg, bundle, None)
    contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
    index, n_batch = replica_index(), world_size()
    stats = []
    for inputs in case["steps"]:
        b = inputs["clips"].shape[0] // n_batch
        rows = slice(index * b, (index + 1) * b)
        clips = torch.from_numpy(inputs["clips"][rows])
        infos = {k: torch.from_numpy(v[rows]) for k, v in inputs["infos"].items()}
        for k, per_rank in inputs.get("rank_infos", {}).items():
            infos[k] = per_rank[index]
        if "keeps" in inputs:  # JAX's drop-path draws, {block: masks}, in place of the encoder's
            state.model.encoder._keeps = lambda b, generator, keeps=inputs["keeps"]: keeps
        gen = torch.Generator().manual_seed(1000 + index)
        if contrastive:
            out = step(state, clips, infos, gen, case["lr"], case["epoch"])
        else:
            out = step(state, clips, infos, gen, case["lr"])
        stats.append({k: float(v) for k, v in out.items()})
    ssl = {k: v.detach().clone() for k, v in state.ssl.items() if torch.is_tensor(v)}
    ema = module_state(state.ssl["ema_model"]) if "ema_model" in state.ssl else {}
    return {"stats": stats, "model": _tensors(module_state(state.model)), "ema": _tensors(ema), "ssl": ssl}


def cases_worker(rank: int, world: int, tmp: str, names) -> None:
    """Every case of ``names`` (``tmp/case_<name>.pt``) on this rank of a
    gloo group of ``world``; writes ``tmp/out_<name>_<rank>.pt``."""
    from advise_tpu_torch.parallel.mesh import init_groups

    try:
        join_group(rank, world, tmp)
        for name in names:
            case = torch.load(os.path.join(tmp, f"case_{name}.pt"), weights_only=False)
            init_groups(case["cfg"])
            torch.save(run_case(case, rank, world), os.path.join(tmp, f"out_{name}_{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def world_one_worker(rank: int, world: int, tmp: str, names) -> None:
    """Each case of ``names`` twice in one process: with no process group,
    then as the one rank of a gloo group; writes both results."""
    from advise_tpu_torch.parallel.mesh import init_groups

    torch.set_num_threads(1)
    cases = {n: torch.load(os.path.join(tmp, f"case_{n}.pt"), weights_only=False) for n in names}
    alone = {n: run_case(c, 0, 1) for n, c in cases.items()}
    join_group(rank, world, tmp)
    grouped = {}
    for n, c in cases.items():
        init_groups(c["cfg"])
        grouped[n] = run_case(c, 0, 1)
    torch.save({"alone": alone, "grouped": grouped}, os.path.join(tmp, "world_one.pt"))
    dist.destroy_process_group()


def trainer_worker(rank: int, world: int, tmp: str, cfgs) -> None:
    """The trainer on each config of ``cfgs`` in turn, this rank of a gloo
    group; writes each run's record, with the checkpoint writes this rank
    made (``saves``), to ``tmp/record_<i>_<rank>.pt``."""
    from advise_tpu_torch.engine import checkpoint
    from advise_tpu_torch.engine.train import trainer

    saves = []
    save_at = checkpoint.CheckpointManager._save_at

    def counted(self, path, state, meta):
        saves.append(os.path.basename(path))
        return save_at(self, path, state, meta)

    checkpoint.CheckpointManager._save_at = counted
    try:
        join_group(rank, world, tmp)
        for i, cfg in enumerate(cfgs):
            record = {}
            saves.clear()
            trainer(cfg, device="cpu", record=record)
            torch.save(dict(record, saves=list(saves)), os.path.join(tmp, f"record_{i}_{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def loader_worker(rank: int, world: int, tmp: str, cfg) -> None:
    """The port's build_loader on this rank: its first epoch's item ids
    [batches, B] and first batch's clips into ``tmp/loader_<rank>.npz``."""
    from advise_tpu_torch.data import build_loader

    join_group(rank, world, tmp)
    loader = build_loader(cfg, "train")
    batches = list(loader.epoch(0))
    np.savez(os.path.join(tmp, f"loader_{rank}.npz"), ids=np.stack([infos["item_id"] for _, infos in batches]),
             clips=batches[0][0])
    dist.destroy_process_group()


def model_parallel_worker(rank: int, world: int, tmp: str, names) -> None:
    """Every case of ``names`` (``tmp/case_<name>.pt``, each a dict with a
    ``kind``) on this rank of a gloo group of ``world``, in order; writes
    ``tmp/out_<name>_<rank>.pt``. Kinds: 'steps' (:func:`run_case`), and
    'fn': ``case['fn']`` (a function of this module, by name) called with
    the case."""
    from advise_tpu_torch.parallel.mesh import init_groups

    try:
        join_group(rank, world, tmp)
        for name in names:
            case = torch.load(os.path.join(tmp, f"case_{name}.pt"), weights_only=False)
            init_groups(case["cfg"])
            if case["kind"] == "steps":
                out = run_case(case, rank, world)
            else:
                out = globals()[case["fn"]](case, rank, world)
            torch.save(out, os.path.join(tmp, f"out_{name}_{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def ring_case(case, rank: int, world: int):
    """``sequence_sharded_attention`` of the case's whole q, k, v over 'seq':
    the output and the inputs' gradients of sum(out * w) on this rank."""
    from advise_tpu_torch.parallel.ring_attention import sequence_sharded_attention

    q, k, v = (torch.from_numpy(case[n]).requires_grad_(True) for n in ("q", "k", "v"))
    out = sequence_sharded_attention(q, k, v, "seq")
    (out * torch.from_numpy(case["w"])).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in (q, k, v)]}


def attention_case(case, rank: int, world: int):
    """The port's MultiScaleAttention of the case's kwargs with seq_axis
    'seq', holding the case's parameters: its output on the case's x and
    the gradients of sum(out * w) by parameter name and for x."""
    from advise_tpu_torch.models.layers.attention import MultiScaleAttention

    attn = MultiScaleAttention(**case["kwargs"], seq_axis="seq")
    attn.load_state_dict(case["params"])
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    out, _ = attn(x, case["thw"])
    (out * torch.from_numpy(case["w"])).sum().backward()
    grads = {n: p.grad for n, p in attn.named_parameters()}
    return {"out": out.detach(), "grads": grads, "x_grad": x.grad}


def gpipe_case(case, rank: int, world: int):
    """The port's gpipe over 'pipe' of the case's chain (tanh(h @ w_k), the
    stage's contiguous range of the depth), with sync_cotangents on w and x:
    the output and the gradients of sum(y^2); and, with ``index_probe``,
    the chain h + m of the microbatch index on zeros."""
    from advise_tpu_torch.parallel.collectives import replica_index
    from advise_tpu_torch.parallel.pipeline import gpipe, sync_cotangents

    w = torch.from_numpy(case["w"]).requires_grad_(True)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    ws, xs = sync_cotangents([w, x], "pipe")
    s, local = replica_index("pipe"), w.shape[0] // world

    def stage(h, m):
        (hh,) = h
        for k in range(s * local, (s + 1) * local):
            hh = torch.tanh(hh @ ws[k])
        return (hh,)

    (y,) = gpipe(stage, (xs,), n_stage=world, n_micro=case["n_micro"], axes="pipe")
    (y ** 2).sum().backward()
    (probe,) = gpipe(lambda h, m: (h[0] + m,), (torch.zeros(world, 2, dtype=torch.float64),), n_stage=world,
                     n_micro=world, axes="pipe")
    return {"y": y.detach(), "w_grad": w.grad, "x_grad": x.grad, "probe": probe}


def divides_none_case(case, rank: int, world: int):
    """The port's MViT of the case's config (a pipe size that divides none
    of its reversible segments) forward on zeros: the AssertionError's
    text."""
    from advise_tpu_torch.models import build_model

    model = build_model(case["cfg"], "cpu")
    try:
        model(torch.zeros(case["shape"]), loader_mask=torch.zeros(case["mask_shape"], dtype=torch.bool))
    except AssertionError as err:
        return {"error": str(err)}
    return {"error": None}


def auto_checkpoint_case(case, rank: int, world: int):
    """Under 'auto': the plain checkpoint at ``case['plain_ckpt']`` restored
    (each rank its shards), one step, the state saved by the
    CheckpointManager into ``case['logdir']`` (whole tensors, rank 0
    writing). Returns the whole state's digests after the restore and at
    the end, and the whole moments' after the restore."""
    from advise_tpu_torch.engine.checkpoint import CheckpointManager, module_state, state_dict, tensors_digest
    from advise_tpu_torch.engine.steps import make_train_step

    state, bundle = build_case_state(case)
    manager = CheckpointManager(case["cfg"])
    manager.restore(case["plain_ckpt"], state)
    restored = tensors_digest(module_state(state.model))
    moments = tensors_digest(state_dict(state)["opt_state"]["mu"])
    inputs = case["steps"][0]
    step = make_train_step(case["cfg"], bundle, None)
    from advise_tpu_torch.parallel.collectives import replica_index, world_size

    b = inputs["clips"].shape[0] // world_size()
    rows = slice(replica_index() * b, (replica_index() + 1) * b)
    step(state, torch.from_numpy(inputs["clips"][rows]),
         {k: torch.from_numpy(v[rows]) for k, v in inputs["infos"].items()}, torch.Generator().manual_seed(3), case["lr"])
    manager.save(state, 0, {"loss_mask": 1.0})
    return {"restored": restored, "moments": moments, "end": tensors_digest(module_state(state.model))}


def trainer_case(case, rank: int, world: int):
    """The trainer on the case's config (this rank of the group), checkpoint
    writes counted as in :func:`trainer_worker`: its run record."""
    from advise_tpu_torch.engine import checkpoint
    from advise_tpu_torch.engine.train import trainer

    saves = []
    save_at = checkpoint.CheckpointManager._save_at

    def counted(self, path, state, meta):
        saves.append(os.path.basename(path))
        return save_at(self, path, state, meta)

    checkpoint.CheckpointManager._save_at = counted
    try:
        record = {}
        trainer(case["cfg"], device="cpu", record=record)
    finally:
        checkpoint.CheckpointManager._save_at = save_at
    return dict(record, saves=saves)
