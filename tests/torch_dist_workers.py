"""Rank processes of the port's data-parallel tests (tests/test_torch_dist.py,
tests/test_torch_mesh.py), at module level so that ``spawn`` can import
them. They import torch and the port only, never JAX: the parent test
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
    model = build_model(cfg, "cpu")
    model.load_state_dict(case["model"])
    ssl = {}
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        ssl = tc.init_ssl_state(cfg, model, torch.Generator().manual_seed(0))
        if "ema_model" in ssl:
            ssl["ema_model"].load_state_dict(case["ema"])
            ssl["ema_model"].train()
        for name, value in case["ssl"].items():
            ssl[name] = value.clone()
    model.train()
    named = dict(model.named_parameters())
    bundle = build_tx(cfg, named)
    return TrainState(model, bundle.tx.init(named), 0, ssl), bundle


def run_case(case, rank: int, world: int):
    """The case's steps on this rank's rows of each global batch (rank r:
    rows r*b:(r+1)*b, shard_map's split) with the per-rank extras the parent
    drew from JAX's keys. Returns the per-step stats, the final model,
    momentum encoder and SSL tensors."""
    from advise_tpu_torch.engine.steps import make_train_step

    cfg = case["cfg"]
    state, bundle = build_case_state(case)
    step = make_train_step(cfg, bundle, None)
    contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
    stats = []
    for inputs in case["steps"]:
        b = inputs["clips"].shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        clips = torch.from_numpy(inputs["clips"][rows])
        infos = {k: torch.from_numpy(v[rows]) for k, v in inputs["infos"].items()}
        for k, per_rank in inputs.get("rank_infos", {}).items():
            infos[k] = per_rank[rank]
        gen = torch.Generator().manual_seed(1000 + rank)
        if contrastive:
            out = step(state, clips, infos, gen, case["lr"], case["epoch"])
        else:
            out = step(state, clips, infos, gen, case["lr"])
        stats.append({k: float(v) for k, v in out.items()})
    ssl = {k: v.detach().clone() for k, v in state.ssl.items() if torch.is_tensor(v)}
    ema = state.ssl["ema_model"].state_dict() if "ema_model" in state.ssl else {}
    return {"stats": stats, "model": _tensors(state.model.state_dict()), "ema": _tensors(ema), "ssl": ssl}


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
