"""The train steps' spans (``advise_tpu_torch/utils/host_times.py``, placed
by ``engine/steps.py``) and the split of a profiled window's device time by
them (``engine/meters.py span_split``), on the CPU at the tiny sizes of the
step tests: every step kind records ``step`` with its children, recording
changes no bit of a step, nothing is kept while not recording, the
profiler's trace shows the spans, and the split charges each operation,
each idle gap and each launch to the innermost span open when the host
launched it."""

import json
import threading
import types

import numpy as np
import pytest
import torch

from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, ingest_geometry
from advise_tpu_torch.engine.contrastive import init_ssl_state
from advise_tpu_torch.engine.meters import span_split
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import init_tmodeling_ssl, make_train_step
from advise_tpu_torch.engine.train import ProfileWindow
from advise_tpu_torch.models import build_model
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.host_times import HOST_TIMES, HostTimes, Span

from torch_port_common import (
    MASK_B,
    MASK_K,
    MASK_T,
    SPEED_B,
    SPEED_K,
    SPEED_T,
    TM_B,
    TM_K,
    TM_S,
    TM_T,
    B,
    T,
    loader_masks,
    masked_cfg,
    small_cfg,
    speed_cfg,
    tm_cfg,
)

torch.set_num_threads(1)

LR = 1e-3
AUG, FWD, BWD, BN, OPT = "step.aug", "step.forward", "step.backward", "step.bn_commit", "step.optimizer"


def _state(cfg, ssl=None, seed=0):
    model = build_model(cfg, "cpu", seed=seed)
    named = dict(model.named_parameters())
    bundle = build_tx(cfg, named)
    state = TrainState(model, bundle.tx.init(named), 0)
    if ssl is not None:
        state.ssl = ssl(model)
    return state, bundle


def _u8(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def _speed(sequential=False):
    cfg = speed_cfg(tconfig, **{"TRAIN.SEQUENTIAL": sequential})
    w, h = ingest_geometry(cfg, "train")
    infos = {"spd_label": torch.from_numpy(np.random.default_rng(1).integers(0, 4, (SPEED_B, SPEED_K)))}
    return cfg, _u8((SPEED_B, SPEED_K, SPEED_T, h, w, 3)), infos, (), None


def _byol(sequential=False):
    cfg = small_cfg(tconfig, **{"CONTRASTIVE.SEQUENTIAL": sequential})
    w, h = ingest_geometry(cfg, "train")
    ssl = lambda model: init_ssl_state(cfg, model, torch.Generator().manual_seed(0))  # noqa: E731
    return cfg, _u8((B, 2, T, h, w, 3)), {"item_id": torch.arange(B)}, (1.0,), ssl


def _tmodeling():
    cfg = tm_cfg(tconfig, **{"SSL.TASK": "speed_byol"})
    clips = torch.randn(TM_B, TM_K, TM_T, TM_S, TM_S, 3, generator=torch.Generator().manual_seed(2))
    infos = {"spd_label": torch.from_numpy(np.random.default_rng(1).integers(0, 4, (TM_B, TM_K)))}
    return cfg, clips, infos, (), lambda model: init_tmodeling_ssl(cfg, model)


def _masked():
    cfg = masked_cfg(tconfig)
    w, h = ingest_geometry(cfg, "train")
    masks = loader_masks(cfg, MASK_B * MASK_K)
    return (cfg, _u8((MASK_B, MASK_K, MASK_T, h, w, 3)),
            {"mask": torch.from_numpy(masks.reshape(MASK_B, MASK_K, *masks.shape[1:]))}, (), None)


# kind -> (set-up, the children of one step in order)
KINDS = {
    "speed": (_speed, [AUG, FWD, BWD, BN, OPT]),
    "speed_sequential": (lambda: _speed(True), [AUG] + [FWD, BWD] * SPEED_K + [BN, OPT]),
    "byol": (_byol, [AUG, FWD, BWD, BN, OPT]),
    # the momentum keys of both views, then one forward and backward a view
    "byol_sequential": (lambda: _byol(True), [AUG, FWD] + [FWD, BWD] * 2 + [BN, OPT]),
    "tmodeling": (_tmodeling, [FWD, BWD, BN, OPT]),  # clips already augmented: no aug
    "masked": (_masked, [AUG, FWD, BWD, BN, OPT]),
}


def _run(kind, steps, record, seed=0):
    setup, _ = KINDS[kind]
    cfg, clips, infos, extra, ssl = setup()
    state, bundle = _state(cfg, ssl, seed)
    aug = None if kind == "tmodeling" else build_device_aug(cfg, "train")
    step = make_train_step(cfg, bundle, aug)
    gen = torch.Generator().manual_seed(3)
    if record:
        HOST_TIMES.start()
    try:
        stats = [step(state, clips, infos, gen, LR, *extra) for _ in range(steps)]
    finally:
        spans = HOST_TIMES.stop()
    return state, stats, spans


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_each_step_kind_records_its_spans(kind):
    """Two steps record two roots ``step`` (ids 0 and 1), each with its
    children in order, nested inside it on its thread with its id; the
    sequential paths have one forward and backward a clip. The masked
    step's attention cores add their spans (``attn.*``) inside its forward
    and backward."""
    _, children = KINDS[kind]
    _, _, spans = _run(kind, 2, record=True)
    roots = [i for i, s in enumerate(spans) if s.name == "step"]
    assert [spans[i].step for i in roots] == [0, 1]
    for r in roots:
        root = spans[r]
        assert root.parent is None
        mine = [s for s in spans if s.parent == r]
        assert [s.name for s in mine] == children
        inside = [s for s in spans if s.step == root.step]
        cores = [s for s in inside if s.name.startswith("attn.")]
        assert bool(cores) == (kind == "masked")
        assert all(spans[s.parent].name in (FWD, BWD) for s in cores)
        assert len(inside) == len(children) + 1 + len(cores)
        for s in inside:
            assert s.thread == root.thread == threading.get_ident()
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        for a, b in zip(mine, mine[1:]):
            assert a.end_ns <= b.start_ns


def test_recording_changes_no_bit_of_a_step():
    """The speed step's stats and its model (parameters, BN buffers) are
    bit-equal with the recorder on and off."""
    off_state, off_stats, off_spans = _run("speed", 2, record=False, seed=5)
    on_state, on_stats, on_spans = _run("speed", 2, record=True, seed=5)
    assert off_spans == [] and len(on_spans) == 12
    for a, b in zip(off_stats, on_stats):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    off, on = off_state.model.state_dict(), on_state.model.state_dict()
    assert all(torch.equal(off[k], on[k]) for k in off)


def test_sums_always_on_and_spans_only_while_recording():
    """The sums count every span; nothing is kept before ``start`` or after
    ``stop``; a span records its parent and inherits its step."""
    times = HostTimes()
    with times("step", step=7):
        with times("step.forward"):
            pass
    assert times.stop() == []
    times.start()
    with times("step", step=8):
        with times("step.forward"):
            pass
        with times("step.backward"):
            pass
    spans = times.stop()
    with times("step", step=9):
        pass
    assert times.stop() == []
    assert [(s.name, s.parent, s.step) for s in spans] == [("step", None, 8), ("step.forward", 0, 8),
                                                            ("step.backward", 0, 8)]
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans)
    assert {k: n for k, (_, n) in times.snapshot().items()} == {"step": 3, "step.backward": 1, "step.forward": 2}


def test_operator_trace_shows_the_spans(tmp_path):
    """ProfileWindow (TPU.PROFILE_DIR) over one speed step: its trace.json
    holds each span as a ``record_function`` range, and its result splits no
    device time on the CPU."""
    setup, children = KINDS["speed"]
    cfg, clips, infos, _, _ = setup()
    cfg.TPU.PROFILE_DIR = str(tmp_path)
    cfg.TPU.PROFILE_START, cfg.TPU.PROFILE_STEPS = 0, 1
    state, bundle = _state(cfg)
    step = make_train_step(cfg, bundle, build_device_aug(cfg, "train"))
    window = ProfileWindow(cfg)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        step(state, clips, infos, gen, LR)
        window.after_step(state.step)
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"step", *children} <= names
    assert window.result["steps"] == 1 and window.result["spans"] == {}
    assert HOST_TIMES.stop() == []


def _span(name, parent, start, end, thread=1, step=0):
    return Span(name, parent, step, thread, start, end)


def test_span_split_charges_time_gaps_and_launches():
    """A hand-made window: one step (ns) with a forward, a backward whose
    operations autograd's thread launched, and an optimizer; an idle gap
    that ends at an optimizer's operation, overlapping operations, an
    operation of the root's own time and two charged to ``outside`` (one
    launched after the step, one whose launch the window missed). Each
    name's busy ms sum to the union of the operations."""
    spans = [_span("step", None, 0, 1000), _span("step.forward", 0, 10, 200),
             _span("step.backward", 0, 200, 600), _span("step.optimizer", 0, 600, 990),
             _span("worker", None, 0, 2000, thread=2)]  # another thread's span: not matched
    ops = [("f1", 1_000_000, 2_000_000, 1), ("f2", 2_500_000, 1_000_000, 2),  # overlap f1 by 0.5 ms
           ("b1", 4_000_000, 1_000_000, 3),  # gap 0.5 ms before it
           ("o1", 9_000_000, 500_000, 4),  # gap 4 ms: the card waits on the optimizer's launch
           ("o2", 9_500_000, 500_000, 5), ("self", 10_000_000, 1_000_000, 6),
           ("late", 11_000_000, 1_000_000, 7), ("lost", 12_500_000, 500_000, 8)]
    launched = {1: 20, 2: 150, 3: 300, 4: 700, 5: 980, 6: 995, 7: 1500}
    split = span_split(spans, ops, launched)
    assert split == {
        "step.forward": {"busy_ms": 2.5, "waited_ms": 0.0, "launches": 2},
        "step.backward": {"busy_ms": 1.0, "waited_ms": 0.5, "launches": 1},
        "step.optimizer": {"busy_ms": 1.0, "waited_ms": 4.0, "launches": 2},
        "step": {"busy_ms": 1.0, "waited_ms": 0.0, "launches": 1},
        "outside": {"busy_ms": 1.5, "waited_ms": 0.5, "launches": 2},
    }
    assert sum(r["busy_ms"] for r in split.values()) == 7.0


def test_span_split_innermost_and_open_spans():
    """A launch inside nested spans goes to the innermost; after a child
    closes, to its parent; inside a span still open when the recording
    stopped, to that span; without ``step`` spans nothing is matched."""
    spans = [_span("step", None, 0, None), _span("step.forward", 0, 10, 100),
             _span("inner", 1, 20, 30)]
    ops = [("a", 0, 10, 1), ("b", 10, 10, 2), ("c", 20, 10, 3), ("d", 30, 10, 4)]
    launched = {1: 25, 2: 50, 3: 150, 4: 5}
    split = span_split(spans, ops, launched)
    assert {k: v["launches"] for k, v in split.items()} == {"inner": 1, "step.forward": 1, "step": 2}
    fake = types.SimpleNamespace
    assert set(span_split([fake(name="x", thread=1, start_ns=0, end_ns=9, parent=None)], ops, launched)) == {
        "outside"}
