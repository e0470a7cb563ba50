"""The system under test: the train step of ``advise_tpu_torch`` for one
configuration, driven as the trainer drives it, on the benchmark's weights
and batches.

The step is ``make_train_step(cfg, bundle, aug)`` over
``build_train_state(cfg, device)``, called as ``step(state, clips_u8,
infos, generator, lr)``; step i's generator is seeded with
``inputs.step_seed(seed, i)`` and its batch is the pool's ``i % pool``.
The weights that ``build_train_state`` draws are replaced by the
benchmark's before the first step.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from harness import manifest
from harness.inputs import Batch, step_seed


def port_config(spec: dict):
    """The measured package's config: its defaults, the preset of the
    configuration's file, then its ``overrides`` (every key of ``reduced``)."""
    from advise_tpu_torch import config as tconfig

    cfg = tconfig.get_cfg()
    cfg.merge_from_other_cfg(spec["preset"])
    cfg.merge_from_other_cfg(spec["overrides"])
    cfg.NUM_WORLDS = cfg.NUM_GPUS
    return tconfig.assert_and_infer_cfg(cfg)


class AugSpan:
    """The aug callable handed to the step with a CUDA event recorded on the
    step's stream before and after each call: the aug's stream time,
    read once the window has closed."""

    def __init__(self, aug):
        self.aug = aug
        self.events: List[tuple] = []

    def __call__(self, batch_u8, generator):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.aug(batch_u8, generator)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> List[float]:
        return [s.elapsed_time(e) for s, e in self.events]


class Program:
    def __init__(self, spec: dict, traffic: dict, seed: int, device, aug_span: bool = False):
        from advise_tpu_torch.data import build_device_aug
        from advise_tpu_torch.engine.steps import make_train_step
        from advise_tpu_torch.engine.train import build_train_state

        self.cfg = port_config(spec)
        self.spec, self.seed, self.lr = spec, seed, float(traffic["lr"])
        self.state, self.bundle = build_train_state(self.cfg, device)
        aug = build_device_aug(self.cfg, "train")
        self.aug_span = AugSpan(aug) if aug_span else None
        self.step = make_train_step(self.cfg, self.bundle, self.aug_span or aug)
        self.gen = torch.Generator(device=device)

    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.state.model.named_parameters())

    @torch.no_grad()
    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        """Copy the benchmark's weights into the model; names and shapes have
        to be the reference's exactly."""
        params = self.params()
        if set(params) != set(weights):
            missing, extra = sorted(set(weights) - set(params)), sorted(set(params) - set(weights))
            raise ValueError(f"the program's parameters differ from the reference's: "
                             f"not in the program {missing[:5]}, not in the reference {extra[:5]}")
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])

    def call(self, i: int, batch: Batch) -> Dict[str, torch.Tensor]:
        """Step i on ``batch``; returns the step's stats, not read."""
        clips, infos = batch
        self.gen.manual_seed(step_seed(self.seed, i))
        return self.step(self.state, clips, infos, self.gen, self.lr)

    def received(self, start: Dict[str, torch.Tensor], wds: Dict[str, float]) -> Dict[str, torch.Tensor]:
        """The first gradient as the optimizer received it (after its clip),
        worked out from its state after one step by the solver's reader,
        ``benchmark/solvers/<method>.py``."""
        solver = self.spec["reference_spec"]["solver"]
        return manifest.solver(solver["method"]).received(self.state.opt_state, start, wds, solver)

    def release(self) -> None:
        self.state = self.bundle = self.step = None
