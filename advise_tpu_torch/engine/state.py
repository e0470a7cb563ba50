"""Train state (counterpart of ``advise_tpu/engine/state.py``).

The JAX state is one immutable pytree threaded through the jitted step.
Here the model module owns the parameters and BN buffers, and the step
updates them, the momentum trace and the SSL state in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from torch import nn


@dataclass
class TrainState:
    model: nn.Module             # online parameters + BN running statistics
    opt_state: Dict[str, Any]    # the optimizer's state ({'trace': {name: tensor}})
    step: int = 0
    # BYOL: {'ema_model': momentum encoder, 'knn_mem': kNN bank}; {} on the task step
    ssl: Dict[str, Any] = field(default_factory=dict)
