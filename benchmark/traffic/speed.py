"""Speed labels: ``spd_label`` [B, K] uniform over the cell's ``classes``
(``labels``: ``{"kind": "speed", "classes": C}``)."""

import torch


def infos(labels: dict, clips: torch.Tensor, gen: torch.Generator) -> dict:
    b, k = clips.shape[:2]
    return {"spd_label": torch.randint(0, labels["classes"], (b, k), generator=gen, device=clips.device)}
