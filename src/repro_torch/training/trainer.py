"""Training-loop steps (the port of ``repro.training.trainer``).

So far the evaluation step: validation loss and perplexity through
``models.loss_fn``, whose loss is the LM head's cross-entropy kernels.
``make_train_step`` comes with attention backward.
"""
from __future__ import annotations

import torch

from repro_torch.models import loss_fn


def make_eval_step(cfg):
    """eval_step(params, batch) -> {"loss", "perplexity"} (0-d f32 tensors
    on the batch's device), run under ``torch.no_grad()``."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch)
        return {"loss": metrics["loss"],
                "perplexity": torch.exp(metrics["loss"])}

    return eval_step
