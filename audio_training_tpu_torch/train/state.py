"""Train state: the model (parameters and BatchNorm running statistics)
plus Adam with a learning rate settable between steps (port of
``audio_training_tpu/train/state.py``).

``torch.optim.Adam`` is what ``optax.adam`` is: b1 0.9, b2 0.999, eps 1e-8
added outside the square root, bias-corrected moments.  The learning rate
lives in the param group, so ReduceLROnPlateau rescales it from the host
(the reference uses the Keras callback, audiomodel.py:913-921).  The state
is mutable: a step updates the model and the optimizer in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from audio_training_tpu_torch.utils.profiling import setup_span


def make_optimizer(params, learning_rate: float = 0.01) -> torch.optim.Adam:
    """Adam at lr 0.01 (audiomodel.py:149, optimizer(), :1226-1240)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def current_lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_lr(self, lr: float) -> "TrainState":
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self

    def reset_optimizer(self) -> "TrainState":
        """Fresh Adam moments at the current learning rate."""
        self.optimizer = make_optimizer(self.model.parameters(),
                                        self.current_lr())
        return self


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Draw every layer's initial weights anew from ``seed`` (the Flax
    ``module.init(PRNGKey(seed))``; the bits differ from JAX's)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return module


@setup_span("setup.create_train_state")
def create_train_state(
    module: nn.Module,
    learning_rate: float = 0.01,
    seed: int | None = None,
    device: str | torch.device | None = None,
) -> TrainState:
    """The model (weights drawn from ``seed`` when given, else kept as
    built) on ``device`` (default: where it is), with fresh Adam moments.
    The seed's draws run on the CPU, so they do not depend on the device."""
    device = device or next(module.parameters()).device
    if seed is not None:
        init_weights(module.cpu(), seed)
    module.to(device)
    return TrainState(module, make_optimizer(module.parameters(),
                                             learning_rate))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
