"""Host-side learning-rate controllers (a copy of
``dalle_pytorch_tpu/utils/schedules.py``).

The reference uses torch's stateful schedulers: ReduceLROnPlateau on the
DALL-E trainer (train_dalle.py:429-441) and ExponentialLR on the VAE trainer
(train_vae.py:150-151). The controller stays on the host (tiny state,
checkpointable via state_dict) and emits a plain float that the train step
takes per call, so a change of lr rebuilds nothing.
"""

from __future__ import annotations

import math
from typing import Optional


class ReduceLROnPlateau:
    """lr *= factor after ``patience`` non-improving metrics (torch semantics
    with min mode, the reference's configuration, train_dalle.py:430-437)."""

    def __init__(
        self,
        lr: float,
        factor: float = 0.5,
        patience: int = 10,
        cooldown: int = 10,
        min_lr: float = 1e-6,
        threshold: float = 1e-4,
    ):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = math.inf
        self.num_bad = 0
        self.cooldown_counter = 0

    def step(self, metric: float) -> float:
        # torch's exact step order (lr_scheduler.ReduceLROnPlateau.step):
        # improvement test, THEN the cooldown decrement (which runs on every
        # in-cooldown step — including improving ones — and zeroes the bad
        # count), then the reduction check
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad": self.num_bad,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad = int(d["num_bad"])
        self.cooldown_counter = int(d["cooldown_counter"])


class ExponentialDecay:
    """lr *= gamma per epoch (train_vae.py:150-151)."""

    def __init__(self, lr: float, gamma: float = 0.98):
        self.lr = lr
        self.gamma = gamma

    def step(self, metric: Optional[float] = None) -> float:
        self.lr *= self.gamma
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])


class ConstantLR:
    def __init__(self, lr: float):
        self.lr = lr

    def step(self, metric: Optional[float] = None) -> float:
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])


def gumbel_temperature(step: int, t0: float, anneal_rate: float, t_min: float) -> float:
    """temp = max(t0 * exp(-rate * step), t_min), updated every 100 steps in
    the reference (train_vae.py:269-271)."""
    return max(t0 * math.exp(-anneal_rate * step), t_min)
