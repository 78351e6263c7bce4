"""The optimizer stack with the JAX package's semantics (``train/optim.py``),
on PyTorch's own Adam.

``torch.optim.Adam(lr=1e-4, eps=1e-6, weight_decay=1e-4, amsgrad=True)``
couples the weight decay into the gradient (L2, not AdamW) after the global
gradient norm is clipped to 100 (``clip_grad_norm_``); the JAX package's
``scale_by_torch_adam`` mirrors exactly this. On the card the optimizer is
``capturable``: its step counts live on the device beside the moments, so
the NaN gate (``train/steps.py``) can keep a skipped step's whole state on
the device without a host round trip; :func:`make_optimizer` creates the
state at once for the same reason. There the learning rate is a 0-d device
tensor too, so that a CUDA graph of the step (``train/steps.py``) reads it
at every replay: the plateau schedule, torch's own ``ReduceLROnPlateau``
(:func:`make_plateau`, of which the JAX package keeps a mirror), fills it in
place, and a restore writes into it (:func:`load_optimizer_state`). On the
CPU it is a float. :class:`SWA` is the JAX package's parameter average.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch

from dcs_net_tpu_torch.core.config import OptimConfig


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: OptimConfig) -> torch.optim.Adam:
    """Adam with amsgrad and coupled L2 on ``params`` (all on one device),
    its state created now: zero moments and a zero step count, on the
    device (capturable) when that is CUDA, and there the learning rate a
    float32 device scalar."""
    params = list(params)
    on_card = params[0].device.type == "cuda"
    lr = (torch.tensor(cfg.lr, dtype=torch.float32, device=params[0].device)
          if on_card else cfg.lr)
    opt = torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, cfg.beta2),
                           eps=cfg.eps, weight_decay=cfg.weight_decay,
                           amsgrad=cfg.amsgrad, capturable=on_card)
    for p in params:
        st = {"step": torch.zeros((), dtype=torch.float32,
                                  device=p.device if on_card else "cpu"),
              "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        if cfg.amsgrad:
            st["max_exp_avg_sq"] = torch.zeros_like(p)
        opt.state[p] = st
    return opt


def load_optimizer_state(opt: torch.optim.Optimizer, state: dict) -> None:
    """``opt.load_state_dict(state)`` that keeps each group's learning rate
    of the kind it had: a device tensor stays the same tensor (a captured
    step reads it), given the saved value; a float stays a float."""
    lrs = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict(state)
    for g, lr in zip(opt.param_groups, lrs):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(g["lr"]))
            g["lr"] = lr
        else:
            g["lr"] = float(g["lr"])


def optimizer_tensors(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every tensor of the optimizer's state, step counts included."""
    return [t for st in opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every gradient, on the device."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def step_count(opt: torch.optim.Optimizer) -> int:
    """Adam's applied steps (the first parameter's step count; a step that
    the NaN gate undid does not count). Reads the device."""
    st = opt.state[opt.param_groups[0]["params"][0]]
    return int(st["step"])


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def make_plateau(opt: torch.optim.Optimizer, cfg: OptimConfig
                 ) -> torch.optim.lr_scheduler.ReduceLROnPlateau:
    """ReduceLROnPlateau on the minimum of the monitored metric, relative
    threshold; ``eps=0`` so that every reduction above ``min_lr`` is taken,
    as in the JAX package's mirror."""
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="min", factor=cfg.plateau_factor, patience=cfg.plateau_patience,
        threshold=cfg.plateau_threshold, min_lr=cfg.plateau_min_lr, eps=0.0)


@dataclass
class SWA:
    """Equal-weight parameter averaging from ``start_epoch`` on, over a list
    of tensors (a model's parameters, in their order): ``avg += (p - avg) /
    (n + 1)``, as the JAX package's ``SWA``."""

    start_epoch: int
    avg_params: Optional[List[torch.Tensor]] = None
    n_averaged: int = 0

    def update(self, epoch: int, params: Iterable[torch.Tensor]) -> None:
        if epoch < self.start_epoch:
            return
        params = [p.detach() for p in params]
        if self.avg_params is None:
            self.avg_params = [p.clone() for p in params]
            self.n_averaged = 1
            return
        n = self.n_averaged
        for a, p in zip(self.avg_params, params):
            a.add_((p - a) / (n + 1))
        self.n_averaged = n + 1

    @property
    def active(self) -> bool:
        return self.avg_params is not None
