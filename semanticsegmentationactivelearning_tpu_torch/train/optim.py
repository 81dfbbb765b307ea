"""Optimizers from the conf schema, the PyTorch port of
``semanticsegmentationactivelearning_tpu/train/optim.py`` (reference:
train.py:136-150; the ``hyperparams.optimizer`` block of C22).

The TF names of the kwargs (beta1, beta2, epsilon, momentum, decay,
use_nesterov, weight_decay) map onto ``torch.optim`` as the JAX package
maps them onto optax, with optax's defaults. The learning rate follows
the inverse-time decay ``lr / (1 + rate * step / decay_steps)`` of
``tf.train.inverse_time_decay`` through a ``LambdaLR`` stepped once per
optimizer step, so the rate of update ``k`` is the schedule at ``k``.

RMSProp is the port's own: optax's ``rmsprop`` puts ``eps`` inside the
square root (``g / sqrt(nu + eps)``) and runs its momentum on the
learning-rate-scaled update, where ``torch.optim.RMSprop`` adds ``eps``
outside the root and scales by the rate after the momentum.

Weight decay belongs to the loss (``ops.losses.regularization_loss``);
no optimizer here decays weights, AdamW's decoupled decay excepted, as
in optax.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Tuple, Union

import torch
from torch.optim.lr_scheduler import LambdaLR


def make_schedule(learning_rate: float, decay_rate: float,
                  decay_steps: int) -> Union[float, Callable]:
    """The learning rate, or ``step -> rate`` under inverse-time decay."""
    if decay_rate <= 0.0:
        return learning_rate

    def schedule(step):
        return learning_rate / (1.0 + decay_rate * step / decay_steps)

    return schedule


class RMSProp(torch.optim.Optimizer):
    """optax's ``rmsprop`` (not centred, no bias correction, initial
    scale 0): ``nu = decay * nu + (1 - decay) * g**2``,
    ``u = lr * g / sqrt(nu + eps)``, then with momentum
    ``t = u + momentum * t`` (Nesterov: ``u + momentum * t``, the new
    ``t``), and ``p -= t``."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9,
                 eps: float = 1e-8, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if group["momentum"]:
                        state["trace"] = torch.zeros_like(p)
                g = p.grad
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(g, g,
                                                 value=1 - group["decay"])
                u = g * torch.rsqrt(nu + group["eps"]) * group["lr"]
                if group["momentum"]:
                    t = state["trace"]
                    t.mul_(group["momentum"]).add_(u)
                    u = (u + group["momentum"] * t if group["nesterov"]
                         else t)
                p.sub_(u)
        return loss


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   hyperparams: Dict[str, Any], steps_per_epoch: int = 1
                   ) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    """``(optimizer, scheduler)`` for the conf's ``hyperparams``:
    Adam, SGD (or GradientDescent), Momentum, RMSProp or AdamW, at the
    conf's learning rate under its inverse-time decay with
    ``steps_per_epoch`` as the decay steps. Step the scheduler once
    after every optimizer step."""
    params = list(params)
    opt_conf = hyperparams.get("optimizer", {"type": "Adam", "kwargs": {}})
    kwargs = dict(opt_conf.get("kwargs", {}))
    lr = float(hyperparams.get("learning_rate", 5e-4))
    schedule = make_schedule(lr, hyperparams.get("learning_rate_decay", 0.0),
                             max(int(steps_per_epoch), 1))
    kind = opt_conf.get("type", "Adam").lower()

    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr,
                               betas=(kwargs.get("beta1", 0.9),
                                      kwargs.get("beta2", 0.999)),
                               eps=kwargs.get("epsilon", 1e-8))
    elif kind in ("sgd", "gradientdescent"):
        opt = torch.optim.SGD(params, lr=lr)
    elif kind == "momentum":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=kwargs.get("momentum", 0.9),
                              nesterov=kwargs.get("use_nesterov", False))
    elif kind == "rmsprop":
        opt = RMSProp(params, lr=lr, decay=kwargs.get("decay", 0.9),
                      eps=kwargs.get("epsilon", 1e-10),
                      momentum=kwargs.get("momentum", 0.0))
    elif kind == "adamw":
        # optax.adamw: eps 1e-8, whatever the conf's epsilon
        opt = torch.optim.AdamW(params, lr=lr,
                                betas=(kwargs.get("beta1", 0.9),
                                       kwargs.get("beta2", 0.999)),
                                weight_decay=kwargs.get("weight_decay",
                                                        1e-4))
    else:
        raise NotImplementedError(f"Optimizer {opt_conf.get('type')!r} "
                                  "not supported")
    factor = ((lambda step: schedule(step) / lr) if callable(schedule)
              else (lambda step: 1.0))
    return opt, LambdaLR(opt, factor)


def set_schedule_step(scheduler: LambdaLR, step: int) -> None:
    """Put ``scheduler`` and its optimizer at update ``step`` (a run
    resumed from a checkpoint that holds no scheduler state)."""
    scheduler.last_epoch = int(step)
    lrs = [base * fn(step) for base, fn in zip(scheduler.base_lrs,
                                               scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
