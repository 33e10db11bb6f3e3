"""Adam as ``optax`` steps it, with optax's global-norm clip and cosine
decay, for the port's two optimisers: the Gaussian-splatting volume's
(``ops/gaussian_splatting.py``) and the trainers' (``models/train_*.py``).

- ``adam_step_``: ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, eps_root 0): the moments of every leaf, their bias
  corrections by the update count, then ``p -= lr * mu_hat /
  (sqrt(nu_hat) + eps)``, in place.
- ``clip_by_global_norm``: ``optax.clip_by_global_norm``, which scales by
  ``max_norm / norm`` only when ``norm >= max_norm`` and adds nothing to
  the norm (``torch.nn.utils.clip_grad_norm_`` adds 1e-6); decided on the
  device, with no host synchronisation.
- ``cosine_decay``: ``optax.cosine_decay_schedule``'s closed form at an
  update count from 0 (``CosineAnnealingLR`` is a recursion that drifts
  from it).
- ``minimise_step_``: a loss's gradient by autograd, the optional clip,
  then one Adam update: a trainer's step.

The leaves go through the multi-tensor ``torch._foreach_*`` ops, a few
launches for all of them instead of several a leaf; elementwise they are
the same operations in the same order as one tensor at a time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


@dataclass
class AdamState:
    """optax ``adam`` state: first and second moments of every trainable
    leaf, and the update count."""
    mu: dict = field(default_factory=dict)
    nu: dict = field(default_factory=dict)
    count: int = 0


def init_state(params: dict) -> AdamState:
    return AdamState({n: torch.zeros_like(p) for n, p in params.items()},
                     {n: torch.zeros_like(p) for n, p in params.items()})


@torch.no_grad()
def adam_step_(params: dict, grads: dict, state: AdamState, lr: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamState:
    """One Adam update of the tensors ``params`` (name -> tensor) by
    ``grads`` (the same names), in place."""
    state.count += 1
    c1 = 1.0 - b1 ** state.count
    c2 = 1.0 - b2 ** state.count
    names = list(params)
    gs = [grads[n] for n in names]
    mus = [state.mu[n] for n in names]
    nus = [state.nu[n] for n in names]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, gs, alpha=1.0 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, torch._foreach_mul(gs, gs), alpha=1.0 - b2)
    den = torch._foreach_div(nus, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    step = torch._foreach_div(mus, c1)
    torch._foreach_mul_(step, lr)
    torch._foreach_div_(step, den)
    torch._foreach_sub_([params[n] for n in names], step)
    return state


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """``grads`` scaled by ``max_norm / norm`` when their global L2 norm is
    ``max_norm`` or more, else unchanged (a new dict)."""
    names = list(grads)
    gs = [grads[n] for n in names]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return dict(zip(names, torch._foreach_mul(gs, scale)))


def cosine_decay(lr: float, steps: int, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps)`` at update ``count``."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))


def minimise_step_(params: dict, loss: torch.Tensor, state: AdamState, lr: float,
                   max_norm: float | None = None) -> torch.Tensor:
    """Differentiate ``loss`` with respect to ``params`` (name -> leaf
    tensor), clip the gradient's global norm at ``max_norm`` when given,
    and take one Adam step in place; returns the loss, detached."""
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    if max_norm is not None:
        grads = clip_by_global_norm(grads, max_norm)
    adam_step_(params, grads, state, lr)
    return loss.detach()
