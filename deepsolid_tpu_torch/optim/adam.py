"""The adam optimizer of the training step, as plain functions on the
parameter tree.

Counterpart of what the JAX package builds from optax in
train/process.py (`adam_optimizer`): an optional clip of the gradient's
global norm, scale_by_adam, the learning-rate schedule
rate * (1 / (1 + t / delay)) ** decay, a sign flip, and MultiSteps when
`ministeps` > 1. torch.optim.Adam is not used: its epsilon sits after the
bias correction of the second moment alone and it has no eps_root, so it
does not give optax's update.

The state mirrors optax's, element by element and field by field (a
tuple in chain order of named tuples with optax's field names), so a
checkpoint's optimizer state reads the same from either package:
`state_from_numpy` takes whatever has those fields, `state_to_numpy`
gives numpy leaves for the checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from deepsolid_tpu_torch.utils.tree import tree_leaves, tree_map


class EmptyState(NamedTuple):
    """State of a stateless link of the chain (clip, sign flip)."""


class ScaleByAdamState(NamedTuple):
    count: Any  # int32 scalar
    mu: Any  # first moments, a tree like the parameters
    nu: Any  # second moments


class ScaleByScheduleState(NamedTuple):
    count: Any


class MultiStepsState(NamedTuple):
    mini_step: Any
    gradient_step: Any
    inner_opt_state: Any
    acc_grads: Any
    skip_state: Any = ()


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


def learning_rate_schedule(cfg) -> Callable:
    rate, delay, decay = cfg.optim.lr.rate, cfg.optim.lr.delay, cfg.optim.lr.decay

    def schedule(t):
        return rate * (1.0 / (1.0 + t / delay)) ** decay

    return schedule


class Adam:
    """init(params) -> state; update(grads, state) -> (updates, state);
    apply the updates with `apply_updates`."""

    def __init__(self, schedule: Callable, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, gradient_clip: float = 0.0, ministeps: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.gradient_clip = gradient_clip
        self.ministeps = ministeps

    @classmethod
    def from_config(cls, cfg) -> "Adam":
        return cls(learning_rate_schedule(cfg), **dict(cfg.optim.adam),
                   gradient_clip=cfg.optim.gradient_clip,
                   ministeps=cfg.optim.ministeps)

    # -- state ---------------------------------------------------------------

    def init(self, params) -> Tuple:
        leaf = tree_leaves(params)[0]
        zero = torch.zeros((), dtype=torch.int32, device=leaf.device)
        chain = (ScaleByAdamState(zero, tree_map(torch.zeros_like, params),
                                  tree_map(torch.zeros_like, params)),
                 ScaleByScheduleState(zero), EmptyState())
        if self.gradient_clip > 0:
            chain = (EmptyState(),) + chain
        if self.ministeps > 1:
            return MultiStepsState(zero, zero, chain,
                                   tree_map(torch.zeros_like, params), ())
        return chain

    # -- update --------------------------------------------------------------

    def _chain_update(self, grads, chain):
        adam_at = 1 if self.gradient_clip > 0 else 0
        adam, sched = chain[adam_at], chain[adam_at + 1]
        if self.gradient_clip > 0:
            norm = global_norm(grads)
            factor = torch.where(norm < self.gradient_clip, torch.ones_like(norm),
                                 self.gradient_clip / norm)
            grads = tree_map(lambda g: g * factor, grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, adam.mu)
        nu = tree_map(lambda g, v: (1 - b2) * g * g + b2 * v, grads, adam.nu)
        count = adam.count + 1
        c1 = 1 - b1 ** count.to(torch.float64)
        c2 = 1 - b2 ** count.to(torch.float64)
        step = -self.schedule(sched.count.to(torch.float64))
        updates = tree_map(
            lambda m, v: ((m / c1.to(m.dtype))
                          / (torch.sqrt(v / c2.to(v.dtype) + self.eps_root) + self.eps)
                          * step.to(m.dtype)), mu, nu)
        new = (ScaleByAdamState(count, mu, nu),
               ScaleByScheduleState(sched.count + 1), EmptyState())
        return updates, chain[:adam_at] + new

    def update(self, grads, state):
        if self.ministeps <= 1:
            return self._chain_update(grads, state)
        # optax.MultiSteps: the running mean of the ministeps' gradients
        # goes through the chain at the last ministep; before it the
        # updates are zero and the chain's state stays
        n = state.mini_step.to(tree_leaves(grads)[0].dtype)
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state.acc_grads)
        emit = int(state.mini_step) == self.ministeps - 1
        if emit:
            updates, inner = self._chain_update(acc, state.inner_opt_state)
            acc = tree_map(torch.zeros_like, acc)
        else:
            updates, inner = tree_map(torch.zeros_like, acc), state.inner_opt_state
        return updates, MultiStepsState(
            (state.mini_step + 1) % self.ministeps,
            state.gradient_step + (1 if emit else 0), inner, acc, ())


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


# ---------------------------------------------------------------------------
# checkpoint form
# ---------------------------------------------------------------------------

_STATE_TYPES = (EmptyState, ScaleByAdamState, ScaleByScheduleState, MultiStepsState)


def _convert_state(state, leaf: Callable):
    """The state with every array leaf mapped by `leaf`, rebuilt from this
    module's named tuples; `state` may be optax's (same field names)."""
    fields = getattr(state, "_fields", None)
    if fields is not None:
        for kind in _STATE_TYPES:
            if kind._fields == fields:
                return kind(*(_convert_state(getattr(state, f), leaf) for f in fields))
        raise ValueError(f"unknown optimizer state {type(state).__name__}{fields}")
    if isinstance(state, dict):
        return {k: _convert_state(v, leaf) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_convert_state(v, leaf) for v in state)
    if isinstance(state, list):
        return [_convert_state(v, leaf) for v in state]
    return leaf(state)


def state_to_numpy(state):
    return _convert_state(state, lambda t: t.detach().cpu().numpy()
                          if isinstance(t, torch.Tensor) else np.asarray(t))


def state_from_numpy(state, device, dtype):
    """A checkpoint's optimizer state as this module's, on `device`;
    floating leaves take `dtype`, counters stay int32."""

    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return torch.tensor(a, dtype=dtype, device=device)
        return torch.tensor(a, dtype=torch.int32, device=device)

    return _convert_state(state, leaf)
