"""The reference follows the program's first steps, as the traffic's
`optimizer` states them: 'kfac' (a training step) or 'none' (the energy
alone, the parameters held).

It starts from the raw checkpoint the run started from (parameters and
KFAC state, or a fresh state for a handoff), and at each step takes the
walkers the program's sampler produced: the sampler draws its moves from
the program's generator on the card, which no plain implementation
repeats, so the walkers are the one thing taken from the run. Everything
else, parameters and optimizer state included, the reference carries
itself from step to step. The sampler's last move is judged by the
reference's log|psi| at its walkers and at their proposals.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.step import Kfac, Model, gradient, loss_of, to_torch
from portbench.reference.system import System


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 products on (the control) or off, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def load_checkpoint(path):
    with np.load(path, allow_pickle=True) as z:
        return z["params"].tolist(), z["opt_state"].tolist()


OPTIMIZERS = ("kfac", "none")


def follow(config: dict, traffic: dict, checkpoint, walkers, probes,
           dtype=torch.float32, device="cpu", tf32: bool = False,
           half_batch: bool = False) -> dict:
    """The reference's 'loss', 'e_l', 'logpsi' at the last move's
    proposals and 'logpsi_from' at its walkers; where the traffic trains,
    'grads' of the first step, 'params' after the steps and 'params0'.

    walkers[k] (B, 3n) are the walkers of step k, probes[k] the walkers
    (P, 3n) of the sampler's last move of that step and their proposals.
    `half_batch` plants a fault: the loss, gradient and curvature of each
    step take the first half of the walkers only."""
    optimizer = traffic["optimizer"]
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"the reference follows the optimizers {OPTIMIZERS}, "
                         f"not {optimizer!r}")
    system = System.from_config(config)
    ndet = config["network"]["determinants"]
    chunk = traffic["reference_chunk"]
    model = Model(system, ndet, chunk)
    params_np, state_np = load_checkpoint(checkpoint)
    out = {"loss": [], "e_l": [], "logpsi": [], "logpsi_from": []}

    def log_psi(params, x):
        with torch.no_grad():
            return torch.cat([model.log_psi(params, part).real for part in
                              x.to(device=device, dtype=dtype).split(chunk)])

    with matmul_precision(tf32):
        params = to_torch(params_np, dtype, device)
        if optimizer == "kfac":
            kfac = Kfac(model, traffic["kfac"], traffic["lr"], chunk)
            out["params0"] = params
            state = (Kfac.from_checkpoint(state_np, dtype, device) if state_np
                     else kfac.fresh_state(params))
        for k, (x, (start, proposal)) in enumerate(zip(walkers, probes)):
            x = x.to(device=device, dtype=dtype)
            if half_batch:
                x = x[:x.shape[0] // 2]
            loss, e_l = loss_of(model.local_energy(params, x))
            out["loss"].append(loss)
            out["e_l"].append(e_l)
            out["logpsi"].append(log_psi(params, proposal))
            out["logpsi_from"].append(log_psi(params, start))
            if optimizer == "none":
                continue
            grads = gradient(model, params, x, e_l, loss, traffic["clip_el"], chunk)
            if k == 0:
                out["grads"] = grads
            params, state = kfac.step(
                state, params, grads, x, loss,
                lambda p, x=x: loss_of(model.local_energy(p, x))[0])
        if optimizer == "kfac":
            out["params"] = params
    return out
