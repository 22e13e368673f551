"""The numbers that decide `correct`: what the program's first steps
produced against the plain reference's, each beside its limit.

  loss_gap     the largest over the followed steps of |loss - reference|,
               Ha per primitive cell
  el_gap       the largest over the steps and over the E_L chunks (the
               cell's `el_chunk` walkers each, the batch where unset) of
               the median over the chunk's walkers of |E_L - reference
               E_L|, Ha per primitive cell: one walker near a node does
               not move it, a chunk computed wrong does
  logpsi_gap   the largest |log|psi| - reference| over the sampler's last
               proposals of each step (the value path through B1)
  move_rows    the walkers, over the steps, that the sampler's last move
               returned equal neither to where they were nor to their
               proposal
  accept_z     the largest over the steps of |accepted - sum p| /
               sqrt(max(sum p (1 - p), 1)): the last move's accepted
               proposals against the Metropolis rule's expectation, p =
               min(1, |psi(proposal) / psi(walker)|^2) from the reference
               (a sampler that never moves, or accepts by another rule,
               reads tens)

and where the traffic trains (its optimizer is not 'none'):

  grad_gap     the first step's energy gradient as the optimizer got it:
               the worst leaf's |norm - reference norm| over the larger of
               that leaf's reference norm and the median leaf's
  update_gap   the change of the parameters over the followed steps, the
               same way, over the leaves whose reference gradient is at
               least a thousandth of the median leaf's (a smaller one
               moves by rounding alone under the step's scaling)
"""

from __future__ import annotations

from typing import Dict

import torch

NAMES = ("loss_gap", "el_gap", "logpsi_gap", "move_rows", "accept_z", "grad_gap",
         "update_gap")


def _leaves(tree, prefix=()) -> Dict[tuple, torch.Tensor]:
    """{path: leaf in float64 on the CPU}: trees are compared leaf by path."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaves(tree[key], prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _leaves(x, prefix + (i,)).items()}
    return {prefix: tree.detach().to("cpu", torch.float64)}


def _norms(tree: Dict[tuple, torch.Tensor], keys) -> torch.Tensor:
    return torch.stack([tree[k].norm() for k in keys])


def _norm_gaps(got, want, keep=None) -> float:
    """The worst leaf's |norm - reference norm| over the larger of the
    leaf's reference norm and the median leaf's; `keep` names the leaves."""
    keys = sorted(want) if keep is None else keep
    got_n, want_n = _norms(got, keys), _norms(want, sorted(want))
    floor = float(want_n.median())
    want_k = _norms(want, keys)
    return float(((got_n - want_k).abs() / torch.clamp(want_k, min=floor)).max())


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| entry by entry, over the entries both have."""
    m = min(len(a), len(b))
    return (a[:m].to("cpu", torch.complex128) - b[:m].to("cpu", torch.complex128)).abs()


def _change(after, before) -> Dict[tuple, torch.Tensor]:
    after, before = _leaves(after), _leaves(before)
    return {k: after[k] - before[k] for k in before}


def _chunk_medians(gap: torch.Tensor, chunk: int) -> torch.Tensor:
    """The median of each `chunk` walkers' gaps (all of them where 0)."""
    return torch.stack([part.median() for part in gap.split(chunk or len(gap))])


def _move(prog_move, lp_from, lp_to):
    """(rows equal to neither walker nor proposal, accepted, sum p,
    sum p (1 - p), and the sum under |psi| unsquared) of one move."""
    x1, x2, out = (t.to("cpu", torch.float64) for t in prog_move)
    at_start = (out == x1).all(dim=1)
    accepted = (out == x2).all(dim=1)
    log_ratio = lp_to.to("cpu", torch.float64) - lp_from.to("cpu", torch.float64)
    p = torch.exp(torch.clamp(2 * log_ratio, max=0.0))
    unsquared = torch.exp(torch.clamp(log_ratio, max=0.0))
    return (int((~(at_start | accepted)).sum()), float(accepted.sum()), float(p.sum()),
            float((p * (1 - p)).sum()), float(unsquared.sum()))


def _z(count: float, expected: float, var: float) -> float:
    return abs(count - expected) / max(var, 1.0) ** 0.5


def numbers(prog: dict, ref: dict, scale: int, chunk: int = 0) -> Dict[str, float]:
    """prog and ref: 'loss' [K], 'e_l' [K] (B,), 'logpsi' [K] (P,); in
    prog 'moves' [K] (walkers, proposals, returned walkers) of the last
    move where the program sampled, and in ref 'logpsi_from' [K] (P,) at
    those walkers; where the traffic trains, 'grads' (the first step's
    tree), 'params' (after K steps), and in ref 'params0' (the starting
    parameters). `chunk` is the cell's E_L chunk."""
    steps = range(len(ref["loss"]))
    out = {
        "loss_gap": max(abs(float(prog["loss"][k]) - float(ref["loss"][k])) / scale
                        for k in steps),
        "el_gap": max(float(_chunk_medians(_gap(prog["e_l"][k], ref["e_l"][k]), chunk).max())
                      / scale for k in steps),
        "logpsi_gap": max(float(_gap(prog["logpsi"][k], ref["logpsi"][k]).max())
                          for k in steps),
    }
    if "moves" in prog:
        moves = [_move(prog["moves"][k], ref["logpsi_from"][k], ref["logpsi"][k])
                 for k in steps]
        out["move_rows"] = float(sum(m[0] for m in moves))
        out["accept_z"] = max(_z(*m[1:4]) for m in moves)
    if "grads" in ref:
        ref_grad = _leaves(ref["grads"])
        norms = {k: float(v.norm()) for k, v in ref_grad.items()}
        median = float(torch.tensor(list(norms.values())).median())
        keep = sorted(k for k, v in norms.items() if v >= 1e-3 * median)
        out["grad_gap"] = _norm_gaps(_leaves(prog["grads"]), ref_grad)
        out["update_gap"] = _norm_gaps(_change(prog["params"], ref["params0"]),
                                       _change(ref["params"], ref["params0"]), keep)
    return out


def diagnostics(prog: dict, ref: dict, scale: int, chunk: int = 0) -> dict:
    """Per-step readings behind the numbers, for setting their limits,
    with the acceptance faults' readings on the same rows: a sampler that
    never moves (accepts none) and one that accepts by |psi| unsquared,
    each at its expected count."""
    out = {}
    for k in range(len(ref["loss"])):
        el = _gap(prog["e_l"][k], ref["e_l"][k]) / scale
        lp = _gap(prog["logpsi"][k], ref["logpsi"][k])
        rows, accepted, p_sum, var, unsquared = _move(
            prog["moves"][k], ref["logpsi_from"][k], ref["logpsi"][k])
        out[f"step{k}"] = {
            "loss": float(prog["loss"][k]) / scale,
            "loss_gap": abs(float(prog["loss"][k]) - float(ref["loss"][k])) / scale,
            "el_median": float(el.median()), "el_p99": float(el.quantile(0.99)),
            "el_max": float(el.max()), "el_chunk_max": float(_chunk_medians(el, chunk).max()),
            "logpsi_median": float(lp.median()), "logpsi_max": float(lp.max()),
            "move_rows": rows, "accepted": accepted, "expected": p_sum,
            "accept_z": _z(accepted, p_sum, var), "z_never_moves": _z(0.0, p_sum, var),
            "z_unsquared": _z(unsquared, p_sum, var)}
    if "grads" in ref:
        grads = _leaves(ref["grads"])
        out["update_gap_all_leaves"] = _norm_gaps(_change(prog["params"], ref["params0"]),
                                                  _change(ref["params"], ref["params0"]))
        norms = sorted((float(v.norm()), "/".join(map(str, k))) for k, v in grads.items())
        out["smallest_grad_leaves"] = norms[:3]
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers computed:
    correct when every one is finite and within its limit; a number
    without a limit fails."""
    rows = [(name, values[name], limits.get(name)) for name in NAMES if name in values]
    ok = all(limit is not None and value == value and value <= limit
             for _, value, limit in rows)
    return ok, rows
