"""One production training step of VMC with KFAC, in plain PyTorch.

  energy    E_L = kinetic + Ewald per walker; the loss is the batch mean
            of E_L (a walker whose E_L is not finite takes the mean of the
            others);
  gradient  mean over walkers of Re(clip(E_L - loss) conj(d log psi)),
            the clip at 5 mean absolute deviations of the real and the
            imaginary part each;
  KFAC      per dense layer the Fisher block extra_scale (A kron G) with
            A the input second moments (bias column appended), G the
            second moments of d log psi / d output under cotangent sqrt 2
            on Re and on Im log psi, both an exponential moving average;
            a diagonal block per other parameter; pi-adjusted damped
            inverses; a step -lr F^-1 g scaled down to the norm
            constraint; every `damping_adaptation_interval` steps the
            Levenberg-Marquardt rule on the loss again at the same walkers.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from portbench.reference import laplacian, network
from portbench.reference.ewald import Ewald
from portbench.reference.system import System


# ---- parameter trees ----------------------------------------------------------

def paths(tree, prefix=()):
    """(path, leaf) of every leaf; dicts in key order, lists by index."""
    if isinstance(tree, dict):
        for key in tree:
            yield from paths(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def to_torch(tree, dtype, device):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device),
                    tree)


# ---- energy and gradient --------------------------------------------------------

class Model:
    """The wavefunction of one configuration, with its Ewald sum."""

    def __init__(self, system: System, ndet: int, chunk: int):
        self.system = system
        self.ndet = ndet
        self.chunk = chunk
        self.ewald = Ewald(system)

    def log_psi(self, params, x, eps=None, taps=None):
        return network.log_psi(params, x, self.system, self.ndet, eps, taps)

    def local_energy(self, params, x) -> torch.Tensor:
        """E_L (B,) complex, `chunk` walkers at a time."""
        out = []
        with torch.no_grad():
            for part in x.split(self.chunk):
                kinetic, _ = laplacian.kinetic_and_log_psi(params, part, self.system,
                                                           self.ndet)
                out.append(kinetic + self.ewald.energy(part))
        return torch.cat(out)


def loss_of(e_l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, E_L with non-finite walkers replaced by the finite mean)."""
    finite = torch.isfinite(e_l.real) & torch.isfinite(e_l.imag)
    mean = e_l[finite].mean()
    e_l = torch.where(finite, e_l, mean)
    return e_l.mean().real, e_l


def gradient(model: Model, params, x, e_l, loss, clip=5.0, chunk=None):
    """The covariance estimator of d loss / d params."""
    diff = e_l - loss
    lim_re = clip * diff.real.abs().mean()
    lim_im = clip * diff.imag.abs().mean()
    cd = torch.complex(diff.real.clamp(-lim_re, lim_re), diff.imag.clamp(-lim_im, lim_im))
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    n = x.shape[0]
    chunk = chunk or n
    for xc, cc in zip(x.split(chunk), cd.split(chunk)):
        with torch.enable_grad():
            lp = model.log_psi(leaves, xc)
            (torch.sum((cc * torch.conj(lp)).real) / n).backward()
    return tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)


# ---- KFAC -------------------------------------------------------------------------

def _dense_layers(params, system: System) -> Dict[str, Tuple[tuple, int]]:
    """name -> (path, rows per walker) of every dense layer."""
    n = system.nelectron
    out = {}
    for i in range(len(params["single"])):
        out[f"single_{i}"] = (("single", i), n)
    for i in range(len(params["double"])):
        out[f"double_{i}"] = (("double", i), n * n)
    for c, (s, e) in enumerate(system.channels):
        out[f"orbital_{c}"] = (("orbital", c), e - s)
    return out


def _matrix(tree, path):
    """A layer's weight with its bias as a last row."""
    layer = get(tree, path)
    if "b" in layer:
        return torch.cat([layer["w"], layer["b"][None]], dim=0)
    return layer["w"]


def _from_matrix(mat, like):
    """A layer's {w, b} from its matrix, keys in the order of `like`."""
    parts = {"w": mat[:-1], "b": mat[-1]} if "b" in like else {"w": mat}
    return {key: parts[key] for key in like}


def dot(a, b):
    """The inner product of two trees of one structure, leaf by path."""
    return sum(torch.sum(leaf * get(b, path)) for path, leaf in paths(a))


def _inv_spd(m):
    return torch.cholesky_inverse(torch.linalg.cholesky(m))


class Kfac:
    """KFAC as the traffic's settings state it; the reference implements
    fisher_exact curvature refreshed and inverted every step, without
    momentum or L2 regularization, and refuses other settings."""

    def __init__(self, model: Model, hyper: dict, lr: dict, chunk: int):
        wanted = {"estimation_mode": "fisher_exact", "momentum": 0.0, "l2_reg": 0.0,
                  "invert_every": 1, "cov_update_every": 1}
        for key, value in wanted.items():
            if hyper.get(key, value) != value:
                raise ValueError(f"the reference KFAC takes {key}={value!r}, "
                                 f"not {hyper[key]!r}")
        self.model = model
        self.h = hyper
        self.lr = lr
        self.chunk = chunk

    def fresh_state(self, params):
        dt, dev = params["single"][0]["w"].dtype, params["single"][0]["w"].device
        blocks, diag = {}, {}
        dense = _dense_layers(params, self.model.system)
        for name, (path, rows) in dense.items():
            mat = _matrix(params, path)
            blocks[name] = {"a_raw": torch.zeros((mat.shape[0],) * 2, dtype=dt, device=dev),
                            "g_raw": torch.zeros((mat.shape[1],) * 2, dtype=dt, device=dev),
                            "weight": torch.zeros((), dtype=dt, device=dev),
                            "extra_scale": torch.tensor(float(rows), dtype=dt, device=dev)}
        for path, leaf in self._diag_leaves(params):
            diag["/".join(map(str, path))] = {"raw": torch.zeros_like(leaf),
                                              "weight": torch.zeros((), dtype=dt, device=dev)}
        return {"step": 0, "blocks": blocks, "diag": diag,
                "damping": torch.tensor(self.h["damping"], dtype=dt, device=dev)}

    @staticmethod
    def from_checkpoint(state, dtype, device):
        """The checkpoint's state: the moments, their weights, the step and
        the damping (the cached inverses are recomputed every step)."""
        conv = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
        return {"step": int(np.asarray(state["step"])),
                "blocks": {k: {f: conv(b[f]) for f in ("a_raw", "g_raw", "weight",
                                                       "extra_scale")}
                           for k, b in state["blocks"].items()},
                "diag": {k: {f: conv(d[f]) for f in ("raw", "weight")}
                         for k, d in state["diag"].items()},
                "damping": conv(state["damping"])}

    def _diag_leaves(self, params):
        covered = {path for path, _ in _dense_layers(params, self.model.system).values()}
        return [(p, leaf) for p, leaf in paths(params) if p[:2] not in covered]

    def _moments(self, params, x):
        """Sums over the walkers x of the layer input and output-tangent
        second moments, and the summed gradients of the diagonal leaves."""
        system = self.model.system
        dense = _dense_layers(params, system)
        batch = x.shape[0]
        n = system.nelectron
        outs = {}
        for name, (path, rows) in dense.items():
            lead = {"single": (n,), "double": (n, n), "orbital": (rows,)}[path[0]]
            outs[name] = torch.zeros((batch,) + lead + (get(params, path)["w"].shape[1],),
                                     dtype=x.dtype, device=x.device, requires_grad=True)
        leaves = tree_map(lambda t: t.detach(), params)
        diag = {}
        for path, _ in self._diag_leaves(params):
            leaf = get(params, path).detach().requires_grad_(True)
            get(leaves, path[:-1])[path[-1]] = leaf
            diag["/".join(map(str, path))] = leaf
        inputs = list(outs.values()) + list(diag.values())
        taps = {}
        with torch.enable_grad():
            lp = self.model.log_psi(leaves, x, eps=outs, taps=taps)
            re = torch.autograd.grad(math.sqrt(2.0) * lp.real.sum(), inputs,
                                     retain_graph=True, allow_unused=True)
            im = torch.autograd.grad(math.sqrt(2.0) * lp.imag.sum(), inputs,
                                     allow_unused=True)
        re = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, re)]
        im = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, im)]
        k = len(outs)
        moments = {}
        for (name, (path, _)), g_re, g_im in zip(dense.items(), re[:k], im[:k]):
            xin = taps[name].detach().reshape(-1, taps[name].shape[-1])
            if "b" in get(params, path):
                xin = torch.cat([xin, torch.ones_like(xin[:, :1])], dim=1)
            d_re = g_re.reshape(-1, g_re.shape[-1])
            d_im = g_im.reshape(-1, g_im.shape[-1])
            moments[name] = (xin.T @ xin, d_re.T @ d_re + d_im.T @ d_im)
        grads = {key: (g_re, g_im) for key, g_re, g_im in zip(diag, re[k:], im[k:])}
        return moments, grads

    def update_curvature(self, state, params, x):
        decay = self.h["cov_ema_decay"]
        total = None
        for part in x.split(self.chunk):
            m, g = self._moments(params, part)
            if total is None:
                total = (m, g)
            else:
                total = ({k: tuple(a + b for a, b in zip(total[0][k], m[k])) for k in m},
                         {k: tuple(a + b for a, b in zip(total[1][k], g[k])) for k in g})
        moments, grads = total
        batch = x.shape[0]
        blocks = {}
        for name, block in state["blocks"].items():
            reps = batch * float(block["extra_scale"])
            a_sum, g_sum = moments[name]
            blocks[name] = {**block, "a_raw": block["a_raw"] * decay + a_sum / reps,
                            "g_raw": block["g_raw"] * decay + g_sum / reps,
                            "weight": block["weight"] * decay + 1.0}
        diag = {}
        for key, entry in state["diag"].items():
            g_re, g_im = grads[key]
            diag[key] = {"raw": entry["raw"] * decay + (g_re**2 + g_im**2) / batch,
                         "weight": entry["weight"] * decay + 1.0}
        return {**state, "blocks": blocks, "diag": diag}

    def _precondition(self, state, params, grads, damping):
        out = tree_map(lambda t: t, grads)
        for name, (path, _) in _dense_layers(params, self.model.system).items():
            block = state["blocks"][name]
            w = block["weight"].clamp(min=1e-30)
            a, g = block["a_raw"] / w, block["g_raw"] / w
            lam = damping / block["extra_scale"]
            tr_a, tr_g = torch.trace(a), torch.trace(g)
            if float(tr_a * tr_g) > 0.0:
                pi = torch.sqrt((tr_a / a.shape[0]) / (tr_g / g.shape[0]))
                eye_a = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
                eye_g = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
                a_inv = _inv_spd(a + pi * torch.sqrt(lam) * eye_a)
                g_inv = _inv_spd(g + torch.sqrt(lam) / pi * eye_g)
                mat = a_inv @ _matrix(grads, path) @ g_inv
            else:
                mat = _matrix(grads, path) / lam
            node = get(out, path[:-1])
            node[path[-1]] = _from_matrix(mat / block["extra_scale"], get(grads, path))
        for key, entry in state["diag"].items():
            path = tuple(int(p) if p.isdigit() else p for p in key.split("/"))
            factor = entry["raw"] / entry["weight"].clamp(min=1e-30)
            get(out, path[:-1])[path[-1]] = get(grads, path) / (factor + damping)
        return out

    def _quadratic(self, state, params, vec):
        total = 0.0
        for name, (path, _) in _dense_layers(params, self.model.system).items():
            block = state["blocks"][name]
            w = block["weight"].clamp(min=1e-30)
            v = _matrix(vec, path)
            total = total + torch.sum(v * ((block["a_raw"] / w) @ v @ (block["g_raw"] / w))) \
                * block["extra_scale"]
        for key, entry in state["diag"].items():
            path = tuple(int(p) if p.isdigit() else p for p in key.split("/"))
            v = get(vec, path)
            total = total + torch.sum(entry["raw"] / entry["weight"].clamp(min=1e-30) * v * v)
        return total

    def step(self, state, params, grads, x, loss, loss_at: Callable):
        """(params, state) after one step; `loss_at(params)` is the loss at
        the same walkers, asked for on a step that adapts the damping."""
        t = state["step"]
        state = self.update_curvature(state, params, x)
        damping = state["damping"].clamp(min=self.h["min_damping"])
        lr = self.lr["rate"] * (1.0 / (1.0 + t / self.lr["delay"])) ** self.lr["decay"]
        pre = self._precondition(state, params, grads, damping)
        inner = dot(pre, grads)
        coeff = torch.clamp(torch.sqrt(self.h["norm_constraint"] / (inner * lr**2)), max=1.0)
        new = tree_map(lambda p, v: p - lr * coeff * v, params, pre)
        state = {**state, "step": t + 1}
        if self.h["adaptive_damping"] and t % self.h["damping_adaptation_interval"] == 0:
            delta = tree_map(torch.sub, new, params)
            quad = (dot(grads, delta) + 0.5 * self._quadratic(state, params, delta)
                    + 0.5 * state["damping"] * dot(delta, delta))
            rho = (loss_at(new) - loss) / quad if float(quad) < 0.0 else torch.tensor(-1.0)
            omega = self.h["damping_adaptation_decay"] ** self.h["damping_adaptation_interval"]
            d = state["damping"]
            d = d * omega if rho > 0.75 else (d / omega if rho < 0.25 else d)
            state["damping"] = d.clamp(self.h["min_damping"], self.h["max_damping"])
        return new, state
