"""The periodic FermiNet of DeepSolid, value path, in plain PyTorch.

Inputs: the 'nu' periodic distance of every electron to every primitive
atom (wrapped into the primitive cell) and to every other electron
(wrapped into the simulation cell), with their periodic relative
coordinates. A two-stream permutation-equivariant trunk (tanh, residual
connections of equal widths scaled by 1/sqrt 2), one complex orbital head
per spin channel, an isotropic envelope sum_a pi exp(-|sigma d_a|), Bloch
phases exp(i k.r) of the occupied k-list, and log psi the log of the sum
over determinants of the product over spin channels. Parameters are the
checkpoint's tree: single, double, orbital, envelope.

`orbitals(..., eps, taps)` adds eps[name] to each dense layer's output
and records its input in taps[name], for KFAC.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference.system import System

PI = math.pi


def tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def wrap_into(x: torch.Tensor, lattice: np.ndarray) -> torch.Tensor:
    """Positions (..., 3) moved by lattice translations into the cell."""
    frac = x @ tensor(np.linalg.inv(lattice), x)
    return (frac - torch.floor(frac)) @ tensor(lattice, x)


def nu_distance(dx: torch.Tensor, av: np.ndarray, bv: np.ndarray):
    """DeepSolid's periodic distance and relative coordinates of
    displacements dx (..., 3): w = dx . b_l wrapped into (-pi, pi],
    f(w) = |w| (1 - |w|^3 / (4 pi^3)), g(w) = w (1 - 3|w|/(2 pi) +
    w^2 / (2 pi^2)); d^2 = sum_l |a_l|^2 f_l^2 + sum_{l != m} a_l.a_m g_l
    g_m and rel = sum_l g_l a_l."""
    av_t, bv_t = tensor(av, dx), tensor(bv, dx)
    w = dx @ bv_t.T
    w = w - 2.0 * PI * torch.floor((w + PI) / (2.0 * PI))
    aw = torch.abs(w)
    f = aw * (1.0 - aw**3 / (4.0 * PI**3))
    g = w * (1.0 - 1.5 * aw / PI + 0.5 * (aw / PI) ** 2)
    metric = av_t @ av_t.T
    diag = torch.diagonal(metric)
    off = metric - torch.diag(diag)
    d2 = torch.sum(diag * f * f, dim=-1) + torch.einsum("...l,lm,...m->...", g, off, g)
    return torch.sqrt(d2), g @ av_t


def input_features(system: System, x: torch.Tensor):
    """(electron-atom features (B, n, 4a), electron-electron features
    (B, n, n, 4) with a zero diagonal, electron-atom distances (B, n, a))."""
    batch, n = x.shape[0], system.nelectron
    pos = x.reshape(batch, n, 3)
    av, bv = System.feature_vectors(system.prim_lattice)
    prim_pos = wrap_into(pos, system.prim_lattice)
    ae = prim_pos[:, :, None, :] - tensor(system.prim_atoms, x)
    d_ae, rel_ae = nu_distance(ae, av, bv)
    h_one = torch.cat([d_ae[..., None], rel_ae], dim=-1).reshape(batch, n, -1)

    av_s, bv_s = System.feature_vectors(system.sim_lattice)
    sim_pos = wrap_into(pos, system.sim_lattice)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    ee = sim_pos[:, :, None, :] - sim_pos[:, None, :, :] + eye[..., None]
    d_ee, rel_ee = nu_distance(ee, av_s, bv_s)
    h_two = torch.cat([d_ee[..., None], rel_ee], dim=-1) * (1.0 - eye)[..., None]
    return h_one, h_two, d_ae


def _dense(x, layer, name, eps, taps):
    y = x @ layer["w"]
    if "b" in layer:
        y = y + layer["b"]
    if eps is not None and name in eps:
        y = y + eps[name]
    if taps is not None:
        taps[name] = x
    return y


def symmetric(system: System, h_one, h_two):
    """[h_one | per-channel means of h_one | per-channel means over j of
    h_two[j, i]] for every electron i."""
    parts = [h_one]
    for s, e in system.channels:
        parts.append(h_one[:, s:e].mean(dim=1, keepdim=True).expand_as(h_one))
    for s, e in system.channels:
        parts.append(h_two[:, s:e].mean(dim=1))
    return torch.cat(parts, dim=-1)


def _residual(old, new):
    return (old + new) / math.sqrt(2.0) if old.shape == new.shape else new


def orbitals(params, x: torch.Tensor, system: System, ndet: int,
             eps: Optional[Dict[str, torch.Tensor]] = None,
             taps: Optional[Dict[str, torch.Tensor]] = None) -> List[torch.Tensor]:
    """The orbital matrices (B, ndet, n_s, n_s) of each spin channel, rows
    electrons, columns orbitals."""
    batch = x.shape[0]
    h_one, h_two, d_ae = input_features(system, x)
    n_double = len(params["double"])
    for i in range(n_double):
        one = torch.tanh(_dense(symmetric(system, h_one, h_two),
                                params["single"][i], f"single_{i}", eps, taps))
        two = torch.tanh(_dense(h_two, params["double"][i], f"double_{i}", eps, taps))
        h_one, h_two = _residual(h_one, one), _residual(h_two, two)
    last = len(params["single"]) - 1
    one = torch.tanh(_dense(symmetric(system, h_one, h_two), params["single"][last],
                            f"single_{last}", eps, taps))
    h_one = _residual(h_one, one)

    pos = x.reshape(batch, -1, 3)
    mats = []
    for ch, (s, e) in enumerate(system.channels):
        n_s = e - s
        raw = _dense(h_one[:, s:e], params["orbital"][ch], f"orbital_{ch}", eps, taps)
        half = raw.shape[-1] // 2
        orb = torch.complex(raw[..., :half], raw[..., half:])
        env = params["envelope"][ch]
        decay = torch.exp(-torch.abs(env["sigma"] * d_ae[:, s:e, :, None]))
        orb = orb * torch.sum(decay * env["pi"], dim=-2)
        orb = orb.reshape(batch, n_s, ndet, n_s).transpose(1, 2)
        k = tensor(system.klist[ch], x)
        phase = torch.exp(1j * (pos[:, s:e] @ k.T))
        mats.append(orb * phase[:, None])
    return mats


def log_psi(params, x, system: System, ndet: int, eps=None, taps=None):
    """Complex log psi (B,) = log sum_d prod_s det A_{d,s}."""
    log_det = None
    for mat in orbitals(params, x, system, ndet, eps, taps):
        sign, logabs = torch.linalg.slogdet(mat)
        part = torch.log(sign) + logabs
        log_det = part if log_det is None else log_det + part
    top = log_det.real.max(dim=-1, keepdim=True).values.detach()
    return torch.log(torch.sum(torch.exp(log_det - top), dim=-1)) + top[..., 0]
