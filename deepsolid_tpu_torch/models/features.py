"""Lattice-periodic generalized distance features.

Mirrors deepsolid_tpu/models/features.py. Two families:
  * 'nu'  - polynomial periodic metric, Phys. Rev. B 94, 035157;
  * 'tri' - sin/cos periodic map, Phys. Rev. Lett. 130, 036401.
Electron-atom features are periodic in the primitive cell, electron-
electron features in the simulation cell. Every function takes (..., 3)
displacements, so any leading walker/electron axes pass through.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from deepsolid_tpu_torch.device import constant
from deepsolid_tpu_torch.ops.distance import enforce_pbc

PI = math.pi


def _wrap_pi(w: torch.Tensor) -> torch.Tensor:
    """Wrap into (-pi, pi] as jnp's `w - ((w + pi) // (2 pi)) * 2 pi`."""
    return w - torch.div(w + PI, 2.0 * PI, rounding_mode="floor") * 2.0 * PI


def _scaled_f(w: torch.Tensor) -> torch.Tensor:
    """Periodic |w| with matched value/derivative at the zone boundary."""
    aw = torch.abs(w)
    return aw * (1.0 - aw * aw * aw / (4.0 * PI**3))


def _scaled_g(w: torch.Tensor) -> torch.Tensor:
    """Periodic odd coordinate map with cusp-preserving slope at 0."""
    aw = torch.abs(w)
    return w * (1.0 - 1.5 * aw / PI + 0.5 * (aw / PI) ** 2)


def nu_distance(dx: torch.Tensor, av, bv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Periodic generalized distance sd (...,) and relative coords (..., 3).

    av: (m, 3) feature lattice vectors over 2 pi (rows); bv: (m, 3)
    feature reciprocal vectors (rows).
    """
    av = constant(av, dx)
    bv = constant(bv, dx)
    w = _wrap_pi(dx @ bv.T)  # (..., m)
    f2 = (torch.linalg.norm(av, dim=-1) * _scaled_f(w)) ** 2
    sg = _scaled_g(w)
    rel = sg @ av
    metric = av @ av.T
    cross = metric * (sg[..., :, None] * sg[..., None, :])
    off = cross * (1.0 - torch.eye(metric.shape[-1], dtype=dx.dtype,
                                   device=dx.device))
    sd2 = torch.sum(f2, dim=-1) + torch.sum(off, dim=(-1, -2))
    return torch.sqrt(sd2), rel


def tri_distance(dx: torch.Tensor, av, bv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Periodic generalized distance and relative coords (..., 6) ('tri')."""
    av = constant(av, dx)
    bv = constant(bv, dx)
    w = dx @ bv.T
    sg, cg = torch.sin(w), torch.cos(w)
    rel = torch.cat([sg @ av, cg @ av], dim=-1)
    metric = av @ av.T
    pair = (1.0 - cg[..., :, None]) * (1.0 - cg[..., None, :]) + (
        sg[..., :, None] * sg[..., None, :]
    )
    sd2 = torch.einsum("...ij,ij->...", pair, metric)
    return torch.sqrt(sd2), rel


DISTANCE_FNS = {"nu": nu_distance, "tri": tri_distance}
# relative-coordinate dims per distance type
REL_DIMS = {"nu": 3, "tri": 6}


def input_feature_dims(natom: int, distance_type: str) -> Tuple[int, int]:
    """(one-electron, two-electron) input feature widths."""
    rel = REL_DIMS[distance_type]
    return (natom * (rel + 1), rel + 1)


def periodic_input_features(
    x: torch.Tensor,
    atoms,
    *,
    prim_lattice,
    prim_av,
    prim_bv,
    sim_lattice,
    sim_av,
    sim_bv,
    distance_type: str = "nu",
):
    """Periodic network inputs from flat electron positions x (B, n*3).

    Returns ae_rel (B, n, natom, rel), ee_rel (B, n, n, rel) (diagonal
    zeroed), r_ae (B, n, natom, 1) and r_ee (B, n, n, 1).
    """
    dist_fn = DISTANCE_FNS[distance_type]
    batch = x.shape[0]
    atoms = constant(atoms, x)

    prim_x, _ = enforce_pbc(prim_lattice, x)
    prim_x = prim_x.reshape(batch, -1, 3)
    ae_disp = prim_x[:, :, None, :] - atoms
    r_ae, ae_rel = dist_fn(ae_disp, prim_av, prim_bv)

    sim_x, _ = enforce_pbc(sim_lattice, x)
    sim_x = sim_x.reshape(batch, -1, 3)
    n = sim_x.shape[1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    ee_disp = sim_x[:, :, None, :] - sim_x[:, None, :, :]
    # keep the diagonal off zero so sqrt stays finite, then mask
    r_ee, ee_rel = dist_fn(ee_disp + eye[..., None], sim_av, sim_bv)
    r_ee = r_ee * (1.0 - eye)
    ee_rel = ee_rel * (1.0 - eye)[..., None]
    return ae_rel, ee_rel, r_ae[..., None], r_ee[..., None]


def nu_distance_jet(dx, av, bv):
    """Analytic jets of nu_distance with respect to the displacement dx.

    Returns (sd, dsd, lap_sd, rel, drel, lap_rel) with derivative axes
    last: dsd (..., 3), drel (..., 3, rel_dim).
    """
    av = constant(av, dx)
    bv = constant(bv, dx)
    w = _wrap_pi(dx @ bv.T)  # (..., m)
    aw = torch.abs(w)
    sw = torch.sign(w)

    # f = |w| - w^4/(4 pi^3);  g = w - 3 w|w|/(2 pi) + w^3/(2 pi^2)
    f = aw - w**4 / (4.0 * PI**3)
    fp = sw - w**3 / PI**3
    fpp = -3.0 * w * w / PI**3
    g = w - 3.0 * w * aw / (2.0 * PI) + w**3 / (2.0 * PI**2)
    gp = 1.0 - 3.0 * aw / PI + 1.5 * w * w / PI**2
    gpp = -3.0 * sw / PI + 3.0 * w / PI**2

    a2 = torch.sum(av * av, dim=-1)      # (m,)  |a_l|^2
    b2 = torch.sum(bv * bv, dim=-1)      # (m,)  |B_l|^2
    metric = av @ av.T                    # (m, m)
    off = metric * (1.0 - torch.eye(metric.shape[0], dtype=dx.dtype,
                                    device=dx.device))
    bdotb = bv @ bv.T                     # (m, m)

    # rel_j = sum_l g(w_l) A_{lj}
    rel = g @ av
    drel = torch.einsum("...l,ld,lj->...dj", gp, bv, av)
    lap_rel = (gpp * b2) @ av

    mg = g @ off.T                        # sum_{l' != l} M_{ll'} g_{l'}
    sd2 = torch.sum(a2 * f * f, dim=-1) + torch.sum(g * mg, dim=-1)
    coeff = 2.0 * a2 * f * fp + 2.0 * mg * gp
    dsd2 = coeff @ bv                     # (..., 3)
    lap_sd2 = torch.sum(
        (2.0 * a2 * (fp * fp + f * fpp) + 2.0 * mg * gpp) * b2, dim=-1
    ) + 2.0 * torch.einsum("...l,...m,lm->...", gp, gp, off * bdotb)

    sd = torch.sqrt(sd2)
    dsd = dsd2 / (2.0 * sd[..., None])
    lap_sd = lap_sd2 / (2.0 * sd) - torch.sum(dsd2 * dsd2, dim=-1) / (
        4.0 * sd2 * sd
    )
    return sd, dsd, lap_sd, rel, drel, lap_rel


def tri_distance_jet(dx, av, bv):
    """Analytic jets of tri_distance (same output layout as nu)."""
    av = constant(av, dx)
    bv = constant(bv, dx)
    w = dx @ bv.T
    sg, cg = torch.sin(w), torch.cos(w)
    b2 = torch.sum(bv * bv, dim=-1)
    metric = av @ av.T
    bdotb = bv @ bv.T
    mdiag = torch.diagonal(metric)

    rel = torch.cat([sg @ av, cg @ av], dim=-1)
    drel = torch.cat(
        [
            torch.einsum("...l,ld,lj->...dj", cg, bv, av),
            torch.einsum("...l,ld,lj->...dj", -sg, bv, av),
        ],
        dim=-1,
    )
    lap_rel = torch.cat([(-sg * b2) @ av, (-cg * b2) @ av], dim=-1)

    # sd^2 = sum_{ll'} M_{ll'} [ (1-c_l)(1-c_l') + s_l s_l' ]
    one_c = 1.0 - cg
    m_oc = one_c @ metric.T
    m_s = sg @ metric.T
    sd2 = torch.sum(one_c * m_oc + sg * m_s, dim=-1)
    dw = 2.0 * (sg * m_oc + cg * m_s)
    dsd2 = dw @ bv
    diag = 2.0 * (cg * m_oc - sg * m_s + (sg * sg + cg * cg) * mdiag)
    mb = metric * bdotb
    lap_sd2 = torch.sum(diag * b2, dim=-1) + 2.0 * (
        torch.einsum("...l,...m,lm->...", sg, sg, mb)
        + torch.einsum("...l,...m,lm->...", cg, cg, mb)
        - torch.sum((sg * sg + cg * cg) * mdiag * b2, dim=-1)
    )
    sd = torch.sqrt(sd2)
    dsd = dsd2 / (2.0 * sd[..., None])
    lap_sd = lap_sd2 / (2.0 * sd) - torch.sum(dsd2 * dsd2, dim=-1) / (
        4.0 * sd2 * sd
    )
    return sd, dsd, lap_sd, rel, drel, lap_rel


DISTANCE_JET_FNS = {"nu": nu_distance_jet, "tri": tri_distance_jet}
