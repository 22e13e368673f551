"""Analytic Gaussian integrals (McMurchie-Davidson) for the native SCF.

A copy of deepsolid_tpu/scf/integrals.py.

Host-side numpy. Supports arbitrary angular momentum through the general
E/R recursions (we currently build shells with l <= 1). Kernels:
  * overlap, kinetic
  * nuclear attraction with bare 1/r and erf(omega r)/r attenuation —
    the Ewald short-range piece is erfc = bare - erf.

All conventions are validated against brute-force numerical quadrature in
the JAX package's SCF tests (tests/test_scf.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.special import hyp1f1


def boys(n: int, t: np.ndarray) -> np.ndarray:
    """Boys function F_n(t) = int_0^1 u^{2n} exp(-t u^2) du."""
    return hyp1f1(n + 0.5, n + 1.5, -t) / (2.0 * n + 1.0)


def e_coeffs(la: int, lb: int, p: np.ndarray, pa: np.ndarray, pb: np.ndarray,
             kab: np.ndarray) -> Dict[Tuple[int, int, int], np.ndarray]:
    """1-D Hermite expansion coefficients E^{ij}_t including the pair
    prefactor exp(-mu X_AB^2) (in kab). Arrays broadcast elementwise."""
    e = {(0, 0, 0): kab}
    inv2p = 1.0 / (2.0 * p)
    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            if j == 0:
                src, x = (i - 1, 0), pa
            else:
                src, x = (i, j - 1), pb
            for t in range(i + j + 1):
                val = 0.0
                if (src[0], src[1], t - 1) in e:
                    val = val + inv2p * e[(src[0], src[1], t - 1)]
                if (src[0], src[1], t) in e:
                    val = val + x * e[(src[0], src[1], t)]
                if (src[0], src[1], t + 1) in e:
                    val = val + (t + 1) * e[(src[0], src[1], t + 1)]
                if np.isscalar(val) and val == 0.0:
                    continue
                e[(i, j, t)] = val
    return e


def overlap_1d(la, lb, p, pa, pb, kab):
    e = e_coeffs(la, lb, p, pa, pb, kab)
    return e[(la, lb, 0)] * np.sqrt(np.pi / p)


def overlap_prim(la3, lb3, alpha, beta, ab):
    """Overlap of primitive cartesian Gaussians.

    la3/lb3: (lx, ly, lz) tuples; alpha, beta: exponent arrays; ab: A - B
    displacement array (..., 3). Returns elementwise overlap (no norm).
    """
    p = alpha + beta
    mu = alpha * beta / p
    out = 1.0
    for d in range(3):
        x = ab[..., d]
        kab = np.exp(-mu * x * x)
        pa = -(beta / p) * x  # PA = P - A = -(beta/p)(A-B)
        pb = (alpha / p) * x  # PB = P - B = (alpha/p)(A-B)
        out = out * overlap_1d(la3[d], lb3[d], p, pa, pb, kab)
    return out


def kinetic_prim(la3, lb3, alpha, beta, ab):
    """Kinetic energy -1/2 <a|nabla^2|b> via the lb +/- 2 overlap identity."""
    def s_shift(d, shift):
        lb_new = list(lb3)
        lb_new[d] += shift
        if lb_new[d] < 0:
            return 0.0
        return overlap_prim(la3, tuple(lb_new), alpha, beta, ab)

    # s_shift returns the FULL 3D overlap with lb_d shifted, so the
    # other-dimension 1D overlaps are already included in each term.
    total = 0.0
    for d in range(3):
        lb_d = lb3[d]
        term = beta * (2 * lb_d + 1) * s_shift(d, 0) - 2.0 * beta**2 * s_shift(d, 2)
        if lb_d >= 2:
            term = term - 0.5 * lb_d * (lb_d - 1) * s_shift(d, -2)
        total = total + term
    return total


def hermite_r(tmax: int, p: np.ndarray, pc: np.ndarray, fns) -> Dict:
    """MD Hermite Coulomb integrals R_{tuv} for t+u+v <= tmax.

    fns(n) must return the order-n auxiliary integral array (already
    including kernel-specific scaling); bare Coulomb uses
    fns(n) = (-2p)^n F_n(p |PC|^2).
    """
    r = {}
    # R^{(n)}_{000}
    rn = {n: fns(n) for n in range(tmax + 1)}

    def rec(t, u, v, n):
        if t == u == v == 0:
            return rn[n]
        if t > 0:
            out = pc[..., 0] * rec(t - 1, u, v, n + 1)
            if t > 1:
                out = out + (t - 1) * rec(t - 2, u, v, n + 1)
            return out
        if u > 0:
            out = pc[..., 1] * rec(t, u - 1, v, n + 1)
            if u > 1:
                out = out + (u - 1) * rec(t, u - 2, v, n + 1)
            return out
        out = pc[..., 2] * rec(t, u, v - 1, n + 1)
        if v > 1:
            out = out + (v - 1) * rec(t, u, v - 2, n + 1)
        return out

    for t in range(tmax + 1):
        for u in range(tmax + 1 - t):
            for v in range(tmax + 1 - t - u):
                r[(t, u, v)] = rec(t, u, v, 0)
    return r


def nuclear_prim(la3, lb3, alpha, beta, a_pos, b_pos, c_pos, omega=None):
    """<a| kernel(|r - C|) |b> for kernel = 1/r (omega None) or erf(w r)/r.

    a_pos, b_pos, c_pos: (..., 3) arrays (broadcastable); returns array.
    """
    p = alpha + beta
    mu = alpha * beta / p
    ab = a_pos - b_pos
    P = (alpha[..., None] * a_pos + beta[..., None] * b_pos) / p[..., None]
    pc = P - c_pos
    r2 = np.sum(pc * pc, axis=-1)

    es = []
    for d in range(3):
        x = ab[..., d]
        kab = np.exp(-mu * x * x)
        es.append(
            e_coeffs(la3[d], lb3[d], p, -(beta / p) * x, (alpha / p) * x, kab)
        )

    tmax = sum(la3) + sum(lb3)
    if omega is None:
        fns = lambda n: (-2.0 * p) ** n * boys(n, p * r2)
    else:
        theta2 = omega**2 / (omega**2 + p)
        fns = lambda n: (-2.0 * p) ** n * np.sqrt(theta2) * theta2**n * boys(
            n, theta2 * p * r2
        )
    r = hermite_r(tmax, p, pc, fns)

    out = 0.0
    for t in range(la3[0] + lb3[0] + 1):
        et = es[0].get((la3[0], lb3[0], t))
        if et is None:
            continue
        for u in range(la3[1] + lb3[1] + 1):
            eu = es[1].get((la3[1], lb3[1], u))
            if eu is None:
                continue
            for v in range(la3[2] + lb3[2] + 1):
                ev = es[2].get((la3[2], lb3[2], v))
                if ev is None:
                    continue
                out = out + et * eu * ev * r[(t, u, v)]
    return 2.0 * np.pi / p * out


def eri_prim(la3, lb3, lc3, ld3, alpha, beta, gamma, delta,
             a_pos, b_pos, c_pos, d_pos):
    """Bare-Coulomb primitive ERI (ab|cd), chemists' notation, via
    McMurchie-Davidson Hermite expansion on both pair densities.

    Exponent/position arrays broadcast elementwise. Free-space kernel —
    used by scf/molecular.py (validation harness); the periodic SCF uses
    the range-separated engines in scf/eri.py instead.
    """
    p = alpha + beta
    q = gamma + delta
    ab = a_pos - b_pos
    cd = c_pos - d_pos
    P = (alpha[..., None] * a_pos + beta[..., None] * b_pos) / p[..., None]
    Q = (gamma[..., None] * c_pos + delta[..., None] * d_pos) / q[..., None]
    pq = P - Q
    r2 = np.sum(pq * pq, axis=-1)
    a_red = p * q / (p + q)

    e_bra, e_ket = [], []
    for d in range(3):
        x = ab[..., d]
        kab = np.exp(-(alpha * beta / p) * x * x)
        e_bra.append(
            e_coeffs(la3[d], lb3[d], p, -(beta / p) * x, (alpha / p) * x, kab)
        )
        y = cd[..., d]
        kcd = np.exp(-(gamma * delta / q) * y * y)
        e_ket.append(
            e_coeffs(lc3[d], ld3[d], q, -(delta / q) * y, (gamma / q) * y, kcd)
        )

    tmax = sum(la3) + sum(lb3) + sum(lc3) + sum(ld3)
    fns = lambda n: (-2.0 * a_red) ** n * boys(n, a_red * r2)
    r = hermite_r(tmax, a_red, pq, fns)

    out = 0.0
    for t in range(la3[0] + lb3[0] + 1):
        et = e_bra[0].get((la3[0], lb3[0], t))
        if et is None:
            continue
        for u in range(la3[1] + lb3[1] + 1):
            eu = e_bra[1].get((la3[1], lb3[1], u))
            if eu is None:
                continue
            for v in range(la3[2] + lb3[2] + 1):
                ev = e_bra[2].get((la3[2], lb3[2], v))
                if ev is None:
                    continue
                bra = et * eu * ev
                for tt in range(lc3[0] + ld3[0] + 1):
                    ft = e_ket[0].get((lc3[0], ld3[0], tt))
                    if ft is None:
                        continue
                    for uu in range(lc3[1] + ld3[1] + 1):
                        fu = e_ket[1].get((lc3[1], ld3[1], uu))
                        if fu is None:
                            continue
                        for vv in range(lc3[2] + ld3[2] + 1):
                            fv = e_ket[2].get((lc3[2], ld3[2], vv))
                            if fv is None:
                                continue
                            sign = (-1.0) ** (tt + uu + vv)
                            out = out + bra * ft * fu * fv * sign * r[
                                (t + tt, u + uu, v + vv)
                            ]
    return (
        2.0 * np.pi**2.5
        / (p * q * np.sqrt(p + q))
        * out
    )


def pair_density_ft(la3, lb3, alpha, beta, a_pos, b_pos, g):
    """Fourier transform int chi_a(r) chi_b(r) e^{-i G. r} dr.

    g: (ng, 3). Other args broadcast over pair instances (...,).
    Returns complex array of shape (..., ng).
    """
    p = alpha + beta
    mu = alpha * beta / p
    ab = a_pos - b_pos
    P = (alpha[..., None] * a_pos + beta[..., None] * b_pos) / p[..., None]

    pref = (np.pi / p)[..., None] ** 1.5 * np.exp(
        -np.sum(g * g, axis=-1) / (4.0 * p[..., None])
    )  # (..., ng)
    phase = np.exp(-1j * (P @ g.T if P.ndim == 2 else np.einsum("...d,gd->...g", P, g)))

    out = pref * phase
    for d in range(3):
        x = ab[..., d]
        kab = np.exp(-mu * x * x)
        e = e_coeffs(la3[d], lb3[d], p, -(beta / p) * x, (alpha / p) * x, kab)
        poly = 0.0
        for t in range(la3[d] + lb3[d] + 1):
            et = e.get((la3[d], lb3[d], t))
            if et is None:
                continue
            poly = poly + et[..., None] * (-1j * g[:, d]) ** t
        out = out * poly
    return out


# cartesian components per l (s: 1, p: 3, d: 6 — pyscf cart order)
CART = {
    0: [(0, 0, 0)],
    1: [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
    2: [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2)],
}
