"""Free-space (molecular) UHF on the native Gaussian integrals.

Host numpy, a copy of deepsolid_tpu/scf/molecular.py (the et-dz
generator's atomic UHF, scf/etdz.py).

This is the open-boundary limit of the periodic SCF stack — no lattice
sums, bare Coulomb everywhere. Its role is validation: atomic/molecular
HF energies computed here are compared against published values in
tests/test_molecular_hf.py, which pins the basis-set tables
(scf/basis.py) and the McMurchie-Davidson integral engine
(scf/integrals.py) to literature numbers independently of any periodic
machinery. The reference delegates this entire layer to PySCF
(DeepSolid/hf.py:26,61-81).

Cartesian shells: d carries 6 components, so energies for l>=2 bases dip
slightly BELOW published spherical-harmonic values (the extra r^2
combination enlarges the variational space).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import scipy.linalg

from deepsolid_tpu_torch.scf.basis import Shell, primitive_norm
from deepsolid_tpu_torch.scf.integrals import (
    CART,
    eri_prim,
    kinetic_prim,
    nuclear_prim,
    overlap_prim,
)


def _prim_grid(*shells: Shell):
    """Outer-product exponent/coefficient grids for 2 or 4 shells."""
    n = len(shells)
    alphas, coefs = [], []
    for i, s in enumerate(shells):
        shape = [1] * n
        shape[i] = -1
        a = np.asarray(s.exponents, np.float64).reshape(shape)
        c = (
            np.asarray(s.coefficients, np.float64)
            * primitive_norm(np.asarray(s.exponents, np.float64), s.l)
        ).reshape(shape)
        alphas.append(a)
        coefs.append(c)
    weight = coefs[0]
    for c in coefs[1:]:
        weight = weight * c
    return alphas, weight


def one_electron_matrices(
    shells: Sequence[Shell], nuclei: Sequence[Tuple[float, np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(S, T, V) over contracted cartesian AOs; V = bare nuclear attraction."""
    nao = sum(s.nfunc for s in shells)
    S = np.zeros((nao, nao))
    T = np.zeros((nao, nao))
    V = np.zeros((nao, nao))
    offs = np.cumsum([0] + [s.nfunc for s in shells])
    for ia, sa in enumerate(shells):
        for ib, sb in enumerate(shells):
            if ib < ia:
                continue
            (aa, bb), w = _prim_grid(sa, sb)
            ab = sa.center - sb.center
            for ca, la3 in enumerate(CART[sa.l]):
                for cb, lb3 in enumerate(CART[sb.l]):
                    s_val = np.sum(w * overlap_prim(la3, lb3, aa, bb, ab))
                    t_val = np.sum(w * kinetic_prim(la3, lb3, aa, bb, ab))
                    v_val = 0.0
                    for z, cpos in nuclei:
                        v_val -= z * np.sum(
                            w
                            * nuclear_prim(
                                la3, lb3, aa, bb,
                                sa.center, sb.center, np.asarray(cpos),
                            )
                        )
                    i, j = offs[ia] + ca, offs[ib] + cb
                    S[i, j] = S[j, i] = s_val
                    T[i, j] = T[j, i] = t_val
                    V[i, j] = V[j, i] = v_val
    return S, T, V


def eri_tensor(shells: Sequence[Shell]) -> np.ndarray:
    """Full (nao, nao, nao, nao) bare-Coulomb ERI tensor, chemists'
    (ij|kl). Small systems only (validation harness)."""
    nao = sum(s.nfunc for s in shells)
    out = np.zeros((nao, nao, nao, nao))
    offs = np.cumsum([0] + [s.nfunc for s in shells])
    ns = len(shells)
    # canonical shell quartets only; the 8-fold permutation symmetry of
    # real bare-Coulomb ERIs fills the rest
    for ia in range(ns):
        for ib in range(ia + 1):
            for ic in range(ia + 1):
                id_max = ib if ic == ia else ic
                for idd in range(id_max + 1):
                    sa, sb = shells[ia], shells[ib]
                    sc, sd = shells[ic], shells[idd]
                    (aa, bb, cc, dd), w = _prim_grid(sa, sb, sc, sd)
                    for ca, la3 in enumerate(CART[sa.l]):
                        for cb, lb3 in enumerate(CART[sb.l]):
                            for cc_i, lc3 in enumerate(CART[sc.l]):
                                for cd, ld3 in enumerate(CART[sd.l]):
                                    val = np.sum(
                                        w
                                        * eri_prim(
                                            la3, lb3, lc3, ld3,
                                            aa, bb, cc, dd,
                                            sa.center, sb.center,
                                            sc.center, sd.center,
                                        )
                                    )
                                    i = offs[ia] + ca
                                    j = offs[ib] + cb
                                    k = offs[ic] + cc_i
                                    l_ = offs[idd] + cd
                                    for (p, q, r, s) in (
                                        (i, j, k, l_), (j, i, k, l_),
                                        (i, j, l_, k), (j, i, l_, k),
                                        (k, l_, i, j), (l_, k, i, j),
                                        (k, l_, j, i), (l_, k, j, i),
                                    ):
                                        out[p, q, r, s] = val
    return out


def run_uhf_molecular(
    shells: Sequence[Shell],
    nuclei: Sequence[Tuple[float, np.ndarray]],
    nelec: Tuple[int, int],
    max_iter: int = 100,
    tol: float = 1e-9,
    lindep: float = 1e-9,
    eri: np.ndarray = None,
    initial_dms: List[np.ndarray] = None,
    occupation: str = "aufbau",
) -> Tuple[float, List[np.ndarray], List[np.ndarray]]:
    """Free-space UHF. Returns (E_total, [eps_a, eps_b], [C_a, C_b]).

    `eri` optionally supplies a precomputed (nao,)*4 chemists' tensor
    (e.g. the vectorized one-center builder in scf/etdz.py).
    `initial_dms` optionally seeds the SCF with [D_alpha, D_beta] AO
    density matrices instead of the core-Hamiltonian aufbau guess —
    used by the ET-DZ generator to steer open-d-shell atoms toward a
    specific real-determinant occupation (scf/etdz._atomic_uhf).
    `occupation='mom'` fills each spin's orbitals by maximum overlap
    with the previous iteration's density (seeded by `initial_dms`)
    instead of by energy — aufbau refilling freely rotates within a
    degenerate open d shell, so a configuration seed alone cannot hold
    a target determinant; MOM locks it (the caller compares stationary
    solutions across seeds and keeps the lowest)."""
    S, T, V = one_electron_matrices(shells, nuclei)
    if eri is None:
        eri = eri_tensor(shells)
    hcore = T + V

    # canonical orthogonalization with linear-dependence pruning
    s_eig, s_vec = np.linalg.eigh(S)
    keep = s_eig > lindep * s_eig.max()
    X = s_vec[:, keep] / np.sqrt(s_eig[keep])

    def solve(F):
        f_o = X.T @ F @ X
        eps, c_o = np.linalg.eigh(f_o)
        return eps, X @ c_o

    eps0, c0 = solve(hcore)
    if initial_dms is not None:
        dms = [np.array(d, dtype=float) for d in initial_dms]
    else:
        dms = []
        for n_s in nelec:
            c_occ = c0[:, :n_s]
            dms.append(c_occ @ c_occ.T)

    e_nn = 0.0
    for i, (zi, ri) in enumerate(nuclei):
        for j, (zj, rj) in enumerate(nuclei):
            if j > i:
                e_nn += zi * zj / np.linalg.norm(
                    np.asarray(ri) - np.asarray(rj)
                )

    e_prev = None
    eps_out, c_out = [eps0, eps0], [c0, c0]
    for _ in range(max_iter):
        d_tot = dms[0] + dms[1]
        J = np.einsum("ijkl,kl->ij", eri, d_tot)
        focks, e_elec = [], 0.0
        new_dms, eps_out, c_out = [], [], []
        for s in range(2):
            K = np.einsum("ikjl,kl->ij", eri, dms[s])
            F = hcore + J - K
            e_elec += 0.5 * np.sum(dms[s] * (hcore + F))
            eps, c = solve(F)
            if occupation == "mom":
                # occupy by overlap with the previous density's range
                p = np.einsum("mi,mn,np,pq,qi->i", c, S, dms[s], S, c,
                              optimize=True)
                occ_idx = np.sort(np.argsort(-p, kind="stable")[: nelec[s]])
                c = np.concatenate(
                    [c[:, occ_idx],
                     np.delete(c, occ_idx, axis=1)], axis=1
                )
                eps = np.concatenate(
                    [eps[occ_idx], np.delete(eps, occ_idx)]
                )
            eps_out.append(eps)
            c_out.append(c)
            c_occ = c[:, : nelec[s]]
            new_dms.append(c_occ @ c_occ.T)
        e_total = e_elec + e_nn
        if e_prev is not None and abs(e_total - e_prev) < tol:
            dms = new_dms
            break
        # light damping stabilizes small open-shell atoms
        dms = [0.7 * n + 0.3 * o for n, o in zip(new_dms, dms)]
        e_prev = e_total
    return e_total, eps_out, c_out
