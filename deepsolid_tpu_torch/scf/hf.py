"""Native periodic SCF orbital source (no PySCF).

A copy of deepsolid_tpu/scf/hf.py: the solver (core matrices, UHF
cycles, the on-disk cache of converged solutions, band solve, aufbau)
stays host numpy; `ScfOrbitals.orbital_mats` and `slogdet` are torch on
the walkers' device. The cache is the JAX package's: the same file names
under the same DEEPSOLID_TPU_SCF_CACHE directory, so the two packages
share one cache.

Solves the k-point core-Hamiltonian problem H_k C_k = S_k C_k eps_k with
analytic lattice-summed Gaussian integrals (overlap, kinetic) and an
Ewald-split nuclear attraction (short-range erfc via McMurchie-Davidson,
long-range via reciprocal-space pair-density Fourier transforms). Bands
fill by aufbau across all supercell k-points, yielding the occupied k-list
and MO coefficients for pretraining targets.

Replaces the reference's PySCF HF bridge (hf.py:44-218) for the systems
the built-in basis covers. The mean-field J/K terms are intentionally
deferred (core Hamiltonian only): orbitals lack e-e screening but carry
the right Bloch/band structure, which is what pretraining consumes. The
G=0 constant of the Ewald potential is dropped — it shifts all
eigenvalues uniformly and does not affect orbitals or occupations.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from deepsolid_tpu_torch import native
from deepsolid_tpu_torch.device import constant
from deepsolid_tpu_torch.scf import basis as basis_lib
from deepsolid_tpu_torch.scf import integrals as ints
from deepsolid_tpu_torch.scf.free_electron import twisted_kpts, wrap_kpoints
from deepsolid_tpu_torch.scf.gto import PeriodicAOEvaluator, _lattice_images
from deepsolid_tpu_torch.scf.interface import slogdet_sum
from deepsolid_tpu_torch.system.cell import Supercell, reciprocal_vectors


def _shell_pairs(shells):
    out = []
    ao_off = []
    off = 0
    for s in shells:
        ao_off.append(off)
        off += s.nfunc
    for i, si in enumerate(shells):
        for j, sj in enumerate(shells):
            out.append((i, j, si, sj, ao_off[i], ao_off[j]))
    return out, off


def _nuclear_sr_block(sa, sb, a_pos, bk, nuc_centers, nuc_z, omega,
                      inv_lattice, lattice):
    """Contracted erfc-attenuated nuclear-attraction block (nfa, nfb, nT).

    Shares one Hermite R table (for the erfc = bare - erf difference
    kernel) across all cartesian components of the shell pair — the
    dominant cost otherwise repeats it 9x for p-p pairs and 2x per kernel.
    """
    la, lb = sa.l, sb.l
    na, nb = len(sa.exponents), len(sb.exponents)
    al = sa.exponents.reshape(na, 1, 1, 1)
    be = sb.exponents.reshape(1, nb, 1, 1)
    a_p = np.broadcast_to(a_pos, (1, 1, 1, 1, 3))
    b_p = bk[None, None, :, None]
    p = al + be
    mu = al * be / p
    # wrap the pair center into the home cell (translation invariance)
    P = (al[..., None] * a_p + be[..., None] * b_p) / p[..., None]
    shift = np.floor(P.reshape(-1, 3) @ inv_lattice) @ lattice
    shift = shift.reshape(P.shape)
    a_sh = a_p - shift
    b_sh = b_p - shift
    P = P - shift
    pc = P - nuc_centers[None, None, None, :]
    r2 = np.sum(pc * pc, axis=-1)
    ab = a_sh - b_sh

    # E coefficients per dimension at the pair's max angular momenta
    es = []
    for d in range(3):
        x = ab[..., d]
        kab = np.exp(-mu * x * x)
        es.append(
            ints.e_coeffs(la, lb, p, -(be / p) * x, (al / p) * x, kab)
        )

    theta2 = omega**2 / (omega**2 + p)
    sq_theta = np.sqrt(theta2)

    def fns(n):  # erfc kernel = bare - erf difference, one table
        return (-2.0 * p) ** n * (
            ints.boys(n, p * r2)
            - sq_theta * theta2**n * ints.boys(n, theta2 * p * r2)
        )

    r_tab = ints.hermite_r(la + lb, p, pc, fns)

    norm_a = basis_lib.primitive_norm(sa.exponents, la)
    norm_b = basis_lib.primitive_norm(sb.exponents, lb)
    ca = (sa.coefficients * norm_a).reshape(na, 1, 1, 1)
    cb = (sb.coefficients * norm_b).reshape(1, nb, 1, 1)
    weight = 2.0 * np.pi / p * ca * cb

    rows = []
    for la3 in ints.CART[la]:
        cols = []
        for lb3 in ints.CART[lb]:
            acc = 0.0
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
                        acc = acc + (et * eu * ev) * r_tab[(t, u, v)]
            block = np.einsum("abtc,c->abt", weight * acc, -nuc_z)
            cols.append(block.sum(axis=(0, 1)))
        rows.append(cols)
    return np.array(rows)  # (nfa, nfb, nT)


def _pair_ft_vlr_block(sa, sb, a_pos, bk, gpts, w_eff):
    """Long-range nuclear-attraction block (nfa, nfb, nT) from pair FTs.

    Computes -2 Re sum_G conj(rho_ab(G)) w_eff(G) with
    w_eff = (nuclear structure factor) * (LR Ewald weight), sharing ONE
    Gaussian base exp(-G^2/4p) e^{-iG.P} and ONE weighted moment GEMM
    across all cartesian component pairs — the naive route rebuilds the
    (na, nb, nT, ng) array per component pair (36x for d-d shells) and
    dominated the round-1 cc-pVDZ diamond build (1190 s of 1330 s).
    """
    la, lb = sa.l, sb.l
    na, nb = len(sa.exponents), len(sb.exponents)
    al = sa.exponents.reshape(na, 1, 1)
    be = sb.exponents.reshape(1, nb, 1)
    p = al + be  # (na, nb, 1)
    mu = al * be / p
    a_p = np.broadcast_to(a_pos, (1, 1, 1, 3))
    b_p = bk[None, None, :, :]  # (1, 1, nT, 3)

    lsum = la + lb
    combos = [
        (t, u, v)
        for t in range(lsum + 1)
        for u in range(lsum + 1)
        for v in range(lsum + 1)
        if t + u + v <= lsum
    ]
    nT = bk.shape[0]

    lib = native.load_pair_ft()
    if lib is not None:
        import ctypes

        out_re = np.zeros((na, nb, nT, len(combos)))
        out_im = np.zeros_like(out_re)

        def dptr(x):
            return np.ascontiguousarray(x, np.float64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)
            )

        a_c = np.ascontiguousarray(np.asarray(a_pos, np.float64))
        b_c = np.ascontiguousarray(bk, np.float64)
        g_c = np.ascontiguousarray(gpts, np.float64)
        wr = np.ascontiguousarray(np.real(w_eff))
        wi = np.ascontiguousarray(np.imag(w_eff))
        al_c = np.ascontiguousarray(sa.exponents, np.float64)
        be_c = np.ascontiguousarray(sb.exponents, np.float64)
        rc = lib.pair_ft_r_table(
            na, nb, dptr(al_c), dptr(be_c), dptr(a_c), dptr(b_c), nT,
            dptr(g_c), dptr(wr), dptr(wi), gpts.shape[0],
            lsum, 1e-14,
            out_re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        assert rc == 0, f"pair_ft_r_table failed with rc={rc}"
        r_tab = out_re + 1j * out_im
    else:
        g2 = np.sum(gpts * gpts, axis=-1)  # (ng,)
        P = (al[..., None] * a_p + be[..., None] * b_p) / p[..., None]
        pref = (np.pi / p[..., None]) ** 1.5 * np.exp(
            -g2 / (4.0 * p[..., None])
        )  # (na, nb, 1, ng)
        phase = np.exp(-1j * (P.reshape(-1, 3) @ gpts.T)).reshape(
            P.shape[:-1] + (-1,)
        )
        base = pref * phase  # (na, nb, nT, ng)
        gx, gy, gz = gpts[:, 0], gpts[:, 1], gpts[:, 2]
        w_rows = np.stack([
            w_eff
            * np.conj((-1j * gx) ** t * (-1j * gy) ** u * (-1j * gz) ** v)
            for (t, u, v) in combos
        ])  # (nc, ng)
        # one zgemm: (na*nb*nT, ng) @ (ng, nc)
        r_tab = (np.conj(base).reshape(-1, g2.shape[0]) @ w_rows.T).reshape(
            na, nb, nT, len(combos)
        )

    ab = a_p - b_p  # (1, 1, nT, 3)
    es = []
    for d in range(3):
        x = ab[..., d]
        kab = np.exp(-mu * x * x)
        es.append(ints.e_coeffs(la, lb, p, -(be / p) * x, (al / p) * x, kab))
    r_idx = {c: i for i, c in enumerate(combos)}

    norm_a = basis_lib.primitive_norm(sa.exponents, la)
    norm_b = basis_lib.primitive_norm(sb.exponents, lb)
    ca = (sa.coefficients * norm_a).reshape(na, 1, 1)
    cb = (sb.coefficients * norm_b).reshape(1, nb, 1)
    weight = ca * cb  # (na, nb, 1)

    rows = []
    for la3 in ints.CART[la]:
        cols = []
        for lb3 in ints.CART[lb]:
            acc = 0.0
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
                        acc = acc + (et * eu * ev) * r_tab[
                            ..., r_idx[(t, u, v)]
                        ]
            cols.append(-2.0 * np.real(np.sum(weight * acc, axis=(0, 1))))
        rows.append(cols)
    return np.array(rows)  # (nfa, nfb, nT)


def _contracted(block_fn, sa, sb, b_shift):
    """Contract a primitive-pair integral over both shells' primitives.

    block_fn(la3, lb3, alpha, beta) -> array over (na_prim, nb_prim) +
    extra dims; returns (nfunc_a, nfunc_b) + extra dims.
    """
    na = ints.CART[sa.l]
    nb = ints.CART[sb.l]
    norm_a = basis_lib.primitive_norm(sa.exponents, sa.l)
    norm_b = basis_lib.primitive_norm(sb.exponents, sb.l)
    ca = sa.coefficients * norm_a
    cb = sb.coefficients * norm_b
    alpha = sa.exponents[:, None]
    beta = sb.exponents[None, :]
    rows = []
    for la3 in na:
        cols = []
        for lb3 in nb:
            prim = block_fn(la3, lb3, alpha, beta)
            cols.append(np.einsum("a,b,ab...->...", ca, cb, prim))
        rows.append(cols)
    return np.array(rows)


def core_matrices(
    cell,
    shells,
    kpts: np.ndarray,
    beta: float = None,
    eps: float = 1e-12,
):
    """(S_k, T_k, V_k) arrays of shape (nk, nao, nao), complex."""
    lattice = np.asarray(cell.lattice)
    volume = abs(np.linalg.det(lattice))
    charges = np.asarray(cell.atom_charges)
    coords = np.asarray(cell.atom_coords)

    if beta is None:
        # Balance real-space erfc images (cost ~ (1/beta)^3 / V) against
        # reciprocal G points (cost ~ V beta^3): optimum beta ~ V^{-1/3}.
        # (Tying beta to the smallest height like the Ewald energy does
        # explodes the G count for strongly anisotropic cells.)
        beta = 5.0 / volume ** (1.0 / 3.0)

    # pair images: overlap decays with reduced exponent mu
    alpha_min = min(float(s.exponents.min()) for s in shells)
    mu_min = alpha_min / 2.0
    rcut_pair = np.sqrt(-np.log(eps) / mu_min)
    images = _lattice_images(lattice, rcut_pair)

    # nuclear centers for the erfc short-range part: pair centers P are
    # wrapped into the home cell (translation invariance), so a SMALL
    # image set around it suffices regardless of how far the pair image is
    rcut_sr = 5.5 / beta
    cell_center = lattice.sum(0) / 2
    half_diag = np.linalg.norm(cell_center)
    nuc_images = _lattice_images(lattice, rcut_sr + 2 * half_diag)
    nuc_centers = (coords[:, None, :] + nuc_images[None, :, :]).reshape(-1, 3)
    nuc_z = np.repeat(charges, nuc_images.shape[0])
    # wrapped pair centers live in the home cell: only nuclei within
    # rcut_sr of it contribute to the erfc sum
    keep_nuc = (
        np.linalg.norm(nuc_centers - cell_center, axis=1)
        <= rcut_sr + half_diag + 1e-9
    )
    nuc_centers = nuc_centers[keep_nuc]
    nuc_z = nuc_z[keep_nuc]
    inv_lattice = np.linalg.inv(lattice)

    # reciprocal vectors for the long-range part
    from deepsolid_tpu_torch.ops.ewald import _gpoints_in_cutoff

    gpts, _ = _gpoints_in_cutoff(
        2 * np.pi * np.linalg.inv(lattice).T, beta, volume, 1e-12
    )
    gw = (
        4.0 * np.pi
        * np.exp(-np.sum(gpts**2, -1) / (4 * beta**2))
        / (volume * np.sum(gpts**2, -1))
    )
    n_g = np.exp(-1j * gpts @ coords.T) @ charges  # nuclear structure factor

    pairs, nao = _shell_pairs(shells)
    nk = kpts.shape[0]
    s_k = np.zeros((nk, nao, nao), np.complex128)
    t_k = np.zeros((nk, nao, nao), np.complex128)
    v_k = np.zeros((nk, nao, nao), np.complex128)
    phases = np.exp(1j * kpts @ images.T)  # (nk, nT)

    chunk = 256  # pair images per sweep: bounds peak memory

    for (i, j, si, sj, oi, oj) in pairs:
        a_pos = si.center
        b_pos = sj.center[None, :] + images  # (nT, 3)
        ab = a_pos[None, :] - b_pos  # (nT, 3)
        # screen images by pair Gaussian decay
        mu_pair = (si.exponents.min() * sj.exponents.min()) / (
            si.exponents.min() + sj.exponents.min()
        )
        keep = mu_pair * np.sum(ab * ab, -1) < -np.log(eps)
        if not np.any(keep):
            continue
        abk_all = ab[keep]
        bk_all = b_pos[keep]
        ph_all = phases[:, keep]  # (nk, nTk)

        for c0 in range(0, abk_all.shape[0], chunk):
            abk = abk_all[c0:c0 + chunk]
            bk = bk_all[c0:c0 + chunk]
            ph = ph_all[:, c0:c0 + chunk]

            def s_fn(la3, lb3, alpha, beta_):
                return ints.overlap_prim(
                    la3, lb3, alpha[..., None], beta_[..., None],
                    abk[None, None],
                )

            def t_fn(la3, lb3, alpha, beta_):
                return ints.kinetic_prim(
                    la3, lb3, alpha[..., None], beta_[..., None],
                    abk[None, None],
                )

            s_blk = _contracted(s_fn, si, sj, abk)  # (nfa, nfb, nTc)
            t_blk = _contracted(t_fn, si, sj, abk)

            v_sr_blk = _nuclear_sr_block(
                si, sj, a_pos, bk, nuc_centers, nuc_z, beta,
                inv_lattice, lattice,
            )

            v_lr_blk = _pair_ft_vlr_block(si, sj, a_pos, bk, gpts, n_g * gw)

            nfa, nfb = s_blk.shape[0], s_blk.shape[1]
            s_k[:, oi:oi + nfa, oj:oj + nfb] += np.einsum(
                "kt,abt->kab", ph, s_blk
            )
            t_k[:, oi:oi + nfa, oj:oj + nfb] += np.einsum(
                "kt,abt->kab", ph, t_blk
            )
            v_k[:, oi:oi + nfa, oj:oj + nfb] += np.einsum(
                "kt,abt->kab", ph, v_sr_blk + v_lr_blk
            )

    # The real-space erfc image sum carries the SR kernel's zero-momentum
    # component (int erfc(beta r)/r d^3r = pi/beta^2 per unit charge); the
    # G = 0-dropped (neutralizing background) convention removes it:
    # attraction of -Z_tot with that uniform component is
    # -(pi/(V beta^2)) Z_tot S_k, so add it back. Without this the core
    # bands carry a spurious O(1/L) shift (caught by the exact Ewald-
    # potential quadrature in tests/test_scf.py).
    v_k += (np.pi / (volume * beta**2)) * charges.sum() * s_k

    return s_k, t_k, v_k


def exx_madelung(lattice_bvk: np.ndarray) -> float:
    """Madelung constant of the Born-von-Karman supercell for the
    exxdiv='ewald' exchange correction (probe unit charge + background).

    Mirrors the reference's reliance on PySCF's `tools.madelung`
    (exchange divergence handling in its KRHF bridge, hf.py:44-218).
    """
    from deepsolid_tpu_torch.ops.ewald import EwaldSum

    @dataclasses.dataclass
    class _Probe:
        lattice: np.ndarray
        atom_coords: np.ndarray
        atom_charges: np.ndarray
        nelec: Tuple[int, int]

    probe = _Probe(
        lattice=np.asarray(lattice_bvk),
        atom_coords=np.zeros((1, 3)),
        atom_charges=np.ones(1),
        nelec=(0, 0),
    )
    return -2.0 * EwaldSum.build(probe).madelung


def _fill_aufbau(eps_all, n_occ):
    """Global (k, band) aufbau occupation: per-k sorted band index lists."""
    flat = [
        (e, ki, bi)
        for ki, es in enumerate(eps_all)
        for bi, e in enumerate(es)
    ]
    flat.sort(key=lambda x: (round(x[0], 9), x[1], x[2]))
    per_k = {ki: [] for ki in range(len(eps_all))}
    for e, ki, bi in flat[:n_occ]:
        per_k[ki].append(bi)
    return [sorted(per_k[ki]) for ki in range(len(eps_all))]


def _density(c_all, occ):
    nao = c_all[0].shape[0]
    dm = np.zeros((len(c_all), nao, nao), np.complex128)
    for ki, (c, bands) in enumerate(zip(c_all, occ)):
        co = c[:, bands]
        dm[ki] = co @ co.conj().T
    return dm


def _fermi_occupations(eps_all, n_occ, sigma):
    """Fractional Fermi-Dirac occupations n_{k,b} summing to n_occ.

    The chemical potential is found by bisection across the combined
    (k, band) spectrum. Fermi broadening is the standard fix for SCF
    occupation oscillation between near-degenerate band fixed points
    (the role PySCF's `scf.addons.smearing_` plays for the reference's
    bridge); annealed to sigma -> 0 it recovers an integer-occupation
    UHF solution.
    """
    flat = np.concatenate([np.asarray(e) for e in eps_all])
    lo = float(flat.min()) - 20.0 * sigma
    hi = float(flat.max()) + 20.0 * sigma

    def total(mu):
        z = np.clip((flat - mu) / sigma, -40.0, 40.0)
        return float(np.sum(1.0 / (1.0 + np.exp(z))))

    for _ in range(200):
        mu = 0.5 * (lo + hi)
        if total(mu) < n_occ:
            lo = mu
        else:
            hi = mu
    mu = 0.5 * (lo + hi)
    return [
        1.0 / (1.0 + np.exp(np.clip((np.asarray(e) - mu) / sigma, -40.0, 40.0)))
        for e in eps_all
    ]


def _density_frac(c_all, occ_frac):
    """Density matrices from fractional per-(k, band) occupations."""
    nao = c_all[0].shape[0]
    dm = np.zeros((len(c_all), nao, nao), np.complex128)
    for ki, (c, n) in enumerate(zip(c_all, occ_frac)):
        dm[ki] = (c * np.asarray(n)[None, :]) @ c.conj().T
    return dm


class _Diis:
    """Pulay DIIS over flattened Fock matrices."""

    def __init__(self, max_vec: int = 8):
        self.f: List[np.ndarray] = []
        self.e: List[np.ndarray] = []
        self.max_vec = max_vec

    def update(self, f_flat: np.ndarray, err_flat: np.ndarray) -> np.ndarray:
        self.f.append(f_flat)
        self.e.append(err_flat)
        if len(self.f) > self.max_vec:
            self.f.pop(0)
            self.e.pop(0)
        n = len(self.f)
        if n < 2:
            return f_flat
        b = np.empty((n + 1, n + 1), np.complex128)
        b[:n, :n] = np.array(
            [[np.vdot(ei, ej) for ej in self.e] for ei in self.e]
        )
        b[n, :] = -1.0
        b[:, n] = -1.0
        b[n, n] = 0.0
        rhs = np.zeros(n + 1, np.complex128)
        rhs[n] = -1.0
        try:
            coeff = np.linalg.solve(b, rhs)[:n]
        except np.linalg.LinAlgError:
            return f_flat
        return sum(c * f for c, f in zip(coeff, self.f))


@dataclasses.dataclass
class MeanField:
    """Converged (or last-iterate) periodic UHF state."""

    e_tot: float
    converged: bool
    eps: Tuple[List[np.ndarray], List[np.ndarray]]  # per spin, per k
    c: Tuple[List[np.ndarray], List[np.ndarray]]
    n_cycles: int


def run_uhf(sc: Supercell, shells, kpts, beta: float = None,
            eps_eri: float = 1e-8, max_cycle: int = 60,
            conv_tol: float = 1e-8, restricted: bool = False) -> MeanField:
    """Self-consistent periodic UHF with Ewald-split J/K.

    Fock: F^s = h + J[D_tot] - K[D^s] with the SR erfc ERIs
    (eri.sr_eri_tensors) + reciprocal-space LR blocks (eri.LrBlocks) and
    the exxdiv='ewald' Madelung correction on K. Energy is per primitive
    cell; nuclear repulsion from the primitive-cell Ewald sum. Parity
    target: the reference's PySCF bridge (hf.py:44-218) — which supports
    BOTH KRHF and KUHF (hf.py:61-81); `restricted=True` is the KRHF path
    (closed shells only: the spin manifolds are tied, one band solve per
    cycle, alpha orbitals == beta orbitals by construction).
    """
    from deepsolid_tpu_torch.ops.ewald import EwaldSum
    from deepsolid_tpu_torch.scf import eri as eri_lib

    prim = sc.prim
    lattice = np.asarray(prim.lattice)
    volume = abs(np.linalg.det(lattice))
    if beta is None:
        beta = 5.0 / volume ** (1.0 / 3.0)

    import logging
    import time as _time

    t0 = _time.time()
    s_k, t_k, v_k = core_matrices(prim, shells, kpts, beta=beta)
    h_k = t_k + v_k
    nk = kpts.shape[0]
    logging.info("run_uhf: core matrices %.1f s", _time.time() - t0)

    t0 = _time.time()
    sr = eri_lib.SrBlocks(shells, lattice, kpts, beta, s_k, eps_eri)
    logging.info("run_uhf: SR-ERI blocks %.1f s", _time.time() - t0)
    t0 = _time.time()
    gpts = eri_lib.full_gpoints(lattice, beta)
    lr = eri_lib.LrBlocks(shells, lattice, kpts, beta, volume, gpts)
    logging.info("run_uhf: LR blocks (%d G points) %.1f s", len(gpts),
                 _time.time() - t0)
    xi = exx_madelung(sc.lattice)
    e_nn = EwaldSum.build(prim).madelung

    n_occ = tuple(sc.nelec)
    if restricted and n_occ[0] != n_occ[1]:
        raise ValueError(
            f"restricted=True (KRHF) requires a closed shell; got "
            f"nelec={n_occ}"
        )
    eps0, c0 = _solve_bands(h_k, s_k)
    occ = [_fill_aufbau(eps0, n) for n in n_occ]
    dm = [_density(c0, o) for o in occ]

    result = _scf_cycles(
        h_k, s_k, sr, lr, xi, e_nn, n_occ, dm, nk,
        max_cycle=max_cycle, conv_tol=conv_tol, restricted=restricted,
    )
    # Rescue ladder for oscillating cases (diffuse/near-degenerate
    # bases): restart from the best density with a level shift on the
    # virtuals + Fock damping before DIIS engages; escalate the shift if
    # the oscillation survives (e.g. Si diamond et-dz bounces between two
    # occupation fixed points that 0.3 Ha does not separate). PySCF's
    # level_shift/damp knobs serve the same role in the reference's
    # bridge; the expensive SR/LR blocks are reused across attempts.
    rescue_ladder = (
        dict(level_shift=0.3, damp=0.5, diis_start_cycle=5),
        dict(level_shift=1.0, damp=0.8, diis_start_cycle=12),
    )
    for attempt in rescue_ladder:
        if result.converged:
            break
        logging.info(
            "run_uhf: not converged in %d cycles (E=%.8f), retrying "
            "with level_shift=%.1f damp=%.1f", result.n_cycles,
            result.e_tot, attempt["level_shift"], attempt["damp"],
        )
        dm = [_density(result.c[s], _fill_aufbau(result.eps[s], n_occ[s]))
              for s in range(2)]
        result = _scf_cycles(
            h_k, s_k, sr, lr, xi, e_nn, n_occ, dm, nk,
            max_cycle=max_cycle, conv_tol=conv_tol,
            restricted=restricted, **attempt,
        )
        if result.converged:
            # one unshifted build+solve from the converged density so the
            # returned band energies carry no +shift on the virtuals
            dm = [_density(result.c[s],
                           _fill_aufbau(result.eps[s], n_occ[s]))
                  for s in range(2)]
            clean = _scf_cycles(
                h_k, s_k, sr, lr, xi, e_nn, n_occ, dm, nk, max_cycle=1,
                conv_tol=conv_tol, restricted=restricted,
            )
            result = MeanField(
                e_tot=clean.e_tot, converged=True, eps=clean.eps,
                c=clean.c, n_cycles=result.n_cycles + 1,
            )

    # Final rescue: Fermi-smearing annealed to zero. Fractional
    # occupations make the SCF map continuous in the band energies, so
    # the two-cycle occupation oscillation the level shift cannot
    # separate (e.g. Si diamond et-dz, docs/ROADMAP.md) relaxes to one
    # self-consistent filling; shrinking sigma then recovers an
    # integer-occupation UHF fixed point (the last stage runs sigma=0).
    if not result.converged:
        logging.info(
            "run_uhf: level-shift rescue failed (E=%.8f); "
            "Fermi-smearing anneal", result.e_tot,
        )
        dm = [_density(result.c[s], _fill_aufbau(result.eps[s], n_occ[s]))
              for s in range(2)]
        total_cycles = result.n_cycles
        for sigma in (0.2, 0.1, 0.05, 0.02, 0.01, 0.005, 0.0):
            result = _scf_cycles(
                h_k, s_k, sr, lr, xi, e_nn, n_occ, dm, nk,
                max_cycle=(30 if sigma > 0.0 else max_cycle),
                conv_tol=conv_tol, damp=0.3, diis_start_cycle=3,
                smearing_sigma=sigma, restricted=restricted,
            )
            total_cycles += result.n_cycles
            logging.info(
                "run_uhf: anneal sigma=%.3f -> E=%.8f converged=%s "
                "(%d cycles)", sigma, result.e_tot, result.converged,
                result.n_cycles,
            )
            # _scf_cycles updates `dm` in place: the next (colder) stage
            # starts from this stage's final density
        result = MeanField(
            e_tot=result.e_tot, converged=result.converged,
            eps=result.eps, c=result.c, n_cycles=total_cycles,
        )
    return result


def _scf_cycles(h_k, s_k, sr, lr, xi, e_nn, n_occ, dm, nk,
                max_cycle=60, conv_tol=1e-8, level_shift=0.0,
                damp=0.0, diis_start_cycle=1, smearing_sigma=0.0,
                restricted=False):
    """The UHF cycle loop over prebuilt SR/LR two-electron blocks.

    `level_shift` raises the virtual manifold by a constant (F +=
    shift*(S - S D S)); since Q D S = 0 at idempotency this leaves the
    converged density and the FDS-SDF error unchanged while damping
    occupation flips between near-degenerate bands. `damp` mixes the
    previous Fock into the current one for the first `diis_start_cycle`
    cycles before Pulay extrapolation takes over. `smearing_sigma` > 0
    replaces aufbau integer occupations with Fermi-Dirac fractions
    (anneal it to zero to escape occupation-oscillation fixed points;
    do not combine with level_shift — the projector algebra assumes an
    idempotent density)."""
    import logging

    diis = _Diis()
    eps_s, c_s = [None, None], [None, None]
    f_prev = None
    e_old, e_tot, converged, cyc = 0.0, 0.0, False, 0
    for cyc in range(1, max_cycle + 1):
        dm_tot = dm[0] + dm[1]
        j_mat = sr.coulomb(dm_tot) + lr.coulomb(dm_tot)
        f_s, k_s = [], []
        for s in range(2):
            if n_occ[s] == 0:
                k_mat = np.zeros_like(j_mat)
            else:
                k_mat = (
                    sr.exchange(dm[s])
                    + lr.exchange(dm[s])
                    + xi * np.einsum("kab,kbc,kcd->kad", s_k, dm[s], s_k)
                )
            k_s.append(k_mat)
            f_s.append(h_k + j_mat - k_mat)

        e_elec = 0.0
        for s in range(2):
            e_elec += np.einsum("kab,kba->", h_k, dm[s]).real
            e_elec += 0.5 * np.einsum("kab,kba->", j_mat, dm[s]).real
            e_elec -= 0.5 * np.einsum("kab,kba->", k_s[s], dm[s]).real
        e_tot = e_elec / nk + e_nn

        if damp > 0.0 and cyc < diis_start_cycle and f_prev is not None:
            f_s = [(1.0 - damp) * f + damp * fp
                   for f, fp in zip(f_s, f_prev)]
        f_prev = [f.copy() for f in f_s]
        if level_shift > 0.0:
            for s in range(2):
                sds = np.einsum("kab,kbc,kcd->kad", s_k, dm[s], s_k)
                f_s[s] = f_s[s] + level_shift * (s_k - sds)

        # DIIS on the combined spin-Fock vector with FDS-SDF errors
        errs, focks = [], []
        for s in range(2):
            fds = np.einsum("kab,kbc,kcd->kad", f_s[s], dm[s], s_k)
            errs.append((fds - fds.conj().transpose(0, 2, 1)).ravel())
            focks.append(f_s[s].ravel())
        err_norm = max(float(np.abs(e).max()) for e in errs)
        if cyc >= diis_start_cycle:
            f_new = diis.update(np.concatenate(focks), np.concatenate(errs))
            f_s = [
                f_new[i * h_k.size:(i + 1) * h_k.size].reshape(h_k.shape)
                for i in range(2)
            ]

        for s in range(2):
            if restricted and s == 1:
                # KRHF: tie the beta manifold to alpha (one band solve)
                eps_s[1] = eps_s[0]
                c_s[1] = c_s[0]
                dm[1] = dm[0].copy()
                continue
            eps_s[s], c_s[s] = _solve_bands(f_s[s], s_k)
            if smearing_sigma > 0.0 and n_occ[s] > 0:
                n_frac = _fermi_occupations(
                    eps_s[s], n_occ[s], smearing_sigma
                )
                dm[s] = _density_frac(c_s[s], n_frac)
            else:
                occ_s = _fill_aufbau(eps_s[s], n_occ[s])
                dm[s] = _density(c_s[s], occ_s)

        if cyc <= 3 or cyc % 10 == 0:
            logging.info(
                "run_uhf: cycle %d E=%.8f dE=%.2e err=%.2e", cyc, e_tot,
                e_tot - e_old, err_norm,
            )
        if abs(e_tot - e_old) < conv_tol and err_norm < np.sqrt(conv_tol):
            converged = True
            break
        e_old = e_tot

    return MeanField(
        e_tot=float(e_tot), converged=converged,
        eps=(eps_s[0], eps_s[1]), c=(c_s[0], c_s[1]), n_cycles=cyc,
    )


def _uhf_cache_path(sc: Supercell, basis: str, kpts: np.ndarray,
                    shells=None) -> str:
    """Content-keyed cache file for a converged periodic UHF solution.

    A multi-k SR-ERI build costs minutes; training restarts re-enter
    ScfOrbitals.build just to recover the k-list and pretraining targets,
    so the (eps, C) solution is cached on disk. Override the location
    with DEEPSOLID_TPU_SCF_CACHE; set it empty to disable."""
    import hashlib
    import os

    root = os.environ.get(
        "DEEPSOLID_TPU_SCF_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "deepsolid_tpu",
                     "scf"),
    )
    if not root:
        return ""
    prim = sc.prim
    h = hashlib.sha256()
    for arr in (
        np.asarray(prim.lattice, np.float64),
        np.asarray(prim.atom_coords, np.float64),
        np.asarray(sc.lattice, np.float64),
        np.asarray(kpts, np.float64).round(12),
        np.asarray(sc.nelec, np.int64),
    ):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(",".join(prim.atom_symbols).encode())
    h.update(basis.lower().encode())
    # hash the actual shell data, not just the basis name: generated
    # bases (et-dz) can be regenerated with different tables under the
    # same name, and a name-keyed cache would silently serve stale
    # orbitals for them
    if shells is not None:
        for s in shells:
            h.update(np.int64(s.l).tobytes())
            h.update(np.asarray(s.exponents, np.float64).tobytes())
            h.update(np.asarray(s.coefficients, np.float64).tobytes())
            h.update(np.int64(s.atom_index).tobytes())
    return os.path.join(root, f"uhf_{h.hexdigest()[:24]}.npz")


def run_uhf_cached(sc: Supercell, shells, kpts,
                   basis: str, restricted: bool = False) -> "MeanField":
    """run_uhf with a content-addressed disk cache of (eps, C)."""
    import os

    key = basis + (":rhf" if restricted else "")
    path = _uhf_cache_path(sc, key, kpts, shells)
    if path and os.path.exists(path):
        try:
            with np.load(path) as f:
                nk = int(f["nk"])
                eps = tuple(
                    [f[f"eps_{s}_{k}"] for k in range(nk)] for s in range(2)
                )
                c = tuple(
                    [f[f"c_{s}_{k}"] for k in range(nk)] for s in range(2)
                )
                cached = MeanField(
                    e_tot=float(f["e_tot"]),
                    converged=bool(f["converged"]),
                    eps=eps, c=c, n_cycles=0,
                )
            # An unconverged entry must not pin the run forever: the SCF
            # code (rescue pass, damping defaults) may have improved since
            # it was written. Serve only converged results; recompute and
            # overwrite otherwise.
            if cached.converged:
                return cached
        except Exception:
            pass  # corrupt cache entry: recompute
    mf = run_uhf(sc, shells, kpts, restricted=restricted)
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "nk": np.asarray(len(mf.eps[0])),
            "e_tot": np.asarray(mf.e_tot),
            "converged": np.asarray(mf.converged),
        }
        for s in range(2):
            for k, (e_arr, c_arr) in enumerate(zip(mf.eps[s], mf.c[s])):
                payload[f"eps_{s}_{k}"] = np.asarray(e_arr)
                payload[f"c_{s}_{k}"] = np.asarray(c_arr)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    return mf


def _solve_bands(h_k, s_k, lindep: float = 1e-8):
    """Generalized eigenproblem per k with canonical orthogonalization."""
    eps_all, c_all = [], []
    for h, s in zip(h_k, s_k):
        s = (s + s.conj().T) / 2
        w, u = np.linalg.eigh(s)
        keep = w > lindep * w.max()
        x = u[:, keep] / np.sqrt(w[keep])
        hp = x.conj().T @ ((h + h.conj().T) / 2) @ x
        e, cp = np.linalg.eigh(hp)
        eps_all.append(e)
        c_all.append(x @ cp)
    return eps_all, c_all


@dataclasses.dataclass
class ScfOrbitals:
    """Orbital source backed by the native periodic SCF."""

    evaluator: PeriodicAOEvaluator
    c_occ: Tuple[List[np.ndarray], List[np.ndarray]]  # per spin: per k
    klist: Tuple[np.ndarray, np.ndarray]
    spins: Tuple[int, int]
    band_energies: List[np.ndarray]

    @classmethod
    def build(cls, sc: Supercell, basis: str = "sto-3g",
              twist=(0.0, 0.0, 0.0), level: str = "core") -> "ScfOrbitals":
        """level: 'core' (core-Hamiltonian bands, fast), 'hf' (full
        self-consistent UHF via run_uhf), or 'rhf' (restricted KRHF,
        closed shells — the reference's PySCF bridge supports both,
        hf.py:61-81)."""
        prim = sc.prim
        shells = basis_lib.build_shells(prim, basis)
        kpts = twisted_kpts(sc, twist)
        if level in ("hf", "rhf"):
            mf = run_uhf_cached(
                sc, shells, kpts, basis, restricted=(level == "rhf")
            )
            eps_spin = mf.eps
            c_spin = mf.c
        elif level == "core":
            s_k, t_k, v_k = core_matrices(prim, shells, kpts)
            eps_all, c_all = _solve_bands(t_k + v_k, s_k)
            eps_spin = (eps_all, eps_all)
            c_spin = (c_all, c_all)
        else:
            raise ValueError(f"unknown SCF level: {level!r}")

        # aufbau over (k, band) per spin channel; network phases get the
        # first-BZ (minimal-norm) representative of each occupied k — the
        # AO Bloch sums below keep the raw kpts (both are k mod G_prim
        # invariant; the network's fixed e^{ik.r} phases are not, in
        # conditioning: see free_electron.wrap_kpoints)
        wrapped = wrap_kpoints(kpts, reciprocal_vectors(prim.lattice))
        c_occ = ([], [])
        klists = ([], [])
        for s, n_s in enumerate(sc.nelec):
            occ = _fill_aufbau(eps_spin[s], n_s)
            for ki in range(kpts.shape[0]):
                bands = occ[ki]
                c_occ[s].append(c_spin[s][ki][:, bands])
                klists[s].extend([wrapped[ki]] * len(bands))
        klist = tuple(
            np.asarray(kl).reshape(-1, 3) if kl else np.zeros((0, 3))
            for kl in klists
        )
        evaluator = PeriodicAOEvaluator.build(prim, shells, kpts)
        return cls(
            evaluator=evaluator,
            c_occ=c_occ,
            klist=klist,
            spins=tuple(sc.nelec),
            band_energies=list(eps_spin[0]),
        )

    # ---- evaluation on the walkers' device ------------------------------------
    def orbital_mats(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (batch, ne*3) -> [(batch, n_s, n_s) complex] per active spin."""
        batch = x.shape[0]
        aos = self.evaluator.eval_aos(x.reshape(-1, 3))  # (nk, batch*ne, nao)
        aos = aos.reshape(aos.shape[0], batch, sum(self.spins), -1)
        out = []
        start = 0
        for s, n_s in enumerate(self.spins):
            if n_s == 0:
                continue
            rows = aos[:, :, start:start + n_s, :]
            mos = [rows[k] @ constant(self.c_occ[s][k], rows)
                   for k in range(rows.shape[0]) if self.c_occ[s][k].shape[1] > 0]
            out.append(torch.cat(mos, dim=-1))  # (batch, n_s, n_s)
            start += n_s
        return out

    def slogdet(self, x: torch.Tensor) -> torch.Tensor:
        return slogdet_sum(self.orbital_mats(x))
