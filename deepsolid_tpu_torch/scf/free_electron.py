"""Native occupied-k-list construction (no external SCF required).

The network's Bloch phases need one k-vector per occupied orbital per spin
channel (reference obtains these from PySCF k-point HF occupations,
hf.py:84-104). Natively we support:

  * 'uniform' — every supercell k-point hosts the same number of bands
    (exact for band insulators, where HF occupations are k-uniform).
  * 'fermi'   — fill candidate plane-wave states (k + G) in order of
    kinetic energy |k+G|^2/2 (free-electron Fermi sea; right default for
    simple metals).
  * 'auto'    — 'uniform' when the electron count divides evenly over
    k-points, else 'fermi'.

Users may also pass an explicit klist (e.g. from an external HF run)
straight to the network.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from deepsolid_tpu_torch.system.cell import Supercell, reciprocal_vectors


def twisted_kpts(sc: Supercell, twist=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Supercell k-points shifted by a twist (fractions of the supercell
    reciprocal vectors). Reference semantics: hf.py:61-62."""
    shift = np.mod(np.asarray(twist, np.float64), 1.0) @ reciprocal_vectors(sc.lattice)
    return sc.kpts + shift


def wrap_kpoints(klist: np.ndarray, prim_recip: np.ndarray) -> np.ndarray:
    """Minimal-norm representative of each k modulo the PRIMITIVE
    reciprocal lattice (first-BZ / Wigner-Seitz wrap).

    Every consumer of an occupied k is invariant under k -> k - G for a
    primitive reciprocal vector G: AO Bloch sums pick e^{-iG.T} = 1 over
    lattice translations T, and supercell boundary phases pick
    e^{-iG.L_sim} = 1. The NETWORK's fixed phase factors e^{ik.r} are not
    invariant in conditioning: an unwrapped k (the supercell-folding
    convention keeps fractional coordinates in [0,1)) forces the learned
    periodic factor to unlearn a fast e^{iG.r} oscillation and inflates
    the initial kinetic energy by ~|k|^2/2 per orbital — the round-1 H10
    training stall. Always wrap before handing k's to the ansatz.
    """
    klist = np.asarray(klist, np.float64)
    if klist.size == 0:
        return klist
    m = np.array(
        list(itertools.product((-1, 0, 1), repeat=3)), np.float64
    ) @ prim_recip
    cand = klist[:, None, :] - m[None, :, :]
    norms = np.sum(cand**2, axis=-1)
    # deterministic tie-break on BZ boundaries: smallest shift index wins
    best = np.argmin(np.round(norms, 12), axis=1)
    return cand[np.arange(len(klist)), best]


def _candidates(kpts: np.ndarray, prim_recip: np.ndarray, n: int):
    """All (k index, G) plane-wave states within a shell big enough for n."""
    nk = kpts.shape[0]
    m = max(2, int(np.ceil((4.0 * n / nk) ** (1.0 / 3.0))))
    gs = np.array(
        list(itertools.product(range(-m, m + 1), repeat=3)), np.float64
    ) @ prim_recip
    cand_k = np.repeat(np.arange(nk), gs.shape[0])
    cand_g = np.tile(gs, (nk, 1))
    cand_vec = (kpts[:, None, :] + gs[None, :, :]).reshape(-1, 3)
    energy = 0.5 * np.sum(cand_vec**2, axis=-1)
    return cand_k, cand_g, cand_vec, energy


def fill_states(
    kpts: np.ndarray, prim_recip: np.ndarray, n: int, policy: str = "auto"
) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied plane-wave states for one spin channel.

    Returns (k_reduced (n, 3), q_full (n, 3)) with q = k + G. The reduced
    k's feed the network's Bloch phases; the full q's define plane-wave
    pretraining orbitals.
    """
    nk = kpts.shape[0]
    if policy == "auto":
        policy = "uniform" if n % nk == 0 else "fermi"
    cand_k, cand_g, cand_vec, energy = _candidates(kpts, prim_recip, n)
    order = np.lexsort((np.arange(len(energy)), cand_k, np.round(energy, 10)))
    if policy == "fermi":
        sel = order[:n]
        sel = sel[np.argsort(cand_k[sel], kind="stable")]
    elif policy == "uniform":
        if n % nk != 0:
            raise ValueError(f"uniform filling needs nk={nk} to divide n={n}")
        per_k = n // nk
        sel = []
        for ki in range(nk):
            mine = order[cand_k[order] == ki]
            sel.extend(mine[:per_k])
        sel = np.asarray(sel)
    else:
        raise ValueError(f"Unknown filling policy: {policy}")
    return wrap_kpoints(kpts[cand_k[sel]], prim_recip), cand_vec[sel]


def fill_klist(
    kpts: np.ndarray, prim_recip: np.ndarray, n: int, policy: str = "auto"
) -> np.ndarray:
    """Occupied k-vector per orbital, shape (n, 3)."""
    return fill_states(kpts, prim_recip, n, policy)[0]


def free_electron_klist(
    sc: Supercell, twist=(0.0, 0.0, 0.0), policy: str = "auto"
) -> Tuple[np.ndarray, np.ndarray]:
    """(k_up, k_down) occupied k-lists for a supercell."""
    kpts = twisted_kpts(sc, twist)
    prim_recip = reciprocal_vectors(sc.prim.lattice)
    return tuple(
        fill_klist(kpts, prim_recip, n, policy) if n > 0 else np.zeros((0, 3))
        for n in sc.nelec
    )


def plane_wave_states(
    sc: Supercell, twist=(0.0, 0.0, 0.0), policy: str = "auto"
) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """((k_up, q_up), (k_dn, q_dn)) occupied plane-wave states per spin."""
    kpts = twisted_kpts(sc, twist)
    prim_recip = reciprocal_vectors(sc.prim.lattice)
    return tuple(
        fill_states(kpts, prim_recip, n, policy)
        if n > 0
        else (np.zeros((0, 3)), np.zeros((0, 3)))
        for n in sc.nelec
    )
