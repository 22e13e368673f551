"""Periodic two-electron (J/K) matrices for the native SCF.

Host numpy, a copy of deepsolid_tpu/scf/eri.py; the native engine is
this package's own build of the same C++ (deepsolid_tpu_torch/native).

Ewald-split Coulomb:
  * long range  — reciprocal space via analytic Bloch pair-density
    Fourier transforms (the same machinery as the nuclear LR term).
    Exchange needs mixed-k pair densities, whose momentum support is
    q + G with q = k' - k, so the FT is evaluated on shifted G sets.
  * short range — erfc(beta r12) ERIs via McMurchie-Davidson
    (`sr_eri_tensors`), organized by lattice translations: with Bloch
    AOs phi_{mu k} = sum_T chi_mu(r-T) e^{ikT} every four-index Bloch
    ERI reduces (after momentum conservation collapses one lattice sum)
    to real integrals I[A,B,D] = (chi_a chi_b(-A) | erfc | chi_c(-B)
    chi_d(-B-D)) phase-summed over the bra internal offset A, the
    bra-ket translation B, and the ket internal offset D. Both the
    Hartree (J) and exchange (K) phase patterns are rank-separable in
    (k, k'), so one pass over screened quartets accumulates both.

The erfc kernel makes the B sum finite; the attenuated Hermite R table
uses theta^2 = 1/(1/alpha + 1/beta^2) (the erf(beta r12)/r12 integral
is the bare one with a Gaussian-smeared charge), and erfc = bare - erf
is fused into a single R recursion, as in hf._nuclear_sr_block.

Conventions: Bloch AOs phi_{mu k}(r) = sum_T chi_mu(r - T) e^{i k.T}
(un-normalized lattice sums, matching scf/hf.py core_matrices); density
matrices D_k are per-spin occupied C C^H with D[l s] = sum_occ C_l
C_s^*; all outputs are per PRIMITIVE cell. Replaces the PySCF FFTDF
J/K build the reference leans on (reference hf.py:44-218). Validated
against dense-grid / bare-G-space oracles and a beta-independence check
(tests/test_scf_jk.py, tests/test_scf_eri.py).
"""

from __future__ import annotations

import numpy as np

from deepsolid_tpu_torch.scf import basis as basis_lib
from deepsolid_tpu_torch.scf import integrals as ints
from deepsolid_tpu_torch.scf.gto import _lattice_images


def _shell_offsets(shells):
    offs = []
    off = 0
    for s in shells:
        offs.append(off)
        off += s.nfunc
    return offs, off


def _pair_ft_block(si, sj, al, be, ca, cb, b_pos, gpts):
    """FT of one shell pair over flattened Gaussian products.

    al/be/ca/cb: per-product exponents and (norm-folded) contraction
    coefficients, (np,); b_pos: per-product absolute ket centers (np, 3)
    (image offsets folded in). Returns (nfa, nfb, np, ng) complex with
    the coefficients ALREADY multiplied in.

    The exp(-G^2/4p) / exp(-iP.G) base and the per-dimension Hermite E
    tables are shared across all cartesian component pairs — for a d x d
    shell pair the 36 components reuse one base evaluation instead of
    recomputing it per component as a naive per-component FT would.
    """
    gpts = np.asarray(gpts)
    ng = gpts.shape[0]
    npr = al.shape[0]
    a_pos = np.asarray(si.center)

    p = al + be
    P = (al[:, None] * a_pos[None, :] + be[:, None] * b_pos) / p[:, None]
    g2 = np.sum(gpts * gpts, axis=-1)
    base = (np.pi / p)[:, None] ** 1.5 * np.exp(
        -g2[None, :] / (4.0 * p[:, None])
    )
    base = base * np.exp(-1j * (P @ gpts.T))
    coef = ca * cb
    base *= coef[:, None]

    ab = a_pos[None, :] - b_pos  # (np, 3)
    etabs, gpows = [], []
    for d in range(3):
        x = ab[:, d]
        mu = al * be / p
        kab = np.exp(-mu * x * x)
        etabs.append(
            ints.e_coeffs(si.l, sj.l, p, -(be / p) * x, (al / p) * x, kab)
        )
        tmax = si.l + sj.l
        gd = -1j * gpts[:, d]
        pows = [np.ones(ng, np.complex128)]
        for _ in range(tmax):
            pows.append(pows[-1] * gd)
        gpows.append(pows)

    nfa, nfb = len(ints.CART[si.l]), len(ints.CART[sj.l])
    out = np.empty((nfa, nfb, npr, ng), np.complex128)
    for ia, la3 in enumerate(ints.CART[si.l]):
        for ib, lb3 in enumerate(ints.CART[sj.l]):
            acc = base
            for d in range(3):
                poly = np.zeros((npr, ng), np.complex128)
                for t in range(la3[d] + lb3[d] + 1):
                    et = etabs[d].get((la3[d], lb3[d], t))
                    if et is None:
                        continue
                    poly += np.asarray(et)[:, None] * gpows[d][t][None, :]
                acc = acc * poly
            out[ia, ib] = acc
    return out


def bloch_pair_ft(shells, lattice, kpts, gpts, eps: float = 1e-10,
                  g_chunk: int = 4096):
    """rho_k[mu nu](G) = sum_T e^{i k.T} \\int chi_mu(r) chi_nu(r - T) e^{-iG.r} dr.

    Returns complex array (nk, nao, nao, ng). `gpts` may be any set of
    3-vectors (shifted sets for exchange).

    Screening is per PRIMITIVE pair: the surviving (prim_a, prim_b, image)
    products are flattened per shell pair, so a tight-core primitive is
    never evaluated over the hundreds of lattice images only its diffuse
    shell-mates reach (the dominant waste in contracted bases, where one
    shell spans exponents 1e3..1e-1).
    """
    kpts = np.asarray(kpts).reshape(-1, 3)
    gpts = np.asarray(gpts).reshape(-1, 3)
    offs, nao = _shell_offsets(shells)
    nk, ng = kpts.shape[0], gpts.shape[0]
    lnq = -np.log(eps)

    alpha_min = min(float(s.exponents.min()) for s in shells)
    rcut = np.sqrt(lnq / (alpha_min / 2.0))
    images = _lattice_images(np.asarray(lattice), rcut)

    out = np.zeros((nk, nao, nao, ng), np.complex128)
    for i, si in enumerate(shells):
        for j, sj in enumerate(shells):
            al_s, be_s = si.exponents, sj.exponents
            mu = (al_s[:, None] * be_s[None, :]) / (
                al_s[:, None] + be_s[None, :]
            )  # (na, nb)
            d0 = si.center[None, :] - sj.center[None, :] - images  # (nT, 3)
            r2 = np.sum(d0 * d0, axis=-1)  # (nT,)
            keep = mu[:, :, None] * r2[None, None, :] < lnq
            if not np.any(keep):
                continue
            ia, ib, it = np.nonzero(keep)
            al = al_s[ia]
            be = be_s[ib]
            ca = (si.coefficients
                  * basis_lib.primitive_norm(si.exponents, si.l))[ia]
            cb = (sj.coefficients
                  * basis_lib.primitive_norm(sj.exponents, sj.l))[ib]
            b_pos = sj.center[None, :] + images[it]
            # phase rows carry e^{ik.T} per product (nk, np)
            phases = np.exp(1j * kpts @ images[it].T)

            nfa, nfb = si.nfunc, sj.nfunc
            for g0 in range(0, ng, g_chunk):
                gsl = slice(g0, min(g0 + g_chunk, ng))
                blk = _pair_ft_block(si, sj, al, be, ca, cb, b_pos,
                                     gpts[gsl])
                # (nk,np) x (nfa,nfb,np,ngc) -> (nk,nfa,nfb,ngc), BLAS path
                res = np.tensordot(phases, blk, axes=([1], [2]))
                out[:, offs[i]:offs[i] + nfa,
                    offs[j]:offs[j] + nfb, gsl] += res
    return out


def lr_weights(gpts, beta, volume):
    """Long-range Coulomb kernel 4 pi e^{-G^2/4 beta^2} / (V G^2); zero at
    G=0. `beta=None` gives the BARE kernel 4 pi / (V G^2) (oracle use)."""
    g2 = np.sum(np.asarray(gpts) ** 2, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        att = 1.0 if beta is None else np.exp(-g2 / (4.0 * beta**2))
        w = 4.0 * np.pi * att / (volume * g2)
    return np.where(g2 < 1e-12, 0.0, w)


def coulomb_lr(rho_g, dm_total, gw):
    """Long-range Hartree J_k[mu nu] from the total density.

    rho_g: (nk, nao, nao, ng) Bloch pair FTs at the unshifted G set;
    dm_total: (nk, nao, nao) spin-summed density matrices; gw: (ng,).
    """
    nk = rho_g.shape[0]
    # n_e(G) = (1/nk) sum_k tr(D_k rho_k(G)^*): the electron density FT
    n_g = np.einsum("kab,kabg->g", dm_total, np.conj(rho_g)) / nk
    return np.einsum("kabg,g,g->kab", rho_g, gw, n_g)


def exchange_lr(shells, lattice, kpts, gpts, gw, dm_k, beta, volume,
                eps=1e-10):
    """Long-range exchange K_k[mu nu] for ONE spin channel.

    K_k[mu nu] = (1/nk) sum_k' sum_{lam sig} D_k'[lam sig] sum_G
        w(|G+q|) rho_bra[mu lam](G+q) rho_ket[sig nu](-(G+q))
    with q = k' - k. The bra pair density (phi_{mu k}^* phi_{lam k'})
    carries lattice phases k' on the shifted set G + q; the ket pair
    (phi_{sig k'}^* phi_{nu k}) carries phases k on the NEGATED shifted
    set. At gamma the ket factor reduces to conj(rho_bra), but at mixed
    k the two differ by e^{-i G~ T} per image — using conj there is a
    gamma-only shortcut that breaks multi-k exchange (caught by the
    beta-independence test against the real-space erfc sum).
    """
    kpts = np.asarray(kpts).reshape(-1, 3)
    nk = kpts.shape[0]
    nao = dm_k.shape[-1]
    out = np.zeros((nk, nao, nao), np.complex128)
    # distinct momentum transfers q = k' - k (nk of them on a regular grid)
    for ik in range(nk):
        for ikp in range(nk):
            q = kpts[ikp] - kpts[ik]
            gq = np.asarray(gpts) + q
            wq = lr_weights(gq, beta, volume)
            rho_b = bloch_pair_ft(shells, lattice, kpts[ikp:ikp + 1], gq,
                                  eps)[0]  # (nao, nao, ng)
            rho_k = bloch_pair_ft(shells, lattice, kpts[ik:ik + 1], -gq,
                                  eps)[0]
            out[ik] += np.einsum(
                "ls,alg,g,sbg->ab", dm_k[ikp], rho_b, wq, rho_k
            ) / nk
    return out


# ---------------------------------------------------------------------------
# Short-range erfc(beta r12) ERIs
# ---------------------------------------------------------------------------


def _pair_entries(shells, lattice, eps):
    """Screened (image x primitive-pair) entries per ordered shell pair.

    Each entry carries the Gaussian-product data a McMurchie-Davidson
    quartet needs: combined exponent p, pair center P, contraction
    coefficient, the internal image offset A, per-dimension Hermite E
    coefficient arrays, and a magnitude weight for Schwarz-like screens.
    """
    lattice = np.asarray(lattice)
    offs, nao = _shell_offsets(shells)
    alpha_min = min(float(s.exponents.min()) for s in shells)
    rcut = np.sqrt(-np.log(eps) / (alpha_min / 2.0))
    images = _lattice_images(lattice, rcut)
    out = []
    for i, si in enumerate(shells):
        for j, sj in enumerate(shells):
            b_pos = sj.center[None, :] + images
            ab_all = si.center[None, :] - b_pos
            mu_pair = (si.exponents.min() * sj.exponents.min()) / (
                si.exponents.min() + sj.exponents.min()
            )
            keep = mu_pair * np.sum(ab_all * ab_all, -1) < -np.log(eps)
            if not np.any(keep):
                continue
            A = images[keep]
            ab = ab_all[keep]
            bk = b_pos[keep]
            na, nb = len(si.exponents), len(sj.exponents)
            al = si.exponents.reshape(1, na, 1)
            be = sj.exponents.reshape(1, 1, nb)
            p = al + be
            mu = al * be / p
            es = []
            for d in range(3):
                x = ab[:, None, None, d]
                kab = np.exp(-mu * x * x)
                es.append(
                    ints.e_coeffs(si.l, sj.l, p, -(be / p) * x, (al / p) * x,
                                  kab)
                )
            P = (
                al[..., None] * si.center[None, None, None, :]
                + be[..., None] * bk[:, None, None, :]
            ) / p[..., None]
            ca = si.coefficients * basis_lib.primitive_norm(si.exponents, si.l)
            cb = sj.coefficients * basis_lib.primitive_norm(sj.exponents, sj.l)
            coef = ca[None, :, None] * cb[None, None, :]
            # magnitude screen weight; the 4^l factor covers the
            # polynomial prefactors of higher-l cartesians that the pure
            # Gaussian estimate misses
            w = (
                np.abs(coef)
                * 4.0 ** (si.l + sj.l)
                * (np.pi / p) ** 1.5
                * np.exp(-mu * np.sum(ab * ab, -1)[:, None, None])
            )
            shape = (A.shape[0], na, nb)

            def flat(a):
                return np.ascontiguousarray(np.broadcast_to(a, shape)).reshape(-1)

            A_rep = np.repeat(A, na * nb, axis=0)
            out.append(dict(
                la=si.l, lb=sj.l, oi=offs[i], oj=offs[j],
                A=A_rep,
                # integer lattice coordinates of A (exact: images are
                # integer combinations) for the v2 native engine
                iA=np.ascontiguousarray(
                    np.round(A_rep @ np.linalg.inv(lattice)).astype(np.int32)
                ),
                p=flat(p), coef=flat(coef), w=flat(w),
                P=np.ascontiguousarray(
                    np.broadcast_to(P, shape + (3,))).reshape(-1, 3),
                es=[{key: flat(v) for key, v in e.items()} for e in es],
            ))
    return out, nao


def _accumulate_quartet(wj, wk, bra, ket, ib, ik, bv, beta, kpts):
    """Add one screened batch of SR quartet integrals into WJ / WK."""
    p = bra["p"][ib]
    q = ket["p"][ik]
    pc = bra["P"][ib] - (ket["P"][ik] + bv)
    r2 = np.sum(pc * pc, -1)
    al = p * q / (p + q)
    th2 = 1.0 / (1.0 / al + 1.0 / beta**2)
    sq = np.sqrt(th2 / al)
    pref = (
        2.0 * np.pi**2.5 / (p * q * np.sqrt(p + q))
        * bra["coef"][ib] * ket["coef"][ik]
    )

    def fns(n):
        return (-2.0 * al) ** n * ints.boys(n, al * r2) - sq * (
            -2.0 * th2
        ) ** n * ints.boys(n, th2 * r2)

    la, lb = bra["la"], bra["lb"]
    lc, ld = ket["la"], ket["lb"]
    rtab = ints.hermite_r(la + lb + lc + ld, al, pc, fns)

    a_vec = bra["A"][ib]
    d_vec = ket["A"][ik]
    # J: e^{ik.A} e^{-ik'.D}; K: e^{ik.(B+D)} e^{ik'.(A-B)} — both rank-1 in (k, k')
    ph_j1 = np.exp(1j * kpts @ a_vec.T)
    ph_j2 = np.exp(-1j * kpts @ d_vec.T)
    ph_k1 = np.exp(1j * kpts @ (bv + d_vec).T)
    ph_k2 = np.exp(1j * kpts @ (a_vec - bv).T)

    oi, oj, ol, os_ = bra["oi"], bra["oj"], ket["oi"], ket["oj"]
    for ia, la3 in enumerate(ints.CART[la]):
        for jb, lb3 in enumerate(ints.CART[lb]):
            eb = [
                {t: bra["es"][d].get((la3[d], lb3[d], t))
                 for t in range(la3[d] + lb3[d] + 1)}
                for d in range(3)
            ]
            for icc, lc3 in enumerate(ints.CART[lc]):
                for jd, ld3 in enumerate(ints.CART[ld]):
                    ek = [
                        {t: ket["es"][d].get((lc3[d], ld3[d], t))
                         for t in range(lc3[d] + ld3[d] + 1)}
                        for d in range(3)
                    ]
                    acc = 0.0
                    for t in range(la3[0] + lb3[0] + 1):
                        ebx = eb[0][t]
                        if ebx is None:
                            continue
                        for u in range(la3[1] + lb3[1] + 1):
                            eby = eb[1][u]
                            if eby is None:
                                continue
                            for v in range(la3[2] + lb3[2] + 1):
                                ebz = eb[2][v]
                                if ebz is None:
                                    continue
                                e_b = ebx[ib] * eby[ib] * ebz[ib]
                                for tt in range(lc3[0] + ld3[0] + 1):
                                    ekx = ek[0][tt]
                                    if ekx is None:
                                        continue
                                    for uu in range(lc3[1] + ld3[1] + 1):
                                        eky = ek[1][uu]
                                        if eky is None:
                                            continue
                                        for vv in range(lc3[2] + ld3[2] + 1):
                                            ekz = ek[2][vv]
                                            if ekz is None:
                                                continue
                                            sgn = (-1.0) ** (tt + uu + vv)
                                            acc = acc + sgn * e_b * (
                                                ekx[ik] * eky[ik] * ekz[ik]
                                            ) * rtab[(t + tt, u + uu, v + vv)]
                    if np.isscalar(acc):
                        continue
                    val = pref * acc
                    wj[:, :, oi + ia, oj + jb, ol + icc, os_ + jd] += (
                        np.einsum("kn,Kn,n->kK", ph_j1, ph_j2, val)
                    )
                    wk[:, :, oi + ia, oj + jb, ol + icc, os_ + jd] += (
                        np.einsum("kn,Kn,n->kK", ph_k1, ph_k2, val)
                    )


def _dense_e(pair):
    """Dense Hermite-E array (nE, 3*(la+1)*(lb+1)*(la+lb+1)) for the
    native engine; cached on the pair dict."""
    if "e_dense" in pair:
        return pair["e_dense"]
    la, lb = pair["la"], pair["lb"]
    n_e = pair["p"].shape[0]
    dense = np.zeros((n_e, 3, la + 1, lb + 1, la + lb + 1))
    for d in range(3):
        for (i, j, t), arr in pair["es"][d].items():
            dense[:, d, i, j, t] = arr
    pair["e_dense"] = np.ascontiguousarray(dense.reshape(n_e, -1))
    return pair["e_dense"]


def sr_eri_tensors(shells, lattice, kpts, beta, eps=1e-8,
                   mask_chunk=int(4e6), engine="auto"):
    """Short-range erfc(beta r12) Bloch ERI tensors (WJ, WK).

    WJ[k,k'][m n l s] phase-sums I[A,B,D] with e^{ik.A} e^{-ik'.D}
    (Hartree pattern: (m_k n_k | l_k' s_k') with l unconjugated, s
    conjugated), WK with e^{ik.(B+D)} e^{ik'.(A-B)} (exchange pattern
    (m_k l_k' | s_k' n_k)). Consumers:
      J_k = (1/nk) einsum('kKmnls,Kls->kmn', WJ, D_tot)
      K_k = (1/nk) einsum('kKmlsn,Kls->kmn', WK, D_spin)

    engine: 'auto' uses the native C++ quartet engine when it compiles
    (deepsolid_tpu_torch/native, the libcint analog), 'numpy'/'native' force
    a path. Both produce identical tensors (tests/test_native_eri.py, tests/test_torch_scf.py).
    """
    import ctypes

    lattice = np.asarray(lattice)
    kpts = np.ascontiguousarray(np.asarray(kpts, np.float64).reshape(-1, 3))
    nk = kpts.shape[0]
    pairs, nao = _pair_entries(shells, lattice, eps)
    wj = np.zeros((nk, nk, nao, nao, nao, nao), np.complex128)
    wk = np.zeros_like(wj)
    logeps = -np.log(eps)
    inv_lat = np.linalg.inv(lattice)

    lib = None
    if engine in ("auto", "native"):
        from deepsolid_tpu_torch import native

        lib = native.load()
        if engine == "native" and lib is None:
            raise RuntimeError("native sr_eri engine unavailable")

    def dptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    for bi, bra in enumerate(pairs):
        c_b = bra["P"].mean(0)
        span_b = float(np.linalg.norm(bra["P"] - c_b, axis=1).max())
        for ki_, ket in enumerate(pairs):
            # bra<->ket exchange symmetry: the swapped ordered block is a
            # relabeling of this one (I real, B-set symmetric):
            #   WJ'[k,K,c,d,a,b] = conj(WJ[K,k,a,b,c,d])
            #   WK'[k,K,c,d,a,b] =      WK[K,k,a,b,c,d]
            # so only ki_ >= bi is computed; both blocks are scattered.
            if ki_ < bi:
                continue
            c_k = ket["P"].mean(0)
            span_k = float(np.linalg.norm(ket["P"] - c_k, axis=1).max())
            al_min = (bra["p"].min() * ket["p"].min()) / (
                bra["p"].min() + ket["p"].min()
            )
            th2_min = 1.0 / (1.0 / al_min + 1.0 / beta**2)
            radius = np.sqrt(logeps / th2_min) + span_b + span_k
            # candidate bra-ket translations near the cloud separation
            shift = np.round((c_b - c_k) @ inv_lat) @ lattice
            bs = shift[None, :] + _lattice_images(lattice, radius)
            keep_b = (
                np.linalg.norm(c_b - c_k - bs, axis=1)
                <= radius + 1e-9
            )
            bs = np.ascontiguousarray(bs[keep_b])
            if bs.shape[0] == 0:
                continue

            nfa = len(ints.CART[bra["la"]])
            nfb = len(ints.CART[bra["lb"]])
            nfc = len(ints.CART[ket["la"]])
            nfd = len(ints.CART[ket["lb"]])
            oi, oj = bra["oi"], bra["oj"]
            ol, os_ = ket["oi"], ket["oj"]

            if lib is not None:
                wj_blk = np.zeros((nk, nk, nfa, nfb, nfc, nfd),
                                  np.complex128)
                wk_blk = np.zeros_like(wj_blk)
                ibs = np.ascontiguousarray(
                    np.round(bs @ inv_lat).astype(np.int32)
                )
                lat_c = np.ascontiguousarray(lattice, np.float64)

                def iptr(a):
                    return a.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)
                    )

                ret = lib.sr_eri_block2(
                    bra["p"].shape[0], bra["la"], bra["lb"],
                    dptr(bra["p"]), dptr(bra["coef"]), dptr(bra["w"]),
                    dptr(bra["P"]), iptr(bra["iA"]), dptr(_dense_e(bra)),
                    ket["p"].shape[0], ket["la"], ket["lb"],
                    dptr(ket["p"]), dptr(ket["coef"]), dptr(ket["w"]),
                    dptr(ket["P"]), iptr(ket["iA"]), dptr(_dense_e(ket)),
                    bs.shape[0], dptr(bs), iptr(ibs), nk, dptr(kpts),
                    dptr(lat_c), float(beta), float(eps),
                    dptr(wj_blk.view(np.float64)),
                    dptr(wk_blk.view(np.float64)),
                )
                if ret != 0:
                    raise RuntimeError(
                        f"native sr_eri_block2 failed: rc={ret} "
                        "(1 = angular momentum beyond MAX_L, 2 = lattice"
                        "-image offset outside the packed-key range)"
                    )
            else:
                # numpy fallback: accumulate the same block locally
                wj_blk = np.zeros((nk, nk, nfa, nfb, nfc, nfd),
                                  np.complex128)
                wk_blk = np.zeros_like(wj_blk)
                bra0 = {**bra, "oi": 0, "oj": 0}
                ket0 = {**ket, "oi": 0, "oj": 0}
                th2 = 1.0 / (
                    1.0 / (bra["p"][:, None] * ket["p"][None, :]
                           / (bra["p"][:, None] + ket["p"][None, :]))
                    + 1.0 / beta**2
                )
                ww = bra["w"][:, None] * ket["w"][None, :]
                n_b, n_k = ww.shape
                cb_sz = max(1, mask_chunk // max(1, n_b * n_k))
                for b0 in range(0, bs.shape[0], cb_sz):
                    bc = bs[b0:b0 + cb_sz]
                    diff = (
                        bra["P"][:, None, None, :]
                        - ket["P"][None, :, None, :]
                        - bc[None, None, :, :]
                    )
                    r2 = np.sum(diff * diff, -1)
                    keep = ww[..., None] * np.exp(-th2[..., None] * r2) > eps
                    if not np.any(keep):
                        continue
                    ib, ik, ibv = np.nonzero(keep)
                    _accumulate_quartet(
                        wj_blk, wk_blk, bra0, ket0, ib, ik, bc[ibv], beta,
                        kpts,
                    )

            wj[:, :, oi:oi + nfa, oj:oj + nfb,
               ol:ol + nfc, os_:os_ + nfd] += wj_blk
            wk[:, :, oi:oi + nfa, oj:oj + nfb,
               ol:ol + nfc, os_:os_ + nfd] += wk_blk
            if ki_ > bi:
                # swapped ordered block via the exchange relabeling
                wj[:, :, ol:ol + nfc, os_:os_ + nfd,
                   oi:oi + nfa, oj:oj + nfb] += np.conj(
                       wj_blk.transpose(1, 0, 4, 5, 2, 3))
                wk[:, :, ol:ol + nfc, os_:os_ + nfd,
                   oi:oi + nfa, oj:oj + nfb] += wk_blk.transpose(
                       1, 0, 4, 5, 2, 3)
    return wj, wk


class LrBlocks:
    """Precomputed long-range (reciprocal-space) J/K machinery.

    Caches the Bloch pair-density FTs once so the per-SCF-iteration J/K
    builds are pure einsums. `beta=None` uses the bare Coulomb kernel
    (oracle mode; then the full J/K, not just the LR split).
    """

    def __init__(self, shells, lattice, kpts, beta, volume, gpts,
                 eps=1e-10):
        self.kpts = np.asarray(kpts).reshape(-1, 3)
        self.nk = self.kpts.shape[0]
        nk = self.nk
        self.beta = beta
        self.volume = volume
        gpts = np.asarray(gpts).reshape(-1, 3)
        ng = gpts.shape[0]
        self.gw = lr_weights(gpts, beta, volume)

        # ---- universal fine grid -----------------------------------------
        # Every shifted evaluation set G + q (q = k' - k) lies on the
        # SUPERCELL reciprocal lattice, and the ket sets -(G + q) mirror
        # onto G + (-q) because `gpts` is inversion-symmetric. So ONE
        # Bloch-FT evaluation on the deduplicated union — with all nk
        # phase rows at once — replaces the 2*nk^2 per-pair FT calls the
        # naive build needs (the nk=8 LiH cc-pVDZ build drops from ~100
        # min to ~2 min; nk=27 bcc-Li would be ~1500 calls). Points
        # beyond the |G| cutoff of the unshifted set carry LR weights
        # below the `full_gpoints` tolerance and are dropped (gathered
        # from a zero pad column).
        qdiff = (self.kpts[None, :, :] - self.kpts[:, None, :]).reshape(-1, 3)
        qkey = np.round(qdiff, 9)
        quniq, qinv = np.unique(qkey, axis=0, return_inverse=True)
        self._qidx = qinv.reshape(nk, nk)  # [ik, ikp] -> unique-q row
        nq = quniq.shape[0]

        shifted = quniq[:, None, :] + gpts[None, :, :]  # (nq, ng, 3)
        r2max = float(np.max(np.sum(gpts * gpts, -1))) * (1.0 + 1e-9)
        pts = shifted.reshape(-1, 3)
        inside = np.sum(pts * pts, -1) <= r2max
        fine, inv = np.unique(np.round(pts[inside], 9), axis=0,
                              return_inverse=True)
        nf = fine.shape[0]
        # map every (q, g) slot to a fine index; out-of-cutoff -> pad nf
        idx_plus = np.full(nq * ng, nf, np.int64)
        idx_plus[inside] = inv
        idx_plus = idx_plus.reshape(nq, ng)
        lookup = {tuple(row): n for n, row in enumerate(fine)}
        neg = np.round(-shifted.reshape(-1, 3), 9)
        idx_minus = np.full(nq * ng, nf, np.int64)
        for n, row in enumerate(map(tuple, neg)):
            hit = lookup.get(row)
            if hit is not None:
                idx_minus[n] = hit
        idx_minus = idx_minus.reshape(nq, ng)

        rho_fine = bloch_pair_ft(shells, lattice, self.kpts, fine, eps)
        pad = np.zeros(rho_fine.shape[:-1] + (1,), rho_fine.dtype)
        rho_pad = np.concatenate([rho_fine, pad], axis=-1)  # (nk,nao,nao,nf+1)

        q0 = int(self._qidx[0, 0])
        self.rho0 = np.ascontiguousarray(rho_pad[..., idx_plus[q0]])
        self.rho_q = []     # bra pair FTs: phases k' at G + q
        self.rho_q2 = []    # ket pair FTs: phases k at -(G + q)
        self.wq = []
        for ik in range(nk):
            row_r, row_r2, row_w = [], [], []
            for ikp in range(nk):
                qi = int(self._qidx[ik, ikp])
                row_r.append(rho_pad[ikp][..., idx_plus[qi]])
                row_r2.append(rho_pad[ik][..., idx_minus[qi]])
                row_w.append(lr_weights(gpts + quniq[qi], beta, volume))
            self.rho_q.append(row_r)
            self.rho_q2.append(row_r2)
            self.wq.append(row_w)

    def coulomb(self, dm_total):
        return coulomb_lr(self.rho0, dm_total, self.gw)

    def exchange(self, dm_k):
        nao = dm_k.shape[-1]
        out = np.zeros((self.nk, nao, nao), np.complex128)
        for ik in range(self.nk):
            for ikp in range(self.nk):
                out[ik] += np.einsum(
                    "ls,alg,g,sbg->ab",
                    dm_k[ikp], self.rho_q[ik][ikp], self.wq[ik][ikp],
                    self.rho_q2[ik][ikp],
                ) / self.nk
        return out


def sr_coulomb(wj, dm_total):
    """SR Hartree matrices J_k from the spin-summed density."""
    return np.einsum("kKmnls,Kls->kmn", wj, dm_total) / wj.shape[1]


def sr_exchange(wk, dm_spin):
    """SR exchange matrices K_k for one spin channel."""
    return np.einsum("kKmlsn,Kls->kmn", wk, dm_spin) / wk.shape[1]


def full_gpoints(lattice, beta, tol=1e-12):
    """Inversion-symmetric reciprocal set for the LR kernel.

    ops.ewald._gpoints_in_cutoff returns a HALF space (its consumers use
    the 2*Re convention); coulomb_lr / exchange_lr sum complex products
    over the full set, so mirror it."""
    from deepsolid_tpu_torch.ops.ewald import _gpoints_in_cutoff

    lattice = np.asarray(lattice)
    volume = abs(np.linalg.det(lattice))
    half, _ = _gpoints_in_cutoff(
        2 * np.pi * np.linalg.inv(lattice).T, beta, volume, tol
    )
    # Include the origin: lr_weights zeroes it for unshifted (q = 0)
    # sums, but on SHIFTED sets G + q it is the regular — and dominant —
    # smallest-momentum exchange contribution.
    return np.concatenate([half, -half, np.zeros((1, 3))], axis=0)


class SrBlocks:
    """Short-range erfc J/K with the kernel's G=0 component removed.

    The real-space image sum includes the full SR kernel, whose zero-
    momentum Fourier component is w0 = int erfc(beta r)/r d^3r / V =
    pi / (V beta^2). The Ewald-split convention drops G=0 everywhere
    (neutralizing background), so subtract w0 * S_k * N_e from J and
    (w0/nk) * S D S from K (its k'=k, G+q=0 term). This is what makes
    the SR+LR total independent of the split point beta.
    """

    def __init__(self, shells, lattice, kpts, beta, s_k, eps=1e-8):
        lattice = np.asarray(lattice)
        self.wj, self.wk = sr_eri_tensors(shells, lattice, kpts, beta, eps)
        self.s_k = np.asarray(s_k)
        self.nk = self.wj.shape[0]
        volume = abs(np.linalg.det(lattice))
        self.w0 = np.pi / (volume * beta**2)

    def coulomb(self, dm_total):
        n_e = np.einsum("kab,kab->", dm_total, np.conj(self.s_k)).real
        n_e /= self.nk
        return sr_coulomb(self.wj, dm_total) - self.w0 * n_e * self.s_k

    def exchange(self, dm_spin):
        sds = np.einsum("kab,kbc,kcd->kad", self.s_k, dm_spin, self.s_k)
        return sr_exchange(self.wk, dm_spin) - (self.w0 / self.nk) * sds
