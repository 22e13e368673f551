// Short-range erfc(beta r12) ERI quartet engine.
//
// Native counterpart of deepsolid_tpu_torch/scf/eri.sr_eri_tensors's inner
// loops — the role PySCF's libcint (C) plays for the reference's HF
// bridge (reference hf.py:44-218). One call processes one ordered
// (bra shell-pair block, ket shell-pair block) pair: it screens the
// (bra entry, ket entry, translation B) triples hierarchically, runs
// the McMurchie-Davidson R recursion for the fused erfc = bare - erf
// kernel, contracts with the precomputed Hermite E coefficients, and
// phase-accumulates both the Hartree (J) and exchange (K) patterns
// into per-(k, k') output blocks.
//
// Two generations:
//   * sr_eri_block  — v1: applies the nkpt^2 phase outer product per
//     surviving quartet (kept for reference/fallback).
//   * sr_eri_block2 — v2: accumulates quartet values into REAL tables
//     keyed by integer lattice offsets (A for bra, D for ket on the J
//     pattern; B+D and A-B on the K pattern), then applies the phases
//     ONCE per block as two small complex transforms. For nk k-points
//     this removes an O(nk^2 nq) factor from every quartet — the
//     dominant cost of multi-k builds. Bra/ket entries are processed
//     in descending screening-weight order with early exit, and the
//     quartet loop is OpenMP-parallel over bra entries with per-thread
//     accumulators.
//
// Compiled on first use via g++ (see native/__init__.py); results are
// bit-compared against the pure-numpy path in tests/test_native_eri.py.

#include <algorithm>
#include <array>
#include <cmath>
#include <complex>
#include <cstdint>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int MAX_L = 2;
constexpr int MAX_T = 4 * MAX_L;  // tmax for (dd|dd)

// cartesian components per l, pyscf cart order (matches ints.CART)
const int CART_N[3] = {1, 3, 6};
const int CART_X[3][6] = {{0}, {1, 0, 0}, {2, 1, 1, 0, 0, 0}};
const int CART_Y[3][6] = {{0}, {0, 1, 0}, {0, 1, 0, 2, 1, 0}};
const int CART_Z[3][6] = {{0}, {0, 0, 1}, {0, 0, 1, 0, 1, 2}};

// Boys function F_n(t) for n = 0..nmax (nmax <= MAX_T).
void boys(int nmax, double t, double* f) {
    if (t < 1e-14) {
        for (int n = 0; n <= nmax; ++n) f[n] = 1.0 / (2 * n + 1);
        return;
    }
    if (t > 35.0) {
        // upward from F0 ~ sqrt(pi/4t): erf(sqrt(t)) == 1 to machine eps
        f[0] = 0.5 * std::sqrt(M_PI / t);
        double expt = (t > 700.0) ? 0.0 : std::exp(-t);
        for (int n = 0; n < nmax; ++n)
            f[n + 1] = ((2 * n + 1) * f[n] - expt) / (2.0 * t);
        return;
    }
    // series for F_nmax, then stable downward recursion
    double expt = std::exp(-t);
    double term = 1.0 / (2 * nmax + 1);
    double sum = term;
    for (int i = 1; i < 200; ++i) {
        term *= 2.0 * t / (2 * nmax + 2 * i + 1);
        sum += term;
        if (term < 1e-17 * sum) break;
    }
    f[nmax] = expt * sum;
    for (int n = nmax; n > 0; --n)
        f[n - 1] = (2.0 * t * f[n] + expt) / (2 * n - 1);
}

// Hermite Coulomb R_{tuv} for t+u+v <= tmax from kernel-scaled fns[n].
// r[idx(t,u,v)] with idx = (t*(TM+1) + u)*(TM+1) + v, TM = tmax.
void hermite_r(int tmax, const double* pc, const double* fns, double* out) {
    const int tm1 = tmax + 1;
    const int stride = tm1 * tm1;
    // work[n][idx]: build from n = tmax down to 0. Every entry read at
    // level n was written at level n+1 in the SAME call (write guard
    // n+s <= tmax covers all reads, which have (n+1)+(s-1) <= tmax), so
    // the buffer never needs zeroing — only sizing.
    static thread_local std::vector<double> work;
    const size_t need = (size_t)tm1 * tm1 * tm1 * tm1;
    if (work.size() < need) work.resize(need, 0.0);
    auto w = [&](int n, int t, int u, int v) -> double& {
        return work[((size_t)n * tm1 * tm1 * tm1) + (size_t)t * stride +
                    (size_t)u * tm1 + v];
    };
    for (int n = tmax; n >= 0; --n) {
        for (int s = 0; s <= tmax - n; ++s) {
            for (int t = s; t >= 0; --t) {
                for (int u = s - t; u >= 0; --u) {
                    int v = s - t - u;
                    double val;
                    if (s == 0) {
                        val = fns[n];
                    } else if (t > 0) {
                        val = pc[0] * w(n + 1, t - 1, u, v);
                        if (t > 1) val += (t - 1) * w(n + 1, t - 2, u, v);
                    } else if (u > 0) {
                        val = pc[1] * w(n + 1, t, u - 1, v);
                        if (u > 1) val += (u - 1) * w(n + 1, t, u - 2, v);
                    } else {
                        val = pc[2] * w(n + 1, t, u, v - 1);
                        if (v > 1) val += (v - 1) * w(n + 1, t, u, v - 2);
                    }
                    if (n + s <= tmax) w(n, t, u, v) = val;
                }
            }
        }
    }
    for (int t = 0; t <= tmax; ++t)
        for (int u = 0; u <= tmax - t; ++u)
            for (int v = 0; v <= tmax - t - u; ++v)
                out[(size_t)t * stride + (size_t)u * tm1 + v] = w(0, t, u, v);
}

// Cartesian contraction of one quartet: vals[q] = pref * sum_tuv E R.
void contract_quartet(int la, int lb, int lc, int ld,
                      const double* Eb, const double* Ek,
                      const double* rtab, int tm1, double pref,
                      double* vals) {
    const int rstride = tm1 * tm1;
    const int nfa = CART_N[la], nfb = CART_N[lb];
    const int nfc = CART_N[lc], nfd = CART_N[ld];
    const int eb_i = (lb + 1) * (la + lb + 1);
    const int eb_j = (la + lb + 1);
    const int eb_dim = (la + 1) * eb_i;
    const int ek_i = (ld + 1) * (lc + ld + 1);
    const int ek_j = (lc + ld + 1);
    const int ek_dim = (lc + 1) * ek_i;
    int q = 0;
    for (int ia = 0; ia < nfa; ++ia) {
        const int ax = CART_X[la][ia], ay = CART_Y[la][ia],
                  az = CART_Z[la][ia];
        for (int jb = 0; jb < nfb; ++jb) {
            const int bx = CART_X[lb][jb], by = CART_Y[lb][jb],
                      bz = CART_Z[lb][jb];
            const double* ebx = Eb + 0 * eb_dim + ax * eb_i + bx * eb_j;
            const double* eby = Eb + 1 * eb_dim + ay * eb_i + by * eb_j;
            const double* ebz = Eb + 2 * eb_dim + az * eb_i + bz * eb_j;
            for (int ic = 0; ic < nfc; ++ic) {
                const int cx = CART_X[lc][ic], cy = CART_Y[lc][ic],
                          cz = CART_Z[lc][ic];
                for (int jd = 0; jd < nfd; ++jd) {
                    const int dx = CART_X[ld][jd], dy = CART_Y[ld][jd],
                              dz = CART_Z[ld][jd];
                    const double* ekx = Ek + 0 * ek_dim + cx * ek_i + dx * ek_j;
                    const double* eky = Ek + 1 * ek_dim + cy * ek_i + dy * ek_j;
                    const double* ekz = Ek + 2 * ek_dim + cz * ek_i + dz * ek_j;
                    double acc = 0.0;
                    for (int t = 0; t <= ax + bx; ++t) {
                        const double et = ebx[t];
                        if (et == 0.0) continue;
                        for (int u = 0; u <= ay + by; ++u) {
                            const double eu = eby[u];
                            if (eu == 0.0) continue;
                            const double etu = et * eu;
                            for (int v = 0; v <= az + bz; ++v) {
                                const double ev = ebz[v];
                                if (ev == 0.0) continue;
                                const double e_b3 = etu * ev;
                                for (int tt = 0; tt <= cx + dx; ++tt) {
                                    const double kt = ekx[tt];
                                    if (kt == 0.0) continue;
                                    for (int uu = 0; uu <= cy + dy; ++uu) {
                                        const double ku = eky[uu];
                                        if (ku == 0.0) continue;
                                        const double ktu = kt * ku;
                                        for (int vv = 0; vv <= cz + dz; ++vv) {
                                            const double kv2 = ekz[vv];
                                            if (kv2 == 0.0) continue;
                                            const double sgn =
                                                ((tt + uu + vv) & 1) ? -1.0
                                                                     : 1.0;
                                            acc += sgn * e_b3 * ktu * kv2 *
                                                   rtab[(size_t)(t + tt) *
                                                            rstride +
                                                        (size_t)(u + uu) * tm1 +
                                                        (v + vv)];
                                        }
                                    }
                                }
                            }
                        }
                    }
                    vals[q++] = pref * acc;
                }
            }
        }
    }
}

// Number of lattice images contracted together by the vectorized quartet
// kernel. The Hermite E coefficients and the contraction prefactor are
// image-independent, so processing IC images per pass amortizes the whole
// E-product/sparsity machinery and turns the innermost accumulation into
// stride-1 FMAs over the image lane (auto-vectorized: 2 AVX2 / 1 AVX-512
// fma per Hermite term).
constexpr int IC = 8;

// vals[q*IC + m] = pref * sum_tuv E R_m for IC images at once.
// rtab_v layout: [hermite_idx * IC + m]; unused lanes must be zero.
void contract_quartet_multi(int la, int lb, int lc, int ld,
                            const double* Eb, const double* Ek,
                            const double* rtab_v, int tm1, double pref,
                            double* vals) {
    const int rstride = tm1 * tm1;
    const int nfa = CART_N[la], nfb = CART_N[lb];
    const int nfc = CART_N[lc], nfd = CART_N[ld];
    const int eb_i = (lb + 1) * (la + lb + 1);
    const int eb_j = (la + lb + 1);
    const int eb_dim = (la + 1) * eb_i;
    const int ek_i = (ld + 1) * (lc + ld + 1);
    const int ek_j = (lc + ld + 1);
    const int ek_dim = (lc + 1) * ek_i;
    int q = 0;
    for (int ia = 0; ia < nfa; ++ia) {
        const int ax = CART_X[la][ia], ay = CART_Y[la][ia],
                  az = CART_Z[la][ia];
        for (int jb = 0; jb < nfb; ++jb) {
            const int bx = CART_X[lb][jb], by = CART_Y[lb][jb],
                      bz = CART_Z[lb][jb];
            const double* ebx = Eb + 0 * eb_dim + ax * eb_i + bx * eb_j;
            const double* eby = Eb + 1 * eb_dim + ay * eb_i + by * eb_j;
            const double* ebz = Eb + 2 * eb_dim + az * eb_i + bz * eb_j;
            for (int ic = 0; ic < nfc; ++ic) {
                const int cx = CART_X[lc][ic], cy = CART_Y[lc][ic],
                          cz = CART_Z[lc][ic];
                for (int jd = 0; jd < nfd; ++jd) {
                    const int dx = CART_X[ld][jd], dy = CART_Y[ld][jd],
                              dz = CART_Z[ld][jd];
                    const double* ekx =
                        Ek + 0 * ek_dim + cx * ek_i + dx * ek_j;
                    const double* eky =
                        Ek + 1 * ek_dim + cy * ek_i + dy * ek_j;
                    const double* ekz =
                        Ek + 2 * ek_dim + cz * ek_i + dz * ek_j;
                    double acc[IC] = {0.0};
                    for (int t = 0; t <= ax + bx; ++t) {
                        const double et = ebx[t];
                        if (et == 0.0) continue;
                        for (int u = 0; u <= ay + by; ++u) {
                            const double eu = eby[u];
                            if (eu == 0.0) continue;
                            const double etu = et * eu;
                            for (int v = 0; v <= az + bz; ++v) {
                                const double ev = ebz[v];
                                if (ev == 0.0) continue;
                                const double e_b3 = etu * ev;
                                for (int tt = 0; tt <= cx + dx; ++tt) {
                                    const double kt = ekx[tt];
                                    if (kt == 0.0) continue;
                                    for (int uu = 0; uu <= cy + dy; ++uu) {
                                        const double ku = eky[uu];
                                        if (ku == 0.0) continue;
                                        const double ktu = kt * ku;
                                        for (int vv = 0; vv <= cz + dz;
                                             ++vv) {
                                            const double kv2 = ekz[vv];
                                            if (kv2 == 0.0) continue;
                                            const double s =
                                                (((tt + uu + vv) & 1)
                                                     ? -e_b3
                                                     : e_b3) * ktu * kv2;
                                            const double* rt =
                                                rtab_v +
                                                ((size_t)(t + tt) *
                                                     rstride +
                                                 (size_t)(u + uu) * tm1 +
                                                 (v + vv)) * IC;
                                            for (int m = 0; m < IC; ++m)
                                                acc[m] += s * rt[m];
                                        }
                                    }
                                }
                            }
                        }
                    }
                    for (int m = 0; m < IC; ++m)
                        vals[(size_t)q * IC + m] = pref * acc[m];
                    ++q;
                }
            }
        }
    }
}

// 20-bit fields: collision-free for coords in [-524288, 524287]; a
// false return is a caller error (rc=2), never a silent skip
inline bool pack3(const int* v, uint64_t* key) {
    uint64_t out = 0;
    for (int d = 0; d < 3; ++d) {
        if (v[d] < -524288 || v[d] > 524287) return false;
        out = out << 20 | (uint32_t)(v[d] + 524288);
    }
    *key = out;
    return true;
}

// 10-bit fields (coords in [-512, 511], 60 bits total) so a (u, v)
// offset pair fits a single collision-free uint64 key. u = B+D and
// v = A-B each sum two single-offset coordinates, so |coord| stays
// within 2x the largest lattice-image index of the screened pair
// lists — hundreds at most for the diffusest et-dz primitives; an
// out-of-range coordinate is reported as rc=2 by the caller, never
// silently dropped (a dropped K term with its J term kept would be a
// silently wrong exchange energy).
inline bool pack6(const int* u, const int* v, uint64_t* key) {
    uint64_t out = 0;
    for (int d = 0; d < 3; ++d) {
        if (u[d] < -512 || u[d] > 511 || v[d] < -512 || v[d] > 511)
            return false;
        out = out << 10 | (uint32_t)(u[d] + 512);
    }
    for (int d = 0; d < 3; ++d) out = out << 10 | (uint32_t)(v[d] + 512);
    *key = out;
    return true;
}

}  // namespace

// v2: integer-offset accumulation + one phase transform per block.
// iA_b / iD_k / iB are integer lattice coordinates (n1,n2,n3) of the
// bra-internal offset A, ket-internal offset D, and bra-ket translation
// B; `lattice` is row-major (a1; a2; a3) so the phase of offset n is
// exp(i k . (n1 a1 + n2 a2 + n3 a3)).
extern "C" int sr_eri_block2(
    int64_t nb, int la, int lb, const double* p_b, const double* coef_b,
    const double* w_b, const double* P_b, const int32_t* iA_b,
    const double* E_b,
    int64_t nk_e, int lc, int ld, const double* p_k, const double* coef_k,
    const double* w_k, const double* P_k, const int32_t* iD_k,
    const double* E_k,
    int64_t nB, const double* Bs, const int32_t* iB,
    int64_t nkpt, const double* kpts, const double* lattice,
    double beta, double eps,
    double* wj_out, double* wk_out) {
    if (la > MAX_L || lb > MAX_L || lc > MAX_L || ld > MAX_L) return 1;
    using cd = std::complex<double>;
    const int nfa = CART_N[la], nfb = CART_N[lb];
    const int nfc = CART_N[lc], nfd = CART_N[ld];
    const int nq = nfa * nfb * nfc * nfd;
    const int tmax = la + lb + lc + ld;
    const int tm1 = tmax + 1;
    const int eb_dim = (la + 1) * (lb + 1) * (la + lb + 1);
    const int ek_dim = (lc + 1) * (ld + 1) * (lc + ld + 1);
    const double inv_beta2 = 1.0 / (beta * beta);

    // ---- compact integer-offset indices for bra A and ket D ----------
    std::unordered_map<uint64_t, int> amap, dmap;
    std::vector<int> aidx(nb), didx(nk_e);
    std::vector<std::array<int, 3>> uA, uD;
    for (int64_t i = 0; i < nb; ++i) {
        int v[3] = {iA_b[3 * i], iA_b[3 * i + 1], iA_b[3 * i + 2]};
        uint64_t k3;
        if (!pack3(v, &k3)) return 2;
        auto it = amap.emplace(k3, (int)uA.size());
        if (it.second) uA.push_back(std::array<int, 3>{v[0], v[1], v[2]});
        aidx[i] = it.first->second;
    }
    for (int64_t i = 0; i < nk_e; ++i) {
        int v[3] = {iD_k[3 * i], iD_k[3 * i + 1], iD_k[3 * i + 2]};
        uint64_t k3;
        if (!pack3(v, &k3)) return 2;
        auto it = dmap.emplace(k3, (int)uD.size());
        if (it.second) uD.push_back(std::array<int, 3>{v[0], v[1], v[2]});
        didx[i] = it.first->second;
    }
    const int nA = (int)uA.size(), nD = (int)uD.size();

    // ---- descending screening-weight order with early exit ----------
    std::vector<int> ob(nb), ok(nk_e);
    for (int64_t i = 0; i < nb; ++i) ob[i] = (int)i;
    for (int64_t i = 0; i < nk_e; ++i) ok[i] = (int)i;
    std::sort(ob.begin(), ob.end(),
              [&](int x, int y) { return w_b[x] > w_b[y]; });
    std::sort(ok.begin(), ok.end(),
              [&](int x, int y) { return w_k[x] > w_k[y]; });

    // ---- accumulation tables ----------------------------------------
    // J pattern: real VJ[aidx][didx][q]
    // K pattern: slots keyed by (B+D, A-B) integer-offset pair
    struct KStore {
        std::unordered_map<uint64_t, int> slots;
        std::vector<double> vals;        // nslots * nq
        std::vector<std::array<int, 6>> keys;  // (u=B+D, v=A-B)
    };
    const size_t vj_len = (size_t)nA * nD * nq;

    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
#endif
    std::vector<std::vector<double>> vj_t(nthreads);
    std::vector<KStore> ks_t(nthreads);
    for (int t = 0; t < nthreads; ++t) vj_t[t].assign(vj_len, 0.0);
    // pack6-overflow flag: benign write race (all writers store 1)
    int key_overflow = 0;

#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads)
#endif
    {
        int tid = 0;
#ifdef _OPENMP
        tid = omp_get_thread_num();
#endif
        double* vj = vj_t[tid].data();
        KStore& ks = ks_t[tid];
        const size_t nidx = (size_t)tm1 * tm1 * tm1;
        std::vector<double> vals((size_t)nq * IC), fns(tm1);
        std::vector<double> rtab(nidx), rtab_v(nidx * IC);
        std::vector<int> live;
        live.reserve(1024);
        double fb[MAX_T + 1];

#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
        for (int64_t sb = 0; sb < nb; ++sb) {
            const int ib = ob[sb];
            const double pb = p_b[ib];
            const double wb = w_b[ib];
            if (wb * w_k[ok[0]] <= eps) continue;  // all ket below cut
            const double* Pb = P_b + 3 * ib;
            const double* Eb = E_b + (size_t)ib * 3 * eb_dim;
            const int ia_c = aidx[ib];
            for (int64_t sk = 0; sk < nk_e; ++sk) {
                const int ik = ok[sk];
                const double wprod = wb * w_k[ik];
                if (wprod <= eps) break;  // sorted: rest are smaller
                const double qk = p_k[ik];
                const double alpha = pb * qk / (pb + qk);
                const double th2 = 1.0 / (1.0 / alpha + inv_beta2);
                const double logcut = std::log(wprod / eps);
                const double pref0 =
                    2.0 * std::pow(M_PI, 2.5) /
                    (pb * qk * std::sqrt(pb + qk)) * coef_b[ib] * coef_k[ik];
                const double sq = std::sqrt(th2 / alpha);
                const double* Qk = P_k + 3 * ik;
                const double* Ek = E_k + (size_t)ik * 3 * ek_dim;
                const int id_c = didx[ik];

                // pass 1: screening — collect surviving images
                live.clear();
                for (int64_t ibv = 0; ibv < nB; ++ibv) {
                    const double* B = Bs + 3 * ibv;
                    double pc[3] = {Pb[0] - Qk[0] - B[0],
                                    Pb[1] - Qk[1] - B[1],
                                    Pb[2] - Qk[2] - B[2]};
                    const double r2 =
                        pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2];
                    if (th2 * r2 < logcut) live.push_back((int)ibv);
                }
                // pass 2: IC images per contraction (lanes >= mn hold
                // stale garbage; their vals lanes are never read)
                for (int m0 = 0; m0 < (int)live.size(); m0 += IC) {
                    const int mn =
                        std::min(IC, (int)live.size() - m0);
                    for (int m = 0; m < mn; ++m) {
                        const double* B = Bs + 3 * live[m0 + m];
                        double pc[3] = {Pb[0] - Qk[0] - B[0],
                                        Pb[1] - Qk[1] - B[1],
                                        Pb[2] - Qk[2] - B[2]};
                        const double r2 = pc[0] * pc[0] +
                                          pc[1] * pc[1] + pc[2] * pc[2];
                        boys(tmax, alpha * r2, fb);
                        double ca = 1.0;
                        for (int n = 0; n <= tmax; ++n) {
                            fns[n] = ca * fb[n];
                            ca *= -2.0 * alpha;
                        }
                        boys(tmax, th2 * r2, fb);
                        double ct = sq;
                        for (int n = 0; n <= tmax; ++n) {
                            fns[n] -= ct * fb[n];
                            ct *= -2.0 * th2;
                        }
                        hermite_r(tmax, pc, fns.data(), rtab.data());
                        for (size_t i = 0; i < nidx; ++i)
                            rtab_v[i * IC + m] = rtab[i];
                    }
                    contract_quartet_multi(la, lb, lc, ld, Eb, Ek,
                                           rtab_v.data(), tm1, pref0,
                                           vals.data());

                    // J: sum image lanes into the (A, D) slot
                    double* vv = vj + ((size_t)ia_c * nD + id_c) * nq;
                    for (int iq = 0; iq < nq; ++iq) {
                        const double* vq = vals.data() + (size_t)iq * IC;
                        double sum = 0.0;
                        for (int m = 0; m < mn; ++m) sum += vq[m];
                        vv[iq] += sum;
                    }

                    // K: per-image scatter on (B+D, A-B)
                    for (int m = 0; m < mn; ++m) {
                        const int ibv = live[m0 + m];
                        int u[3], v[3];
                        for (int d = 0; d < 3; ++d) {
                            u[d] = iB[3 * ibv + d] + uD[id_c][d];
                            v[d] = uA[ia_c][d] - iB[3 * ibv + d];
                        }
                        uint64_t key;
                        if (!pack6(u, v, &key)) {
                            key_overflow = 1;
                            continue;  // result discarded via rc=2 below
                        }
                        auto it =
                            ks.slots.emplace(key, (int)ks.keys.size());
                        if (it.second) {
                            ks.keys.push_back(std::array<int, 6>{
                                u[0], u[1], u[2], v[0], v[1], v[2]});
                            ks.vals.resize(
                                ks.keys.size() * (size_t)nq, 0.0);
                        }
                        double* kv = ks.vals.data() +
                                     (size_t)it.first->second * nq;
                        for (int iq = 0; iq < nq; ++iq)
                            kv[iq] += vals[(size_t)iq * IC + m];
                    }
                }
            }
        }
    }

    // ---- merge threads ----------------------------------------------
    std::vector<double>& vj0 = vj_t[0];
    for (int t = 1; t < nthreads; ++t)
        for (size_t i = 0; i < vj_len; ++i) vj0[i] += vj_t[t][i];
    KStore& ks0 = ks_t[0];
    for (int t = 1; t < nthreads; ++t) {
        KStore& ks = ks_t[t];
        for (size_t s = 0; s < ks.keys.size(); ++s) {
            const auto& k6 = ks.keys[s];
            int u[3] = {k6[0], k6[1], k6[2]}, v[3] = {k6[3], k6[4], k6[5]};
            uint64_t key;
            if (!pack6(u, v, &key)) return 2;  // unreachable: was packed
            auto it = ks0.slots.emplace(key, (int)ks0.keys.size());
            if (it.second) {
                ks0.keys.push_back(k6);
                ks0.vals.resize(ks0.keys.size() * (size_t)nq, 0.0);
            }
            double* dst = ks0.vals.data() + (size_t)it.first->second * nq;
            const double* src = ks.vals.data() + s * nq;
            for (int iq = 0; iq < nq; ++iq) dst[iq] += src[iq];
        }
    }

    if (key_overflow) return 2;  // caller raises; never silently wrong

    // ---- phase transforms -------------------------------------------
    // k . a_j per k-point and lattice row
    std::vector<double> ka((size_t)nkpt * 3);
    for (int64_t k = 0; k < nkpt; ++k)
        for (int j = 0; j < 3; ++j)
            ka[k * 3 + j] = kpts[3 * k] * lattice[3 * j] +
                            kpts[3 * k + 1] * lattice[3 * j + 1] +
                            kpts[3 * k + 2] * lattice[3 * j + 2];
    auto phase = [&](int64_t k, const int* v) -> cd {
        const double d = ka[k * 3] * v[0] + ka[k * 3 + 1] * v[1] +
                         ka[k * 3 + 2] * v[2];
        return cd(std::cos(d), std::sin(d));
    };

    cd* wj = reinterpret_cast<cd*>(wj_out);
    cd* wk = reinterpret_cast<cd*>(wk_out);

    // J: WJ[k,K,q] += sum_{a,d} e^{ik.A_a} conj(e^{iK.D_d}) VJ[a,d,q]
    {
        std::vector<cd> t1((size_t)nkpt * nD * nq, cd(0.0, 0.0));
        for (int64_t k = 0; k < nkpt; ++k)
            for (int a = 0; a < nA; ++a) {
                const cd pa = phase(k, uA[a].data());
                const double* src = vj0.data() + (size_t)a * nD * nq;
                cd* dst = t1.data() + (size_t)k * nD * nq;
                for (size_t i = 0; i < (size_t)nD * nq; ++i)
                    dst[i] += pa * src[i];
            }
        for (int64_t k = 0; k < nkpt; ++k)
            for (int64_t K = 0; K < nkpt; ++K) {
                cd* dst = wj + ((size_t)k * nkpt + K) * nq;
                for (int d = 0; d < nD; ++d) {
                    const cd pd = std::conj(phase(K, uD[d].data()));
                    const cd* src =
                        t1.data() + ((size_t)k * nD + d) * nq;
                    for (int iq = 0; iq < nq; ++iq) dst[iq] += pd * src[iq];
                }
            }
    }
    // K: WK[k,K,q] += sum_s e^{ik.(B+D)_s} e^{iK.(A-B)_s} VK[s,q]
    for (size_t s = 0; s < ks0.keys.size(); ++s) {
        const auto& k6 = ks0.keys[s];
        const int u[3] = {k6[0], k6[1], k6[2]};
        const int v[3] = {k6[3], k6[4], k6[5]};
        const double* src = ks0.vals.data() + s * nq;
        for (int64_t k = 0; k < nkpt; ++k) {
            const cd pu = phase(k, u);
            for (int64_t K = 0; K < nkpt; ++K) {
                const cd pf = pu * phase(K, v);
                cd* dst = wk + ((size_t)k * nkpt + K) * nq;
                for (int iq = 0; iq < nq; ++iq) dst[iq] += pf * src[iq];
            }
        }
    }
    return 0;
}

extern "C" int sr_eri_block(
    // bra block: nb entries, angular momenta (la, lb)
    int64_t nb, int la, int lb, const double* p_b, const double* coef_b,
    const double* w_b, const double* P_b, const double* A_b,
    const double* E_b,
    // ket block
    int64_t nk_e, int lc, int ld, const double* p_k, const double* coef_k,
    const double* w_k, const double* P_k, const double* D_k,
    const double* E_k,
    // translations, k-points
    int64_t nB, const double* Bs, int64_t nkpt, const double* kpts,
    double beta, double eps,
    // outputs, complex interleaved:
    // wj[k,K,a,b,c,d] and wk[k,K,a,l,s,n] of shape
    // (nkpt, nkpt, nfa, nfb, nfc, nfd)
    double* wj_out, double* wk_out) {
    if (la > MAX_L || lb > MAX_L || lc > MAX_L || ld > MAX_L) return 1;
    using cd = std::complex<double>;
    const int nfa = CART_N[la], nfb = CART_N[lb];
    const int nfc = CART_N[lc], nfd = CART_N[ld];
    const int tmax = la + lb + lc + ld;
    const int tm1 = tmax + 1;
    const int rstride = tm1 * tm1;
    const int eb_i = (lb + 1) * (la + lb + 1);  // stride over i for bra E
    const int eb_j = (la + lb + 1);
    const int eb_dim = (la + 1) * eb_i;  // per-dim block
    const int ek_i = (ld + 1) * (lc + ld + 1);
    const int ek_j = (lc + ld + 1);
    const int ek_dim = (lc + 1) * ek_i;
    const double inv_beta2 = 1.0 / (beta * beta);

    cd* wj = reinterpret_cast<cd*>(wj_out);
    cd* wk = reinterpret_cast<cd*>(wk_out);

    // phase tables
    std::vector<cd> phA((size_t)nkpt * nb), phD((size_t)nkpt * nk_e),
        phB((size_t)nkpt * nB);
    for (int64_t k = 0; k < nkpt; ++k) {
        const double* kv = kpts + 3 * k;
        for (int64_t i = 0; i < nb; ++i) {
            double d = kv[0] * A_b[3 * i] + kv[1] * A_b[3 * i + 1] +
                       kv[2] * A_b[3 * i + 2];
            phA[k * nb + i] = cd(std::cos(d), std::sin(d));
        }
        for (int64_t i = 0; i < nk_e; ++i) {
            double d = kv[0] * D_k[3 * i] + kv[1] * D_k[3 * i + 1] +
                       kv[2] * D_k[3 * i + 2];
            phD[k * nk_e + i] = cd(std::cos(d), std::sin(d));
        }
        for (int64_t i = 0; i < nB; ++i) {
            double d = kv[0] * Bs[3 * i] + kv[1] * Bs[3 * i + 1] +
                       kv[2] * Bs[3 * i + 2];
            phB[k * nB + i] = cd(std::cos(d), std::sin(d));
        }
    }

    const int nq = nfa * nfb * nfc * nfd;
    std::vector<double> vals(nq);
    std::vector<double> fns(tm1), rtab((size_t)tm1 * tm1 * tm1);
    double fb[MAX_T + 1];

    const int64_t out_kk = (int64_t)nq;  // per (k,K) block length

    for (int64_t ib = 0; ib < nb; ++ib) {
        const double pb = p_b[ib];
        const double wb = w_b[ib];
        const double* Pb = P_b + 3 * ib;
        const double* Eb = E_b + (size_t)ib * 3 * eb_dim;
        for (int64_t ik = 0; ik < nk_e; ++ik) {
            const double wprod = wb * w_k[ik];
            if (wprod <= eps) continue;  // exp factor <= 1
            const double qk = p_k[ik];
            const double alpha = pb * qk / (pb + qk);
            const double th2 = 1.0 / (1.0 / alpha + inv_beta2);
            const double logcut = std::log(wprod / eps);  // keep th2*R2 < logcut
            const double pref0 =
                2.0 * std::pow(M_PI, 2.5) / (pb * qk * std::sqrt(pb + qk)) *
                coef_b[ib] * coef_k[ik];
            const double sq = std::sqrt(th2 / alpha);
            const double* Qk = P_k + 3 * ik;
            const double* Ek = E_k + (size_t)ik * 3 * ek_dim;

            for (int64_t ibv = 0; ibv < nB; ++ibv) {
                const double* B = Bs + 3 * ibv;
                double pc[3] = {Pb[0] - Qk[0] - B[0], Pb[1] - Qk[1] - B[1],
                                Pb[2] - Qk[2] - B[2]};
                const double r2 =
                    pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2];
                if (th2 * r2 >= logcut) continue;

                // fused erfc kernel: (-2a)^n F_n(a r2) - sq (-2 th2)^n F_n(th2 r2)
                boys(tmax, alpha * r2, fb);
                double ca = 1.0;
                for (int n = 0; n <= tmax; ++n) {
                    fns[n] = ca * fb[n];
                    ca *= -2.0 * alpha;
                }
                boys(tmax, th2 * r2, fb);
                double ct = sq;
                for (int n = 0; n <= tmax; ++n) {
                    fns[n] -= ct * fb[n];
                    ct *= -2.0 * th2;
                }
                hermite_r(tmax, pc, fns.data(), rtab.data());

                // cartesian contraction
                int q = 0;
                for (int ia = 0; ia < nfa; ++ia) {
                    const int ax = CART_X[la][ia], ay = CART_Y[la][ia],
                              az = CART_Z[la][ia];
                    for (int jb = 0; jb < nfb; ++jb) {
                        const int bx = CART_X[lb][jb], by = CART_Y[lb][jb],
                                  bz = CART_Z[lb][jb];
                        const double* ebx = Eb + 0 * eb_dim + ax * eb_i + bx * eb_j;
                        const double* eby = Eb + 1 * eb_dim + ay * eb_i + by * eb_j;
                        const double* ebz = Eb + 2 * eb_dim + az * eb_i + bz * eb_j;
                        for (int ic = 0; ic < nfc; ++ic) {
                            const int cx = CART_X[lc][ic], cy = CART_Y[lc][ic],
                                      cz = CART_Z[lc][ic];
                            for (int jd = 0; jd < nfd; ++jd) {
                                const int dx = CART_X[ld][jd],
                                          dy = CART_Y[ld][jd],
                                          dz = CART_Z[ld][jd];
                                const double* ekx =
                                    Ek + 0 * ek_dim + cx * ek_i + dx * ek_j;
                                const double* eky =
                                    Ek + 1 * ek_dim + cy * ek_i + dy * ek_j;
                                const double* ekz =
                                    Ek + 2 * ek_dim + cz * ek_i + dz * ek_j;
                                double acc = 0.0;
                                for (int t = 0; t <= ax + bx; ++t) {
                                    const double et = ebx[t];
                                    if (et == 0.0) continue;
                                    for (int u = 0; u <= ay + by; ++u) {
                                        const double eu = eby[u];
                                        if (eu == 0.0) continue;
                                        const double etu = et * eu;
                                        for (int v = 0; v <= az + bz; ++v) {
                                            const double ev = ebz[v];
                                            if (ev == 0.0) continue;
                                            const double e_b3 = etu * ev;
                                            for (int tt = 0; tt <= cx + dx;
                                                 ++tt) {
                                                const double kt = ekx[tt];
                                                if (kt == 0.0) continue;
                                                for (int uu = 0;
                                                     uu <= cy + dy; ++uu) {
                                                    const double ku = eky[uu];
                                                    if (ku == 0.0) continue;
                                                    const double ktu = kt * ku;
                                                    for (int vv = 0;
                                                         vv <= cz + dz; ++vv) {
                                                        const double kv2 =
                                                            ekz[vv];
                                                        if (kv2 == 0.0)
                                                            continue;
                                                        const double sgn =
                                                            ((tt + uu + vv) & 1)
                                                                ? -1.0
                                                                : 1.0;
                                                        acc += sgn * e_b3 *
                                                               ktu * kv2 *
                                                               rtab[(size_t)(t + tt) *
                                                                        rstride +
                                                                    (size_t)(u + uu) *
                                                                        tm1 +
                                                                    (v + vv)];
                                                    }
                                                }
                                            }
                                        }
                                    }
                                }
                                vals[q++] = pref0 * acc;
                            }
                        }
                    }
                }

                // phase accumulation:
                // J: e^{ik.A} e^{-ik'.D};  K: e^{ik.(B+D)} e^{ik'.(A-B)}
                for (int64_t k = 0; k < nkpt; ++k) {
                    const cd fJ = phA[k * nb + ib];
                    const cd fK = phB[k * nB + ibv] * phD[k * nk_e + ik];
                    for (int64_t K = 0; K < nkpt; ++K) {
                        const cd gJ = std::conj(phD[K * nk_e + ik]);
                        const cd gK = phA[K * nb + ib] *
                                      std::conj(phB[K * nB + ibv]);
                        const cd pj = fJ * gJ;
                        const cd pk2 = fK * gK;
                        cd* oj = wj + (k * nkpt + K) * out_kk;
                        cd* ok = wk + (k * nkpt + K) * out_kk;
                        for (int iq = 0; iq < nq; ++iq) {
                            oj[iq] += pj * vals[iq];
                            ok[iq] += pk2 * vals[iq];
                        }
                    }
                }
            }
        }
    }
    return 0;
}
