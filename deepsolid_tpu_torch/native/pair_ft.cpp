// Weighted pair-density-FT moment tables for the long-range (reciprocal
// space) nuclear attraction, the host-side hot spot of core_matrices
// (scf/hf.py:_pair_ft_vlr_block). Plays the role PySCF's libcint C code
// plays for the reference (DeepSolid/hf.py:26).
//
//   R[a,b,T,c] = sum_g (pi/p)^{3/2} exp(-|g|^2/(4p)) e^{+i g.P} w(g)
//                * (i g_x)^t (i g_y)^u (i g_z)^v        (c = (t,u,v))
//
// with p = alpha_a + beta_b and P the Gaussian product center of
// primitive pair (a, b) at image translation T. Combo ordering matches
// the Python assembly: t, u, v in row-major order, t+u+v <= lsum.
//
// The key win over the numpy path (besides loop fusion on a 1-core box):
// per-PRIMITIVE screening. The image list is sized for the most diffuse
// primitive in the shell; tight pairs contribute at only a few images,
// so most (a, b, T) triples die on exp(-mu |AB_T|^2) < eps.

#include <cmath>
#include <complex>
#include <cstdint>

extern "C" int pair_ft_r_table(
    int na, int nb,
    const double* alpha,        // (na,)
    const double* beta,         // (nb,)
    const double* a_pos,        // (3,)
    const double* b_images,     // (nT, 3): shell-b center + lattice images
    int64_t nT,
    const double* gpts,         // (ng, 3)
    const double* w_re,         // (ng,) Re of w_eff = n_g * gw
    const double* w_im,         // (ng,)
    int64_t ng,
    int lsum,                   // la + lb; moments up to this total order
    double screen_eps,          // drop (a,b,T) with exp(-mu|AB|^2) < eps
    double* out_re,             // (na, nb, nT, nc) row-major
    double* out_im) {
  const int LMAX = 8;
  if (lsum < 0 || lsum > LMAX) return 1;
  // combo table (t,u,v) with t+u+v <= lsum, row-major in (t,u,v)
  int ct[165], cu[165], cv[165];
  int nc = 0;
  for (int t = 0; t <= lsum; ++t)
    for (int u = 0; u <= lsum; ++u)
      for (int v = 0; v <= lsum; ++v)
        if (t + u + v <= lsum) { ct[nc] = t; cu[nc] = u; cv[nc] = v; ++nc; }

  const double log_eps = std::log(screen_eps);
  const std::complex<double> I(0.0, 1.0);

  for (int a = 0; a < na; ++a) {
    for (int b = 0; b < nb; ++b) {
      const double al = alpha[a], be = beta[b];
      const double p = al + be, mu = al * be / p;
      const double pref0 = std::pow(M_PI / p, 1.5);
      const double inv4p = 1.0 / (4.0 * p);
      for (int64_t T = 0; T < nT; ++T) {
        const double bx = b_images[3 * T], by = b_images[3 * T + 1],
                     bz = b_images[3 * T + 2];
        const double dx = a_pos[0] - bx, dy = a_pos[1] - by,
                     dz = a_pos[2] - bz;
        const double r2 = dx * dx + dy * dy + dz * dz;
        if (-mu * r2 < log_eps) continue;  // kab kills the E coefficients
        const double Px = (al * a_pos[0] + be * bx) / p;
        const double Py = (al * a_pos[1] + be * by) / p;
        const double Pz = (al * a_pos[2] + be * bz) / p;
        std::complex<double> acc[165];
        for (int c = 0; c < nc; ++c) acc[c] = 0.0;
        for (int64_t g = 0; g < ng; ++g) {
          const double gx = gpts[3 * g], gy = gpts[3 * g + 1],
                       gz = gpts[3 * g + 2];
          const double g2 = gx * gx + gy * gy + gz * gz;
          const double pref = pref0 * std::exp(-g2 * inv4p);
          const double th = gx * Px + gy * Py + gz * Pz;
          const std::complex<double> z =
              pref * std::complex<double>(std::cos(th), std::sin(th)) *
              std::complex<double>(w_re[g], w_im[g]);
          // moment powers (i g_d)^t up to lsum
          std::complex<double> px[LMAX + 1], py[LMAX + 1], pz[LMAX + 1];
          px[0] = py[0] = pz[0] = 1.0;
          for (int t = 1; t <= lsum; ++t) {
            px[t] = px[t - 1] * (I * gx);
            py[t] = py[t - 1] * (I * gy);
            pz[t] = pz[t - 1] * (I * gz);
          }
          for (int c = 0; c < nc; ++c)
            acc[c] += z * px[ct[c]] * py[cu[c]] * pz[cv[c]];
        }
        double* orow = out_re + (((int64_t)(a * nb + b) * nT + T) * nc);
        double* irow = out_im + (((int64_t)(a * nb + b) * nT + T) * nc);
        for (int c = 0; c < nc; ++c) {
          orow[c] = acc[c].real();
          irow[c] = acc[c].imag();
        }
      }
    }
  }
  return 0;
}
