"""The operations one training iteration needs, counted from the
configuration's shapes: the dense products and the determinants, 2 flops
a multiply-add and 8 a complex one, elementwise work not counted.

Per walker (n electrons, T = 3n tangents, nch spin channels of n_s):
  value pass   the trunk's products, the rows against the row-varying
               inputs [h1 | pair means] and once per walker against the
               channel means of h1; the pair stream; the orbital heads; an
               n_s^3 complex inverse per determinant and channel;
  E_L pass     the same products on T + 2 jet columns (the pair stream
               on 6 + 2), and per determinant the inverse and T products
               A^-1 d_t A;
  gradient     a value pass and its backward (twice the forward);
  capture      a value pass and two backward passes (Re and Im log psi).
Per iteration: `mcmc_steps` value passes of the sampler and an E_L pass
per walker; with KFAC a gradient and a capture per walker, the KFAC
factors (x^T x over every row of every walker, the output tangents'
square for Re and Im), a Cholesky inverse of each factor (d^3
multiply-adds) and the preconditioning, and an E_L pass more on an
iteration that adapts the damping; with optimizer 'none' nothing more.
"""

from __future__ import annotations


def _layers(conf):
    """[(rows per walker, d_in, d_out, kind)] of the dense layers, and the
    widths of the row-varying and channel-mean parts of each one-electron
    layer."""
    net = conf["network"]
    natom = len(conf["atoms"])
    n, spins = _electrons(conf)
    nch = sum(1 for s in spins if s)
    f1, f2 = 4 * natom, 4
    singles, doubles = [], []
    hidden = net["hidden_dims"]
    for i, (h1, h2) in enumerate(hidden):
        singles.append((f1 + nch * f2, nch * f1, h1))
        if i < len(hidden) - 1:
            doubles.append((f2, h2))
        f1, f2 = h1, h2
    return n, spins, singles, doubles, f1


def _electrons(conf):
    import numpy as np

    scale = round(abs(np.linalg.det(np.asarray(conf["supercell"], float))))
    n = int(round(sum(a["charge"] for a in conf["atoms"]))) * scale
    return n, (n // 2, n - n // 2)


def value_flops(conf) -> float:
    """One walker's value pass."""
    return _pass_flops(conf, columns=1, pair_columns=1, det_products=0)


def local_energy_flops(conf) -> float:
    """One walker's forward-Laplacian pass."""
    n, _ = _electrons(conf)
    t = 3 * n
    return _pass_flops(conf, columns=t + 2, pair_columns=6 + 2, det_products=t)


def _pass_flops(conf, columns, pair_columns, det_products) -> float:
    n, spins, singles, doubles, f_last = _layers(conf)
    ndet = conf["network"]["determinants"]
    total = 0.0
    for row_in, mean_in, d_out in singles:
        total += 2.0 * columns * (n * row_in + mean_in) * d_out
    for d_in, d_out in doubles:
        total += 2.0 * pair_columns * n * n * d_in * d_out
    for n_s in spins:
        if n_s:
            total += 2.0 * columns * n_s * f_last * 2 * ndet * n_s
            total += 8.0 * n_s**3 * ndet * (1 + det_products)
    return total


def kfac_flops(conf) -> float:
    """The factor products of one walker's capture."""
    n, spins, singles, doubles, f_last = _layers(conf)
    ndet = conf["network"]["determinants"]
    total = 0.0
    for row_in, mean_in, d_out in singles:
        d_in = row_in + mean_in + 1
        total += 2.0 * n * (d_in * d_in + 2 * d_out * d_out)
    for d_in, d_out in doubles:
        total += 2.0 * n * n * ((d_in + 1) ** 2 + 2 * d_out * d_out)
    for n_s in spins:
        if n_s:
            d_out = 2 * ndet * n_s
            total += 2.0 * n_s * (f_last * f_last + 2 * d_out * d_out)
    return total


def inverse_flops(conf) -> float:
    """The Cholesky inverses and the preconditioning, once an iteration."""
    n, spins, singles, doubles, f_last = _layers(conf)
    ndet = conf["network"]["determinants"]
    shapes = [(r + m + 1, d) for r, m, d in singles] + [(d + 1, o) for d, o in doubles]
    shapes += [(f_last, 2 * ndet * s) for s in spins if s]
    return sum(2.0 * (a**3 + b**3) + 2.0 * (a * a * b + a * b * b) for a, b in shapes)


def iteration_flops(conf, batch: int, mcmc_steps: int, adapted: bool,
                    optimizer: str = "kfac") -> float:
    value = value_flops(conf)
    e_l = local_energy_flops(conf)
    per_walker = mcmc_steps * value + e_l
    if optimizer == "none":
        return batch * per_walker
    if optimizer != "kfac":
        raise ValueError(f"no count of the optimizer {optimizer!r}")
    per_walker += 3 * value + 5 * value + kfac_flops(conf)
    if adapted:
        per_walker += e_l
    return batch * per_walker + inverse_flops(conf)
