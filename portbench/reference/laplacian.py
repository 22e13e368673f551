"""The local kinetic energy -(lap log psi + grad log psi . grad log psi) / 2
by a forward Laplacian: every quantity of the network is carried as a
jet (value, derivatives along the 3N electron coordinates, Laplacian).

Three kinds of jet keep the memory in bounds:
  Row    one row per electron, a dense tangent axis: v (B, n, f),
         g (B, T, n, f), l (B, n, f), T = 3n;
  Pair   the two-electron stream, whose entry (i, j) depends on r_i and
         r_j only: v, l (B, n, n, f), g (B, n, n, 6, f), d/dr_i then d/dr_j;
  Local  a per-electron factor (envelope, Bloch phase) that depends on its
         own electron only: v, l (B, n_s, f), g (B, n_s, 3, f).
The input features' jets come from torch.func (jacfwd and hessian of the
distance function of one displacement), the determinants' from
d log det A = tr(A^-1 dA) and
lap log det A = tr(A^-1 lap A) - sum_t tr(A^-1 d_t A A^-1 d_t A).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import hessian, jacfwd, vmap

from portbench.reference.network import nu_distance, tensor, wrap_into
from portbench.reference.system import System


class Jet(NamedTuple):
    v: torch.Tensor
    g: torch.Tensor
    l: torch.Tensor


def _feature_jet(dx: torch.Tensor, av, bv):
    """Value (..., 4), gradient (..., 3, 4) and Laplacian (..., 4) of
    [distance, relative coordinates] at displacements dx (..., 3)."""
    def feat(d):
        dist, rel = nu_distance(d, av, bv)
        return torch.cat([dist[..., None], rel], dim=-1)

    flat = dx.reshape(-1, 3)
    val = feat(flat)
    jac = vmap(jacfwd(feat))(flat)                      # (P, 4, 3)
    lap = torch.diagonal(vmap(hessian(feat))(flat), dim1=-2, dim2=-1).sum(-1)
    lead = dx.shape[:-1]
    return (val.reshape(*lead, 4), jac.transpose(-1, -2).reshape(*lead, 3, 4),
            lap.reshape(*lead, 4))


def _spread(local: torch.Tensor, n: int, first: int = 0) -> torch.Tensor:
    """A local derivative (B, m, 3, f) of rows first..first+m as the dense
    (B, 3n, m, f) one: row i moves with electron first + i only."""
    batch, m, _, f = local.shape
    dense = local.new_zeros((batch, n, 3, m, f))
    idx = torch.arange(m, device=local.device)
    dense[:, first + idx, :, idx, :] = local.transpose(0, 1)
    return dense.reshape(batch, 3 * n, m, f)


def _own(dense: torch.Tensor, n: int, first: int = 0) -> torch.Tensor:
    """The (B, m, 3, f) derivatives of each row of a dense (B, 3n, m, f)
    jet along its own electron's coordinates."""
    batch, _, m, f = dense.shape
    idx = torch.arange(m, device=dense.device)
    return dense.reshape(batch, n, 3, m, f)[:, first + idx, :, idx, :].transpose(0, 1)


def _tanh_row(z: Jet) -> Jet:
    v = torch.tanh(z.v)
    d = 1.0 - v * v
    return Jet(v, z.g * d[:, None], d * z.l - 2.0 * v * d * torch.sum(z.g * z.g, dim=1))


def _tanh_pair(z: Jet) -> Jet:
    v = torch.tanh(z.v)
    d = 1.0 - v * v
    return Jet(v, z.g * d[..., None, :],
               d * z.l - 2.0 * v * d * torch.sum(z.g * z.g, dim=-2))


def _residual(old: Jet, new: Jet) -> Jet:
    if old.v.shape != new.v.shape:
        return new
    s = 1.0 / math.sqrt(2.0)
    return Jet((old.v + new.v) * s, (old.g + new.g) * s, (old.l + new.l) * s)


def _pair_mean(h2: Jet, n: int, s: int, e: int) -> Jet:
    """Row i of mean over j in [s, e) of the pair entry (j, i)."""
    m = e - s
    part = h2.g[:, s:e]                                  # (B, m, n, 6, f)
    batch, f = part.shape[0], part.shape[-1]
    # d/dr_j of entry (j, i): tangent rows of electron j
    first = part[..., 0:3, :].permute(0, 1, 3, 2, 4) / m  # (B, m, 3, n, f)
    dense = part.new_zeros((batch, n, 3, n, f))
    dense[:, s:e] = first
    dense = dense.reshape(batch, 3 * n, n, f)
    # d/dr_i of entry (j, i), summed over j: the row's own electron
    own = part[..., 3:6, :].sum(dim=1) / m              # (B, n, 3, f)
    dense = dense + _spread(own, n)
    return Jet(h2.v[:, s:e].mean(dim=1), dense, h2.l[:, s:e].mean(dim=1))


def _row_mean(h1: Jet, s: int, e: int) -> Jet:
    return Jet(h1.v[:, s:e].mean(dim=1, keepdim=True),
               h1.g[:, :, s:e].mean(dim=2, keepdim=True),
               h1.l[:, s:e].mean(dim=1, keepdim=True))


def _single_layer(system: System, h1: Jet, h2: Jet, layer) -> Jet:
    """tanh of [h1 | channel means of h1 | channel means of h2] @ w + b,
    with the channel means of h1 (the same for every row) contracted once
    per walker."""
    n = system.nelectron
    f1 = h1.v.shape[-1]
    w = layer["w"]
    nch = len(system.channels)
    blocks = [(h1, w[:f1])]
    for c, (s, e) in enumerate(system.channels):
        blocks.append((_row_mean(h1, s, e), w[f1 * (1 + c):f1 * (2 + c)]))
    f2 = h2.v.shape[-1]
    base = f1 * (1 + nch)
    for c, (s, e) in enumerate(system.channels):
        blocks.append((_pair_mean(h2, n, s, e), w[base + f2 * c:base + f2 * (c + 1)]))
    v = g = l = None
    for jet, wb in blocks:
        pv, pg, pl = jet.v @ wb, jet.g @ wb, jet.l @ wb
        v = pv if v is None else v + pv
        g = pg if g is None else g + pg
        l = pl if l is None else l + pl
    if "b" in layer:
        v = v + layer["b"]
    return _tanh_row(Jet(v, g, l))


def _pair_layer(h2: Jet, layer) -> Jet:
    w = layer["w"]
    v = h2.v @ w
    if "b" in layer:
        v = v + layer["b"]
    return _tanh_pair(Jet(v, h2.g @ w, h2.l @ w))


def _logdet_jet(mat: Jet, tangent_chunk: int):
    """(log det (B, ndet) complex, d_t log det (B, T, ndet), lap (B, ndet))
    of matrices v (B, ndet, m, m), g (B, T, ndet, m, m), l like v."""
    inv = torch.linalg.inv(mat.v)
    sign, logabs = torch.linalg.slogdet(mat.v)
    d = torch.einsum("bdji,btdij->btd", inv, mat.g)
    square = 0.0
    for t0 in range(0, mat.g.shape[1], tangent_chunk):
        x = inv[:, None] @ mat.g[:, t0:t0 + tangent_chunk]
        square = square + torch.einsum("btdij,btdji->bd", x, x)
    lap = torch.einsum("bdji,bdij->bd", inv, mat.l) - square
    return torch.log(sign) + logabs, d, lap


def kinetic_and_log_psi(params, x: torch.Tensor, system: System, ndet: int,
                        tangent_chunk: int = 48):
    """(kinetic energy (B,) complex, log psi (B,) complex) of walkers x
    (B, 3n)."""
    batch, n = x.shape[0], system.nelectron
    pos = x.reshape(batch, n, 3)

    av, bv = System.feature_vectors(system.prim_lattice)
    ae = wrap_into(pos, system.prim_lattice)[:, :, None, :] - tensor(system.prim_atoms, x)
    ae_v, ae_g, ae_l = _feature_jet(ae, av, bv)          # (B, n, a, 4), (B, n, a, 3, 4)
    natom = ae_v.shape[2]
    h1 = Jet(ae_v.reshape(batch, n, 4 * natom),
             _spread(ae_g.permute(0, 1, 3, 2, 4).reshape(batch, n, 3, 4 * natom), n),
             ae_l.reshape(batch, n, 4 * natom))

    av_s, bv_s = System.feature_vectors(system.sim_lattice)
    sim = wrap_into(pos, system.sim_lattice)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    u = sim[:, :, None, :] - sim[:, None, :, :] + eye[..., None]
    ee_v, ee_g, ee_l = _feature_jet(u, av_s, bv_s)
    mask = (1.0 - eye)[..., None]
    h2 = Jet(ee_v * mask, torch.cat([ee_g, -ee_g], dim=-2) * mask[..., None],
             2.0 * ee_l * mask)

    for i in range(len(params["double"])):
        one = _single_layer(system, h1, h2, params["single"][i])
        two = _pair_layer(h2, params["double"][i])
        h1, h2 = _residual(h1, one), _residual(h2, two)
    h1 = _residual(h1, _single_layer(system, h1, h2, params["single"][-1]))

    log_d = grad_d = lap_d = None
    for ch, (s, e) in enumerate(system.channels):
        m = e - s
        layer = params["orbital"][ch]
        w = layer["w"]
        rv, rg, rl = h1.v[:, s:e] @ w, h1.g[:, :, s:e] @ w, h1.l[:, s:e] @ w
        if "b" in layer:
            rv = rv + layer["b"]
        half = w.shape[-1] // 2
        orb = Jet(*(torch.complex(t[..., :half], t[..., half:]) for t in (rv, rg, rl)))

        # envelope sum_a pi exp(-|sigma| d_a) and phase exp(i k.r): local jets
        env = params["envelope"][ch]
        rate = torch.abs(env["sigma"])                   # (a, P)
        dist = ae_v[:, s:e, :, 0]                         # (B, m, a)
        dgrad = ae_g[:, s:e, :, :, 0]                     # (B, m, a, 3)
        dlap = ae_l[:, s:e, :, 0]
        decay = env["pi"] * torch.exp(-rate * dist[..., None])   # (B, m, a, P)
        env_v = decay.sum(dim=2)
        env_g = -torch.einsum("bmap,bmac->bmcp", decay * rate, dgrad)
        env_l = torch.einsum("bmap,bma->bmp", decay * rate * rate,
                             torch.sum(dgrad * dgrad, dim=-1)) \
            - torch.einsum("bmap,bma->bmp", decay * rate, dlap)
        k = tensor(system.klist[ch], x)                   # (m, 3)
        ph = torch.exp(1j * (pos[:, s:e] @ k.T)).repeat(1, 1, ndet)     # (B, m, P)
        kk = k.repeat(ndet, 1)                            # (P, 3)
        ph_g = 1j * kk.T[None, None] * ph[:, :, None, :]  # (B, m, 3, P)
        ph_l = -torch.sum(kk * kk, dim=-1) * ph
        ep_v = env_v * ph
        ep_g = env_g * ph[:, :, None] + env_v[:, :, None] * ph_g
        ep_l = env_l * ph + 2.0 * torch.sum(env_g * ph_g, dim=2) + env_v * ph_l

        cross = torch.sum(_own(orb.g, n, s) * ep_g, dim=2)
        prod = Jet(orb.v * ep_v,
                   orb.g * ep_v[:, None] + _spread(orb.v[:, :, None] * ep_g, n, s),
                   orb.l * ep_v + orb.v * ep_l + 2.0 * cross)
        t_dim = prod.g.shape[1]
        mat = Jet(prod.v.reshape(batch, m, ndet, m).transpose(1, 2),
                  prod.g.reshape(batch, t_dim, m, ndet, m).transpose(2, 3),
                  prod.l.reshape(batch, m, ndet, m).transpose(1, 2))
        del orb, prod
        ld, gd, lapd = _logdet_jet(mat, tangent_chunk)
        log_d = ld if log_d is None else log_d + ld
        grad_d = gd if grad_d is None else grad_d + gd
        lap_d = lapd if lap_d is None else lap_d + lapd

    top = log_d.real.max(dim=-1, keepdim=True).values
    weight = torch.exp(log_d - top)
    total = weight.sum(dim=-1, keepdim=True)
    log_psi = torch.log(total[..., 0]) + top[..., 0]
    weight = weight / total
    per_det = lap_d + torch.sum(grad_d * grad_d, dim=1)
    kinetic = -0.5 * torch.sum(weight * per_det, dim=-1)
    return kinetic, log_psi
