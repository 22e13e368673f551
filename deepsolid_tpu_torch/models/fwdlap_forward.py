"""Forward-Laplacian evaluation of the periodic FermiNet kinetic energy.

Mirrors deepsolid_tpu/models/fwdlap_forward.py (network_jets with its
optional tangent sharding and the opt-in tangent-chunked orbital and
determinant head). One traversal carrying (value, Jacobian, Laplacian)
jets replaces 3N JVP-of-grad passes: the two-electron stream stays
pair-sparse (6 tangents), each determinant is factorized once, and the 3N
tangent axis rides the batched matmuls. Every layout of the determinant
head (a channel's own matrices, full_det's one matrix, the scan) goes
through fl.det_head_jet, which reads the orbital GEMM's tangent products
a window of tangents at a time. The walker batch is the leading axis of
every value."""

from __future__ import annotations

import logging
import os
from typing import Callable

import torch

from deepsolid_tpu_torch.device import constant
from deepsolid_tpu_torch.models import envelopes as envelopes_lib
from deepsolid_tpu_torch.models import features as features_lib
from deepsolid_tpu_torch.models.network import NetworkConfig, SystemSpec
from deepsolid_tpu_torch.ops import fwdlap as fl
from deepsolid_tpu_torch.ops.distance import enforce_pbc
from deepsolid_tpu_torch.utils import profiling


_ORB_SCAN_ENV = "DEEPSOLID_TPU_ORB_SCAN"
_WARNED = set()


def _use_orb_scan() -> bool:
    """Gate of the tangent-chunked orbital and determinant head: off by
    default, on with DEEPSOLID_TPU_ORB_SCAN=on (the JAX package's gate). A
    memory lever: without it the det head reads a channel's orbital
    products (T, B, n, 2 ndet norb) whole (with full_det every channel's,
    stacked); with it each window of tangents is formed from the trunk's
    parts, so no (T, B, n, ...) tensor past the trunk is held. An
    unrecognized value warns once and keeps it off."""
    value = os.environ.get(_ORB_SCAN_ENV, "")
    if value and value not in ("on", "off"):
        if _ORB_SCAN_ENV not in _WARNED:
            _WARNED.add(_ORB_SCAN_ENV)
            logging.warning("%s=%r not recognized (valid: off|on); using off",
                            _ORB_SCAN_ENV, value)
        return False
    return value == "on"


def _jet0(j: fl.Jet) -> fl.Jet:
    """The value and Laplacian of a jet with an empty tangent axis: every
    fl op below then skips its tangent work (the det head reads the
    tangents as the orbital GEMM's products)."""
    return fl.Jet(j.val, j.jac[:0], j.lap)


def _channel_ranges(spins):
    ranges = []
    start = 0
    for s in spins:
        if s > 0:
            ranges.append((start, start + s))
        start += s
    return ranges


def _isotropic_envelope_jet(r, env_params, spec: SystemSpec, cfg: NetworkConfig,
                            atoms) -> fl.Jet:
    """Analytic jet of the isotropic envelope wrt each electron's position.

    env[..., p] = sum_a pi[a, p] exp(-|sigma[a, p]| sd_a(r)), with sd_a
    the periodic distance to atom a and its analytic jet from features;
    the wrap into the primitive cell shifts r by lattice vectors only, so
    derivatives wrt the displacement are derivatives wrt r. r: (..., 3);
    returns val, lap (..., nparam) and jac (3, ..., nparam). Forward-mode
    autodiff of the same function (fl.jet_of_function, which the other
    envelopes take) issues so many small ops that the host left the card
    idle on the main path (PERF.md).
    """
    jet_fn = features_lib.DISTANCE_JET_FNS[cfg.distance_type]
    pr, _ = enforce_pbc(spec.prim_lattice, r)
    sd, dsd, lap_sd, _, _, _ = jet_fn(pr[..., None, :] - atoms, spec.prim_av,
                                      spec.prim_bv)
    sigma = env_params["sigma"]
    rate = torch.abs(sigma)
    w = env_params["pi"] * torch.exp(-torch.abs(sigma * sd[..., None]))
    wr = w * rate  # (..., natom, nparam)
    return fl.Jet(
        val=torch.sum(w, dim=-2),
        jac=-torch.einsum("...ac,...ap->c...p", dsd, wr),
        lap=(torch.einsum("...ap,...a->...p", wr * rate, torch.sum(dsd * dsd, dim=-1))
             - torch.einsum("...ap,...a->...p", wr, lap_sd)),
    )


def _slice_tangents(jac: torch.Tensor, shard) -> torch.Tensor:
    """This rank's tangent window of a dense (3N, ...) jac."""
    if shard is None:
        return jac
    t_loc = jac.shape[0] // shard.size
    return jac.narrow(0, shard.t0(t_loc), t_loc)


def network_jets(params, x: torch.Tensor, spec: SystemSpec,
                 cfg: NetworkConfig, shard=None) -> fl.Jet:
    """Jet of complex log psi wrt the 3N electron coordinates.

    x: (B, 3N). Returns val (B,) complex, jac (3N, B), lap (B,).

    `shard` (parallel.TangentShard or None) shards the 3N tangent columns
    over the deriv ranks: every dense jet holds this rank's 3N / size
    tangents (jac (T_local, B)) and cross-tangent contractions are summed
    over the ranks; val and lap come out equal on every rank. The
    pair-sparse two-electron jets (6 tangents) and the per-electron
    envelope jets (3) stay rank-local.
    """
    # the trunk: features, layers, residuals, the orbital head's input
    with profiling.annotate("el.trunk"):
        dtype, dev = x.dtype, x.device
        spins = spec.spins
        n = spec.nelectron
        batch = x.shape[0]
        pos = x.reshape(batch, n, 3)

        atoms = constant(spec.atoms, x)
        natom = atoms.shape[0]
        rel = features_lib.REL_DIMS[cfg.distance_type]
        dist_fn = features_lib.DISTANCE_FNS[cfg.distance_type]
        jet_fn = features_lib.DISTANCE_JET_FNS[cfg.distance_type]
        width = natom * (rel + 1)

        # ---- electron-atom features: analytic per-electron jets -----------------
        prim_x, _ = enforce_pbc(spec.prim_lattice, x)
        ae_disp = prim_x.reshape(batch, n, 1, 3) - atoms
        sd, dsd, lap_sd, rl, drl, lap_rl = jet_fn(ae_disp, spec.prim_av, spec.prim_bv)
        ae_jac = torch.cat([dsd[..., None], drl], dim=-1)  # (B, n, natom, 3, rel+1)
        ae_jac = ae_jac.movedim(3, 0).reshape(3, batch, n, width)
        h_one = fl.Jet(
            val=torch.cat([sd[..., None], rl], dim=-1).reshape(batch, n, width),
            jac=_slice_tangents(fl.dense_from_electron_rows(ae_jac), shard),
            lap=torch.cat([lap_sd[..., None], lap_rl], dim=-1).reshape(batch, n, width),
        )

        # ---- electron-electron features: analytic pair-sparse jets -------------
        sim_x, _ = enforce_pbc(spec.sim_lattice, x)
        sim_pos = sim_x.reshape(batch, n, 3)
        eye = torch.eye(n, dtype=dtype, device=dev)
        u = sim_pos[:, :, None, :] - sim_pos[:, None, :, :] + eye[..., None]
        sd, dsd, lap_sd, rl, drl, lap_rl = jet_fn(u, spec.sim_av, spec.sim_bv)
        ee_jac = torch.cat([dsd[..., None], drl], dim=-1).movedim(3, 0)  # wrt u
        mask = (1.0 - eye)[..., None]
        h_two = fl.Jet(
            val=torch.cat([sd[..., None], rl], dim=-1) * mask,
            jac=torch.cat([ee_jac, -ee_jac], dim=0) * mask,
            # Lap_{r_i} + Lap_{r_j} = 2 Lap_u
            lap=2.0 * torch.cat([lap_sd[..., None], lap_rl], dim=-1) * mask,
        )

        ranges = _channel_ranges(spins)

        # ---- symmetric feature mixing ---------------------------------------------
        # [h1 | mean_ch(h1) | mean_ch(h2)] is kept as a row-varying jet (h1 and
        # the pair means) plus a row-constant jet (the per-channel h1 means);
        # weight rows split the same way: w_rv = [w[:f1]; w[f1 (1+nch):]],
        # w_rc = w[f1 : f1 (1+nch)].
        def symmetric_split_parts(h1: fl.Jet, h2: fl.Jet):
            rc_parts = [fl.mean_axis(fl.slice_axis(h1, 1, s, e), axis=1, keepdims=True)
                        for (s, e) in ranges]
            rv_parts = [h1]
            for (s, e) in ranges:
                rv_parts.append(fl.Jet(
                    val=torch.mean(h2.val[:, s:e], dim=1),
                    jac=_slice_tangents(fl.dense_row_mean_from_pairs(h2.jac, s, e),
                                        shard),
                    lap=torch.mean(h2.lap[:, s:e], dim=1),
                ))
            return rv_parts, fl.concat(rc_parts, axis=-1)

        def symmetric_split(h1: fl.Jet, h2: fl.Jet):
            rv_parts, rc = symmetric_split_parts(h1, h2)
            return fl.concat(rv_parts, axis=-1), rc

        def split_w(w, f1):
            nch = len(ranges)
            return torch.cat([w[:f1], w[f1 * (1 + nch):]], dim=0), w[f1:f1 * (1 + nch)]

        inv_sqrt2 = float(2.0 ** -0.5)

        def residual(old: fl.Jet, new: fl.Jet) -> fl.Jet:
            if old.val.shape == new.val.shape:
                return fl.scale(fl.add(old, new), inv_sqrt2)
            return new

        n_double = len(params["double"])
        for i in range(n_double):
            f1 = h_one.val.shape[-1]
            h_rv, h_rc = symmetric_split(h_one, h_two)
            p1 = params["single"][i]
            w_rv, w_rc = split_w(p1["w"], f1)
            h_one_next = fl.dense_tanh_mix(h_rv, h_rc, w_rv, w_rc, p1.get("b"),
                                           shard=shard)
            p2 = params["double"][i]
            h_two_next = fl.dense_tanh(h_two, p2["w"], p2.get("b"))
            h_one = residual(h_one, h_one_next)
            h_two = residual(h_two, h_two_next)

        if n_double != len(params["single"]):
            f1 = h_one.val.shape[-1]
            h_rv, h_rc = symmetric_split(h_one, h_two)
            p1 = params["single"][-1]
            w_rv, w_rc = split_w(p1["w"], f1)
            h_one = residual(h_one, fl.dense_tanh_mix(h_rv, h_rc, w_rv, w_rc,
                                                      p1.get("b"), shard=shard))
            orb_parts, h_orb_rc, f1_orb = [h_one], None, None
        else:
            f1_orb = h_one.val.shape[-1]
            orb_parts, h_orb_rc = symmetric_split_parts(h_one, h_two)

        use_scan = _use_orb_scan()
        if use_scan:
            h_orb_rv = fl.concat([_jet0(p) for p in orb_parts], axis=-1)
        else:
            h_orb_rv = orb_parts[0] if len(orb_parts) == 1 else fl.concat(orb_parts, axis=-1)
        t_loc = orb_parts[0].jac.shape[0]

    # ---- orbital heads ----------------------------------------------------------
    envelope_fn = envelopes_lib.ENVELOPES[cfg.envelope_type]
    klist = [constant(k, x) for k in spec.klist]
    prim_av, prim_bv = spec.prim_av, spec.prim_bv

    dets = []  # per-channel (sign, jet of log det), in channel order
    heads = []  # full_det: per channel, the det head's inputs
    for ch, (s, e) in enumerate(ranges):
        with profiling.annotate("el.orbitals", ch):
            spin = e - s
            w_orb = params["orbital"][ch]["w"]
            b_orb = params["orbital"][ch].get("b")
            rows = fl.slice_axis(h_orb_rv, 1, s, e)
            # the orbitals' value and Laplacian; their tangents stay the
            # orbital GEMM's real products, which the det head reads a
            # window of tangents at a time (fl.det_head_jet)
            if h_orb_rc is None:
                w_rv, jbc = w_orb, None
                raw = fl.dense(_jet0(rows), w_orb, b_orb)
            else:
                w_rv, w_rc = split_w(w_orb, f1_orb)
                raw = fl.dense_mix(_jet0(rows), _jet0(h_orb_rc), w_rv, w_rc, b_orb)
                jbc = (h_orb_rc.jac @ w_rc)[:, :, 0]  # (T_loc, B, 2 nparam)
            window = (_parts_window(orb_parts, w_rv, jbc, s, e) if use_scan
                      else fl.sliced_window(rows.jac @ w_rv, jbc))
            nparam = raw.val.shape[-1] // 2
            orb = fl.complexify(fl.slice_axis(raw, -1, 0, nparam),
                                fl.slice_axis(raw, -1, nparam, 2 * nparam))
            norb = sum(spins) if cfg.full_det else spin
            ndet = cfg.determinants
            # (B, spin, ndet*norb) -> (B, ndet, spin, norb) on every component
            orb = fl.linear_op(
                lambda v: v.unflatten(-1, (ndet, norb)).transpose(-3, -2), orb)

        with profiling.annotate("el.det_head", ch):
            env_params = params["envelope"][ch]
            if cfg.envelope_type == "isotropic":
                envr = _isotropic_envelope_jet(pos[:, s:e], env_params, spec, cfg, atoms)
            else:
                def env_fn(r, env_params=env_params):
                    pr, _ = enforce_pbc(spec.prim_lattice, r)
                    _, rl_ = dist_fn(pr[..., None, :] - atoms, prim_av, prim_bv)
                    return envelope_fn(rl_, env_params)  # (..., nparam)

                envr = fl.jet_of_function(env_fn, pos[:, s:e])  # jac (3, B, spin, nparam)

            # Bloch phases: analytic per-electron jets (B, spin, norb)
            kcol = torch.cat(klist, dim=0) if cfg.full_det else klist[ch]
            phase_val = torch.exp(1j * (pos[:, s:e] @ kcol.T))
            phase_jac3 = 1j * kcol.T[:, None, None, :] * phase_val  # (3, B, spin, norb)
            phase_lap = -torch.sum(kcol**2, dim=-1) * phase_val

            # envelope * phase: a row-local factor, multiplied into the
            # orbital jet by the det head in its pass over the tangents
            env_val = envr.val.unflatten(-1, (ndet, norb))
            env_jac3 = envr.jac.unflatten(-1, (ndet, norb))  # (3, B, spin, ndet, norb)
            env_lap = envr.lap.unflatten(-1, (ndet, norb))
            pv = phase_val[:, :, None, :]
            pj = phase_jac3[:, :, :, None, :]
            ep_val = env_val * pv
            ep_jac3 = env_jac3 * pv + env_val * pj
            ep_lap = (env_lap * pv + 2.0 * torch.sum(env_jac3 * pj, dim=0)
                      + env_val * phase_lap[:, :, None, :])
            head = (orb.val, orb.lap, ep_val.transpose(1, 2),  # (B, ndet, spin, norb)
                    ep_jac3.transpose(2, 3), ep_lap.transpose(1, 2), window)
            if cfg.full_det:
                heads.append(head)
            else:
                dets.append(fl.det_head_jet(*head, t_loc, offset=s, shard=shard,
                                            scan=use_scan))
            # a channel's products go before the next channel's orbital GEMM
            # (full_det keeps them in `heads`)
            del head, window, jbc

    # the rest of the det head: full_det's one matrix of every channel's
    # rows, the determinants and their sum
    with profiling.annotate("el.det_head"):
        if cfg.full_det:
            *mats, windows = zip(*heads)
            del heads
            dets = [fl.det_head_jet(*(torch.cat(m, dim=-2) for m in mats),
                                    _rows_window(windows), t_loc, offset=0,
                                    shard=shard, scan=use_scan)]
        sign_total, l_total = dets[0]
        for sign, l in dets[1:]:
            sign_total = sign_total * sign
            l_total = fl.add(l_total, l)
        return fl.logsumexp_det_jet(sign_total, l_total, shard=shard)


def _parts_window(parts, w_rv, jbc, s: int, e: int):
    """The scan's window of one channel's orbital products: each trunk
    part's tangents [c0, c1) of the rows [s, e) through its own weight rows
    (the parts' (T_loc, B, n, f_p) Jacobians are read a window at a time,
    never concatenated), and the row-constant block's tangents jbc."""
    bounds = [0]
    for p in parts:
        bounds.append(bounds[-1] + p.val.shape[-1])
    w_parts = [w_rv[lo:hi] for lo, hi in zip(bounds, bounds[1:])]

    def window(c0, c1):
        jr = sum(p.jac[c0:c1, :, s:e] @ w for p, w in zip(parts, w_parts))
        return jr, None if jbc is None else jbc[c0:c1]

    return window


def _rows_window(windows):
    """full_det's window: each channel's products with its row-constant
    tangents folded into its own rows (they come from that channel's
    weights), the channels stacked along the rows."""
    def window(c0, c1):
        jrs = []
        for w in windows:
            jr, jbc = w(c0, c1)
            jrs.append(jr if jbc is None else jr + jbc[:, :, None])
        return torch.cat(jrs, dim=2), None

    return window


def _check_shard(spec: SystemSpec, shard) -> None:
    if shard is not None and (3 * spec.nelectron) % shard.size != 0:
        raise ValueError(
            f"the deriv axis ({shard.size} ranks) must divide the "
            f"3N={3 * spec.nelectron} Laplacian tangent columns")


def make_kinetic_forward(network, shard=None) -> Callable:
    """kinetic(params, x) -> complex local kinetic energy (B,). With a
    shard the 3N tangent columns are split over the deriv ranks."""
    spec, cfg = network.spec, network.cfg
    _check_shard(spec, shard)

    def kinetic(params, x):
        jet = network_jets(params, x, spec, cfg, shard=shard)
        return -0.5 * (jet.lap + fl._tsum(jet.jac**2, shard))

    return kinetic


def make_logpsi_and_kinetic(network, shard=None) -> Callable:
    """(params, x) -> (log psi (B,) complex, kinetic (B,) complex) in one
    pass; `shard` as in make_kinetic_forward."""
    spec, cfg = network.spec, network.cfg
    _check_shard(spec, shard)

    def both(params, x):
        jet = network_jets(params, x, spec, cfg, shard=shard)
        return jet.val, -0.5 * (jet.lap + fl._tsum(jet.jac**2, shard))

    return both
