"""The determinant head's one-pass tangent stream (fl.det_head_jet over
dethead_kernels.dethead_traces) against the composition it stands for
(the orbital GEMM's Jacobian -> complexify -> fl.mul_row ->
fl.slogdet_jet), on the CPU, where the wrapper takes its plain version.

Small shapes: one channel of n 4-6 electrons beside another of 4, T =
3 N_total, 2 walkers, 2 determinants; float32 and float64; the channel
first or second (offset 0 or 4); with and without the row-constant
block's tangents; the whole tangent axis or a shard's window whose edges
cut through an electron's three tangents of the channel's slab; the
tangents in one window or in windows of 4, whose edges cut through an
electron's three tangents too. Then network_jets on a tiny LiH cell, for
spin channels and for one full determinant, with the head in one window
against the plain version in windows (dethead_kernels.serves answering
no, the card's path past the kernel's largest n) and against the JAX
package. Tolerances: float64 1e-12 of the scale (the same contractions in
another order), float32 2e-5.
"""

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch.models import fwdlap_forward as tff
from deepsolid_tpu_torch.ops import fwdlap as fl
from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh
from torch_helpers import networks, t64, walkers

OTHER = 4  # electrons of the other spin channel
DETS, BATCH = 2, 2


class Window:
    """A deriv shard's place without ranks: tangents [t0, t0 + T_local)
    of the axis, and a sum over one rank."""

    def __init__(self, t0):
        self._t0 = t0

    def t0(self, t_loc):
        return self._t0

    def all_sum(self, x):
        return x


def _close(got, want, tol):
    scale = want.abs().max()
    torch.testing.assert_close(got, want, rtol=0, atol=tol * float(scale))


def _channel(n, real, jbc_on, seed):
    """A channel's orbital GEMM outputs and envelope-phase factor: the raw
    value and Laplacian (B, n, 2P), the tangent products jr (T, B, n, 2P)
    and jbc (T, B, 2P) or None, and b_val, b_jac3, b_lap."""
    gen = torch.Generator().manual_seed(seed)
    cplx = dh._COMPLEX[real]
    t_dim, two_p = 3 * (n + OTHER), 2 * DETS * n

    def rnd(*shape, dtype=real):
        return torch.randn(shape, generator=gen, dtype=dtype)

    # orbitals near a multiple of the identity in each determinant, so A
    # is well conditioned
    eye = torch.eye(n, dtype=real).repeat(1, DETS)  # (n, D n)
    val = torch.cat([3.0 * eye + 0.3 * rnd(BATCH, n, DETS * n), 0.3 * rnd(BATCH, n, DETS * n)], -1)
    lap, jr = rnd(BATCH, n, two_p), 0.3 * rnd(t_dim, BATCH, n, two_p)
    jbc = 0.3 * rnd(t_dim, BATCH, two_p) if jbc_on else None
    b_val = 1.0 + 0.1 * rnd(BATCH, DETS, n, n, dtype=cplx)
    b_jac3, b_lap = 0.3 * rnd(3, BATCH, DETS, n, n, dtype=cplx), rnd(BATCH, DETS, n, n, dtype=cplx)
    return val, lap, jr, jbc, b_val, b_jac3, b_lap


def _orbitals(raw, n):
    """network_jets' complexify and (B, n, D n) -> (B, D, n, n) reshape."""
    p = raw.val.shape[-1] // 2
    orb = fl.complexify(fl.slice_axis(raw, -1, 0, p), fl.slice_axis(raw, -1, p, 2 * p))
    return fl.linear_op(lambda v: v.unflatten(-1, (DETS, n)).transpose(-3, -2), orb)


@pytest.mark.parametrize("chunk", [None, 4], ids=["one", "tc4"])
@pytest.mark.parametrize("window", [None, (4, 10), (14, 10)], ids=["all", "w4", "w14"])
@pytest.mark.parametrize("jbc_on", [True, False], ids=["jbc", "nojbc"])
@pytest.mark.parametrize("offset", [0, OTHER], ids=["first", "second"])
@pytest.mark.parametrize("real", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_one_pass_matches_composition(real, offset, jbc_on, window, chunk, monkeypatch):
    n = 5 if real == torch.float32 else 4 + offset // 2  # 5; 4 and 6 in float64
    val, lap, jr, jbc, b_val, b_jac3, b_lap = _channel(n, real, jbc_on, seed=3 + offset)
    t_dim = jr.shape[0]
    shard, t0, t_loc = None, 0, t_dim
    if window is not None:
        (t0, t_loc), shard = window, Window(window[0])
        jr = jr[t0:t0 + t_loc]
        jbc = None if jbc is None else jbc[t0:t0 + t_loc]
    tol = 2e-5 if real == torch.float32 else 1e-12

    # the composition: the GEMM's Jacobian with the broadcast add, the
    # complex copy, mul_row, slogdet_jet
    jac = jr if jbc is None else jr + jbc[:, :, None, :]
    orb = _orbitals(fl.Jet(val, jac, lap), n)
    mat = fl.mul_row(orb, b_val, b_jac3, b_lap, n_total=n + OTHER, offset=offset,
                     shard=shard)
    sign, want = fl.slogdet_jet(mat, shard=shard)

    # the plain version's tangent outputs against the composition's
    a_inv = fl.det_factor(mat.val)[0]
    trb, l2 = dh.dethead_traces(jr, jbc, b_val, b_jac3, orb.val, a_inv, offset, t0)
    lead = (BATCH, DETS)
    j2 = torch.movedim(mat.jac, 0, -2).reshape(lead + (n, t_loc * n))
    want_trb, want_l2 = fl._det_scan_traces(a_inv, j2, t_loc, n, lead)
    _close(trb, want_trb, tol)
    _close(l2, want_l2, tol)

    # the one-pass det head: the value and the Laplacian's cross term are
    # the composition's own arithmetic; the tangent outputs within rounding
    orb0 = _orbitals(fl.Jet(val, jac[:0], lap), n)
    head = (orb0.val, orb0.lap, b_val, b_jac3, b_lap, fl.sliced_window(jr, jbc), t_loc)
    got_sign, got = fl.det_head_jet(*head, offset=offset, shard=shard)
    assert torch.equal(got_sign, sign) and torch.equal(got.val, want.val)
    assert got.jac.shape == (t_loc, BATCH, DETS)
    _close(got.jac, want.jac, tol)
    _close(got.lap, want.lap, tol)
    if chunk is None:
        return

    # the same head in windows of `chunk` tangents (the scan's rule, its
    # width forced) against one window
    monkeypatch.setattr(fl, "_pick_det_scan_chunk", lambda t_dim, n: chunk)
    w_sign, windowed = fl.det_head_jet(*head, offset=offset, shard=shard, scan=True)
    assert torch.equal(w_sign, got_sign) and torch.equal(windowed.val, got.val)
    assert windowed.jac.shape == (t_loc, BATCH, DETS)
    _close(windowed.jac, got.jac, tol)
    _close(windowed.lap, got.lap, tol)


def test_split_rule():
    # up to 8 blocks a matrix, down to 16 tangents a block, never an empty
    # block: C-diamond's 288 tangents and bcc-Li's 486 take 8, a deriv
    # rank's 144 take 8 of 18, few tangents fewer blocks
    assert dh.splits(288) == 8 and dh.splits(486) == 8 and dh.splits(144) == 8
    assert dh.splits(40) == 2
    assert dh.splits(3) == 1 and dh.splits(1) == 1
    for t_loc in range(1, 300):
        s = dh.splits(t_loc)
        per = -(-t_loc // s)
        assert 1 <= s <= dh.MAX_SPLITS and (s - 1) * per < t_loc
        assert s == 1 or per >= dh.MIN_TANGENTS_PER_BLOCK
    assert dh.serves(200, torch.float64, torch.device("cpu"))
    assert dh.serves(96, torch.float32, torch.device("cuda"))
    assert dh.serves(112, torch.float32, torch.device("cuda"))
    assert dh.serves(119, torch.float32, torch.device("cuda"))
    assert not dh.serves(120, torch.float32, torch.device("cuda"))
    assert not dh.serves(85, torch.float64, torch.device("cuda"))


@pytest.mark.parametrize("cfg", [dict(full_det=False),
                                 dict(full_det=False, use_last_layer=True),
                                 dict(full_det=True),
                                 dict(full_det=True, use_last_layer=True)],
                         ids=["spins", "spins_last", "full_det", "full_det_last"])
def test_network_jets_one_pass_matches_composition_and_jax(cfg, monkeypatch):
    """The det head in one window against the plain version in windows
    (`serves` answering no: the card's path past the kernel's largest n)
    and against the JAX package: one det head call a matrix, a spin
    channel's or full_det's one."""
    import jax
    import jax.numpy as jnp

    from deepsolid_tpu.models import fwdlap_forward as jff

    jnet, tnet, params, tp, jsc = networks(hidden_dims=((8, 4), (8, 4)), determinants=2,
                                           **cfg)
    x = walkers(3, jsc.nelectron, seed=8)
    calls = []
    plain = dh.dethead_traces_plain

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(dh, "dethead_traces_plain", counting)
    spec = tnet.spec
    sides = [spec.nelectron] if tnet.cfg.full_det else [s for s in spec.spins if s > 0]
    t_dim = 3 * spec.nelectron
    with torch.no_grad():
        one_pass = tff.network_jets(tp, t64(x), spec, tnet.cfg)
        assert len(calls) == len(sides)
        monkeypatch.setattr(dh, "serves", lambda *args: False)
        windowed = tff.network_jets(tp, t64(x), spec, tnet.cfg)
        assert len(calls) == len(sides) + sum(t_dim // fl._pick_det_scan_chunk(t_dim, n)
                                              for n in sides)
    want = jax.jit(jax.vmap(lambda xi: jff.network_jets(params, xi, jnet.spec, jnet.cfg)))(
        jnp.asarray(x))
    for got, plain_w, jax_w in ((one_pass.val, windowed.val, want.val),
                                (one_pass.jac, windowed.jac,
                                 np.moveaxis(np.asarray(want.jac), 0, 1)),
                                (one_pass.lap, windowed.lap, want.lap)):
        _close(got, plain_w, 1e-12)
        _close(got, torch.as_tensor(np.array(jax_w)), 1e-10)
