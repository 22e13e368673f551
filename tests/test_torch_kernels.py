"""The port's kernels: plain versions against the JAX kernels, and dispatch.

The JAX kernels run as the JAX package's own tests run them on the CPU:
the Gauss-Jordan kernel through gj_inverse_slogdet_interpret, the jet
kernels through pl.pallas_call(interpret=True). The CUDA kernels
themselves run only on the card: tests/test_torch_cuda_kernels.py, and
chip_smoke.py at the main path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deepsolid_tpu.ops.pallas import jet_kernels as jjk
from deepsolid_tpu.ops.pallas.det_kernels import gj_inverse_slogdet_interpret
from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.ops.cuda import det_kernels as tdk
from deepsolid_tpu_torch.ops.cuda import jet_kernels as tjk


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jjk.pl, "pallas_call", interp_call)


def _complex64(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _assert_gj_close(got, want, inv_tol, det_tol=1e-5):
    ainv, sign, logabs = got
    np.testing.assert_allclose(ainv.numpy(), np.asarray(want[0]), rtol=inv_tol,
                               atol=inv_tol)
    np.testing.assert_allclose(sign.numpy(), np.asarray(want[1]), atol=det_tol)
    np.testing.assert_allclose(logabs.numpy(), np.asarray(want[2]), atol=det_tol)


# ---- B1: Gauss-Jordan inverse + slogdet -----------------------------------


# (2, 81): bcc-Li 3x3x3's n; (40, 14): Si's; (8, 17), (4, 32): both ends of
# the warp body's one-matrix-a-warp range
@pytest.mark.parametrize("b,n", [(3, 5), (4, 13), (1, 48), (130, 16), (2, 81), (40, 14),
                                 (8, 17), (4, 32)])
def test_gj_plain_matches_jax_kernel(b, n):
    a = _complex64((b, n, n), seed=b * 100 + n)
    got = tdk.gj_inverse_slogdet_plain(torch.from_numpy(a))
    want = gj_inverse_slogdet_interpret(jnp.asarray(a))
    # complex64 on both sides: f32 rounding of the same elimination,
    # amplified by the matrices' conditioning. The sign and log|det| sum n
    # rounded factors: at n = 81 each side lies up to 3e-5 from numpy's
    # complex128 answer (the two sides 1.9e-5 apart), so 4e-5 there
    _assert_gj_close(got, want, inv_tol=2e-4, det_tol=1e-5 if n <= 48 else 4e-5)


def test_gj_plain_zero_diagonal_and_permutation():
    a = np.array([[[0, 1 + 1j], [2 - 1j, 0]]], np.complex64)
    _assert_gj_close(tdk.gj_inverse_slogdet_plain(torch.from_numpy(a)),
                     gj_inverse_slogdet_interpret(jnp.asarray(a)), inv_tol=1e-6)
    perm = np.roll(np.eye(6), 2, axis=0)[None].astype(np.complex64)
    ainv, sign, logabs = tdk.gj_inverse_slogdet_plain(torch.from_numpy(perm))
    want = gj_inverse_slogdet_interpret(jnp.asarray(perm))
    np.testing.assert_array_equal(ainv.numpy()[0], perm[0].T)  # exact
    np.testing.assert_array_equal(sign.numpy(), np.asarray(want[1]))
    assert float(logabs[0]) == float(want[2][0]) == 0.0


def test_gj_plain_zero_pivot_gives_minus_inf():
    """A pivot of exactly zero gives log 0 = -inf, as in JAX, and no error."""
    a = np.diag([1.0, 2.0, 0.0]).astype(np.complex64)[None]
    _, _, logabs = tdk.gj_inverse_slogdet_plain(torch.from_numpy(a))
    _, _, want = gj_inverse_slogdet_interpret(jnp.asarray(a))
    assert float(logabs[0]) == float(want[0]) == -np.inf


def test_gj_plain_batch_axes_and_float64():
    a = _complex64((2, 3, 7, 7), seed=9).astype(np.complex128)
    ainv, sign, logabs = tdk.gj_inverse_slogdet_plain(torch.from_numpy(a))
    assert ainv.shape == (2, 3, 7, 7) and sign.shape == logabs.shape == (2, 3)
    rs, rl = np.linalg.slogdet(a)
    np.testing.assert_allclose(ainv.numpy(), np.linalg.inv(a), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sign.numpy(), rs, atol=1e-12)
    np.testing.assert_allclose(logabs.numpy(), rl, atol=1e-12)


def _gj_edge_matrices():
    """Matrices that exercise the pivot rule, by name."""
    rng = np.random.RandomState(11)
    eye = np.eye(12)
    tie = rng.randn(12, 12) + 1j * rng.randn(12, 12)
    tie[3, 0], tie[7, 0] = 5.0, 5.0j       # equal |.|^2 in the first pivot column
    nan_col = rng.randn(12, 12) + 1j * rng.randn(12, 12)
    nan_col[:, 4] = np.nan
    return {"anti_diagonal": np.fliplr(eye),   # a swap at every step
            "permutation": np.roll(eye, 5, axis=0),
            "tie": tie, "nan_column": nan_col}


@pytest.mark.parametrize("name", ["anti_diagonal", "permutation", "tie"])
def test_gj_plain_edge_matrices_match_numpy_float64(name):
    """What the card's kernel is compared with is itself held: the plain
    version in complex128 against numpy.linalg on the pivot-rule cases."""
    a = _gj_edge_matrices()[name].astype(np.complex128)[None]
    ainv, sign, logabs = tdk.gj_inverse_slogdet_plain(torch.from_numpy(a))
    rs, rl = np.linalg.slogdet(a)
    np.testing.assert_allclose(ainv.numpy(), np.linalg.inv(a), rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(sign.numpy(), rs, atol=1e-12)
    np.testing.assert_allclose(logabs.numpy(), rl, atol=1e-11)


@pytest.mark.parametrize("name", ["anti_diagonal", "permutation", "tie", "nan_column"])
def test_gj_plain_edge_matrices_match_jax_kernel(name):
    a = _gj_edge_matrices()[name].astype(np.complex64)[None]
    got = tdk.gj_inverse_slogdet_plain(torch.from_numpy(a))
    want = gj_inverse_slogdet_interpret(jnp.asarray(a))
    if name == "nan_column":
        # no candidate wins the column: the plain version pivots on a NaN
        # (log|det| NaN), the JAX kernel on no row at all (a zero pivot,
        # log|det| -inf); neither faults and neither answer is finite
        assert not np.isfinite(got[2].numpy()).any()
        assert not np.isfinite(np.asarray(want[2])).any()
        assert not np.isfinite(got[1].numpy()).any()
        assert not np.isfinite(np.asarray(want[1])).any()
        return
    # complex64 on both sides; the same pivots, so only f32 rounding order
    _assert_gj_close(got, want, inv_tol=2e-5)


class _FakeGjLibrary:
    """Stands in for the built library: the size rule of csrc/gj_inverse.cu
    (gj_body: 1 warp, 2 registers, 3 mid, 4 mid wide, 0 shared) and a card
    with 227 KB of shared memory per block."""

    def gj_body(self, n):
        if n <= 32:
            return 1
        if n == 48:
            return 2
        return 3 if 49 <= n <= 96 else 4 if 97 <= n <= 128 else 0

    def gj_smem_bytes(self, n):
        body = self.gj_body(n)
        if body == 0:
            return n * n * 8 + 3 * n * 8 + n * 4
        return n * (n + 1) * 8 if body in (3, 4) else 0

    def gj_max_smem_optin(self, device):
        return 232448


@pytest.mark.parametrize("n,want", [(48, "registers"), (13, "warp"), (96, "mid"),
                                    (47, "shared"), (168, "shared"), (169, None),
                                    (400, None), (1, "warp"), (5, "warp"), (14, "warp"),
                                    (16, "warp"), (17, "warp"), (32, "warp"),
                                    (33, "shared"), (49, "mid"), (81, "mid"),
                                    (97, "mid, wide"), (112, "mid, wide"),
                                    (128, "mid, wide"), (129, "shared")])
def test_gj_variant_is_chosen_by_size_alone(n, want):
    lib, dev = _FakeGjLibrary(), torch.device("cuda", 0)
    if want is None:  # beyond the shared-memory guard: raises, no fallback
        with pytest.raises(ValueError, match="shared memory"):
            tdk.variant(lib, n, dev)
    else:
        assert tdk.variant(lib, n, dev) == want


def test_gj_fake_library_follows_the_source():
    """_FakeGjLibrary's size rule is the one csrc/gj_inverse.cu states."""
    text = (build.CSRC / "gj_inverse.cu").read_text()
    assert "if (n <= 32) return 1;" in text
    assert "if (n == 48) return 2;" in text
    assert "constexpr int kMidMin = 49;" in text and "constexpr int kMidN = 96;" in text
    assert "if (n >= kMidMin && n <= kMidN) return 3;" in text
    assert "constexpr int kMidWideN = 128;" in text
    assert "if (n > kMidN && n <= kMidWideN) return 4;" in text
    assert tdk.BODIES == ("shared", "warp", "registers", "mid", "mid, wide")


def test_gj_wrapper_asks_the_size_rule_before_it_launches(monkeypatch):
    """The CUDA path consults `variant` (and so raises beyond the guard)
    for every tensor it is handed, and never reaches the plain version."""
    _forbid(monkeypatch, tdk, "gj_inverse_slogdet_plain")
    monkeypatch.setattr(tdk, "_lib", lambda: _FakeGjLibrary())
    seen, bodies = [], []
    real = tdk.variant

    def asked(lib, n, dev):
        seen.append(n)
        bodies.append((n, real(lib, n, dev)))
        return bodies[-1][1]

    monkeypatch.setattr(tdk, "variant", asked)

    class _OnCard:  # a tensor's face, as far as the checks before the launch look
        device = torch.device("cuda", 0)
        dtype = torch.complex64
        ndim = 3
        shape = (2, 400, 400)

    with pytest.raises(ValueError, match="shared memory"):
        tdk._gj_cuda(_OnCard())
    assert seen == [400]
    # every body is named by the rule before the launch: the face has no
    # storage, so the wrapper stops right after asking
    for n, body in ((14, "warp"), (48, "registers"), (81, "mid"), (40, "shared")):
        _OnCard.shape = (2, n, n)
        with pytest.raises(AttributeError):
            tdk._gj_cuda(_OnCard())
        assert bodies[-1] == (n, body)
    assert seen == [400, 14, 48, 81, 40]


# ---- B2/B3: fused dense + tanh jet ------------------------------------------


def _jet_case(t_dim, n, d_in, d_out, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d_in), rng.randn(t_dim, n, d_in), rng.randn(n, d_in),
            rng.randn(d_in, d_out) / np.sqrt(d_in), rng.randn(d_out))


@pytest.mark.parametrize("shape", [(12, 10, 20, 12), (8, 4, 132, 256)])
def test_dense_tanh_jet_plain_matches_jax_kernel(shape, interpret_pallas):
    case = [a.astype(np.float32) for a in _jet_case(*shape)]
    # block_t=4 < T: the kernel accumulates the tangent square sum over
    # several sequential grid steps
    want = jjk.fused_dense_tanh_jet(*map(jnp.asarray, case), block_n=8,
                                    block_c=128, block_t=4)
    got = tjk.fused_dense_tanh_jet_plain(*map(torch.from_numpy, case))
    for g, w, name in zip(got, want, ("val", "jac", "lap")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)  # f32 sum order


@pytest.mark.parametrize("shape", [(12, 10, 20, 12), (9, 16, 40, 130)])
def test_dense_tanh_jet_mix_plain_matches_jax_kernel(shape, interpret_pallas):
    t_dim, n, d_in, d_out = shape
    val, jac, lap, w, b = _jet_case(*shape, seed=1)
    rng = np.random.RandomState(2)
    zbc, lbc, jbc = rng.randn(d_out), rng.randn(d_out), rng.randn(t_dim, d_out)
    args = [a.astype(np.float32) for a in (val, jac, lap, zbc, lbc, jbc, w, b)]
    want = jjk.fused_dense_tanh_jet_mix(*map(jnp.asarray, args), block_n=8,
                                        block_c=128, block_t=4)
    val, jac, lap, zbc, lbc, jbc, w, b = map(torch.from_numpy, args)
    got = tjk.fused_dense_tanh_jet_mix_plain(val[None], jac[:, None], lap[None],
                                             zbc[None], lbc[None], jbc[:, None], w, b)
    for g, wnt, name in zip(got, want, ("val", "jac", "lap")):
        np.testing.assert_allclose(g.numpy()[:, 0] if name == "jac" else g.numpy()[0],
                                   np.asarray(wnt), rtol=2e-5, atol=2e-5, err_msg=name)


def test_dense_tanh_jet_mix_plain_groups_are_walkers():
    """Each walker's row-constant terms reach its own rows only."""
    t_dim, groups, n, d_in, d_out = 5, 3, 4, 6, 7
    rng = np.random.RandomState(3)
    val, jac, lap = (torch.from_numpy(rng.randn(*s)) for s in
                     [(groups, n, d_in), (t_dim, groups, n, d_in), (groups, n, d_in)])
    zbc, lbc = (torch.from_numpy(rng.randn(groups, d_out)) for _ in range(2))
    jbc = torch.from_numpy(rng.randn(t_dim, groups, d_out))
    w, b = torch.from_numpy(rng.randn(d_in, d_out)), torch.from_numpy(rng.randn(d_out))
    got = tjk.fused_dense_tanh_jet_mix_plain(val, jac, lap, zbc, lbc, jbc, w, b)
    for g in range(groups):
        one = tjk.fused_dense_tanh_jet_mix_plain(
            val[g:g + 1], jac[:, g:g + 1], lap[g:g + 1], zbc[g:g + 1],
            lbc[g:g + 1], jbc[:, g:g + 1], w, b)
        for x, y in zip(got, one):
            # f64; batched and single-walker products may block differently
            torch.testing.assert_close(x.narrow(x.ndim - 3, g, 1), y,
                                       rtol=1e-12, atol=1e-12)


# ---- B4a/B4b: the open ("partial") forms -------------------------------------


def _mix_case(t_dim, n, d_in, d_out, seed):
    val, jac, lap, w, b = _jet_case(t_dim, n, d_in, d_out, seed=seed)
    rng = np.random.RandomState(seed + 1)
    return (val, jac, lap, rng.randn(d_out), rng.randn(d_out),
            rng.randn(t_dim, d_out), w, b)


def _batched_mix(args):
    """The JAX kernel's one-walker mix layout as the port's (G=1, ...)."""
    val, jac, lap, zbc, lbc, jbc, w, b = map(torch.from_numpy, args)
    return (val[None], jac[:, None], lap[None], zbc[None], lbc[None],
            jbc[:, None], w, b)


@pytest.mark.parametrize("shape", [(12, 10, 20, 12), (7, 4, 132, 256)])
def test_dense_tanh_jet_partial_plain_matches_jax_kernel(shape, interpret_pallas):
    # the JAX kernel keeps float32 scratch, so it runs in float32 only:
    # 2e-5, the f32 rounding of sums taken in another order (as for B2/B3).
    # The identity the open form exists for is held to 1e-12 in float64
    # below (test_partial_forms_recombine_to_the_closed_rule).
    case = [a.astype(np.float32) for a in _jet_case(*shape, seed=5)]
    want = jjk.fused_dense_tanh_jet_partial(*map(jnp.asarray, case), block_n=8,
                                            block_c=128, block_t=4)
    got = tjk.fused_dense_tanh_jet_partial_plain(*map(torch.from_numpy, case))
    assert len(got) == len(want) == 4
    for g, w, name in zip(got, want, ("val", "jac", "lap_part", "s_local")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(12, 10, 20, 12), (9, 16, 40, 130)])
def test_dense_tanh_jet_mix_partial_plain_matches_jax_kernel(shape, interpret_pallas):
    args = [a.astype(np.float32) for a in _mix_case(*shape, seed=6)]  # as above
    want = jjk.fused_dense_tanh_jet_mix_partial(*map(jnp.asarray, args), block_n=8,
                                                block_c=128, block_t=4)
    got = tjk.fused_dense_tanh_jet_mix_partial_plain(*_batched_mix(args))
    for g, wnt, name in zip(got, want, ("val", "jac", "lap_part", "s_local")):
        np.testing.assert_allclose(g.numpy()[:, 0] if name == "jac" else g.numpy()[0],
                                   np.asarray(wnt), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("pieces", [(6, 6), (5, 7), (1, 4, 7)])
def test_partial_forms_recombine_to_the_closed_rule(pieces):
    """Open form on each piece of the tangent axis (T_local of no round
    size), s summed over the pieces, the Laplacian closed: the closed
    rule on the whole axis, for both rules. rtol 1e-12 (float64)."""
    args = _batched_mix(_mix_case(12, 10, 20, 12, seed=7))
    val, jac, lap, zbc, lbc, jbc, w, b = args
    bounds = np.cumsum((0,) + pieces)
    cuts = [slice(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
    for closed, parts in [
        (tjk.fused_dense_tanh_jet_mix(*args),
         [tjk.fused_dense_tanh_jet_mix_partial(val, jac[c], lap, zbc, lbc, jbc[c], w, b)
          for c in cuts]),
        (tjk.fused_dense_tanh_jet(val[0], jac[:, 0], lap[0], w, b),
         [tjk.fused_dense_tanh_jet_partial(val[0], jac[c, 0], lap[0], w, b)
          for c in cuts]),
    ]:
        v, j, l = closed
        torch.testing.assert_close(parts[0][0], v, rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([p[1] for p in parts]), j,
                                   rtol=1e-12, atol=1e-12)
        got = tjk.close_laplacian(v, parts[0][2], sum(p[3] for p in parts))
        torch.testing.assert_close(got, l, rtol=1e-12, atol=1e-12)


# ---- wrapper dispatch -------------------------------------------------------


def _forbid(monkeypatch, module, name):
    def boom(*args, **kwargs):
        raise AssertionError(f"{name} reached the plain version")

    monkeypatch.setattr(module, name, boom)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    shapes = tdk.SHAPES + tjk.SHAPES
    a = torch.from_numpy(_complex64((2, 4, 4), seed=1))
    for x, y in zip(tdk.gj_inverse_slogdet(a), tdk.gj_inverse_slogdet_plain(a)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    case = [torch.from_numpy(c) for c in _jet_case(3, 5, 4, 6)]
    for x, y in zip(tjk.fused_dense_tanh_jet(*case),
                    tjk.fused_dense_tanh_jet_plain(*case)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert tdk.SHAPES + tjk.SHAPES == shapes  # no kernel launched


@pytest.mark.parametrize("slices,label", [
    (tjk.PAIR, "pair"), (4, "wide, 4 tangent slices"), (1, "wide, 1 tangent slices"),
    (0, "general")])
def test_variant_label(slices, label):
    """The words the launch-shape record gives each kernel body."""
    assert tjk.variant_label(slices) == label


def test_wrappers_never_fall_back_for_non_cpu_tensors(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises for anything but a CUDA tensor; the plain version is not used."""
    _forbid(monkeypatch, tdk, "gj_inverse_slogdet_plain")
    _forbid(monkeypatch, tjk, "fused_dense_tanh_jet_plain")
    _forbid(monkeypatch, tjk, "fused_dense_tanh_jet_mix_plain")
    _forbid(monkeypatch, tjk, "fused_dense_tanh_jet_partial_plain")
    _forbid(monkeypatch, tjk, "fused_dense_tanh_jet_mix_partial_plain")
    # float32 / complex64 and float64 / complex128 (precision='float64')
    for real, cplx in ((torch.float32, torch.complex64),
                       (torch.float64, torch.complex128)):
        meta = dict(device="meta", dtype=real)
        with pytest.raises(ValueError, match="CUDA"):
            tdk.gj_inverse_slogdet(torch.empty(2, 4, 4, device="meta", dtype=cplx))
        with pytest.raises(ValueError, match="CUDA"):
            tjk.fused_dense_tanh_jet(*(torch.empty(s, **meta) for s in
                                       [(5, 4), (3, 5, 4), (5, 4), (4, 6), (6,)]))
        with pytest.raises(ValueError, match="CUDA"):
            tjk.fused_dense_tanh_jet_mix(*(torch.empty(s, **meta) for s in
                                           [(2, 5, 4), (3, 2, 5, 4), (2, 5, 4), (2, 6),
                                            (2, 6), (3, 2, 6), (4, 6), (6,)]))
        with pytest.raises(ValueError, match="CUDA"):
            tjk.fused_dense_tanh_jet_partial(*(torch.empty(s, **meta) for s in
                                               [(5, 4), (3, 5, 4), (5, 4), (4, 6),
                                                (6,)]))
        with pytest.raises(ValueError, match="CUDA"):
            tjk.fused_dense_tanh_jet_mix_partial(
                *(torch.empty(s, **meta) for s in
                  [(2, 5, 4), (3, 2, 5, 4), (2, 5, 4), (2, 6), (2, 6), (3, 2, 6),
                   (4, 6), (6,)]))


def test_trunk_rules_without_bias_still_reach_the_kernel(monkeypatch):
    """A bias-free layer runs the kernel with a zero bias: on a tensor
    that is not on the CPU it reaches the kernel path, never a plain rule."""
    from deepsolid_tpu_torch.ops import fwdlap as tfl

    _forbid(monkeypatch, tjk, "fused_dense_tanh_jet_plain")
    _forbid(monkeypatch, tjk, "fused_dense_tanh_jet_mix_plain")
    _forbid(monkeypatch, tfl, "tanh")

    def jet(*shape):
        return tfl.Jet(torch.empty(shape, device="meta"),
                       torch.empty((3,) + shape, device="meta"),
                       torch.empty(shape, device="meta"))

    w = torch.empty(4, 6, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfl.dense_tanh(jet(2, 5, 5, 4), w, None)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.dense_tanh_mix(jet(2, 5, 4), jet(2, 1, 3), w,
                           torch.empty(3, 6, device="meta"), None)


def test_sharded_trunk_rules_reach_the_open_kernels(monkeypatch):
    """With a shard, dense_tanh and dense_tanh_mix go to the open kernels'
    wrappers (which raise for a tensor that is neither CPU nor CUDA), not
    to the closed ones and not to a plain rule."""
    from deepsolid_tpu_torch.ops import fwdlap as tfl
    from deepsolid_tpu_torch.parallel import TangentShard

    for name in ("fused_dense_tanh_jet", "fused_dense_tanh_jet_mix",
                 "fused_dense_tanh_jet_partial_plain",
                 "fused_dense_tanh_jet_mix_partial_plain"):
        _forbid(monkeypatch, tjk, name)

    def jet(*shape):
        return tfl.Jet(torch.empty(shape, device="meta"),
                       torch.empty((3,) + shape, device="meta"),
                       torch.empty(shape, device="meta"))

    w, b = torch.empty(4, 6, device="meta"), torch.empty(6, device="meta")
    shard = TangentShard(0, 2)
    with pytest.raises(ValueError, match="fused_dense_tanh_jet_partial kernel needs CUDA"):
        tfl.dense_tanh(jet(2, 5, 5, 4), w, b, shard=shard)
    with pytest.raises(ValueError, match="fused_dense_tanh_jet_mix_partial kernel needs CUDA"):
        tfl.dense_tanh_mix(jet(2, 5, 4), jet(2, 1, 3), w,
                           torch.empty(3, 6, device="meta"), b, shard=shard)


@pytest.mark.parametrize("shape,sms,slices", [
    ((6, 64 * 96 * 96, 32, 32), 132, 0),   # two-electron layers: never wide
    ((288, 6144, 320, 256), 132, 4),       # one-electron layers: 96 blocks per
    ((288, 6144, 16, 256), 132, 4),        # slice, 2.9 waves of one block per SM
    ((144, 6144, 320, 256), 132, 4),       # a rank's half of the tangents
    ((144, 6144, 16, 256), 132, 4),
    ((144, 6144, 256, 256), 132, 4),       # the open plain rule at 256 -> 256
    ((3, 64 * 96 * 96, 32, 32), 132, 0),   # open form at the pair shape
    ((4, 6144, 320, 256), 132, 1),         # under one wave: slicing buys nothing
    ((1, 130, 8, 128), 132, 1),            # T smaller than any slicing
    ((288, 10 ** 6, 320, 256), 132, 1),    # a full grid needs no slicing
    ((50, 385, 40, 256), 132, 13),         # ragged rows, T no multiple of the slices
    ((288, 6144, 384, 256), 132, 4),       # the largest resident slice of w
    ((288, 6144, 388, 256), 132, 0),       # w's slice does not fit: general
    ((288, 6144, 512, 256), 132, 0),
    ((288, 6144, 318, 256), 132, 0),       # d_in not a multiple of 4
    ((288, 6144, 320, 200), 132, 0),       # d_out not a multiple of 64
])
def test_variant_is_chosen_by_shape(shape, sms, slices):
    t_dim, rows, d_in, d_out = shape
    assert tjk.wide_slices(*shape, sms) == slices
    if slices:
        # what the launcher is handed: `slices` partial sums of rows x d_out,
        # every slice holding at least one tangent under its ceil rule
        assert 1 <= slices <= t_dim
        per = tjk.slice_tangents(t_dim, slices)
        assert (slices - 1) * per < t_dim <= slices * per
        assert d_in <= tjk.WIDE_MAX_D_IN and d_out % tjk.WIDE_COLS == 0


@pytest.mark.parametrize("d_in,d_out,mixed,pair", [
    (4, 32, False, True),     # the first two-electron layer
    (32, 32, False, True),    # the second
    (4, 32, True, False),     # the mix rule has no pair body
    (32, 32, True, False),
    (8, 32, False, False),    # d_in neither 4 nor 32
    (16, 32, False, False),
    (32, 64, False, False),   # d_out off the pair width: wide
    (32, 40, False, False),   # general
    (4, 16, False, False),
])
def test_pair_body_is_chosen_by_shape(d_in, d_out, mixed, pair):
    """Which (d_in, d_out, rule) take the streaming pair body; every other
    shape falls to the wide or the general kernel, whatever T and rows."""
    assert tjk.pair_body(d_in, d_out, mixed) is pair
    for t_dim, rows in ((6, 64 * 96 * 96), (3, 333), (0, 5)):
        got = tjk.kernel_variant(t_dim, rows, d_in, d_out, mixed, 132)
        assert (got == tjk.PAIR) is pair
        if not pair:
            assert got == tjk.wide_slices(t_dim, rows, d_in, d_out, 132) >= 0


def test_pair_constants_match_the_source():
    text = (build.CSRC / "dense_tanh_jet.cu").read_text()
    assert f"constexpr int kPC = {tjk.PAIR_D_OUT};" in text
    for d_in in tjk.PAIR_D_IN:
        assert f"launch_pair<{d_in}>" in text
    assert "if (slices < 0)" in text and tjk.PAIR < 0
    # w and b, and per warp three ring stages of 32 rows x (d_in + 4) floats
    # and the staging tile: two blocks of six warps fit an SM's 228 KB with
    # the 1 KB the system keeps per block
    assert "constexpr int kPWarps = 6;" in text and "constexpr int kPStages = 3;" in text
    block = 4 * (33 * 32 + 6 * (3 * 32 * 36 + 32 * 36))
    assert 2 * (block + 1024) <= 228 * 1024


@pytest.mark.parametrize("open_sum", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("t_dim,rows,d_in", [
    (6, 81, 4), (6, 81, 32),   # T = 6; 81 rows: no multiple of any tile
    (3, 64, 4), (3, 77, 32),   # T_local = 3 of a 2-way deriv axis
])
def test_pair_shapes_plain_matches_jax_kernel(t_dim, rows, d_in, open_sum,
                                              interpret_pallas):
    """The plain version the pair body is held against on the card, against
    the JAX kernel in interpret mode at the pair layers' widths. 2e-5: f32
    sums in another order."""
    case = [a.astype(np.float32) for a in _jet_case(t_dim, rows, d_in, 32, seed=9)]
    name = "fused_dense_tanh_jet" + ("_partial" if open_sum else "")
    want = getattr(jjk, name)(*map(jnp.asarray, case), block_n=8, block_c=128,
                              block_t=2)
    got = getattr(tjk, name + "_plain")(*map(torch.from_numpy, case))
    assert len(got) == len(want) == (4 if open_sum else 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_wide_tiling_constants_match_the_source():
    text = (build.CSRC / "dense_tanh_jet.cu").read_text()
    assert f"constexpr int kWM = {tjk.WIDE_ROWS};" in text
    assert f"constexpr int kWN = {tjk.WIDE_COLS};" in text
    assert f"constexpr int kWMaxK = {tjk.WIDE_MAX_D_IN};" in text
    # the resident slice of w, the tanh tile and either ring fit the 227 KB
    # a block may use at the largest d_in each ring is taken for
    k16 = -(-tjk.WIDE_MAX_D_IN // 16) * 16
    assert 4 * (k16 * 64 + 256 * 64 + 3 * 256 * 20) <= 232448
    assert 4 * (320 * 64 + 256 * 64 + 2 * 256 * 36) <= 232448


def test_ptxas_resources_are_parsed():
    log = """[gj_inverse] ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__8a1b2c3d_13_gj_inverse_cu_1234567819gj_registers_kernelILi48EEEvPK6float2PS1_S4_Pfi' for 'sm_90a'
ptxas info    : Function properties for _ZN58_GLOBAL__N__x19gj_registers_kernelILi48EEEvPK6float2PS1_S4_Pfi
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 186 registers, used 1 barriers, 39936 bytes smem, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__8a1b2c3d_13_gj_inverse_cu_1234567816gj_shared_kernelEPK6float2PS1_S4_Pfi' for 'sm_90a'
ptxas info    : Function properties for _ZN58_GLOBAL__N__x16gj_shared_kernelEPK6float2PS1_S4_Pfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""
    assert build.resources(log) == [
        {"kernel": "gj_registers_kernelILi48EE", "spill_store_bytes": 8,
         "spill_load_bytes": 12, "registers": 186, "static_smem_bytes": 39936},
        {"kernel": "gj_shared_kernel", "spill_store_bytes": 0,
         "spill_load_bytes": 0, "registers": 32, "static_smem_bytes": 0}]
    assert build.resources("") == []


def test_kernel_inputs_are_dense_and_16_byte_aligned():
    base = torch.arange(40, dtype=torch.float32)
    aligned = tjk._dense(base)
    assert aligned.data_ptr() == base.data_ptr()  # nothing copied
    offset = base[1:]
    assert offset.is_contiguous() and offset.data_ptr() % 16 != 0
    fixed = tjk._dense(offset)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, offset)
    strided = tjk._dense(base.reshape(8, 5).T)
    assert strided.is_contiguous() and strided.data_ptr() % 16 == 0


def test_missing_toolchain_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("gj_inverse", {})


def test_kernel_sources_target_hopper():
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    sources = sorted(p for p in build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    assert {p.stem for p in sources if p.suffix == ".cu"} == set(build.SOURCES)
    for path in sources:
        text = path.read_text()
        assert "deepsolid_tpu/ops/pallas/" in text  # names the TPU kernel it replaces
        assert "What bounds it on this card" in text
        assert "torch/extension.h" not in text and "cublas" not in text.lower()
        if path.suffix == ".cu":
            assert 'extern "C"' in text
