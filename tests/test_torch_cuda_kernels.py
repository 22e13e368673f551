"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: skipped without an NVIDIA GPU. This file imports no JAX,
so it also runs on a GPU machine without JAX; there, from the repo root:
    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
(tests/conftest.py configures JAX for the rest of the suite).
"""

import pytest
import torch

from deepsolid_tpu_torch.ops.cuda import det_kernels as tdk
from deepsolid_tpu_torch.ops.cuda import dethead_kernels as tdh
from deepsolid_tpu_torch.ops.cuda import jet_kernels as tjk
from deepsolid_tpu_torch.ops.cuda import time_kernels as tk

# f32 on the card against f32 plain versions: sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches(module, name):
    """Launches of kernel `name` the wrapper module has counted: its
    SHAPES summed over shapes and bodies."""
    return sum(c for (kernel, _, _), c in module.SHAPES.items() if kernel == name)


def _rnd(gen, dev):
    return lambda *s: torch.randn(s, generator=gen, device=dev)


def _gj_body(n):
    """The body csrc/gj_inverse.cu's gj_body gives n x n matrices."""
    if n <= 32:
        return "warp"
    if n == 48:
        return "registers"
    if 49 <= n <= 96:
        return "mid"
    return "mid, wide" if 97 <= n <= 128 else "shared"


@pytest.mark.cuda
def test_gj_kernel_matches_plain(cuda_device):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    # every body at the production sizes (14, 48, 81, 112) and at both ends
    # of its range: warp 1-16 (two matrices a warp) and 17-32, shared 33-47,
    # registers 48, mid 49-96, mid wide 97-128, shared again from 129 (above
    # 48 KB of shared memory, by opt-in)
    for n in (1, 5, 13, 14, 16, 17, 32, 33, 47, 48, 49, 81, 96, 97, 100, 112, 128, 129):
        a = torch.complex(rnd(64, n, n), rnd(64, n, n)) + 4.0 * torch.eye(n, device=cuda_device)
        before = _launches(tdk, "gj_inverse_slogdet")
        key = ("gj_inverse_slogdet", (64, n, n), _gj_body(n))
        shape_before = tdk.SHAPES[key]
        got = tdk.gj_inverse_slogdet(a)
        assert _launches(tdk, "gj_inverse_slogdet") == before + 1
        assert tdk.SHAPES[key] == shape_before + 1, (n, key)
        for x, y in zip(got, tdk.gj_inverse_slogdet_plain(a)):
            torch.testing.assert_close(x, y, rtol=2e-3, atol=2e-3)  # conditioning
    sing = torch.diag(torch.tensor([1.0, 2.0, 0.0], device=cuda_device))
    assert float(tdk.gj_inverse_slogdet(sing.to(torch.complex64)[None])[2][0]) == float("-inf")
    with pytest.raises(ValueError, match="shared memory"):
        tdk.gj_inverse_slogdet(torch.zeros(1, 400, 400, dtype=torch.complex64,
                                           device=cuda_device))
    with pytest.raises(TypeError):  # real matrices are no input of the kernel
        tdk.gj_inverse_slogdet(torch.zeros(1, 4, 4, dtype=torch.float32,
                                           device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 512])  # 1, 3: a block's second warp idle
def test_gj_register_kernel_batches(cuda_device, batch):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(5), cuda_device)
    a = torch.complex(rnd(batch, 48, 48), rnd(batch, 48, 48)) / 96**0.5
    for x, y in zip(tdk.gj_inverse_slogdet(a), tdk.gj_inverse_slogdet_plain(a)):
        torch.testing.assert_close(x, y, rtol=5e-3, atol=5e-3)  # conditioning


@pytest.mark.cuda
@pytest.mark.parametrize("n", [14, 32])  # two matrices a warp, one a warp
@pytest.mark.parametrize("batch", [1, 3, 512])  # 1, 3: the last half warp idle
def test_gj_warp_body_batches(cuda_device, batch, n):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(8), cuda_device)
    a = torch.complex(rnd(batch, n, n), rnd(batch, n, n)) / (2 * n)**0.5
    key = ("gj_inverse_slogdet", (batch, n, n), "warp")
    before = tdk.SHAPES[key]
    got = tdk.gj_inverse_slogdet(a)
    assert tdk.SHAPES[key] == before + 1
    for x, y in zip(got, tdk.gj_inverse_slogdet_plain(a)):
        torch.testing.assert_close(x, y, rtol=5e-3, atol=5e-3)  # conditioning


@pytest.mark.cuda
# the registers, warp (12, 14: Si's), mid (bcc-Li's 81), mid wide (Si
# 2x2x2's 112) and shared bodies
@pytest.mark.parametrize("n", [48, 12, 14, 81, 40, 112])
@pytest.mark.parametrize("case", ["anti_diagonal", "permutation", "tie",
                                  "zero_pivot", "nan_entry"])
def test_gj_kernel_edge_matrices(cuda_device, n, case):
    """The pivot rule's corner cases against the plain version."""
    dev = cuda_device
    rnd = _rnd(torch.Generator(device=dev).manual_seed(6), dev)
    eye = torch.eye(n, device=dev).to(torch.complex64)
    a = torch.complex(rnd(2, n, n), rnd(2, n, n))
    if case == "anti_diagonal":      # a swap at every step
        a = torch.flip(eye, [1])[None]
    elif case == "permutation":
        a = torch.roll(eye, 5, 0)[None]
    elif case == "tie":              # equal |.|^2 in the first pivot column
        a[:, 3, 0], a[:, 7, 0] = 5.0, 5.0j
    elif case == "zero_pivot":
        a[:, :, 7] = 0
    else:
        a[0, 3, 4] = float("nan")
    got, want = tdk.gj_inverse_slogdet(a), tdk.gj_inverse_slogdet_plain(a)
    torch.cuda.synchronize()
    if case in ("zero_pivot", "nan_entry"):  # no fault; non-finite where plain is
        assert torch.equal(torch.isfinite(got[2]), torch.isfinite(want[2]))
        assert not torch.isfinite(got[2][0])
        if case == "nan_entry":  # the batch's other matrix is untouched
            torch.testing.assert_close(got[2][1], want[2][1], rtol=2e-3, atol=2e-3)
        return
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=2e-3, atol=2e-3)
    if case != "tie":  # exact arithmetic on 0 and 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1].real, want[1].real)


@pytest.mark.cuda
@pytest.mark.parametrize("t_dim,rows,d_in,d_out", [
    (6, 300, 32, 32),   # pair variant, ragged row tile
    (6, 300, 32, 40),   # general variant (d_out off the pair width), ragged
    (50, 385, 40, 256), # wide, ragged rows, tangents and k-slice (16-deep ring)
    (9, 600, 64, 128),  # wide, the 32-deep ring
    (5, 100, 388, 64),  # d_in whose slice of w is not kept resident: general
    (7, 300, 20, 64),   # wide variant, ragged row tile
    (3, 50, 7, 40),     # general, d_in not a multiple of 4
])
def test_dense_tanh_jet_kernel_matches_plain(cuda_device, t_dim, rows, d_in, d_out):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(1), cuda_device)
    case = (rnd(rows, d_in), rnd(t_dim, rows, d_in), rnd(rows, d_in),
            rnd(d_in, d_out) / d_in**0.5, rnd(d_out))
    for x, y in zip(tjk.fused_dense_tanh_jet(*case), tjk.fused_dense_tanh_jet_plain(*case)):
        torch.testing.assert_close(x, y, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t_dim,groups,n,d_in,d_out", [
    (20, 3, 96, 40, 256),   # wide variant
    (9, 3, 10, 20, 40),     # general variant
])
def test_dense_tanh_jet_mix_kernel_matches_plain(cuda_device, t_dim, groups, n,
                                                 d_in, d_out):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(2), cuda_device)
    mix = (rnd(groups, n, d_in), rnd(t_dim, groups, n, d_in), rnd(groups, n, d_in),
           rnd(groups, d_out), rnd(groups, d_out), rnd(t_dim, groups, d_out),
           rnd(d_in, d_out) / d_in**0.5, rnd(d_out))
    for x, y in zip(tjk.fused_dense_tanh_jet_mix(*mix),
                    tjk.fused_dense_tanh_jet_mix_plain(*mix)):
        torch.testing.assert_close(x, y, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("open_sum", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("t_dim,rows,d_in", [
    (6, 9216, 4), (6, 9216, 32),    # one walker's pair rows, both layers
    (3, 9216, 4), (3, 9216, 32),    # T_local of a 2-way deriv axis
    (6, 333, 4), (3, 333, 32),      # ragged: no multiple of the 32-row tile
    (6, 120013, 32), (0, 77, 4),    # several tiles per warp; no tangent at all
    (6, 16 * 162 * 162 + 7, 4),     # more than a wave of 16-row tiles, ragged
])
def test_pair_variant_matches_plain(cuda_device, t_dim, rows, d_in, open_sum, dtype):
    """The streaming body of the two-electron layers against the plain
    version: in float32 within 1e-5 of each output's scale (f32 sums in
    another order), in float64 (the pair body in double) within 1e-10, and
    equal bit for bit to the general body in double on the same inputs
    (the same sums in the same order), and to a second launch."""
    assert tjk.pair_body(d_in, 32, mixed=False)
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(7), cuda_device)
    case = tuple(x.to(dtype) for x in (
        rnd(rows, d_in), rnd(t_dim, rows, d_in), rnd(rows, d_in),
        rnd(d_in, 32) / d_in**0.5, rnd(32)))
    f64 = dtype == torch.float64
    name = "fused_dense_tanh_jet" + ("_partial" if open_sum else "")
    before = _launches(tjk, name)
    key = (name, (t_dim, rows, d_in, 32), "pair, float64" if f64 else "pair")
    shape_before = tjk.SHAPES[key]
    got = getattr(tjk, name)(*case)
    torch.cuda.synchronize()
    assert _launches(tjk, name) == before + 1
    assert tjk.SHAPES[key] == shape_before + 1
    want = getattr(tjk, name + "_plain")(*case)
    assert len(got) == len(want) == (4 if open_sum else 3)
    tol = 1e-10 if f64 else 1e-5
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == dtype
        if y.numel():
            assert float((x - y).abs().max()) <= tol * max(float(y.abs().max()), 1.0)
    if f64:
        general = _general_f64(case, open_sum)
        for x, y, z in zip(got, general, getattr(tjk, name)(*case)):
            assert torch.equal(x, y) and torch.equal(x, z)


def _general_f64(case, open_sum):
    """The general body in double on a plain-rule float64 jet: the f64
    entry called with slices 0, as the wrapper called it before the pair
    body in double; (val_o, jac_o, lap_o[, sq_o])."""
    general = tk.jet_launcher(tjk._lib(), 0, *case, None, open_sum)
    general()
    torch.cuda.synchronize()
    return general.outputs


# ---- the open ("partial") forms: tangent sum left to the caller -------------


@pytest.mark.cuda
@pytest.mark.parametrize("t_dim,rows,d_in,d_out", [
    (3, 300, 32, 32),    # pair variant, ragged row tile
    (3, 300, 8, 32),     # general variant (d_in neither 4 nor 32)
    (7, 300, 20, 64),    # wide variant, ragged row tile, T_local of no round size
    (1, 130, 8, 128),    # wide, one tangent: fewer slices than the card wants
])
def test_dense_tanh_jet_partial_kernel_matches_plain(cuda_device, t_dim, rows,
                                                     d_in, d_out):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(3), cuda_device)
    case = (rnd(rows, d_in), rnd(t_dim, rows, d_in), rnd(rows, d_in),
            rnd(d_in, d_out) / d_in**0.5, rnd(d_out))
    before = _launches(tjk, "fused_dense_tanh_jet_partial")
    got = tjk.fused_dense_tanh_jet_partial(*case)
    assert _launches(tjk, "fused_dense_tanh_jet_partial") == before + 1
    assert len(got) == 4
    for x, y in zip(got, tjk.fused_dense_tanh_jet_partial_plain(*case)):
        torch.testing.assert_close(x, y, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t_dim,groups,n,d_in,d_out", [
    (20, 3, 96, 40, 256),   # wide variant
    (50, 5, 77, 320, 256),  # wide, ragged rows and tangents, 32-deep ring
    (9, 3, 10, 20, 40),     # general variant
])
def test_dense_tanh_jet_mix_partial_recombines(cuda_device, t_dim, groups, n,
                                               d_in, d_out):
    """Open launches on uneven pieces of the tangent axis, s summed, the
    Laplacian closed: equal to the closed kernel on the whole axis."""
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(4), cuda_device)
    val, jac, lap = rnd(groups, n, d_in), rnd(t_dim, groups, n, d_in), rnd(groups, n, d_in)
    zbc, lbc, jbc = rnd(groups, d_out), rnd(groups, d_out), rnd(t_dim, groups, d_out)
    w, b = rnd(d_in, d_out) / d_in**0.5, rnd(d_out)
    cut = t_dim // 3
    parts = [tjk.fused_dense_tanh_jet_mix_partial(
        val, jac[sl], lap, zbc, lbc, jbc[sl], w, b)
        for sl in (slice(0, cut), slice(cut, t_dim))]
    for part, sl in zip(parts, (slice(0, cut), slice(cut, t_dim))):
        want = tjk.fused_dense_tanh_jet_mix_partial_plain(
            val, jac[sl], lap, zbc, lbc, jbc[sl], w, b)
        for x, y in zip(part, want):
            torch.testing.assert_close(x, y, **TOL)
    v, j, l = tjk.fused_dense_tanh_jet_mix(val, jac, lap, zbc, lbc, jbc, w, b)
    torch.testing.assert_close(parts[0][0], v, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([p[1] for p in parts]), j, rtol=0, atol=0)
    closed = tjk.close_laplacian(parts[0][0], parts[0][2], parts[0][3] + parts[1][3])
    torch.testing.assert_close(closed, l, **TOL)
    # 1e-5 of the Laplacian's scale: the same products, partial sums in another order
    assert float((closed - l).abs().max()) <= 1e-5 * float(l.abs().max())


# ---- float64 (precision='float64'): the complex128 and float64 bodies -------

# f64 on the card against f64 plain versions: sums in another order
TOL64 = dict(rtol=1e-10, atol=1e-10)
C128_MAX_N = 118  # the largest complex128 matrix a block's shared memory holds


def _gj_body_c128(n):
    """The body csrc/gj_inverse.cu's gj_body_c128 gives n x n matrices."""
    if n <= 32:
        return tdk.BODY_C128_WARP
    if n == 48:
        return tdk.BODY_C128_REGISTERS
    return tdk.BODY_C128_MID if 49 <= n <= 96 else tdk.BODY_C128


@pytest.mark.cuda
def test_gj_complex128_body_matches_plain(cuda_device):
    # every body at both ends of its range: warp 1-16 (two matrices a
    # warp) and 17-32, shared 33-47, registers 48, mid 49-96, shared 97-118
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(10), cuda_device)
    for n in (1, 5, 14, 16, 17, 32, 33, 47, 48, 49, 81, 96, 97, 100, C128_MAX_N):
        a = (torch.complex(rnd(64, n, n), rnd(64, n, n))
             + 4.0 * torch.eye(n, device=cuda_device)).to(torch.complex128)
        key = ("gj_inverse_slogdet", (64, n, n), _gj_body_c128(n))
        before = tdk.SHAPES[key]
        got = tdk.gj_inverse_slogdet(a)
        assert tdk.SHAPES[key] == before + 1, n
        assert got[0].dtype == got[1].dtype == torch.complex128
        assert got[2].dtype == torch.float64
        for x, y in zip(got, tdk.gj_inverse_slogdet_plain(a)):
            torch.testing.assert_close(x, y, **TOL64)
        # no atomics: a second launch agrees bit for bit
        for x, y in zip(got, tdk.gj_inverse_slogdet(a)):
            assert torch.equal(x, y), n
    with pytest.raises(ValueError, match="shared memory"):
        tdk.gj_inverse_slogdet(torch.zeros(1, C128_MAX_N + 1, C128_MAX_N + 1,
                                           dtype=torch.complex128, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 3, 513, 8192])  # 1, 3, 513: a block's
def test_gj_complex128_register_body_batches(cuda_device, batch):  # second matrix idle
    """The complex128 register body (two warps a matrix, two matrices a
    block) on Gaussian 48 x 48 matrices: 1e-9 of the inverse's scale (the
    worst-conditioned of 8192 amplifies f64's 2^-53), and a relaunch equal
    bit for bit."""
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(13), cuda_device)
    a = (torch.complex(rnd(batch, 48, 48), rnd(batch, 48, 48)).to(torch.complex128)
         / 96**0.5)
    key = ("gj_inverse_slogdet", (batch, 48, 48), tdk.BODY_C128_REGISTERS)
    before = tdk.SHAPES[key]
    got = tdk.gj_inverse_slogdet(a)
    assert tdk.SHAPES[key] == before + 1
    want = tdk.gj_inverse_slogdet_plain(a)
    scale = want[0].abs().amax(dim=(-1, -2))
    assert float(((got[0] - want[0]).abs().amax(dim=(-1, -2)) / scale).max()) <= 1e-9
    assert float((got[1] - want[1]).abs().max()) <= 1e-9
    assert float((got[2] - want[2]).abs().max()) <= 1e-9
    for x, y in zip(got, tdk.gj_inverse_slogdet(a)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 513, 8192])  # 1, 3, 513: a warp's second
@pytest.mark.parametrize("n", [14, 32, 81])           # matrix idle (n = 14)
def test_gj_complex128_warp_and_mid_bodies_batches(cuda_device, batch, n):
    """The complex128 warp body (two matrices a warp at n = 14, one at 32)
    and mid body (n = 81, one block a matrix) on Gaussian matrices: 1e-9
    of the inverse's scale, and a relaunch equal bit for bit."""
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(14), cuda_device)
    a = (torch.complex(rnd(batch, n, n), rnd(batch, n, n)).to(torch.complex128)
         / (2 * n)**0.5)
    key = ("gj_inverse_slogdet", (batch, n, n), _gj_body_c128(n))
    assert key[2] in (tdk.BODY_C128_WARP, tdk.BODY_C128_MID)
    before = tdk.SHAPES[key]
    got = tdk.gj_inverse_slogdet(a)
    assert tdk.SHAPES[key] == before + 1
    want = tdk.gj_inverse_slogdet_plain(a)
    scale = want[0].abs().amax(dim=(-1, -2))
    assert float(((got[0] - want[0]).abs().amax(dim=(-1, -2)) / scale).max()) <= 1e-9
    assert float((got[1] - want[1]).abs().max()) <= 1e-9
    assert float((got[2] - want[2]).abs().max()) <= 1e-9
    for x, y in zip(got, tdk.gj_inverse_slogdet(a)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [48, 14, 81, 5, 16, 32, 49, 96, 40, 100])
@pytest.mark.parametrize("case", ["anti_diagonal", "permutation", "tie",
                                  "zero_pivot", "nan_entry"])
def test_gj_complex128_edge_matrices(cuda_device, n, case):
    """The pivot rule's corner cases in complex128 against the plain
    version (n = 48 on the register body, 5-32 on the warp body, 49-96 on
    the mid body, 40 and 100 on the shared-memory body): the same pivots,
    -inf for a zero pivot, NaN confined."""
    dev = cuda_device
    rnd = _rnd(torch.Generator(device=dev).manual_seed(11), dev)
    eye = torch.eye(n, device=dev, dtype=torch.complex128)
    a = torch.complex(rnd(2, n, n), rnd(2, n, n)).to(torch.complex128)
    if case == "anti_diagonal":
        a = torch.flip(eye, [1])[None]
    elif case == "permutation":
        a = torch.roll(eye, 5, 0)[None]
    elif case == "tie":              # row 4 where n = 5 has no row 7
        a[:, 3, 0], a[:, min(7, n - 1), 0] = 5.0, 5.0j
    elif case == "zero_pivot":
        a[:, :, min(7, n - 1)] = 0
    else:
        a[0, 3, 4] = float("nan")
    key = ("gj_inverse_slogdet", tuple(a.shape), _gj_body_c128(n))
    before = tdk.SHAPES[key]
    got, want = tdk.gj_inverse_slogdet(a), tdk.gj_inverse_slogdet_plain(a)
    torch.cuda.synchronize()
    assert tdk.SHAPES[key] == before + 1
    if case in ("zero_pivot", "nan_entry"):
        assert torch.equal(torch.isfinite(got[2]), torch.isfinite(want[2]))
        assert not torch.isfinite(got[2][0])
        if case == "nan_entry":
            torch.testing.assert_close(got[2][1], want[2][1], **TOL64)
        return
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **TOL64)
    if case != "tie":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1].real, want[1].real)


@pytest.mark.cuda
@pytest.mark.parametrize("open_sum", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("mixed", [False, True], ids=["plain", "mix"])
@pytest.mark.parametrize("t_dim,groups,n,d_in,d_out", [
    (6, 3, 300, 32, 32),    # a pair shape (the pair body in double, plain rule)
    (9, 3, 10, 20, 40),     # general in float32 too
    (50, 5, 77, 320, 256),  # a wide shape, ragged rows and tangents
    (0, 2, 7, 4, 32),       # no tangent at all
])
def test_jet_float64_body_matches_plain(cuda_device, t_dim, groups, n, d_in,
                                        d_out, mixed, open_sum):
    """Every rule and form at float64 takes the body its shape names (the
    pair body in double at the plain rule's pair shapes, the wide one on
    the FP64 tensor cores at the 256-wide shape, the general body in double
    elsewhere), against its float64 plain version, and two launches agree
    bit for bit."""
    _jet_float64_case(cuda_device, t_dim, groups, n, d_in, d_out, mixed, open_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("open_sum", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("mixed", [False, True], ids=["plain", "mix"])
@pytest.mark.parametrize("t_dim,groups,n,d_in,d_out", [
    (0, 5, 77, 40, 256),    # no tangent: one slice, the value and Laplacian only
    (1, 3, 50, 16, 64),     # one tangent, one 64-column tile, ragged rows
    (50, 5, 77, 40, 256),   # 4 slices of 13, 13, 13, 11 tangents: ragged
    (13, 2, 96, 320, 256),  # B3's widths, 20 k-slices of the ring
    (5, 3, 41, 352, 128),   # the largest resident slice of w
    (144, 8, 96, 16, 256),  # B4b's first layer at a rank's T_local
])
def test_jet_float64_wide_body_matches_plain(cuda_device, t_dim, groups, n, d_in,
                                             d_out, mixed, open_sum):
    """The float64 wide body (FP64 tensor cores) at ragged rows and
    tangents, both rules, both forms, against the float64 plain version
    within TOL64, and a relaunch equal bit for bit."""
    slices = tjk.wide_slices_f64(t_dim, groups * n, d_in, d_out, 132)
    assert slices > 0
    _jet_float64_case(cuda_device, t_dim, groups, n, d_in, d_out, mixed, open_sum)


def _jet_float64_case(cuda_device, t_dim, groups, n, d_in, d_out, mixed, open_sum):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(12), cuda_device)

    def r(*s):
        return rnd(*s).double()

    name = "fused_dense_tanh_jet" + ("_mix" if mixed else "") + ("_partial" if open_sum else "")
    if mixed:
        args = (r(groups, n, d_in), r(t_dim, groups, n, d_in), r(groups, n, d_in),
                r(groups, d_out), r(groups, d_out), r(t_dim, groups, d_out),
                r(d_in, d_out) / d_in**0.5, r(d_out))
    else:
        args = (r(groups * n, d_in), r(t_dim, groups * n, d_in), r(groups * n, d_in),
                r(d_in, d_out) / d_in**0.5, r(d_out))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    label = tjk.variant_label(tjk.kernel_variant(
        t_dim, groups * n, d_in, d_out, mixed, sms, torch.float64), torch.float64)
    assert label.endswith("float64") or label.startswith("wide, float64")
    pair = tjk.pair_body(d_in, d_out, mixed)
    assert (label == "pair, float64") is pair
    assert (label == "general, float64") == (
        not pair and tjk.wide_slices_f64(t_dim, groups * n, d_in, d_out, sms) == 0)
    key = (name, (t_dim, groups * n, d_in, d_out), label)
    before, shape_before = _launches(tjk, name), tjk.SHAPES[key]
    got = getattr(tjk, name)(*args)
    assert _launches(tjk, name) == before + 1 and tjk.SHAPES[key] == shape_before + 1
    want = getattr(tjk, name + "_plain")(*args)
    assert len(got) == len(want) == (4 if open_sum else 3)
    for x, y in zip(got, want):
        assert x.dtype == torch.float64 and x.shape == y.shape
        torch.testing.assert_close(x, y, **TOL64)
    for x, y in zip(got, getattr(tjk, name)(*args)):
        assert torch.equal(x, y)


# the det head's one-pass tangent stream (csrc/dethead_trace.cu) at the
# production matrices, the tangents cut for time: C-diamond's 512 (64
# walkers x 8 determinants) of n = 48, bcc-Li's 256 of n = 81, each the
# second channel with a window whose first tangents lie before its slab
# (split over 3 and 2 blocks a matrix); a few matrices split over 6
# blocks (n = 16: complex128's FMA body); n = 90, a tile of 6 columns a
# thread; Si 2x2x2's 256 of n = 112 and the largest, 119, on 8-column
# tiles with M_t staged over J_t (complex64 only: complex128 serves n <=
# 84, and takes 84 there; above 40 on the tensor cores)
DETHEAD_CASES = {
    "diamond": dict(batch=64, ndet=8, n=48, offset=48, t0=138, t_loc=48, jbc=True),
    "bcc_li": dict(batch=32, ndet=8, n=81, offset=81, t0=238, t_loc=32, jbc=True),
    "split": dict(batch=2, ndet=2, n=16, offset=0, t0=0, t_loc=96, jbc=False),
    "wide": dict(batch=4, ndet=2, n=90, offset=2, t0=3, t_loc=12, jbc=True),
    "si": dict(batch=32, ndet=8, n=112, offset=112, t0=326, t_loc=32, jbc=True),
    "widest": dict(batch=2, ndet=2, n=119, offset=0, t0=345, t_loc=20, jbc=True),
}


def _dethead_inputs(dev, real, batch, ndet, n, offset, t0, t_loc, jbc, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    cplx = tdh._COMPLEX[real]

    def rnd(*shape, dtype=real):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    mat = (batch, ndet, n, n)
    return (rnd(t_loc, batch, n, 2 * ndet * n), rnd(t_loc, batch, 2 * ndet * n) if jbc else None,
            rnd(*mat, dtype=cplx), rnd(3, *mat, dtype=cplx), rnd(*mat, dtype=cplx),
            rnd(*mat, dtype=cplx) / n**0.5, offset, t0)


@pytest.mark.cuda
@pytest.mark.parametrize("real", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(DETHEAD_CASES))
def test_dethead_kernel_matches_plain(cuda_device, case, real):
    spec = DETHEAD_CASES[case]
    if spec["n"] > tdh.MAX_N[real]:
        spec = dict(spec, n=tdh.MAX_N[real])  # the largest complex128 matrix
    args = _dethead_inputs(cuda_device, real, **spec)
    matrices, n, t_loc = spec["batch"] * spec["ndet"], spec["n"], spec["t_loc"]
    key = (tdh.KERNEL, (matrices, n, t_loc), tdh.body(n, real))
    before = tdh.SHAPES.copy()
    b1, jets = tdk.SHAPES.copy(), tjk.SHAPES.copy()
    got = tdh.dethead_traces(*args)
    again = tdh.dethead_traces(*args)
    torch.cuda.synchronize()
    # one count a launch, under its own key, and none in B1's or the jets'
    assert tdh.SHAPES - before == {key: 2}
    assert tdk.SHAPES == b1 and tjk.SHAPES == jets
    tol = 2e-5 if real == torch.float32 else 1e-12
    for x, y, z in zip(got, again, tdh.dethead_traces_plain(*args)):
        assert torch.equal(x, y)  # no atomics: two launches, the same bits
        torch.testing.assert_close(x, z, rtol=0, atol=tol * float(z.abs().max()))


# the complex128 tensor-core body at the float64 cells' launches, every
# tangent: C-diamond's second channel (512 matrices of 48, T 288) and
# bcc-Li's (128 of 81, T 486); the plain version 96 tangents at a time
DETHEAD_F64_CELLS = {
    "diamond_f64": dict(batch=64, ndet=8, n=48, offset=48, t0=0, t_loc=288, jbc=True),
    "bcc_li_f64": dict(batch=16, ndet=8, n=81, offset=81, t0=0, t_loc=486, jbc=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DETHEAD_F64_CELLS))
def test_dethead_tensor_core_body_at_the_float64_cells(cuda_device, case):
    spec = DETHEAD_F64_CELLS[case]
    jr, jbc, *factors, offset, t0 = _dethead_inputs(cuda_device, torch.float64, **spec)
    matrices, n, t_loc = spec["batch"] * spec["ndet"], spec["n"], spec["t_loc"]
    assert tdh.body(n, torch.float64) == tdh.BODY_C128
    before = tdh.SHAPES.copy()
    got = tdh.dethead_traces(jr, jbc, *factors, offset, t0)
    again = tdh.dethead_traces(jr, jbc, *factors, offset, t0)
    torch.cuda.synchronize()
    assert tdh.SHAPES - before == {(tdh.KERNEL, (matrices, n, t_loc), tdh.BODY_C128): 2}
    parts = [tdh.dethead_traces_plain(jr[s:s + 96], jbc[s:s + 96], *factors, offset, t0 + s)
             for s in range(0, t_loc, 96)]
    want = (torch.cat([q[0] for q in parts]), sum(q[1] for q in parts))
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y)  # no atomic sums: two launches, the same bits
        torch.testing.assert_close(x, z, rtol=0, atol=1e-12 * float(z.abs().max()))


@pytest.mark.cuda
def test_dethead_kernel_refuses(cuda_device):
    args = list(_dethead_inputs(cuda_device, torch.float32, 2, 2, 8, 0, 0, 6, True))
    bad = [
        (0, args[0].double(), TypeError),                 # products not float32 with complex64
        (2, args[2].to(torch.complex128), TypeError),     # factors of another precision
        (5, args[5].cpu(), ValueError),                   # a tensor off the card
        (4, args[4][:, :, :7], ValueError),               # orb_val0 not (B, D, n, n)
        (1, args[1][:, :, :-2], ValueError),              # jbc of another width
        (3, args[3][:2], ValueError),                     # ep_jac3 without three components
    ]
    for index, value, error in bad:
        with pytest.raises(error):
            tdh.dethead_traces(*args[:index], value, *args[index + 1:])
    for real, n in ((torch.float32, 120), (torch.float64, 85)):  # past shared memory
        with pytest.raises(ValueError, match="serves n <="):
            tdh.dethead_traces(*_dethead_inputs(cuda_device, real, 1, 1, n, 0, 0, 3, False))


# fl.det_head_jet on the card against the composition it stands for (the
# complex Jacobian, fl.mul_row, fl.slogdet_jet), every tangent of an n x n
# matrix of all n electrons (full_det's layout, offset 0, T = 3n), 2
# walkers x 2 determinants: C-diamond's full_det matrix (n = 96) in
# complex64 through the kernel in one window; past the kernel's largest n
# (120 in complex64, 85 in complex128) through the plain version in the
# scan's windows, with no kernel launch
DET_HEAD_JET_CASES = {
    "full_det_diamond_c64": (torch.float32, 96),
    "past_max_n_c64": (torch.float32, 120),
    "past_max_n_c128": (torch.float64, 85),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DET_HEAD_JET_CASES))
def test_det_head_jet_matches_composition(cuda_device, case, monkeypatch):
    from deepsolid_tpu_torch.ops import fwdlap as fl

    real, n = DET_HEAD_JET_CASES[case]
    batch, ndet, t_dim = 2, 2, 3 * n
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    cplx = tdh._COMPLEX[real]

    def rnd(*shape, dtype=real):
        return torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)

    # orbitals near 3 x the identity in each determinant: A well conditioned
    eye = torch.eye(n, device=cuda_device, dtype=real).repeat(1, ndet)
    orb = torch.complex(3.0 * eye + rnd(batch, n, ndet * n) / n**0.5,
                        rnd(batch, n, ndet * n) / n**0.5)
    val = orb.unflatten(-1, (ndet, n)).transpose(1, 2)  # (B, D, n, n)
    lap = rnd(batch, ndet, n, n, dtype=cplx)
    jr, jbc = 0.3 * rnd(t_dim, batch, n, 2 * ndet * n), 0.3 * rnd(t_dim, batch, 2 * ndet * n)
    b_val = 1.0 + 0.1 * rnd(batch, ndet, n, n, dtype=cplx)
    b_jac3, b_lap = 0.3 * rnd(3, batch, ndet, n, n, dtype=cplx), rnd(batch, ndet, n, n, dtype=cplx)

    plain_calls = []
    plain = tdh.dethead_traces_plain
    monkeypatch.setattr(tdh, "dethead_traces_plain",
                        lambda *args: plain_calls.append(args[0].shape[0]) or plain(*args))
    kernel = tdh.serves(n, real, cuda_device)
    before = tdh.SHAPES.copy()
    sign, got = fl.det_head_jet(val, lap, b_val, b_jac3, b_lap, fl.sliced_window(jr, jbc),
                                t_dim, offset=0)
    torch.cuda.synchronize()
    if kernel:
        assert n <= tdh.MAX_N[real] and not plain_calls
        assert tdh.SHAPES - before == {
            (tdh.KERNEL, (batch * ndet, n, t_dim), tdh.body(n, real)): 1}
    else:
        chunk = fl._pick_det_scan_chunk(t_dim, n)
        assert n > tdh.MAX_N[real] and tdh.SHAPES == before
        assert plain_calls == [chunk] * (t_dim // chunk) and len(plain_calls) > 1

    jac = jr + jbc[:, :, None, :]
    jc = torch.complex(jac[..., :ndet * n], jac[..., ndet * n:])
    mat = fl.mul_row(fl.Jet(val, jc.unflatten(-1, (ndet, n)).transpose(2, 3), lap),
                     b_val, b_jac3, b_lap, n_total=n, offset=0)
    want_sign, want = fl.slogdet_jet(mat)
    assert torch.equal(sign, want_sign) and torch.equal(got.val, want.val)
    assert got.jac.shape == (t_dim, batch, ndet)
    tol = 2e-5 if real == torch.float32 else 1e-12
    for x, y in ((got.jac, want.jac), (got.lap, want.lap)):
        torch.testing.assert_close(x, y, rtol=0, atol=tol * float(y.abs().max()))
