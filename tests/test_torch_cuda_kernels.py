"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: skipped without an NVIDIA GPU. This file imports no JAX,
so it also runs on a GPU machine without JAX; there, from the repo root:
    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
(tests/conftest.py configures JAX for the rest of the suite).
"""

import pytest
import torch

from deepsolid_tpu_torch.ops.cuda import det_kernels as tdk
from deepsolid_tpu_torch.ops.cuda import jet_kernels as tjk

# f32 on the card against f32 plain versions: sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(gen, dev):
    return lambda *s: torch.randn(s, generator=gen, device=dev)


@pytest.mark.cuda
def test_gj_kernel_matches_plain(cuda_device):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    # 48: the register kernel; the others the shared-memory one (100: above
    # 48 KB of shared memory, by opt-in)
    for n in (5, 13, 48, 96, 100):
        a = torch.complex(rnd(64, n, n), rnd(64, n, n)) + 4.0 * torch.eye(n, device=cuda_device)
        before = tdk.LAUNCHES["gj_inverse_slogdet"]
        key = ("gj_inverse_slogdet", (64, n, n), "registers" if n == 48 else "shared")
        shape_before = tdk.SHAPES[key]
        got = tdk.gj_inverse_slogdet(a)
        assert tdk.LAUNCHES["gj_inverse_slogdet"] == before + 1
        assert tdk.SHAPES[key] == shape_before + 1
        for x, y in zip(got, tdk.gj_inverse_slogdet_plain(a)):
            torch.testing.assert_close(x, y, rtol=2e-3, atol=2e-3)  # conditioning
    sing = torch.diag(torch.tensor([1.0, 2.0, 0.0], device=cuda_device))
    assert float(tdk.gj_inverse_slogdet(sing.to(torch.complex64)[None])[2][0]) == float("-inf")
    with pytest.raises(ValueError, match="shared memory"):
        tdk.gj_inverse_slogdet(torch.zeros(1, 400, 400, dtype=torch.complex64,
                                           device=cuda_device))
    with pytest.raises(TypeError):
        tdk.gj_inverse_slogdet(torch.zeros(1, 4, 4, dtype=torch.complex128,
                                           device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 512])  # 1, 3: a block's second warp idle
def test_gj_register_kernel_batches(cuda_device, batch):
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(5), cuda_device)
    a = torch.complex(rnd(batch, 48, 48), rnd(batch, 48, 48)) / 96**0.5
    for x, y in zip(tdk.gj_inverse_slogdet(a), tdk.gj_inverse_slogdet_plain(a)):
        torch.testing.assert_close(x, y, rtol=5e-3, atol=5e-3)  # conditioning


@pytest.mark.cuda
@pytest.mark.parametrize("n", [48, 12])  # the register and the shared-memory kernel
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
@pytest.mark.parametrize("open_sum", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("t_dim,rows,d_in", [
    (6, 9216, 4), (6, 9216, 32),    # one walker's pair rows, both layers
    (3, 9216, 4), (3, 9216, 32),    # T_local of a 2-way deriv axis
    (6, 333, 4), (3, 333, 32),      # ragged: no multiple of the 32-row tile
    (6, 120013, 32), (0, 77, 4),    # several tiles per warp; no tangent at all
])
def test_pair_variant_matches_plain(cuda_device, t_dim, rows, d_in, open_sum):
    """The streaming body of the two-electron layers against the plain
    version, within 1e-5 of each output's scale (f32 sums in another order)."""
    assert tjk.pair_body(d_in, 32, mixed=False)
    rnd = _rnd(torch.Generator(device=cuda_device).manual_seed(7), cuda_device)
    case = (rnd(rows, d_in), rnd(t_dim, rows, d_in), rnd(rows, d_in),
            rnd(d_in, 32) / d_in**0.5, rnd(32))
    name = "fused_dense_tanh_jet" + ("_partial" if open_sum else "")
    before = tjk.LAUNCHES[name]
    key = (name, (t_dim, rows, d_in, 32), "pair")
    shape_before = tjk.SHAPES[key]
    got = getattr(tjk, name)(*case)
    torch.cuda.synchronize()
    assert tjk.LAUNCHES[name] == before + 1
    assert tjk.SHAPES[key] == shape_before + 1
    want = getattr(tjk, name + "_plain")(*case)
    assert len(got) == len(want) == (4 if open_sum else 3)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        if y.numel():
            assert float((x - y).abs().max()) <= 1e-5 * max(float(y.abs().max()), 1.0)


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
    before = tjk.LAUNCHES["fused_dense_tanh_jet_partial"]
    got = tjk.fused_dense_tanh_jet_partial(*case)
    assert tjk.LAUNCHES["fused_dense_tanh_jet_partial"] == before + 1
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
