"""precision='float64' in the port: the kernels' float64 dispatch and plain
versions, and a float64 run's checkpoint in a float32 run and back.

On the CPU the wrappers take the plain versions, so the dispatch to the
float64 bodies is held with a stand-in for the built library (as
test_torch_kernels.py does for the complex64 bodies) and with tensors on
the `meta` device; the bodies themselves run on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py's float64 phase). The
plain float64 versions are held against the JAX package at float64,
which takes its LAPACK and jnp paths there (no Pallas kernel runs in
float64).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.ops import fwdlap as jfl
from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.ops.cuda import det_kernels as tdk
from deepsolid_tpu_torch.ops.cuda import jet_kernels as tjk
from test_torch_kernels import _FakeGjLibrary, _forbid

# the largest n whose complex128 matrix fits a block's 227 KB on an H100
C128_MAX_N = 118


# a block of the complex128 register body: two matrices, each with its
# 48 x 49 unscrambling tile, two buffers of column k and of the pivot row,
# the pivots (double2) and three int tables of 48
C128_REGISTERS_BYTES = 2 * (48 * 49 * 16 + 4 * 48 * 16 + 48 * 16 + 3 * 48 * 4)


class _FakeGjLibraryC128(_FakeGjLibrary):
    """The complex128 size rule of csrc/gj_inverse.cu beside the complex64
    one (gj_body_c128: 2 warp at n <= 32, 1 registers at n = 48, 3 mid at
    49-96, 0 shared): the warp body's static tiles (no dynamic bytes), the
    register body's two matrices a block, the mid body's n (n + 1) x 16
    bytes of unscrambling tile, the shared-memory body's 16 n^2 + 3 x 16 n
    + 4 n bytes (the matrix, three rows of double2 and the pivot rows), and
    each launch entry a function of its own name."""

    def gj_body_c128(self, n):
        if n <= 32:
            return 2
        if n == 48:
            return 1
        return 3 if 49 <= n <= 96 else 0

    def gj_smem_bytes_c128(self, n):
        body = self.gj_body_c128(n)
        if body == 1:
            return C128_REGISTERS_BYTES
        if body == 2:
            return 0
        if body == 3:
            return n * (n + 1) * 16
        return n * n * 16 + 3 * n * 16 + n * 4

    def gj_inverse_slogdet_launch(self, *args):
        return "complex64 entry"

    def gj_inverse_slogdet_launch_c128(self, *args):
        return "complex128 entry"


# the complex128 body by n, as the source's rule (held to the source in
# test_gj_c128_fake_library_follows_the_source) names it
C128_NS = (1, 5, 6, 14, 16, 47, 48, 49, 81, 100, C128_MAX_N, 17, 32, 33, 96, 97)
C128_BODY_BY_N = {n: tdk.BODIES_C128[_FakeGjLibraryC128().gj_body_c128(n)]
                  for n in C128_NS}


@pytest.mark.parametrize("n", C128_NS)
def test_gj_c128_takes_the_shared_body_where_it_fits(n):
    """Each n takes its complex128 body by size alone (C128_BODY_BY_N: the
    warp body for Si, LiH, graphene and H10, the register body for
    C-diamond's 48, the mid body for bcc-Li's 81, the shared-memory body
    where none of them serves and the matrix fits), through the one
    complex128 entry."""
    lib, dev = _FakeGjLibraryC128(), torch.device("cuda", 0)
    want = C128_BODY_BY_N[n]
    assert tdk.variant_c128(lib, n, dev) == want
    body, entry = tdk.launcher(lib, torch.complex128, n, dev)
    assert body == want and entry() == "complex128 entry"
    # complex64 keeps its own bodies and entry at the same n
    body, entry = tdk.launcher(lib, torch.complex64, n, dev)
    assert body == tdk.variant(lib, n, dev) and entry() == "complex64 entry"


@pytest.mark.parametrize("n", [C128_MAX_N + 1, 168, 400])
def test_gj_c128_beyond_the_body_raises_before_a_launch(n):
    """No fallback: a complex128 matrix that does not fit a block raises,
    also where the complex64 bodies still serve (the mid wide body up to
    128, the shared one up to 168)."""
    lib, dev = _FakeGjLibraryC128(), torch.device("cuda", 0)
    with pytest.raises(ValueError, match="shared memory"):
        tdk.launcher(lib, torch.complex128, n, dev)
    if n <= 168:
        want = "mid, wide" if n <= 128 else "shared"
        assert tdk.launcher(lib, torch.complex64, n, dev)[0] == want


def test_gj_c128_fake_library_follows_the_source():
    """_FakeGjLibraryC128's size rule and the wrapper's signatures are the
    ones csrc/gj_inverse.cu states."""
    text = (build.CSRC / "gj_inverse.cu").read_text()
    assert ("int gj_body_c128(int n) {\n  if (n <= 32) return 2;\n"
            "  if (n == kZN) return 1;\n  if (n >= kMidMin && n <= kMidN) return 3;\n"
            "  return 0;\n}") in text
    assert "constexpr int kMidMin = 49;" in text and "constexpr int kMidN = 96;" in text
    assert "constexpr int kZN = 48;" in text and "constexpr int kZMats = 2;" in text
    assert ("  switch (gj_body_c128(n)) {\n    case 1:\n"
            "      return static_cast<long long>(sizeof(ZRegShared)) * kZMats;\n"
            "    case 2:\n      return 0;\n    case 3:\n"
            "      return mid_tile_bytes<double2>(n);\n    default:\n"
            "      return shared_body_bytes<double2>(n);") in text
    assert "return static_cast<long long>(n) * (n + 1) * sizeof(C);" in text
    # the warp body's tiles are static: two warps a block keep them under
    # the 48 KB a block may hold without opting in
    assert "constexpr int kZWarpWarps = 2;" in text
    assert "__shared__ double2 tiles[kZWarpWarps][kSegs][W][W + 1];" in text
    assert "__shared__ double2 rows[kZWarpWarps][2][kSegs][W];" in text
    assert 2 * (32 * 33 + 2 * 32) * 16 == 35840 <= 48 * 1024
    struct = re.search(r"struct ZRegShared \{(.*?)\};", text, re.S).group(1)
    struct = re.sub(r"//[^\n]*", "", struct)
    fields = [" ".join(f.split()) for f in struct.split(";") if f.strip()]
    assert fields == ["double2 tile[kZN][kZN + 1]", "double2 fcol[2][kZN]",
                      "double2 prow[2][kZN]", "double2 piv[kZN]", "int swapped[kZN]",
                      "int pos[kZN]", "int row_at[kZN]"]
    assert tdk.BODIES_C128 == (tdk.BODY_C128, tdk.BODY_C128_REGISTERS,
                               tdk.BODY_C128_WARP, tdk.BODY_C128_MID)
    # the body by n: warp up to 32 (two matrices a warp up to 16),
    # registers at 48, mid 49-96, shared 33-47 and 97-118
    assert C128_BODY_BY_N == {
        1: tdk.BODY_C128_WARP, 5: tdk.BODY_C128_WARP, 6: tdk.BODY_C128_WARP,
        14: tdk.BODY_C128_WARP, 16: tdk.BODY_C128_WARP, 17: tdk.BODY_C128_WARP,
        32: tdk.BODY_C128_WARP, 33: tdk.BODY_C128, 47: tdk.BODY_C128,
        48: tdk.BODY_C128_REGISTERS, 49: tdk.BODY_C128_MID, 81: tdk.BODY_C128_MID,
        96: tdk.BODY_C128_MID, 97: tdk.BODY_C128, 100: tdk.BODY_C128,
        C128_MAX_N: tdk.BODY_C128}
    assert tdk._SIGNATURES["gj_body_c128"] == tdk._SIGNATURES["gj_body"]
    assert ("return static_cast<long long>(n) * n * sizeof(C) + 3LL * n * sizeof(C) +\n"
            "         static_cast<long long>(n) * sizeof(int);") in text
    assert "return shared_body_bytes<float2>(n);" in text  # complex64's shared body
    assert re.search(r"int gj_inverse_slogdet_launch_c128\(const void\* a, void\* ainv, "
                     r"void\* sign,\s+void\* logdet, int batch, int n,\s+void\* stream\)",
                     text)
    restype, argtypes = tdk._SIGNATURES["gj_inverse_slogdet_launch_c128"]
    assert len(argtypes) == 7 and argtypes == tdk._SIGNATURES["gj_inverse_slogdet_launch"][1]
    # 118 fits the 232448 bytes an H100 block may opt into, 119 does not;
    # the register body's block needs 84 KB, the mid body's at 96 146 KB
    lib = _FakeGjLibraryC128()
    assert lib.gj_smem_bytes_c128(C128_MAX_N) <= 232448 < lib.gj_smem_bytes_c128(C128_MAX_N + 1)
    assert lib.gj_smem_bytes_c128(48) == C128_REGISTERS_BYTES == 84096
    assert lib.gj_smem_bytes_c128(96) == 148992 and lib.gj_smem_bytes_c128(32) == 0


def test_gj_wrapper_asks_the_c128_rule_for_complex128(monkeypatch):
    """A complex128 tensor on the card consults variant_c128 (and raises
    beyond it) and a complex64 one the complex64 rule; neither reaches the
    plain version, and another dtype raises before either."""
    _forbid(monkeypatch, tdk, "gj_inverse_slogdet_plain")
    monkeypatch.setattr(tdk, "_lib", lambda: _FakeGjLibraryC128())
    asked = []
    for name in ("variant", "variant_c128"):
        real = getattr(tdk, name)

        def record(lib, n, dev, real=real, name=name):
            asked.append((name, n))
            return real(lib, n, dev)

        monkeypatch.setattr(tdk, name, record)

    class _OnCard:  # a tensor's face, as far as the checks before the launch look
        device = torch.device("cuda", 0)
        dtype = torch.complex128
        ndim = 3
        shape = (2, 400, 400)

    with pytest.raises(ValueError, match="shared memory"):
        tdk._gj_cuda(_OnCard())
    for n in (14, 48, 81):
        _OnCard.shape = (2, n, n)
        with pytest.raises(AttributeError):  # the face has no storage
            tdk._gj_cuda(_OnCard())
    _OnCard.dtype = torch.complex64
    with pytest.raises(AttributeError):
        tdk._gj_cuda(_OnCard())
    assert asked == [("variant_c128", 400), ("variant_c128", 14), ("variant_c128", 48),
                     ("variant_c128", 81), ("variant", 81)]
    _OnCard.dtype = torch.float64  # a real matrix is no input of the kernel
    with pytest.raises(TypeError, match="complex64 or complex128"):
        tdk._gj_cuda(_OnCard())


# ---- the jet kernels in float64 ---------------------------------------------


@pytest.mark.parametrize("shape,mixed,label", [
    ((6, 64 * 96 * 96, 4, 32), False, "pair, float64"),      # B2's pair shape
    ((3, 64 * 96 * 96, 32, 32), False, "pair, float64"),     # B4a's, open
    ((288, 6144, 320, 256), True, "wide, float64, 1 tangent slices"),  # B3
    ((288, 6144, 16, 256), True, "wide, float64, 1 tangent slices"),
    ((144, 6144, 16, 256), True, "wide, float64, 1 tangent slices"),   # B4b
    ((144, 3072, 320, 256), True, "wide, float64, 2 tangent slices"),  # B4b at 32
    ((144, 6144, 256, 256), False, "wide, float64, 1 tangent slices"),  # B4a's 256
    ((9, 30, 20, 40), True, "general, float64"),              # general in float32 too
])
def test_jet_float64_launches_name_the_float64_body(shape, mixed, label):
    """The two-electron layers take the pair body in double, the 256-wide
    layers the float64 wide body with the slice count its chooser gives,
    every other shape the general body in double."""
    t_dim, rows, d_in, d_out = shape
    got = tjk.kernel_variant(t_dim, rows, d_in, d_out, mixed, 132, torch.float64)
    wide = tjk.wide_slices_f64(t_dim, rows, d_in, d_out, 132)
    if tjk.pair_body(d_in, d_out, mixed):
        assert got == tjk.PAIR
    else:
        assert got == (wide if wide else tjk.FLOAT64)
    assert tjk.variant_label(got, torch.float64) == label
    # float32 is chosen as before, by shape alone
    assert tjk.kernel_variant(t_dim, rows, d_in, d_out, mixed, 132) == \
        tjk.kernel_variant(t_dim, rows, d_in, d_out, mixed, 132, torch.float32) != tjk.FLOAT64


@pytest.mark.parametrize("shape,slices", [
    ((288, 6144, 320, 256), 1),   # 384 tiles: 2.9 waves of one block per SM
    ((144, 3072, 16, 256), 2),    # 192 tiles: a second slice fills the waves
    ((0, 385, 40, 256), 1),       # no tangent: one slice, never zero
    ((1, 150, 16, 64), 1),
    ((50, 385, 40, 256), 4),      # 28 tiles: slices of 13, 13, 13, 11
    ((13, 192, 320, 256), 7),     # slices of 2 and a last one of 1
    ((5, 123, 352, 128), 5),      # the largest resident d_in
    ((5, 123, 356, 128), 0),      # one past it: the general body
    ((288, 6144, 384, 256), 0),   # resident in float32's wide body, not in double's
    ((288, 6144, 318, 256), 0),   # d_in not a multiple of 4
    ((288, 6144, 320, 200), 0),   # d_out off the 64-column tile
    ((6, 64 * 96 * 96, 32, 32), 0),
    ((3, 0, 320, 256), 0),        # no rows: nothing to launch
])
def test_jet_float64_slices_are_chosen_by_shape(shape, slices):
    """The float64 wide body's slice chooser: a shape it does not take
    gives 0 (the general body); otherwise every slice holds a tangent under
    the launcher's ceil rule, or the one slice of a launch without any."""
    t_dim, rows, d_in, d_out = shape
    assert tjk.wide_slices_f64(*shape, 132) == slices
    if slices:
        assert d_in <= tjk.WIDE64_MAX_D_IN and d_out % tjk.WIDE64_COLS == 0
        assert 1 <= slices <= max(t_dim, 1)
        if t_dim:
            per = tjk.slice_tangents(t_dim, slices)
            assert (slices - 1) * per < t_dim <= slices * per
    # float32 keeps its own chooser
    assert tjk.kernel_variant(t_dim, rows, d_in, d_out, True, 132) == \
        tjk.wide_slices(t_dim, rows, d_in, d_out, 132)


def test_jet_float64_wide_constants_match_the_source():
    """The float64 wide body's tile, ring and resident limit as
    csrc/dense_tanh_jet.cu states them, and its shared memory at the
    largest d_in: the 227 KB a block may opt into, exactly."""
    text = (build.CSRC / "dense_tanh_jet.cu").read_text()
    assert f"constexpr int kDM = {tjk.WIDE64_ROWS};" in text
    assert f"constexpr int kDN = {tjk.WIDE64_COLS};" in text
    assert f"constexpr int kDMaxK = {tjk.WIDE64_MAX_D_IN};" in text
    assert "constexpr int kDK = 16;" in text and "constexpr int kDStages = 4;" in text
    assert "constexpr int kDStrideA = kDK + 4;" in text
    assert "constexpr int kDStrideW = kDN + 4;" in text
    # one product shape, m16n8k4, the only mma.sync in the source
    assert text.count("mma.sync.aligned.") == 1
    assert "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64" in text

    def smem(d_in):  # the resident slice of w (rows of 68) and the ring
        return 8 * (-(-d_in // 16) * 16 * 68 + 4 * 64 * 20)

    assert smem(tjk.WIDE64_MAX_D_IN) == 232448 < smem(tjk.WIDE64_MAX_D_IN + 4)
    # the strides keep a half warp's 64-bit fragment loads on 16 banks
    for stride in (16 + 4, 64 + 4):
        assert sorted((g * stride + t) % 16 for g in range(4) for t in range(4)) == \
            list(range(16))


def test_jet_float64_entry_follows_the_source():
    """The float64 entry's parameters in csrc/dense_tanh_jet.cu are the
    ones the wrapper binds, the float32 entry's: 13 pointers, 7 ints and
    the stream."""
    text = (build.CSRC / "dense_tanh_jet.cu").read_text()
    for entry in ("dense_tanh_jet_launch_f64", "dense_tanh_jet_launch"):
        m = re.search(rf"int {entry}\(([^)]*)\)", text)
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = ["int" if p.startswith("int ") else "ptr" for p in params]
        assert kinds == ["ptr"] * 13 + ["int"] * 7 + ["ptr"]
        _, argtypes = tjk._SIGNATURES[entry]
        assert len(argtypes) == len(params)
    # slices < 0 is the pair body in either entry: the same shape check, and
    # launch_pair instantiated for both d_in, deducing float or double
    f64_entry = text[text.index("int dense_tanh_jet_launch_f64("):]
    for entry_text in (text[text.index("int dense_tanh_jet_launch("):], f64_entry):
        branch = entry_text[entry_text.index("if (slices < 0) {"):]
        branch = branch[:branch.index("if (slices > 0)")]
        assert "C != kPC || (K != 4 && K != 32)" in branch
        assert "return static_cast<int>(cudaErrorInvalidValue);" in branch
        assert "launch_pair<4>(v, l, jc, wp, bp, vo, lo, jo, so, T, R, st)" in branch
        assert "launch_pair<32>(v, l, jc, wp, bp, vo, lo, jo, so, T, R, st)" in branch
    assert "const auto* v = static_cast<const double*>(val);" in f64_entry
    assert "struct PairBody<K, double>" in text and "dense_tanh_jet_pair_double_kernel<K, true>" in text
    assert "template <int TN, bool MIX, bool OPEN, typename S>" in text
    assert "double fma_s(double a, double b, double c) {\n  return fma(a, b, c);" in text
    assert "double tanh_s(double x) { return tanh(x); }" in text


@pytest.mark.parametrize("d_in,d_out,mixed,pair", [
    (4, 32, False, True),     # the first two-electron layer
    (32, 32, False, True),    # the second
    (4, 32, True, False),     # the mix rule has no pair body
    (32, 32, True, False),
    (8, 32, False, False),    # d_in neither 4 nor 32
    (16, 32, False, False),
    (32, 64, False, False),   # d_out off the pair width: wide in double
    (32, 40, False, False),   # general in double
    (4, 16, False, False),
])
def test_jet_float64_pair_body_is_chosen_by_shape(d_in, d_out, mixed, pair):
    """Which (d_in, d_out, rule) take the pair body in double, whatever T
    and rows: the float32 pair body's shapes, the same rule. Every other
    shape falls to the wide body in double or the general one."""
    assert tjk.pair_body(d_in, d_out, mixed) is pair
    for t_dim, rows in ((6, 64 * 96 * 96), (6, 16 * 162 * 162), (3, 32 * 96 * 96),
                        (3, 333), (0, 5)):
        got = tjk.kernel_variant(t_dim, rows, d_in, d_out, mixed, 132, torch.float64)
        assert (got == tjk.PAIR) is pair
        assert (tjk.variant_label(got, torch.float64) == "pair, float64") is pair
        assert (got == tjk.PAIR) == (
            tjk.kernel_variant(t_dim, rows, d_in, d_out, mixed, 132) == tjk.PAIR)
        if not pair:
            wide = tjk.wide_slices_f64(t_dim, rows, d_in, d_out, 132)
            assert got == (wide if wide else tjk.FLOAT64)


def test_jet_float64_pair_constants_match_the_source():
    """The pair body in double's tile, ring and shared memory as
    csrc/dense_tanh_jet.cu states them: 16-row warp tiles, the float32
    body's six warps, three ring stages of rows of d_in + 2 doubles (d_in 4:
    no padding) and no staging tile, and two blocks with the 1 KB the
    system keeps per block within an SM's 228 KB at both widths."""
    text = (build.CSRC / "dense_tanh_jet.cu").read_text()
    assert "constexpr int kPRowsD = 16;" in text and "constexpr int kPRows = 32;" in text
    assert "constexpr int kPWarps = 6;" in text and "constexpr int kPStagesD = 3;" in text
    assert "static constexpr int kStride = K == 4 ? 4 : K + 2;" in text
    assert "static constexpr int kWarpDoubles = kPStagesD * kStage;" in text
    assert "static_assert(2 * (PairTileD<32>::kSmem + 1024) <= 228 * 1024" in text

    def block(d_in):  # w and b, then per warp the ring
        stride = 4 if d_in == 4 else d_in + 2
        return 8 * ((d_in + 1) * 32 + 6 * 3 * 16 * stride)

    assert block(32) == 86784 and "86,784 B at d_in 32" in text
    for d_in in tjk.PAIR_D_IN:
        assert 2 * (block(d_in) + 1024) <= 228 * 1024
        # ring rows and each warp's ring stay 16-byte aligned
        stride = 4 if d_in == 4 else d_in + 2
        assert (8 * stride) % 16 == 0 and (8 * 3 * 16 * stride) % 16 == 0
    # a lane's rows rg + 4 i at one k: for fixed i the warp's four row
    # groups read consecutive rows, four 16-byte loads on disjoint banks
    stride = 32 + 2
    banks = sorted(((rg * stride * 8) % 128) // 4 + q for rg in range(4) for q in range(4))
    assert banks == list(range(16))


def test_pair_variants_differ_from_the_source_in_the_pair_body_in_double():
    """time_pair_variants' variants are csrc/dense_tanh_jet.cu with
    dense_tanh_jet_pair_double_kernel (and its tile) changed and nothing
    before it; the timed shapes are the float64 pair shapes of
    time_kernels, which the chooser gives the pair body."""
    from deepsolid_tpu_torch.ops.cuda import time_kernels as tk
    from deepsolid_tpu_torch.ops.cuda import time_pair_variants as tp

    text = (build.CSRC / "dense_tanh_jet.cu").read_text()
    cut = text.index("constexpr int kPStagesD = 3;")
    got = tp.variants()
    assert sorted(got) == ["current", "no_fma", "staged", "stages4"]
    assert got["current"] == text
    for name, src in got.items():
        assert src[:cut] == text[:cut]
        assert (src == text) is (name == "current")
    assert "double* out_s = ring + kPStagesD * Tile::kStage;" in got["staged"]
    pair = [s for s in tk.JET_SHAPES_F64 if tjk.pair_body(s[2], s[3], s[4])]
    assert [(t, r, k, o) for t, r, k, _, _, o, _ in pair] == [
        (6, 64 * 96 * 96, 4, False), (6, 64 * 96 * 96, 32, False),
        (6, 16 * 162 * 162, 4, False), (6, 16 * 162 * 162, 32, False),
        (6, 128 * 28 * 28, 4, False), (6, 128 * 28 * 28, 32, False),
        (3, 32 * 96 * 96, 4, True), (3, 32 * 96 * 96, 32, True)]
    for t, r, k, c, mixed, _, _ in pair:
        assert tjk.kernel_variant(t, r, k, c, mixed, 132, torch.float64) == tjk.PAIR


class _Face:
    """A tensor's face on the card, as far as the wrappers' checks look."""

    def __init__(self, dtype):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype


@pytest.mark.parametrize("name,n_args", [
    ("fused_dense_tanh_jet", 5), ("fused_dense_tanh_jet_partial", 5),
    ("fused_dense_tanh_jet_mix", 8), ("fused_dense_tanh_jet_mix_partial", 8)])
def test_jet_wrappers_take_one_dtype(name, n_args, monkeypatch):
    """float32 val with float64 w (or any mix) raises TypeError; all
    float64 passes the checks (and then meets the face's missing storage);
    another dtype raises. No plain version is reached."""
    _forbid(monkeypatch, tjk, name + "_plain")
    fn = getattr(tjk, name)
    mixed = [_Face(torch.float32)] + [_Face(torch.float64)] * (n_args - 1)
    with pytest.raises(TypeError, match="one dtype"):
        fn(*mixed)
    mixed = [_Face(torch.float64)] * (n_args - 1) + [_Face(torch.float32)]
    with pytest.raises(TypeError, match="one dtype"):
        fn(*mixed)
    with pytest.raises(AttributeError):
        fn(*[_Face(torch.float64)] * n_args)
    with pytest.raises(TypeError, match="float32 or float64"):
        fn(*[_Face(torch.float16)] * n_args)


# ---- the plain float64 versions against the JAX package at float64 ----------


def _complex128(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape) + 1j * rng.randn(*shape)


@pytest.mark.parametrize("b,n", [(4, 48), (2, 81), (16, 14), (16, 5), (8, 16), (4, 32),
                                 (2, 96)])
def test_gj_plain_complex128_matches_jax_lapack(b, n):
    """The plain version the complex128 body is held against on the card,
    against JAX's float64 det_factor (LU, its LAPACK path): 1e-12 relative
    to the inverse's scale, 1e-12 in sign and log|det| (Gaussian matrices
    with a diagonal shift, condition numbers of a few tens)."""
    a = _complex128((b, n, n), seed=n) / np.sqrt(2 * n) + 2.0 * np.eye(n)
    ainv, sign, logdet = tdk.gj_inverse_slogdet_plain(torch.from_numpy(a))
    assert ainv.dtype == torch.complex128 and logdet.dtype == torch.float64
    want = [np.asarray(x) for x in jfl.det_factor(jnp.asarray(a))]
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(ainv.numpy(), want[0], rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(sign.numpy(), want[1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(logdet.numpy(), want[2], rtol=0, atol=1e-12)


def _jet(shape, t_dim, rng):
    return (rng.randn(*shape), rng.randn(t_dim, *shape), rng.randn(*shape))


def test_jet_plain_float64_matches_jax():
    """The plain and mix rules in float64 (and the open forms, closed over
    two pieces of the tangent axis) against JAX's jnp jet rules at float64:
    1e-12 relative to each output's scale."""
    rng = np.random.RandomState(12)
    t_dim, groups, n, d_in, d_rc, d_out = 9, 3, 5, 12, 7, 16
    val, jac, lap = _jet((groups * n, d_in), t_dim, rng)
    w, b = rng.randn(d_in, d_out) / np.sqrt(d_in), rng.randn(d_out)

    def close(got, want):
        for g, w_ in zip(got, want):
            w_ = np.asarray(w_)
            np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                       atol=1e-12 * np.abs(w_).max())

    want = jfl.dense_tanh(jfl.Jet(*map(jnp.asarray, (val, jac, lap))),
                          jnp.asarray(w), jnp.asarray(b))
    want = (want.val, want.jac, want.lap)
    t = [torch.from_numpy(x) for x in (val, jac, lap, w, b)]
    close(tjk.fused_dense_tanh_jet_plain(*t), want)
    cut = slice(0, 4), slice(4, t_dim)
    parts = [tjk.fused_dense_tanh_jet_partial_plain(t[0], t[1][c], *t[2:]) for c in cut]
    close((parts[0][0], torch.cat([p[1] for p in parts]),
           tjk.close_laplacian(parts[0][0], parts[0][2], parts[0][3] + parts[1][3])),
          want)

    # the mix rule: G walkers of n rows, a row-constant jet per walker
    rv = [x.reshape(x.shape[:-2] + (groups, n, d_in)) for x in (val, jac, lap)]
    rc = _jet((groups, 1, d_rc), t_dim, rng)
    w_rc = rng.randn(d_rc, d_out) / np.sqrt(d_rc)
    want = jfl.dense_tanh_mix(jfl.Jet(*map(jnp.asarray, rv)),
                              jfl.Jet(*map(jnp.asarray, rc)),
                              jnp.asarray(w), jnp.asarray(w_rc), jnp.asarray(b))
    want = (want.val, want.jac, want.lap)
    zbc, lbc = ((x @ w_rc).reshape(groups, d_out) for x in (rc[0], rc[2]))
    jbc = (rc[1] @ w_rc).reshape(t_dim, groups, d_out)
    args = [torch.from_numpy(x) for x in (*rv, zbc, lbc, jbc, w, b)]
    close(tjk.fused_dense_tanh_jet_mix_plain(*args), want)
    parts = [tjk.fused_dense_tanh_jet_mix_partial_plain(
        args[0], args[1][c], args[2], args[3], args[4], args[5][c], *args[6:])
        for c in cut]
    close((parts[0][0], torch.cat([p[1] for p in parts]),
           tjk.close_laplacian(parts[0][0], parts[0][2], parts[0][3] + parts[1][3])),
          want)


# ---- a float64 run's checkpoint in a float32 run, and back --------------------


def test_float64_checkpoint_restores_into_float32_and_back(tmp_path):
    """KFAC iterations in float64 write a checkpoint that a float32 run
    restores and continues, and the float32 run's checkpoint continues in
    float64: each run's parameters and walkers take its own dtype, and each
    continuation stays within float32 rounding (1e-4 relative) of the
    run that stayed in float64."""
    import shutil

    from deepsolid_tpu_torch.train import process as tprocess
    from deepsolid_tpu_torch.utils import checkpoint as tckpt
    from deepsolid_tpu_torch.utils.tree import tree_leaves
    from test_torch_training import flat, seed_state, torch_cfg, write_start

    _, _, params, x = seed_state(n_walkers=8, seed=5)

    def run(path, precision, iterations):
        cfg = torch_cfg(path, optimizer="kfac", iterations=iterations, el_chunk=4)
        cfg.precision = precision
        cfg.optim.lr.rate = 1e-3
        out, data, _ = tprocess.process(cfg, device="cpu")
        want = {"float32": torch.float32, "float64": torch.float64}[precision]
        assert data.dtype == want and all(
            p.dtype == want for p in tree_leaves(out))
        return out

    def last(path):
        return tckpt.restore(tckpt.find_last_checkpoint(str(path)))

    write_start(tmp_path / "f64", params, x)
    run(tmp_path / "f64", "float64", 2)
    _, data, p64, state, _ = last(tmp_path / "f64")
    assert data.dtype == np.float64 and state["damping"].dtype == np.float64
    shutil.copytree(tmp_path / "f64", tmp_path / "to_f32")
    shutil.copytree(tmp_path / "f64", tmp_path / "stay")

    in_f32 = run(tmp_path / "to_f32", "float32", 3)
    _, data, _, state, _ = last(tmp_path / "to_f32")
    assert data.dtype == np.float32 and state["damping"].dtype == np.float32
    stay = run(tmp_path / "stay", "float64", 3)
    np.testing.assert_allclose(flat(in_f32), flat(stay), rtol=1e-4, atol=1e-5)

    back = run(tmp_path / "to_f32", "float64", 4)
    _, data, _, state, _ = last(tmp_path / "to_f32")
    assert data.dtype == np.float64 and state["damping"].dtype == np.float64
    stay = run(tmp_path / "stay", "float64", 4)
    np.testing.assert_allclose(flat(back), flat(stay), rtol=1e-4, atol=1e-5)
