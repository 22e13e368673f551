"""Operation and byte counts against hand counts at tiny shapes."""

import pytest

from portbench.counts import kernels, peaks, step


def test_b1_counts():
    # 3 matrices of 2 x 2 complex64: 3 * 2 * 4 entries * 8 bytes in and out,
    # a complex sign and a real log-modulus each; 8 * 2^3 flops a matrix
    nbytes, flops = kernels.b1(3, 2, 4)
    assert nbytes == 2 * 3 * 4 * 8 + 3 * (8 + 4)
    assert flops == 8 * 8 * 3


def test_jet_counts():
    # t = 1 tangent: 3 columns; 2 rows, 2 -> 3, one mix group
    nbytes, flops = kernels.jet(1, 2, 2, 3, mix_groups=1, real_bytes=8)
    assert nbytes == 8 * (3 * 2 * 2 + 2 * 3 + 3 + 3 * 2 * 3 + 3 * 1 * 3)
    assert flops == 2 * 3 * 2 * 2 * 3


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(3.35e12, 1.0, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 67e12, "float64") == pytest.approx(1.0)


CONF = {"network": {"hidden_dims": [[4, 2], [4, 2]], "determinants": 1},
        "atoms": [{"charge": 1.0}], "supercell": [[2, 0, 0], [0, 1, 0], [0, 0, 1]]}


def test_value_pass_by_hand():
    # 2 electrons (1 + 1), one atom: f1 = 4, f2 = 4, two channels
    # layer 0: rows 2 x (4 + 2*4) -> 4, means 2*4 -> 4; pair 2*2 rows 4 -> 2
    # layer 1: rows 2 x (4 + 2*2) -> 4, means 2*4 -> 4
    # orbitals: per channel 1 row, 4 -> 2*1*1; determinants 8 * 1^3 each
    want = (2 * (2 * 12 + 8) * 4 + 2 * 4 * 4 * 2 + 2 * (2 * 8 + 8) * 4
            + 2 * (2 * 1 * 4 * 2) + 2 * 8)
    assert step.value_flops(CONF) == want


def test_local_energy_pass_by_hand():
    # T = 6 tangents: 8 columns, the pair stream 8 columns, determinants
    # (1 + T) products each
    want = (2 * 8 * (2 * 12 + 8) * 4 + 2 * 8 * 4 * 4 * 2 + 2 * 8 * (2 * 8 + 8) * 4
            + 2 * (2 * 8 * 4 * 2) + 2 * 8 * 7)
    assert step.local_energy_flops(CONF) == want


def test_iteration_adds_up():
    v, e, k = step.value_flops(CONF), step.local_energy_flops(CONF), step.kfac_flops(CONF)
    inv = step.inverse_flops(CONF)
    assert step.iteration_flops(CONF, 3, 20, False) == 3 * (28 * v + e + k) + inv
    assert step.iteration_flops(CONF, 3, 20, True) == 3 * (28 * v + 2 * e + k) + inv
    # no optimizer: the sampler and one E_L pass, whether or not the step adapts
    assert step.iteration_flops(CONF, 3, 20, True, "none") == 3 * (20 * v + e)
