"""The det head kernel's roofline share (portbench/metrics/dethead_roofline.py)
and its launch reckoning (portbench/counts/dethead.py) on synthetic run
records: two launches an E_L chunk, one more pass where an iteration
adapted KFAC's damping, only the profiled iterations counted."""

import pytest

from portbench import spec
from portbench.counts import dethead, peaks

CONF = {"network": {"determinants": 8}, "supercell": [[2, 0, 0], [0, 2, 0], [0, 0, 2]],
        "atoms": [{"charge": 14.0}, {"charge": 14.0}]}  # Si 2x2x2: 224 electrons


def _run(traced, batch=512, el_chunk=32, precision="float32", kernels=None, warmup=1,
         window=2):
    """A record with `warmup` iterations, a window of `window`, then the
    profiled iterations, each adapting or not as `traced` says."""
    its = ([{"adapted": True}] * (warmup + window)
           + [{"adapted": adapted} for adapted in traced])
    return {"config": CONF, "precision": precision,
            "traffic": {"batch_size": batch, "el_chunk": el_chunk, "warmup_iterations": warmup},
            "window_iterations": its[warmup:warmup + window], "iterations": its,
            "trace": {"kernels": kernels if kernels is not None
                      else {"dethead_trace_kernel": 1.0, "gj_mid_kernel": 5.0}}}


def _read(run):
    return spec.reader("dethead_roofline")(run)


@pytest.mark.parametrize("traced,passes", [((False,), 1), ((True,), 2),
                                           ((False, True), 3), ((True, True), 4)],
                         ids=["plain", "adapted", "two_one_adapted", "two_adapted"])
def test_launches_two_a_chunk_a_pass(traced, passes):
    # 512 walkers in chunks of 32: 16 chunks, a launch per channel each, on
    # (32 x 8, 112, 672); the warm-up and window iterations not counted
    got = dethead.launches(_run(traced))
    assert got == {(256, 112, 672): 2 * 16 * passes}
    assert sum(got.values()) == 16 * (len(traced) + sum(traced)) * 2


def test_launches_of_a_ragged_or_unchunked_batch():
    assert dethead.launches(_run((False,), batch=80, el_chunk=32)) == {
        (256, 112, 672): 2 * 2, (128, 112, 672): 2}
    assert dethead.launches(_run((True,), batch=64, el_chunk=0)) == {(512, 112, 672): 4}


def test_launches_by_channel_for_odd_electrons():
    run = _run((False,), batch=32, el_chunk=32)
    run["config"] = {**CONF, "supercell": [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     "atoms": [{"charge": 3.0}]}  # 3 electrons: channels of 1 and 2
    assert dethead.launches(run) == {(256, 1, 9): 1, (256, 2, 9): 1}


def test_launch_counts_by_hand():
    # 2 matrices of 3 x 3, 4 tangents, float32: jr 4 x 2 x (2 x 9) reals and
    # the row constants 4 x 2 x 6, six complex 3 x 3 factors a matrix, 4
    # traces and l2 a matrix; 8 x 27 flops a matrix and tangent
    nbytes, flops = dethead.launch(2, 3, 4, 4)
    assert nbytes == 4 * (4 * 2 * 18 + 4 * 2 * 6) + 8 * 2 * (6 * 9 + 4 + 1)
    assert flops == 8 * 27 * 2 * 4


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_share_over_every_instantiation(precision):
    # the bound of 2 x 16 launches over the device time of both templates
    run = _run((False,), precision=precision,
               kernels={"dethead_trace_kernel": 3.0, "dethead_trace_kernel_x": 1.0,
                        "gj_shared_kernel": 9.0})
    real = 8 if precision == "float64" else 4
    nbytes, flops = dethead.launch(256, 112, 672, real)
    want = 100.0 * 32 * peaks.bound_s(nbytes, flops, precision) / 4.0
    assert _read(run) == pytest.approx(want)
    assert 0 < want < 100


def test_nothing_to_read_without_the_kernel_or_a_trace():
    # the composition ran (the kernel did not serve n), or no profile
    assert _read(_run((False,), kernels={"gj_shared_kernel": 2.0})) is None
    run = _run((False,))
    run["trace"] = None
    assert _read(run) is None
    assert _read(_run((), kernels={"dethead_trace_kernel": 1.0})) is None
