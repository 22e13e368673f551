"""The window holds whole iterations and its rate is all the work over all
its time."""

import pytest

from portbench import spec, window


@pytest.mark.parametrize("seconds,held", [(10.0, 2), (18.0, 2), (18.1, 3), (100.0, None)])
def test_window_closes_after_the_first_iteration_past_the_seconds(seconds, held):
    ends = [12.0, 21.0, 30.5, 39.0]          # iterations after a warm-up ending at 3.0
    closing = [i + 1 for i, end in enumerate(ends) if window.closes(3.0, end, seconds)]
    assert (closing[0] if closing else None) == held


def test_rate_is_all_work_over_all_time():
    its = [{"seconds": {"mcmc": 2.0, "local_energy": 6.0}, "adapted": False},
           {"seconds": {"mcmc": 2.0, "local_energy": 6.0, "adapt": 6.0}, "adapted": True},
           {"seconds": {"mcmc": 3.0, "local_energy": 5.0}, "adapted": False}]
    s = window.summary(its, 10.0, 40.0, batch=100)
    run = {"window": s, "batch": 100}
    # 300 walkers over 30 s, not the mean of the iterations' rates
    assert spec.reader("train_walkers_per_s")(run) == pytest.approx(10.0)
    assert spec.reader("mcmc_s")(run) == pytest.approx(7.0 / 3)
    # E_L passes: 3 + 1 adapted, over local_energy + adapt seconds
    assert spec.reader("el_walkers_per_s")(run) == pytest.approx(400 / 23.0)


def test_readers_with_nothing_to_read_return_none():
    run = {"trace": None}
    for name in ("b1_roofline", "jet_roofline", "device_idle"):
        assert spec.reader(name)(run) is None


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::gj_warp_kernel<16>(float2 const*, int)", "gj_warp_kernel"),
    ("(anonymous namespace)::dense_tanh_jet_dmma_kernel<true>(double const*)",
     "dense_tanh_jet_dmma_kernel"),
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float>(float)",
     "kernel"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8", "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8"),
])
def test_kernel_names_group_by_their_short_name(name, short):
    from portbench.trace import short_name

    assert short_name(name) == short
