"""`correct` comes out false for the control and for every fault the
cells can have, and true for the sound program, at a tiny float64 cell on
the CPU held to the float64 cell's limits.

The control is the reference computed in float32 in the program's place.
The faults are planted in the program underneath a whole run (the card's
look skipped): the KFAC step returns its state unchanged; the loss and
gradient take half of the batch, the mean over the rest; the sampler's
log|psi| of one walker is altered where the value path produces it; one
E_L chunk is computed wrong; the sampler never moves, or returns a walker
that is neither where it was nor its proposal. The cells run on one
card, so no exchange between cards can be left out."""

import pytest
import torch

from portbench import check, harness, spec
from portbench.tests.tiny import make_cell

LIMITS = spec.load_json(spec.HERE / "limits" / "diamond-f64-kfac-1024.json")


def _run(tmp_path, batch=8, optimizer="kfac", **kwargs):
    cell = make_cell(tmp_path, limits=LIMITS, batch=batch, optimizer=optimizer)
    return harness.run_cell(cell, 2**31 + 77, 0.0, False, device="cpu", **kwargs)


def _checks(record):
    return {name: value for name, value, _ in record["checks"]}


def test_sound_run_is_correct_and_the_control_is_not(tmp_path):
    record = _run(tmp_path, control=True)
    assert record["correct"], record["checks"]
    assert set(_checks(record)) == set(check.NAMES)
    ok, rows = check.judge(record["control"], LIMITS)
    assert not ok, rows


def test_without_an_optimizer_the_energy_and_sampler_are_checked(tmp_path, monkeypatch):
    """A mix with optimizer 'none' runs from its files alone: the program
    takes no gradient, and the gradient and update numbers drop out."""
    record = _run(tmp_path, optimizer="none")
    assert record["correct"], record["checks"]
    assert set(_checks(record)) == set(check.NAMES) - {"grad_gap", "update_gap"}
    assert spec.reader("optimizer_s")(record) is None
    assert spec.reader("step_mfu")(record) > 0


def test_state_left_unchanged(tmp_path, monkeypatch):
    from deepsolid_tpu_torch.optim import kfac as kfac_lib

    monkeypatch.setattr(kfac_lib.KfacOptimizer, "step",
                        lambda self, params, state, *a, **k: (params, state))
    record = _run(tmp_path)
    assert not record["correct"]
    assert _checks(record)["update_gap"] == pytest.approx(1.0)


def test_half_the_batch(tmp_path, monkeypatch):
    from deepsolid_tpu_torch.train import process as process_mod

    make_loss = process_mod.make_loss

    def half_loss(*args, **kwargs):
        inner = make_loss(*args, **kwargs)

        def total(params, data):
            return inner(params, data[:data.shape[0] // 2])

        total.gradient = lambda params, data, loss, aux: inner.gradient(
            params, data[:data.shape[0] // 2], loss, aux)
        total.value_and_grad = inner.value_and_grad
        return total

    monkeypatch.setattr(process_mod, "make_loss", half_loss)
    assert not _run(tmp_path)["correct"]


def test_an_answer_altered(tmp_path, monkeypatch):
    from deepsolid_tpu_torch.models import network

    slogdet = network.Network.slogdet

    def altered(self, params, x):
        out = slogdet(self, params, x).clone()
        out[0] += 1.0
        return out

    monkeypatch.setattr(network.Network, "slogdet", altered)
    record = _run(tmp_path)
    assert not record["correct"]
    assert _checks(record)["logpsi_gap"] >= 0.99


def test_one_local_energy_chunk_wrong(tmp_path, monkeypatch):
    """E_L of the first chunk (4 of 8 walkers) off by 0.1 Ha a primitive
    cell: the median of that chunk moves, whatever the others read."""
    from deepsolid_tpu_torch.train import process as process_mod

    make_loss = process_mod.make_loss

    def chunk_off(*args, **kwargs):
        inner = make_loss(*args, **kwargs)

        def total(params, data):
            loss, aux = inner(params, data)
            aux.local_energy[:4] += 0.1
            return loss, aux

        total.gradient = inner.gradient
        total.value_and_grad = inner.value_and_grad
        return total

    monkeypatch.setattr(process_mod, "make_loss", chunk_off)
    record = _run(tmp_path)
    assert not record["correct"]
    # the gradient takes the altered E_L, so step 1's E_L moves a little more
    assert _checks(record)["el_gap"] >= 0.1 - 1e-9


@pytest.mark.parametrize("fault", ["never_moves", "off_the_move"])
def test_sampler_faults(fault, tmp_path, monkeypatch):
    """The accept-or-reject step keeps every walker where it was (read by
    accept_z, at a batch large enough for the rule's expectation to
    show), or returns one walker moved off both its place and its
    proposal (read by move_rows)."""
    from deepsolid_tpu_torch.sampling import mcmc

    accept = mcmc._accept

    def faulty(x1, x2, lp_1, lp_2, ratio, uniform, num_accepts):
        if fault == "never_moves":
            return x1, lp_1, num_accepts
        x, lp, n = accept(x1, x2, lp_1, lp_2, ratio, uniform, num_accepts)
        x = x.clone()
        x[0, 0] += 1e-3
        return x, lp, n

    monkeypatch.setattr(mcmc, "_accept", faulty)
    record = _run(tmp_path, batch=64 if fault == "never_moves" else 8)
    assert not record["correct"]
    checks = _checks(record)
    if fault == "never_moves":
        assert checks["accept_z"] > LIMITS["accept_z"]
    else:
        assert checks["move_rows"] >= 1
