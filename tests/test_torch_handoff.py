"""Restoring the post-pretraining handoff checkpoint (step 0, no optimizer
state, as process() writes it after pretraining), on the float64 LiH test
cell.

The port starts such a run at iteration 0 and burns in first, without
pretraining again; any other restore resumes at t + 1 without a burn-in.
The JAX package restores the handoff at t = 1 and skips the burn-in: the
last test pins that, so the departure stays visible beside the port's
behaviour.
"""

import logging

import numpy as np
import pytest

from deepsolid_tpu_torch.models.network import params_from_jax
from deepsolid_tpu_torch.optim import adam as tadam
from deepsolid_tpu_torch.train import pretrain as tpretrain
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import checkpoint as tckpt

from test_torch_training import (  # noqa: F401  (one_device_jax is a fixture)
    F64, jax_cfg, one_device_jax, seed_state, torch_cfg)

BURN_IN = 3
ITERATIONS = 2


def port_cfg(save_path, iterations):
    cfg = torch_cfg(save_path, iterations=iterations, el_chunk=4)
    cfg.mcmc.burn_in, cfg.mcmc.steps = BURN_IN, 1
    cfg.pretrain.method, cfg.pretrain.iterations = "net", 5
    return cfg


def write_checkpoint(path, t, with_state=False):
    """The LiH network's seeded parameters and walkers saved as step t,
    with a fresh adam state or none."""
    _, _, params, x = seed_state(n_walkers=8, seed=5)
    state = None
    if with_state:
        opt = tadam.Adam.from_config(port_cfg(path, 1))
        state = tadam.state_to_numpy(opt.init(params_from_jax(params, dtype=F64)))
    path.mkdir(parents=True, exist_ok=True)
    return tckpt.save(str(path), t, x, params, state, None)


def port_run(save_path, monkeypatch, iterations=ITERATIONS):
    """process() (adam) on the checkpoint in `save_path`, with pretraining
    asked for and recorded instead of run: the iterations it ran, each with
    the sampler calls made up to it, and the pretraining calls."""
    pretrained, calls, steps = [], [0], []
    monkeypatch.setattr(tprocess, "orbital_source", lambda cfg, sc: None)
    monkeypatch.setattr(tpretrain, "pretrain", lambda *a, **k: pretrained.append(a))
    make_step = tprocess.make_mcmc_step

    def counted(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def call(*a, **k):
            calls[0] += 1
            return step(*a, **k)
        return call

    monkeypatch.setattr(tprocess, "make_mcmc_step", counted)
    tprocess.process(port_cfg(save_path, iterations), device="cpu",
                     on_iteration=lambda t, row, s: steps.append((t, calls[0])))
    return steps, pretrained


def test_handoff_restore_burns_in_and_starts_at_iteration_0(tmp_path, monkeypatch,
                                                            caplog):
    """The sampler runs the burn-in's sweeps and then one per iteration:
    BURN_IN + 1 calls before the first loss, BURN_IN + ITERATIONS in all;
    no pretraining, and the clock starts at 0."""
    write_checkpoint(tmp_path, 0)
    with caplog.at_level(logging.INFO):
        steps, pretrained = port_run(tmp_path, monkeypatch)
    assert pretrained == []
    assert any("Burning in" in r.getMessage() for r in caplog.records)
    assert steps == [(t, BURN_IN + 1 + t) for t in range(ITERATIONS)]
    # the checkpoint of its last iteration holds adam's state: a restart
    # from it resumes at ITERATIONS
    t, _, _, state, _ = tckpt.restore(tckpt.find_last_checkpoint(str(tmp_path)))
    assert t == ITERATIONS and state is not None


@pytest.mark.parametrize("t,with_state", [(0, True), (2, False)])
def test_other_restores_resume_at_t_plus_1_without_burn_in(tmp_path, monkeypatch, t,
                                                          with_state):
    """A checkpoint with an optimizer state, or of a step past 0, resumes
    at t + 1: one sampler call per iteration, no burn-in, no pretraining."""
    write_checkpoint(tmp_path, t, with_state)
    steps, pretrained = port_run(tmp_path, monkeypatch, iterations=t + 1 + ITERATIONS)
    assert pretrained == []
    assert steps == [(t + 1 + i, i + 1) for i in range(ITERATIONS)]


def test_jax_restores_the_handoff_at_t1_without_burn_in(tmp_path, one_device_jax,
                                                        caplog):
    """The JAX package's process() on the same handoff: its first
    iteration is 1 and it never burns in (a defect the port repairs, not
    the reference)."""
    from deepsolid_tpu.train import process as jprocess
    from torch_helpers import lih_cells

    write_checkpoint(tmp_path, 0)
    cfg = jax_cfg(tmp_path, lih_cells()[0], iterations=ITERATIONS + 1, el_chunk=4)
    cfg.mcmc.burn_in, cfg.mcmc.steps = BURN_IN, 1
    with caplog.at_level(logging.INFO):
        jprocess.process(cfg)
    assert not any("Burning in" in r.getMessage() for r in caplog.records)
    rows = open(tmp_path / "train_stats.csv").read().strip().split("\n")[1:]
    assert [int(float(r.split(",")[0])) for r in rows] == list(range(1, ITERATIONS + 1))
    assert all(np.isfinite(float(r.split(",")[1])) for r in rows)
