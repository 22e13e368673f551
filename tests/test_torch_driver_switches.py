"""The remaining switches of process() against the JAX package, on the CPU in
float64: the complex polarization column, structure_factor.csv and
local_energies.csv; debug.check_nan's discard of a non-finite update; the
importance and one-electron samplers in process(); and the keys of the
H10 run scripts through the port's config and command line."""

import os
import re
import sys

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import cli, parallel
from deepsolid_tpu_torch.configs import hydrogen_chain
from deepsolid_tpu_torch.optim import adam as tadam
from deepsolid_tpu_torch.train import process as tprocess
from test_torch_training import (  # noqa: F401  (one_device_jax is a fixture)
    RANK_TIMEOUT, flat, jax_cfg, one_device_jax, seed_state, torch_cfg, write_start)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_KEYS = ("mcmc.importance_sampling", "mcmc.one_electron", "log.local_energies",
            "log.complex_polarization", "log.structure_factor", "debug.check_nan")


def observables_on(cfg):
    cfg.log.complex_polarization = True
    cfg.log.structure_factor = True
    cfg.log.local_energies = True
    cfg.log.stats_frequency = 2
    return cfg


def read_rows(path):
    """{t: [floats]} of a CSV whose rows start with the iteration."""
    rows = {}
    for line in open(path).read().strip().split("\n"):
        t, *values = line.split(",")
        rows[int(t)] = [float(v) for v in values]
    return rows


def test_observable_files_match_jax(tmp_path, one_device_jax):
    """Fixed walkers (mcmc.steps = 0), three adam iterations, statistics
    every second one: the polarization column of train_stats, every
    iteration's S(k) and the per-walker E_L rows to 1e-8."""
    from deepsolid_tpu.train import process as jprocess
    from torch_helpers import lih_cells

    _, _, params, x = seed_state(n_walkers=8, seed=4)
    for side in ("jax", "torch"):
        write_start(tmp_path / side, params, x)
    jsc, _ = lih_cells()
    jprocess.process(observables_on(jax_cfg(tmp_path / "jax", jsc, el_chunk=4)))
    tprocess.process(observables_on(torch_cfg(tmp_path / "torch", el_chunk=4)),
                     device="cpu")

    jstats = open(tmp_path / "jax" / "train_stats.csv").read().strip().split("\n")
    tstats = open(tmp_path / "torch" / "train_stats.csv").read().strip().split("\n")
    assert tstats[0] == jstats[0] and tstats[0].endswith(",complex_polarization")
    assert len(tstats) == len(jstats) == 3  # t = 0 and 2
    for jr, tr in zip(jstats[1:], tstats[1:]):
        np.testing.assert_allclose(float(tr.split(",")[-1]), float(jr.split(",")[-1]),
                                   rtol=1e-8, atol=1e-12)
    for name, steps, width in (("structure_factor.csv", [0, 1, 2], 64),
                               ("local_energies.csv", [0, 2], 16)):
        jrows = read_rows(tmp_path / "jax" / name)
        trows = read_rows(tmp_path / "torch" / name)
        assert sorted(trows) == sorted(jrows) == steps
        for t in steps:
            assert len(trows[t]) == width
            np.testing.assert_allclose(trows[t], jrows[t], rtol=1e-8, atol=1e-10)


def observables_rank(rank, world_size, save_path):
    torch.set_num_threads(1)
    tprocess.process(observables_on(torch_cfg(save_path, iterations=3, el_chunk=2)),
                     device="cpu")


def test_observable_files_on_two_data_ranks_equal_one_process(tmp_path):
    """Rank 0 writes the means over both ranks and the gathered E_L of the
    global batch."""
    _, _, params, x = seed_state(n_walkers=8, seed=4)
    write_start(tmp_path / "one", params, x)
    write_start(tmp_path / "two", params, x)
    observables_rank(0, 1, str(tmp_path / "one"))
    parallel.run_ranks(observables_rank, 2, (str(tmp_path / "two"),), timeout=RANK_TIMEOUT)
    for name in ("train_stats.csv", "structure_factor.csv", "local_energies.csv"):
        one = open(tmp_path / "one" / name).read().strip().split("\n")
        two = open(tmp_path / "two" / name).read().strip().split("\n")
        if name == "train_stats.csv":  # its complex_polarization column
            assert one[0] == two[0]
            one, two = ([r.rsplit(",", 1)[1] for r in rows[1:]] for rows in (one, two))
        assert len(one) == len(two) > 1
        for a, b in zip(one, two):
            np.testing.assert_allclose(np.array(b.split(","), float),
                                       np.array(a.split(","), float), rtol=1e-9, atol=1e-12)


def test_check_nan_discards_a_non_finite_update(tmp_path, monkeypatch):
    """The second update is poisoned: that iteration leaves no row and no
    record, the run goes on from the state before it, and three
    iterations end where two clean ones do."""
    _, _, params, x = seed_state(n_walkers=4, seed=5)
    write_start(tmp_path / "clean", params, x)
    clean, _, _ = tprocess.process(torch_cfg(tmp_path / "clean", iterations=2,
                                             batch=4, el_chunk=2), device="cpu")

    calls = []
    apply_updates = tadam.apply_updates

    def poisoned(p, updates):
        calls.append(1)
        out = apply_updates(p, updates)
        if len(calls) == 2:
            out = tadam.tree_map(lambda a: a * float("nan"), out)
        return out

    monkeypatch.setattr(tadam, "apply_updates", poisoned)
    write_start(tmp_path / "nan", params, x)
    cfg = torch_cfg(tmp_path / "nan", iterations=3, batch=4, el_chunk=2)
    cfg.debug.check_nan = True
    seen = []
    got, _, _ = tprocess.process(cfg, device="cpu",
                                 on_iteration=lambda t, row, s: seen.append(t))
    assert len(calls) == 3 and seen == [0, 2]
    rows = open(tmp_path / "nan" / "train_stats.csv").read().strip().split("\n")[1:]
    assert [int(r.split(",")[0]) for r in rows] == [0, 2]
    assert np.isfinite(flat(got)).all()
    np.testing.assert_array_equal(flat(got), flat(clean))


@pytest.mark.parametrize("switch", ["importance_sampling", "one_electron"])
def test_process_runs_each_sampler(tmp_path, switch):
    _, _, params, x = seed_state(n_walkers=4, seed=6)
    write_start(tmp_path, params, x)
    cfg = torch_cfg(tmp_path, iterations=2, batch=4, el_chunk=2, psi_chunk=2)
    cfg.mcmc.steps = 2
    cfg.mcmc.move_width = 0.3
    cfg.mcmc[switch] = True
    rows = []
    _, data, energy = tprocess.process(cfg, device="cpu",
                                       on_iteration=lambda t, row, s: rows.append(row))
    assert len(rows) == 2 and np.isfinite(energy)
    assert all(np.isfinite(r["energy"]) and 0 < r["pmove"] <= 1 for r in rows)
    assert not np.array_equal(data.numpy(), x)  # the walkers moved


@pytest.mark.parametrize("script", ["h10_imp_run.py", "h10_run.py"])
def test_h10_run_scripts_set_only_known_keys(script):
    """Every `cfg.` line of the run script on the port's hydrogen_chain."""
    text = open(os.path.join(REPO, "runs", script)).read()
    assert 'get_config("H,10,1,1,1.8,0,ccpvdz")' in text
    cfg = hydrogen_chain.get_config("H,10,1,1,1.8,0,ccpvdz")
    lines = re.findall(r"^cfg\.\S+ = .*$", text, flags=re.M)
    assert len(lines) >= 14
    for line in lines:
        exec(line, {"cfg": cfg, "sys": sys})
    assert cfg.mcmc.importance_sampling == (script == "h10_imp_run.py")
    assert cfg.batch_size == 2048 and sum(cfg.system.cell.nelec) == 10


@pytest.mark.parametrize("key", NEW_KEYS)
def test_cli_sets_the_new_keys_as_booleans(key):
    path = os.path.join(REPO, "deepsolid_tpu_torch", "configs", "hydrogen_chain.py")
    cfg, _ = cli.parse([f"--config={path}:H,10,1,1,1.8,0,ccpvdz", f"--config.{key}=True"])
    section, name = key.split(".")
    assert cfg[section][name] is True
    assert sum(cfg[s][n] is True for s, n in (k.split(".") for k in NEW_KEYS)) == 1
