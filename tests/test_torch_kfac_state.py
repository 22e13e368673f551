"""The KFAC state across checkpoints, packages and ranks (CPU, float64).

A checkpoint written by the port's KFAC run is read by the JAX package,
which continues from it, and the reverse; the committed C-diamond 2x2x2
checkpoint's KFAC state is restored, not dropped, and the run continues at
its optimizer step; two data ranks (gloo) take the steps one process takes.
Rank workers at module level import no JAX.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.configs import diamond as tdiamond
from deepsolid_tpu_torch.optim import kfac as tkfac
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import checkpoint as tckpt
from test_torch_kfac import assert_trees_close, with_kfac
from test_torch_training import (  # noqa: F401  (one_device_jax is a fixture)
    RANK_TIMEOUT, flat, jax_cfg, jflat, one_device_jax, same_order, seed_state,
    torch_cfg, write_start)
from torch_helpers import REPO_SCF_CACHE

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT_DIR = str(REPO / "runs" / "ckpt_diamond")


def kfac_cfg(path, iterations, **kfac):
    return with_kfac(torch_cfg(path, optimizer="kfac", iterations=iterations,
                               el_chunk=4, psi_chunk=4), **kfac)


def test_kfac_checkpoints_are_interchangeable(tmp_path, one_device_jax):
    """The port's end-of-run checkpoint restores in the JAX package, KFAC
    state included, and JAX continues training from it; JAX's restores in
    the port, which continues to the same parameters: both continued runs
    equal four uninterrupted iterations of the port. rtol 1e-8."""
    from deepsolid_tpu.train import process as jprocess
    from deepsolid_tpu.utils import checkpoint as jckpt
    from torch_helpers import lih_cells

    _, _, params, x = seed_state(n_walkers=8, seed=3)
    jsc, _ = lih_cells()

    def jcfg(path, iterations):
        return with_kfac(jax_cfg(path, jsc, optimizer="kfac", iterations=iterations,
                                 el_chunk=4, psi_chunk=4))

    # the port writes (2 iterations); JAX reads and continues to 4
    write_start(tmp_path / "a", params, x)
    tprocess.process(kfac_cfg(tmp_path / "a", 2), device="cpu")
    t, data, _, jstate, width = jckpt.restore(str(tmp_path / "a" / "qmcjax_ckpt_000001.npz"))
    assert t == 2 and data.shape == (8, 12) and float(width) == 0.02
    assert list(jstate) == ["step", "velocities", "blocks", "env_blocks", "diag",
                            "damping", "rho"]
    assert int(jstate["step"]) == 2 and jstate["step"].dtype == np.int32
    assert jstate["blocks"]["double_0"]["a_raw"].shape == (5, 5)
    ja, _, _ = jprocess.process(jcfg(tmp_path / "a", 4))

    # JAX writes (2 iterations); the port reads and continues to 4
    write_start(tmp_path / "b", params, x)
    jprocess.process(jcfg(tmp_path / "b", 2))
    t, _, _, state, _ = tckpt.restore(str(tmp_path / "b" / "qmcjax_ckpt_000001.npz"))
    assert t == 2 and tkfac.is_kfac_state(state) and int(state["step"]) == 2
    steps = []
    tb, _, _ = tprocess.process(
        kfac_cfg(tmp_path / "b", 4), device="cpu",
        on_iteration=lambda t, row, s: steps.append((t, row["optimizer_step"])))
    assert steps == [(2, 2), (3, 3)]

    write_start(tmp_path / "c", params, x)
    tc, _, _ = tprocess.process(kfac_cfg(tmp_path / "c", 4), device="cpu")
    # (a tree that went through JAX comes back with its keys sorted)
    np.testing.assert_allclose(flat(same_order(tc, tb)), flat(tc), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(jflat(same_order(tc, ja)), flat(tc), rtol=1e-8, atol=1e-12)


def test_kfac_state_round_trips_through_a_checkpoint(tmp_path):
    """state_to_numpy -> checkpoint -> state_from_numpy gives the state
    back leaf for leaf, and a state that lacks the adaptive-damping keys
    (an older schema) restores with the fresh state's."""
    net, _, params, x = seed_state(n_walkers=4)
    tparams = tprocess.params_from_jax(params, dtype=torch.float64)
    opt = tkfac.KfacOptimizer(net, lambda t: 0.01, damping=0.02)
    state = opt.update_curvature(opt.init(tparams), tparams, torch.tensor(x))
    _, state = opt.step_fn(tparams, state, tparams, state["damping"])
    os.makedirs(tmp_path / "s")
    tckpt.save(str(tmp_path / "s"), 0, x, params, tkfac.state_to_numpy(state), 0.02)
    _, _, _, raw, _ = tckpt.restore(str(tmp_path / "s" / "qmcjax_ckpt_000000.npz"))
    back = tkfac.state_from_numpy(raw, "cpu", torch.float64)
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 1
    assert_trees_close(back, state, rtol=0)
    old = {k: v for k, v in raw.items() if k not in ("damping", "rho")}
    merged = tkfac.merge_restored(opt.init(tparams),
                                  tkfac.state_from_numpy(old, "cpu", torch.float64))
    assert float(merged["damping"]) == 0.02 and int(merged["step"]) == 1
    assert not tkfac.is_kfac_state(None) and not tkfac.is_kfac_state((1, 2))


def test_kfac_ignores_another_optimizers_state(tmp_path, caplog):
    """An adam checkpoint under optimizer='kfac': a fresh KFAC state, said so."""
    _, _, params, x = seed_state(n_walkers=4)
    write_start(tmp_path / "k", params, x)
    tprocess.process(torch_cfg(tmp_path / "k", iterations=1, batch=4), device="cpu")
    steps = []
    tprocess.process(torch_cfg(tmp_path / "k", optimizer="kfac", iterations=2, batch=4),
                     device="cpu",
                     on_iteration=lambda t, row, s: steps.append((t, row["optimizer_step"])))
    assert steps == [(1, 0)]
    assert "another optimizer" in caplog.text


def test_committed_diamond_kfac_state_is_restored(tmp_path, monkeypatch):
    """One KFAC iteration of the full-width C-diamond 2x2x2 network from
    the committed checkpoint: its state (step 582, damping 1.0, seven
    Kronecker blocks from 5 x 5 to 833 x 833, four diagonal entries) is
    restored, the run continues at optimizer step 582, and the checkpoint
    it writes carries step 583."""
    t_start, _, _, raw, _ = tckpt.restore(tckpt.find_last_checkpoint(CKPT_DIR))
    assert t_start == 582 and tkfac.is_kfac_state(raw)
    assert int(raw["step"]) == 582 and float(raw["damping"]) == 1.0
    shapes = {name: (b["a_raw"].shape, b["g_raw"].shape)
              for name, b in raw["blocks"].items()}
    assert shapes == {
        "single_0": ((33, 33), (256, 256)), "single_1": ((833, 833), (256, 256)),
        "single_2": ((833, 833), (256, 256)),
        "double_0": ((5, 5), (32, 32)), "double_1": ((33, 33), (32, 32)),
        "orbital_0": ((256, 256), (768, 768)), "orbital_1": ((256, 256), (768, 768))}
    assert sorted(raw["diag"]) == ["envelope/0/pi", "envelope/0/sigma",
                                   "envelope/1/pi", "envelope/1/sigma"]

    monkeypatch.setenv("DEEPSOLID_TPU_SCF_CACHE", REPO_SCF_CACHE)
    cfg = tdiamond.get_config("C,C,3.567,2,sto-3g")
    cfg.pretrain.scf = "hf"  # the committed UHF orbitals give the network's k-list
    cfg.batch_size = 2
    cfg.optim.optimizer = "kfac"
    cfg.optim.el_chunk = 1
    cfg.optim.psi_chunk = 1
    cfg.optim.kfac.adaptive_damping = True
    cfg.optim.kfac.damping_adaptation_interval = 10  # 582 is no multiple: no second E_L
    cfg.mcmc.burn_in = 0
    cfg.mcmc.steps = 1
    cfg.debug.deterministic = True
    cfg.log.restore_path = CKPT_DIR
    cfg.log.save_path = str(tmp_path / "run")
    seen = []
    params, _, energy = tprocess.process(
        cfg, max_iterations=t_start + 1, device="cpu",
        on_iteration=lambda t, row, s: seen.append((t, row, s)))
    assert [(t, row["optimizer_step"]) for t, row, _ in seen] == [(582, 582)]
    assert seen[0][1]["damping"] == 1.0 and "adapt" not in seen[0][2]
    assert np.isfinite(energy) and abs(energy + 66.0) < 15.0
    assert all(bool(torch.isfinite(p).all()) for p in tprocess.adam_lib.tree_leaves(params))
    _, _, _, after, _ = tckpt.restore(tckpt.find_last_checkpoint(str(tmp_path / "run")))
    assert int(after["step"]) == 583 and float(after["damping"]) == 1.0
    # one EMA step on a restored factor: old * 0.95 + this batch's part
    w_old = float(raw["blocks"]["double_0"]["weight"])
    assert float(after["blocks"]["double_0"]["weight"]) == pytest.approx(0.95 * w_old + 1)
    assert all(np.isfinite(b[k]).all() for b in after["blocks"].values()
               for k in ("a_raw", "g_raw", "a_inv", "g_inv"))


# ---- the data axis ---------------------------------------------------------------


def kfac_rank(rank, world_size, save_path, batch, iterations):
    torch.set_num_threads(1)
    cfg = with_kfac(torch_cfg(save_path, optimizer="kfac", iterations=iterations,
                              batch=batch, el_chunk=2, psi_chunk=2))
    rows = []
    params, data, _ = tprocess.process(
        cfg, device="cpu", on_iteration=lambda t, row, s: rows.append(
            {k: row[k] for k in ("energy", "grad_norm", "damping", "rho")}))
    return flat(params), data.numpy(), rows


def test_two_data_ranks_take_one_process_steps(tmp_path):
    """Two KFAC iterations on two gloo data ranks against one process on
    the same global batch: the Kronecker factors are averaged over the
    ranks, and the diagonal factor's batch-summed gradients are summed over
    them BEFORE squaring (squaring per-rank sums would give other envelope
    updates), so every rank ends with the single process's parameters,
    damping and rho. rtol 1e-9."""
    _, _, params, x = seed_state(n_walkers=8, seed=4)
    write_start(tmp_path / "one", params, x)
    write_start(tmp_path / "many", params, x)
    want, _, want_rows = kfac_rank(0, 1, str(tmp_path / "one"), 8, 2)
    out = parallel.run_ranks(kfac_rank, 2, (str(tmp_path / "many"), 8, 2),
                             timeout=RANK_TIMEOUT)
    for rank, (got, data, rows) in enumerate(out):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-13,
                                   err_msg=f"rank {rank}")
        np.testing.assert_array_equal(data, x[4 * rank:4 * rank + 4])
        for row, want_row in zip(rows, want_rows):
            for key in want_row:
                np.testing.assert_allclose(row[key], want_row[key], rtol=1e-9)
    one = tckpt.restore(str(tmp_path / "one" / "qmcjax_ckpt_000001.npz"))[3]
    many = tckpt.restore(str(tmp_path / "many" / "qmcjax_ckpt_000001.npz"))[3]
    assert_trees_close(many["diag"], one["diag"], rtol=1e-9, atol=1e-18)
    assert_trees_close(many["blocks"], one["blocks"], rtol=1e-9, atol=1e-13)
