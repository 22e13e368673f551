"""The plain reference against the port's CPU path, float64, at tiny
cells of both configurations: log psi, the local energy, the Coulomb
energy, the energy gradient and KFAC steps, from a fresh state and from
one the port wrote. The reference itself imports nothing of the port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import laplacian, network, step as rs
from portbench.reference.ewald import Ewald
from portbench.reference.system import System
from portbench.tests.tiny import make_cell

REFERENCE = Path(__file__).resolve().parent.parent / "reference"


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("deepsolid_tpu_torch", "deepsolid_tpu",
                                                  "jax", "chip_smoke"), (path.name, name)


def _port(cell, tmp_path):
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train import process as process_mod

    cfg = harness.program_config(cell.config, cell.traffic, tmp_path)
    sc = cfg.system.cell
    net = process_mod.build_network(cfg, sc)
    params_np = harness.init_params(cell.config, np.random.default_rng(3))
    return cfg, sc, net, params_np, params_from_jax(params_np, dtype=torch.float64)


@pytest.mark.parametrize("config", ["c-diamond-2x2x2", "bcc-li-3x3x3"])
def test_energy_and_log_psi(config, tmp_path):
    from deepsolid_tpu_torch.models.fwdlap_forward import make_kinetic_forward
    from deepsolid_tpu_torch.ops.ewald import EwaldSum

    cell = make_cell(tmp_path, config)
    _, sc, net, _, params = _port(cell, tmp_path)
    system = System.from_config(cell.config)
    x = torch.randn(3, 3 * system.nelectron, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64) * 2.0
    ndet = cell.config["network"]["determinants"]
    np.testing.assert_allclose(network.log_psi(params, x, system, ndet).numpy(),
                               net.logdet(params, x).numpy(), rtol=0, atol=1e-11)
    kinetic, log_psi = laplacian.kinetic_and_log_psi(params, x, system, ndet)
    np.testing.assert_allclose(log_psi.numpy(), net.logdet(params, x).numpy(), atol=1e-11)
    np.testing.assert_allclose(kinetic.numpy(), make_kinetic_forward(net)(params, x).numpy(),
                               rtol=1e-10, atol=1e-10)
    # the port truncates its reciprocal sum at weights of 1e-12: ~1e-8 Ha
    np.testing.assert_allclose(Ewald(system).energy(x).numpy(),
                               EwaldSum.build(sc).total_energy(x).numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("from_state", [False, True])
def test_gradient_and_kfac_steps(from_state, tmp_path):
    from deepsolid_tpu_torch.optim import adam as adam_lib, kfac as kfac_lib
    from deepsolid_tpu_torch.train.loss import make_loss

    cell = make_cell(tmp_path)
    cfg, sc, net, _, params = _port(cell, tmp_path)
    system = System.from_config(cell.config)
    x = torch.randn(8, 3 * system.nelectron, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64) * 2.0
    total = make_loss(net, sc, el_chunk=0, mode="forward")
    opt = kfac_lib.KfacOptimizer.from_config(cfg, net, adam_lib.learning_rate_schedule(cfg))
    model = rs.Model(system, cell.config["network"]["determinants"], chunk=4)
    kfac = rs.Kfac(model, cell.traffic["kfac"], cell.traffic["lr"], chunk=4)
    state_p = opt.init(params)
    state_r = kfac.fresh_state(params)
    if from_state:
        # a state with history, as a checkpoint holds it, written by the port
        loss, aux = total(params, x)
        _, state_p = opt.step(params, state_p, total.gradient(params, x, loss, aux), x,
                              loss=loss, loss_fn=total)
        state_r = rs.Kfac.from_checkpoint(kfac_lib.state_to_numpy(state_p),
                                          torch.float64, "cpu")
    p_p, p_r = params, params
    for _ in range(2):
        loss, aux = total(p_p, x)
        g_p = total.gradient(p_p, x, loss, aux)
        loss_r, e_l = rs.loss_of(model.local_energy(p_r, x))
        g_r = rs.gradient(model, p_r, x, e_l, loss_r)
        assert abs(float(loss) - float(loss_r)) < 1e-7
        for path, leaf in rs.paths(g_r):
            np.testing.assert_allclose(rs.get(g_p, path).numpy(), leaf.numpy(),
                                       rtol=1e-7, atol=1e-9)
        p_p, state_p = opt.step(p_p, state_p, g_p, x, loss=loss, loss_fn=total)
        p_r, state_r = kfac.step(state_r, p_r, g_r, x, loss_r,
                                 lambda p: rs.loss_of(model.local_energy(p, x))[0])
        assert float(state_p["damping"]) == pytest.approx(float(state_r["damping"]))
    for path, leaf in rs.paths(p_r):
        change_r = leaf - rs.get(params, path)
        change_p = rs.get(p_p, path) - rs.get(params, path)
        assert float((change_p - change_r).norm()) <= 1e-6 * float(change_r.norm()) + 1e-12
