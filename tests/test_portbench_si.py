"""The benchmark's Si 2x2x2 configuration (portbench/configs/si-diamond-2x2x2.json)
and its step-0 handoff, and the port against the plain reference
(portbench/reference) on a tiny Si primitive cell: 28 electrons, widths
(32, 4), two determinants, float64 on the CPU, at the tolerances of
portbench/tests/test_portbench_reference.py. The tiny cell's (8, 4)
would make each determinant's 14 x 14 orbital matrix a rank-8 product
times a row factor, singular to rounding (log|psi| near -490, where two
sound inversions part by 0.5); at 16 the kinetic energies of the two
part by 2e-10 of their size, at 32 by 1e-11."""

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.reference import follow, laplacian, network, step as rs
from portbench.reference.ewald import Ewald
from portbench.reference.system import System
from portbench.tests.tiny import free_electron_klist, make_cell

CONFIG = "si-diamond-2x2x2"
BOHR = 0.52917721092  # Angstrom, as the port's units


def _conf():
    return spec.load_json(spec.HERE / "configs" / f"{CONFIG}.json")


def test_config_is_upstreams_si_diamond_2x2x2():
    conf = _conf()
    half = 5.43 / BOHR / 2
    np.testing.assert_allclose(conf["lattice_bohr"],
                               [[0, half, half], [half, 0, half], [half, half, 0]],
                               rtol=1e-12)
    np.testing.assert_allclose(conf["atoms"][1]["coords_bohr"], [half / 2] * 3, rtol=1e-12)
    assert [a["charge"] for a in conf["atoms"]] == [14.0, 14.0]
    system = System.from_config(conf)
    assert system.spins == (112, 112) and len(system.sim_atoms) == 16
    assert conf["network"]["hidden_dims"] == [[256, 32]] * 3
    assert conf["network"]["determinants"] == 8 and not conf["network"]["full_det"]
    assert conf["reduced"] == ["basis", "mcmc_burn_in"]
    assert conf["source_values"] == {"basis": "ccpvdz", "mcmc_burn_in": 100}


def test_klist_is_the_ports_auto_policy():
    conf = _conf()
    want = free_electron_klist(conf)
    np.testing.assert_allclose(conf["klist"], want, rtol=0, atol=1e-12)
    # the 8 k-points of the 2x2x2 supercell, 14 times each, in each spin
    for k in conf["klist"]:
        _, counts = np.unique(np.round(np.asarray(k), 10), axis=0, return_counts=True)
        assert sorted(counts) == [14] * 8


def test_handoff_holds_the_seed_0_init_and_walkers_over_16_atoms(tmp_path):
    from deepsolid_tpu_torch.models.network import param_shapes
    from deepsolid_tpu_torch.train import process as process_mod

    conf = _conf()
    path = spec.ROOT / conf["checkpoint"]
    params, opt_state = follow.load_checkpoint(path)
    assert opt_state is None
    with np.load(path, allow_pickle=True) as z:
        assert int(z["t"]) == 0 and z["mcmc_width"].tolist() is None
        data = z["data"]
    traffic = spec.load_json(spec.HERE / "traffic" / "f32-kfac-512-el32.json")
    cfg = harness.program_config(conf, traffic, tmp_path)
    net = process_mod.build_network(cfg, cfg.system.cell)
    init = net.init(np.random.default_rng(0))
    assert param_shapes(params) == param_shapes(init)
    for path_, leaf in rs.paths(init):
        np.testing.assert_array_equal(rs.get(params, path_),
                                      np.asarray(leaf, np.float16), str(path_))
    # walkers drawn around every atom of the simulation cell, one for each
    # walker of the batch (none a tiled copy of another)
    assert data.shape[1] == 3 * 224 and data.dtype == np.float32
    assert len(np.unique(data, axis=0)) == len(data) == 512
    atoms = System.from_config(conf).sim_atoms
    lattice = System.from_config(conf).sim_lattice
    frac = np.asarray(data, np.float64).reshape(len(data), -1, 3) @ np.linalg.inv(lattice)
    rel = frac[:, :, None, :] - (atoms @ np.linalg.inv(lattice))[None, None]
    dist = np.linalg.norm((rel - np.round(rel)) @ lattice, axis=-1)  # (walkers, e, atoms)
    assert set(dist.argmin(-1).ravel()) == set(range(16))
    # the harness's start of a run reads it as it stands
    start = harness.write_start(conf, traffic, 7, tmp_path / "restore")
    with np.load(start, allow_pickle=True) as z:
        assert int(z["t"]) == 0 and z["data"].shape == (512, 3 * 224)


def _tiny(tmp_path):
    cell = make_cell(tmp_path, CONFIG)
    cell.config["network"]["hidden_dims"] = [[32, 4]] * 3
    return cell


def _port(cell, tmp_path):
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train import process as process_mod

    cfg = harness.program_config(cell.config, cell.traffic, tmp_path)
    sc = cfg.system.cell
    net = process_mod.build_network(cfg, sc)
    params_np = harness.init_params(cell.config, np.random.default_rng(3))
    return cfg, sc, net, params_from_jax(params_np, dtype=torch.float64)


def test_tiny_si_energy_and_log_psi(tmp_path):
    from deepsolid_tpu_torch.models.fwdlap_forward import make_kinetic_forward
    from deepsolid_tpu_torch.ops.ewald import EwaldSum

    cell = _tiny(tmp_path)
    _, sc, net, params = _port(cell, tmp_path)
    system = System.from_config(cell.config)
    assert system.spins == (14, 14)
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


def test_tiny_si_gradient_and_kfac_step(tmp_path):
    from deepsolid_tpu_torch.optim import adam as adam_lib, kfac as kfac_lib
    from deepsolid_tpu_torch.train.loss import make_loss

    cell = _tiny(tmp_path)
    cfg, sc, net, params = _port(cell, tmp_path)
    system = System.from_config(cell.config)
    x = torch.randn(8, 3 * system.nelectron, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64) * 2.0
    total = make_loss(net, sc, el_chunk=0, mode="forward")
    opt = kfac_lib.KfacOptimizer.from_config(cfg, net, adam_lib.learning_rate_schedule(cfg))
    model = rs.Model(system, cell.config["network"]["determinants"], chunk=4)
    kfac = rs.Kfac(model, cell.traffic["kfac"], cell.traffic["lr"], chunk=4)
    loss, aux = total(params, x)
    g_p = total.gradient(params, x, loss, aux)
    loss_r, e_l = rs.loss_of(model.local_energy(params, x))
    g_r = rs.gradient(model, params, x, e_l, loss_r)
    assert abs(float(loss) - float(loss_r)) < 1e-7
    for path, leaf in rs.paths(g_r):
        np.testing.assert_allclose(rs.get(g_p, path).numpy(), leaf.numpy(),
                                   rtol=1e-7, atol=1e-9)
    p_p, state_p = opt.step(params, opt.init(params), g_p, x, loss=loss, loss_fn=total)
    p_r, state_r = kfac.step(kfac.fresh_state(params), params, g_r, x, loss_r,
                             lambda p: rs.loss_of(model.local_energy(p, x))[0])
    assert float(state_p["damping"]) == pytest.approx(float(state_r["damping"]))
    for path, leaf in rs.paths(p_r):
        change_r = leaf - rs.get(params, path)
        change_p = rs.get(p_p, path) - rs.get(params, path)
        assert float((change_p - change_r).norm()) <= 1e-6 * float(change_r.norm()) + 1e-12
