"""The network's occupied k-list in the port's process() against the JAX
package's: with a basis and klist_policy 'auto' it is the SCF source's
aufbau k-list, not the free-electron one (deepsolid_tpu/train/
process.py:139-154)."""

import numpy as np

from deepsolid_tpu.configs import two_hydrogen_cell as jh2
from deepsolid_tpu.scf.free_electron import free_electron_klist
from deepsolid_tpu.train import pretrain as jpretrain
from deepsolid_tpu_torch import config as tconfig
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell
from deepsolid_tpu_torch.train import process as tprocess

from fixtures import h2_supercell
from torch_helpers import SMALL_NET


def test_network_takes_the_scf_klist(monkeypatch, tmp_path):
    """A 2x2x2 H2 supercell at sto-3g: the core-level SCF fills other
    k-points than the free-electron rule, and process() builds its network
    on the SCF's k-list, as the JAX package does. No pretraining runs: the
    basis alone asks for the source."""
    jcfg = jh2.get_config("H,1,1,1,2.0,0,sto-3g")
    jcfg.system.cell = h2_supercell(2 * np.eye(3))
    want = jpretrain.make_orbital_source(jcfg, jcfg.system.cell).klist
    free = free_electron_klist(jcfg.system.cell)
    assert not all(np.array_equal(a, b) for a, b in zip(want, free))

    L = 2.0
    cfg = tconfig.default()
    cfg.system.cell = make_supercell(Cell.from_atoms(
        [Atom("H", (L, 0, 0)), Atom("H", (0, 0, 0))], np.diag([2 * L, 10.0, 10.0])),
        2 * np.eye(3))
    cfg.system.basis = "sto-3g"
    cfg["pretrain"] = {**cfg.get("pretrain", {}), "iterations": 0, "method": "none"}
    cfg.batch_size = 2
    cfg.optim.iterations = 0
    cfg.mcmc.burn_in = 0
    cfg.network.detnet.hidden_dims = SMALL_NET["hidden_dims"]
    cfg.network.detnet.determinants = SMALL_NET["determinants"]
    cfg.log.save_path = str(tmp_path)
    cfg.debug.deterministic = True
    seen = []
    make_network = tprocess.make_network
    monkeypatch.setattr(tprocess, "make_network",
                        lambda sc, klist, c: seen.append(klist) or make_network(sc, klist, c))
    tprocess.process(cfg, device="cpu")
    assert len(seen) == 1
    for got, w in zip(seen[0], want):
        np.testing.assert_array_equal(got, w)
