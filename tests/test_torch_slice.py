"""The port's slice end to end: the trained C-diamond 2x2x2 state at full
width against the JAX reference, and the inference driver on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.configs import diamond as jdiamond
from deepsolid_tpu.hamiltonian import make_local_energy as jmake_le
from deepsolid_tpu.train.process import build_network as jbuild_network
from deepsolid_tpu_torch import device as tdevice
from deepsolid_tpu_torch.configs import diamond as tdiamond
from deepsolid_tpu_torch.hamiltonian import make_local_energy as tmake_le
from deepsolid_tpu_torch.models.fwdlap_forward import make_logpsi_and_kinetic
from deepsolid_tpu_torch.models.network import params_from_jax
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore
from torch_helpers import REPO_SCF_CACHE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(REPO, "runs", "ckpt_diamond")
CONFIG = "C,C,3.567,2,sto-3g"


def test_trained_diamond_full_width_matches_jax():
    """96 electrons, hidden_dims ((256, 32),) * 3, 8 determinants, the
    step-581 parameters, on the first two checkpoint walkers in float64."""
    jcfg, tcfg = jdiamond.get_config(CONFIG), tdiamond.get_config(CONFIG)
    jcfg.system.basis = ""  # the free-electron k-list, which equals the HF one
    jsc, tsc = jcfg.system.cell, tcfg.system.cell
    jnet, tnet = jbuild_network(jcfg, jsc), tprocess.build_network(tcfg, tsc)
    _, data, params, _, _ = restore(find_last_checkpoint(CKPT_DIR))
    x = np.asarray(data[:2], np.float64)

    tp = params_from_jax(params, dtype=torch.float64)
    tx = torch.from_numpy(x)
    logpsi, ke = make_logpsi_and_kinetic(tnet)(tp, tx)
    _, ew = tmake_le(tnet, tsc)(tp, tx)

    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    jel = jmake_le(jnet.logdet, jsc, mode="forward", network=jnet)
    jke, jew = jax.vmap(jel, in_axes=(None, 0))(jp, jnp.asarray(x))
    jlogpsi = jax.vmap(jnet.logdet, in_axes=(None, 0))(jp, jnp.asarray(x))

    scale = tsc.scale
    # 1e-8 Ha per primitive cell: f64 on both sides, differences are
    # rounding in reordered sums (observed ~1e-13)
    np.testing.assert_allclose(logpsi.numpy(), np.asarray(jlogpsi), rtol=0, atol=1e-8)
    np.testing.assert_allclose(ke.numpy() / scale, np.asarray(jke) / scale, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose((ke + ew).numpy() / scale,
                               np.asarray(jke + jew) / scale, rtol=0, atol=1e-8)
    # the trained state sits near the run's -66 Ha/cell
    assert np.all(np.abs((ke + ew).real.numpy() / scale + 66.0) < 10.0)


def _inference_cfg(tmp_path, monkeypatch, batch=2):
    """The production run's source: the UHF orbitals from the committed
    cache, whose k-list the network takes."""
    monkeypatch.setenv("DEEPSOLID_TPU_SCF_CACHE", REPO_SCF_CACHE)
    cfg = tdiamond.get_config(CONFIG)
    cfg.pretrain.scf = "hf"
    cfg.batch_size = batch
    cfg.optim.optimizer = "none"
    cfg.optim.laplacian_mode = "forward"  # the production run's engine
    cfg.optim.el_chunk = 1
    cfg.mcmc.burn_in = 0
    cfg.mcmc.steps = 1
    cfg.debug.deterministic = True
    cfg.log.restore_path = CKPT_DIR
    cfg.log.save_path = str(tmp_path / "run")
    return cfg


def test_process_inference_on_the_cpu(tmp_path, monkeypatch):
    cfg = _inference_cfg(tmp_path, monkeypatch)
    seen = []
    params, data, energy = tprocess.process(
        cfg, max_iterations=1, device="cpu",
        on_iteration=lambda t, row, seconds: seen.append((t, row, seconds)))
    assert data.shape == (2, 288) and data.dtype == torch.float32
    assert np.isfinite(energy) and abs(energy + 66.0) < 15.0
    assert [t for t, _, _ in seen] == [0]
    assert set(seen[0][2]) == {"mcmc", "local_energy", "step"}
    lines = (tmp_path / "run" / "train_stats.csv").read_text().splitlines()
    assert lines[0] == "step," + ",".join(tprocess.TRAIN_SCHEMA)
    assert len(lines) == 2 and float(lines[1].split(",")[1]) == pytest.approx(energy)


def test_process_refuses_training_and_a_missing_gpu(tmp_path, monkeypatch):
    cfg = _inference_cfg(tmp_path, monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tprocess.process(cfg, max_iterations=1)  # the default device is 'cuda'
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_full_precision_policy():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        tdevice.set_full_precision()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])
