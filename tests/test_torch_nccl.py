"""Ranks on the cards: two NCCL ranks, one per card
(parallel.run_ranks(..., backend='nccl')), and two gloo ranks sharing one.

Marked `cuda`: the NCCL tests skip below two NVIDIA GPUs, the shared-card
one below one. This file imports no JAX; on the GPU machine run it with

    python -m pytest --noconftest tests/test_torch_nccl.py -q -s

The committed C-diamond 2x2x2 checkpoint at full width, in float32 on the
cards, against one process on the first card: the data axis takes one
process's KFAC step (continuing the checkpoint's state) on the same
global batch (relative error of the update's global norm <= 3e-4), and a
deriv_devices=2 local energy equals the unsharded one; every tensor
handed to an NCCL collective lies on its rank's card.

The sharded and unsharded local energies come from different kernels
(the open mix kernel and the closed one) and agree to f32 rounding: their
median difference over the checkpoint's first 32 walkers is held to the
sharded limit (5e-4 Ha/cell), and each walker's to 1e-3 Ha/cell: on the
H100 one ill-conditioned walker of the 32 differs by 5.06e-4 over NCCL
and gloo alike, where the median is 7.6e-6.
"""

import collections
import contextlib
import pathlib

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.configs import diamond
from deepsolid_tpu_torch.models.network import params_from_jax
from deepsolid_tpu_torch.optim.adam import tree_leaves
from deepsolid_tpu_torch.parallel import mesh
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import checkpoint as tckpt

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT_DIR = str(REPO / "runs" / "ckpt_diamond")
SCF_CACHE = str(REPO / "runs" / "scf_cache")
BATCH = 32
CHUNK = 16
UPDATE_TOLERANCE = 3e-4  # relative, global norm: chip_smoke.py's KFAC_UPDATE_TOLERANCE
EL_TOLERANCE = 5e-4      # Ha/cell: the sharded limit (f32 sums in another order)
EL_MAX_TOLERANCE = 1e-3  # Ha/cell, any one walker of the sharded E_L
RANK_TIMEOUT = 600.0


def _cards(monkeypatch, count, why):
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} NVIDIA GPU(s): {why}")
    monkeypatch.setenv("DEEPSOLID_TPU_SCF_CACHE", SCF_CACHE)  # the ranks inherit it


@pytest.fixture
def two_cards(monkeypatch):
    _cards(monkeypatch, 2, "NCCL takes one card per rank")


def _cfg(save_path, optimizer, deriv_devices):
    cfg = diamond.get_config("C,C,3.567,2,sto-3g")
    cfg.batch_size = BATCH
    cfg.precision = "float32"
    cfg.optim.optimizer = optimizer
    cfg.optim.laplacian_mode = "forward"
    cfg.optim.el_chunk = cfg.optim.psi_chunk = CHUNK
    cfg.parallel.deriv_devices = deriv_devices
    cfg.mcmc.burn_in = cfg.mcmc.steps = 0  # fixed walkers: the checkpoint's first
    cfg.pretrain.scf = "hf"  # the committed UHF source and its k-list
    cfg.debug.deterministic = True
    cfg.log.restore_path = CKPT_DIR
    cfg.log.save_path = save_path
    return cfg


@contextlib.contextmanager
def collective_tensors():
    """Count, by (kind, device type), every tensor this process hands to
    a collective of the mesh inside the block: the counter it yields."""
    counts = collections.Counter()
    staged = mesh._staged

    def counting(t, group, kind):
        counts[kind, t.device.type] += 1
        return staged(t, group, kind)

    mesh._staged = counting
    try:
        yield counts
    finally:
        mesh._staged = staged


def nccl_rank(rank, world_size, save_path, optimizer, deriv_devices):
    """One iteration of process() on this rank's card: (parameters,
    per-walker E_L per cell of this rank, tensors at collectives by kind
    and device)."""
    cfg = _cfg(save_path, optimizer, deriv_devices)
    t_start = tckpt.restore(tckpt.find_last_checkpoint(CKPT_DIR))[0]
    els = []
    with collective_tensors() as tensors:
        params, _, _ = tprocess.process(
            cfg, 1 if optimizer == "none" else t_start + 1, device="cuda",
            on_iteration=lambda t, row, s: els.append(row["local_energy"].cpu().numpy()))
    return ([p.detach().cpu().numpy() for p in tree_leaves(params)],
            els[0] / cfg.system.cell.scale, dict(tensors))


def _norm(arrays):
    return np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in arrays))


@pytest.mark.cuda
def test_nccl_data_ranks_take_one_processs_kfac_step(two_cards, tmp_path):
    params = tckpt.restore(tckpt.find_last_checkpoint(CKPT_DIR))[2]
    start = [p.numpy() for p in tree_leaves(params_from_jax(params, "cpu", torch.float32))]
    want, want_el, _ = nccl_rank(0, 1, str(tmp_path / "one"), "kfac", 1)
    ranks = parallel.run_ranks(nccl_rank, 2, (str(tmp_path / "two"), "kfac", 1),
                               backend="nccl", timeout=RANK_TIMEOUT)
    update = _norm([w - s for w, s in zip(want, start)])
    for rank, (got, el, tensors) in enumerate(ranks):
        err = _norm([g - w for g, w in zip(got, want)]) / update
        assert err <= UPDATE_TOLERANCE, f"rank {rank}: {err}"
        np.testing.assert_allclose(el, want_el[rank * BATCH // 2:(rank + 1) * BATCH // 2],
                                   rtol=0, atol=EL_TOLERANCE)
        assert tensors and all(device == "cuda" for _, device in tensors), tensors


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_deriv_ranks_match_the_unsharded_local_energy(monkeypatch, tmp_path, backend):
    """deriv_devices=2: two NCCL ranks on a card each, or two gloo ranks
    sharing one card."""
    if backend == "nccl":
        _cards(monkeypatch, 2, "NCCL takes one card per rank")
    else:
        _cards(monkeypatch, 1, "the kernels have no CPU mode")
    _, want_el, _ = nccl_rank(0, 1, str(tmp_path / "one"), "none", 1)
    ranks = parallel.run_ranks(nccl_rank, 2, (str(tmp_path / "two"), "none", 2),
                               backend=backend, timeout=RANK_TIMEOUT)
    for _, el, tensors in ranks:
        diff = np.abs(el - want_el)
        worst = int(np.argmax(diff))
        print(f"{backend}: sharded - unsharded median {np.median(diff):.3g}, max "
              f"{diff[worst]:.3g} Ha/cell at walker {worst}")
        assert np.median(diff) <= EL_TOLERANCE
        assert diff.max() <= EL_MAX_TOLERANCE, diff
        assert tensors[("all_sum", "cuda")] > 0
        assert all(device == "cuda" for _, device in tensors), tensors
