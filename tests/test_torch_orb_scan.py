"""The opt-in tangent-chunked orbital and determinant head
(DEEPSOLID_TPU_ORB_SCAN=on) against the port's full-width head and the
JAX package's scan, on the CPU in float64, for separate spin determinants
and one full determinant, with and without the row-constant block in the
orbital head (use_last_layer); and over two or three gloo ranks of a
sharded tangent axis against one process. Tolerances: 1e-12 of the scale
against the port's full width (the same contractions, partly in another
order), 1e-10 against JAX (another factorization), rtol 1e-9 sharded.
"""

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.models import fwdlap_forward as tff
from deepsolid_tpu_torch.models import network as tnet_lib
from test_torch_sharding import RANK_TIMEOUT, _case, torch_lih_net
from torch_helpers import F64, networks, t64, walkers

SCAN = "DEEPSOLID_TPU_ORB_SCAN"
SMALL = dict(hidden_dims=((8, 4), (8, 4)), determinants=2)
CASES = [dict(full_det=False), dict(full_det=True),
         dict(full_det=False, use_last_layer=True),
         dict(full_det=True, use_last_layer=True)]


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("cfg", CASES, ids=["spins", "full_det", "spins_last",
                                            "full_det_last"])
def test_scan_jets_match_full_width_and_jax(cfg, monkeypatch):
    import jax
    import jax.numpy as jnp

    from deepsolid_tpu.models import fwdlap_forward as jff

    jnet, tnet, params, tp, jsc = networks(**{**SMALL, **cfg})
    x = walkers(3, jsc.nelectron, seed=8)
    monkeypatch.delenv(SCAN, raising=False)
    assert not tff._use_orb_scan()
    with torch.no_grad():
        full = tff.network_jets(tp, t64(x), tnet.spec, tnet.cfg)
        monkeypatch.setenv(SCAN, "on")
        assert tff._use_orb_scan()
        scan = tff.network_jets(tp, t64(x), tnet.spec, tnet.cfg)
    want = jax.jit(jax.vmap(lambda xi: jff.network_jets(params, xi, jnet.spec, jnet.cfg)))(
        jnp.asarray(x))
    for got, full_w, jax_w in ((scan.val, full.val, want.val),
                               (scan.jac, full.jac, np.moveaxis(np.asarray(want.jac), 0, 1)),
                               (scan.lap, full.lap, want.lap)):
        _close(got.numpy(), full_w.numpy(), 1e-12)
        _close(got.numpy(), jax_w, 1e-10)


def test_scan_gate_is_off_by_default_and_on_only_for_on(monkeypatch, caplog):
    monkeypatch.setenv(SCAN, "off")
    assert not tff._use_orb_scan()
    tff._WARNED.clear()
    monkeypatch.setenv(SCAN, "1")
    assert not tff._use_orb_scan()
    assert "not recognized" in caplog.text


def scan_kinetic_rank(rank, world_size, params_np, x_np, cfg):
    """One rank's sharded kinetic energy with the orbital scan on."""
    import os

    os.environ[SCAN] = "on"
    torch.set_num_threads(1)
    mesh = parallel.make_mesh(world_size)
    net, _ = torch_lih_net(**cfg)
    with torch.no_grad():
        ke = tff.make_kinetic_forward(net, shard=mesh.shard)(
            tnet_lib.params_from_jax(params_np, dtype=F64),
            torch.tensor(x_np, dtype=F64))
    return ke.numpy()


@pytest.mark.parametrize("size,cfg", [(2, {}), (3, dict(use_last_layer=True, full_det=True))],
                         ids=["two_ranks", "three_ranks_full_det"])
def test_sharded_scan_matches_one_process(size, cfg, monkeypatch):
    """Each rank starts its chunks' global tangent index at its shard's
    offset; cross terms and lap2 are summed over the ranks. Three ranks put
    a boundary inside one electron's three tangents. rtol 1e-9."""
    net, params, x = _case(seed=2, n_walkers=2, **cfg)
    monkeypatch.delenv(SCAN, raising=False)
    with torch.no_grad():
        want = tff.make_kinetic_forward(net)(tnet_lib.params_from_jax(params, dtype=F64),
                                             torch.tensor(x, dtype=F64)).numpy()
    got = parallel.run_ranks(scan_kinetic_rank, size, (params, x, cfg),
                             timeout=RANK_TIMEOUT)
    for rank, ke in enumerate(got):
        np.testing.assert_allclose(ke, want, rtol=1e-9, err_msg=f"rank {rank}")
