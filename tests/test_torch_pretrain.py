"""Pretraining in the port against the JAX package, in float64.

The orbital-matching loss and its gradient, one pretraining iteration
with the JAX package's own Metropolis draws handed in, the psi_chunk
contract, the data axis, and process() from scratch: pretraining, the
step-0 checkpoint and the restart that does not pretrain again.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from deepsolid_tpu import config as jconfig
from deepsolid_tpu.models import network as jnet_lib
from deepsolid_tpu.scf import hf as jhf
from deepsolid_tpu.train import pretrain as jpretrain
from deepsolid_tpu.train.loss import chunk_batch_fn as jchunk_batch_fn
from deepsolid_tpu_torch import config as tconfig
from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.configs import two_hydrogen_cell as th2
from deepsolid_tpu_torch.models import network as tnet_lib
from deepsolid_tpu_torch.scf import hf as thf
from deepsolid_tpu_torch.train import pretrain as tpretrain
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import checkpoint as tckpt
from deepsolid_tpu_torch.system import make_supercell
from deepsolid_tpu_torch.utils.tree import tree_leaves

from torch_helpers import F64, SMALL_NET, h2_cells, t64, walkers

S_2X1X1 = np.diag([2, 1, 1])  # H2 chain of two cells: 4 electrons, 2 k-points
BATCH = 8
RANK_TIMEOUT = 300.0


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(a.detach().numpy() if isinstance(
        a, torch.Tensor) else a)) for a in tree_leaves(tree)])


def jflat(tree):
    """A JAX tree flattened in the port's leaf order (dict insertion order)."""
    if isinstance(tree, dict):
        return np.concatenate([jflat(v) for v in tree.values()])
    if isinstance(tree, (list, tuple)):
        return np.concatenate([jflat(v) for v in tree])
    return np.ravel(np.asarray(tree))


def port_cfg(method="net", full_det=False, psi_chunk=0, lr=3e-3, iterations=1):
    cfg = tconfig.default()
    cfg.system.basis = "sto-3g"
    cfg.optim.psi_chunk = psi_chunk
    cfg.network.detnet.full_det = full_det
    cfg.pretrain.method = method
    cfg.pretrain.lr = lr
    cfg.pretrain.iterations = iterations
    return cfg


def jax_cfg(method="net", full_det=False, psi_chunk=0, lr=3e-3, iterations=1):
    cfg = jconfig.default()
    cfg.system.basis = "sto-3g"
    cfg.optim.psi_chunk = psi_chunk
    cfg.network.detnet.full_det = full_det
    cfg.pretrain.method = method
    cfg.pretrain.lr = lr
    cfg.pretrain.iterations = iterations
    return cfg


def port_system(full_det=False, seed=2):
    """(supercell, core-level HF source, network on its k-list, params)
    of the H2 2x1x1 chain, made without JAX (the ranks use it)."""
    tsc = make_supercell(h2_cells()[1].prim, S_2X1X1)
    src = thf.ScfOrbitals.build(tsc, "sto-3g")
    net = tnet_lib.make_network(tsc, src.klist,
                                tnet_lib.NetworkConfig(**SMALL_NET, full_det=full_det))
    params = tnet_lib.params_from_jax(net.init(np.random.default_rng(seed)), dtype=F64)
    return tsc, src, net, params


def both_systems(full_det=False, seed=2):
    """The same system, source, network and parameters in both packages."""
    from deepsolid_tpu.system import make_supercell as jmake_sc

    jsc, tsc = h2_cells()
    jsc, tsc = jmake_sc(jsc.prim, S_2X1X1), make_supercell(tsc.prim, S_2X1X1)
    jsrc, tsrc = jhf.ScfOrbitals.build(jsc, "sto-3g"), thf.ScfOrbitals.build(tsc, "sto-3g")
    for kj, kt in zip(jsrc.klist, tsrc.klist):
        np.testing.assert_array_equal(kj, kt)
    cfg = dict(SMALL_NET, full_det=full_det)
    jnet = jnet_lib.make_network(jsc, jsrc.klist, jnet_lib.NetworkConfig(**cfg))
    tnet = tnet_lib.make_network(tsc, tsrc.klist, tnet_lib.NetworkConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed)))
    return (jsc, jsrc, jnet, params), (tsc, tsrc, tnet, tnet_lib.params_from_jax(params,
                                                                                 dtype=F64))


def jax_loss_fn(jnet, jsrc, full_det):
    """The JAX package's orbital-matching loss (train/pretrain.py:98-118),
    unchunked on one device."""

    def loss_per_walker(p, x):
        predict = jnet.batch_orbitals(p, x)
        target = jsrc.orbital_mats(x)
        if full_det and len(target) == 2:
            target = [jpretrain._block_diag_targets(target)]
        losses = [jnp.mean(jnp.abs(t[:, None, ...] - pr) ** 2,
                           axis=tuple(range(1, pr.ndim)))
                  for t, pr in zip(target, predict)]
        return sum(losses) / len(losses)

    return lambda p, x: jnp.mean(loss_per_walker(p, x))


@pytest.mark.parametrize("full_det", [False, True])
def test_loss_and_gradient_match_jax(full_det):
    (jsc, jsrc, jnet, params), (tsc, tsrc, tnet, tparams) = both_systems(full_det)
    x = walkers(BATCH, 4, seed=5)
    jloss, jgrad = jax.value_and_grad(jax_loss_fn(jnet, jsrc, full_det))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    vg = tpretrain.make_value_and_grad(
        tpretrain.make_loss_per_walker(tnet, tsrc, full_det))
    loss, grads = vg(tparams, t64(x))
    assert abs(float(loss) - float(jloss)) <= 1e-10 * abs(float(jloss))
    np.testing.assert_allclose(flat(grads), jflat(jgrad), rtol=1e-10, atol=1e-12)
    if full_det:  # the block-diagonal embedding
        mats = tpretrain._block_diag_targets(tsrc.orbital_mats(t64(x)))
        assert mats.shape == (BATCH, 4, 4)
        assert float(mats[:, :2, 2:].abs().max()) == 0.0


def jax_draws(key, t, x):
    """The normals and uniforms JAX's pretrain() draws for its iteration t
    on a one-device data axis (train/pretrain.py:130-150,
    sampling/mcmc.py:mh_update)."""
    for _ in range(t + 1):
        key, subkey = jax.random.split(key)
    key = jax.random.fold_in(subkey, 0)
    _, sub = jax.random.split(key)
    k, s = jax.random.split(sub)
    noise = jax.random.normal(s, x.shape, dtype=jnp.float64)
    _, s = jax.random.split(k)
    uniform = jax.random.uniform(s, (x.shape[0],), dtype=jnp.float64)
    return np.asarray(noise), np.asarray(uniform)


@pytest.mark.parametrize("method", ["net", "hf"])
def test_one_pretraining_step_matches_jax(method):
    """JAX's pretrain() for one iteration against the port's step with
    JAX's Metropolis draws handed in: parameters and walkers to 1e-9."""
    (jsc, jsrc, jnet, params), (tsc, tsrc, tnet, tparams) = both_systems()
    x = walkers(BATCH, 4, seed=6, spread=1.5)
    key = jax.random.PRNGKey(11)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jp, jx = jpretrain.pretrain(
        jax_cfg(method), jsc, jnet, jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x.copy()), key, mesh, source=jsrc)

    noise, uniform = jax_draws(key, 0, x)
    optimizer, step = tpretrain.make_pretrain_step(
        port_cfg(method), tsc, tnet, tsrc, draw=lambda gen, d: (t64(noise), t64(uniform)))
    with torch.no_grad():
        tp, tx, _, loss, pmove, seconds = step(tparams, t64(x), optimizer.init(tparams),
                                               None)
    np.testing.assert_allclose(flat(tp), jflat(jp), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-12)
    assert 0.0 < float(pmove) <= 1.0 and np.isfinite(float(loss))
    assert set(seconds) == {"loss_grad", "update", "mcmc", "step"}
    # the 'net' sampler's log|psi| is the network's, the 'hf' one the source's
    sampled = jnp.asarray(np.asarray(jx))
    want = (jchunk_batch_fn(jnet.batch_slogdet, 0)(jp, sampled) if method == "net"
            else jsrc.slogdet(sampled))
    got = (tnet.slogdet(tp, tx) if method == "net" else tsrc.slogdet(tx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


def test_psi_chunk_is_invisible_and_must_divide():
    tsc, tsrc, tnet, tparams = port_system()
    x = t64(walkers(BATCH, 4, seed=7))
    loss_per_walker = tpretrain.make_loss_per_walker(tnet, tsrc, False)
    whole = tpretrain.make_value_and_grad(loss_per_walker)(tparams, x)
    for chunk in (2, 4, BATCH, 2 * BATCH):
        got = tpretrain.make_value_and_grad(loss_per_walker, chunk)(tparams, x)
        assert abs(float(got[0] - whole[0])) <= 1e-13
        np.testing.assert_allclose(flat(got[1]), flat(whole[1]), rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="must divide"):
        tpretrain.make_value_and_grad(loss_per_walker, 3)(tparams, x)
    cfg = port_cfg(psi_chunk=3)
    optimizer, step = tpretrain.make_pretrain_step(cfg, tsc, tnet, tsrc)
    with pytest.raises(ValueError, match="must divide"):
        step(tparams, x, optimizer.init(tparams), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Unknown pretrain method"):
        tpretrain.make_pretrain_step(port_cfg("none"), tsc, tnet, tsrc)


def global_draws(iterations, batch, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 12), rng.rand(batch)) for _ in range(iterations)]


def pretrain_rank(rank, world_size, iterations):
    """`iterations` pretraining steps of this rank's share of the batch;
    the draws are the global batch's, sliced like the walkers."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh(1)
    tsc, tsrc, tnet, params = port_system()
    local = BATCH // mesh.num_data
    lo = mesh.data_index * local
    draws = iter(global_draws(iterations, BATCH))

    def draw(gen, x):
        noise, uniform = next(draws)
        return t64(noise[lo:lo + local]), t64(uniform[lo:lo + local])

    optimizer, step = tpretrain.make_pretrain_step(
        port_cfg(), tsc, tnet, tsrc, all_mean=mesh.all_mean, draw=draw)
    data = t64(walkers(BATCH, 4, seed=8)[lo:lo + local])
    opt_state, rows = optimizer.init(params), []
    with torch.no_grad():
        for _ in range(iterations):
            params, data, opt_state, loss, pmove, _ = step(params, data, opt_state, None)
            rows.append((float(loss), float(pmove)))
    return flat(params), data.numpy(), rows


def test_two_data_ranks_pretrain_like_one_process():
    """Loss, acceptance and gradients averaged over two gloo data ranks:
    every rank ends with the one process's parameters; rtol 1e-10."""
    want, want_data, want_rows = pretrain_rank(0, 1, 2)
    out = parallel.run_ranks(pretrain_rank, 2, (2,), timeout=RANK_TIMEOUT)
    for rank, (got, data, rows) in enumerate(out):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(data, want_data[4 * rank:4 * rank + 4], rtol=1e-12)
        np.testing.assert_allclose(rows, want_rows, rtol=1e-10)


def h2_run_cfg(save_path, iterations, pretrain_iterations):
    cfg = th2.get_config("H,2,1,1,2.0,0,sto-3g")
    cfg.batch_size = BATCH
    cfg.precision = "float64"
    cfg.optim.optimizer = "adam"
    cfg.optim.iterations = iterations
    cfg.optim.el_chunk = 4
    cfg.optim.psi_chunk = 4
    cfg.mcmc.burn_in = 2
    cfg.mcmc.steps = 2
    cfg.pretrain.iterations = pretrain_iterations
    cfg.pretrain.lr = 3e-3
    cfg.network.detnet.hidden_dims = SMALL_NET["hidden_dims"]
    cfg.network.detnet.determinants = SMALL_NET["determinants"]
    cfg.log.save_path = str(save_path)
    cfg.log.save_frequency = 1e9
    cfg.debug.deterministic = True
    return cfg


def test_process_pretrains_from_scratch_and_restarts_from_step_0(tmp_path):
    seen = []
    params, data, _ = tprocess.process(
        h2_run_cfg(tmp_path, 0, 20), device="cpu",
        on_pretrain=lambda t, loss, pmove, s: seen.append((t, loss, pmove, s)))
    assert [t for t, *_ in seen] == list(range(20))
    assert seen[-1][1] < seen[0][1]
    assert all(np.isfinite(loss) and 0.0 <= pmove <= 1.0 for _, loss, pmove, _ in seen)
    assert set(seen[0][3]) == {"loss_grad", "update", "mcmc", "step"}
    assert sorted(os.listdir(tmp_path)) == ["qmcjax_ckpt_000000.npz", "train_stats.csv"]
    t, ck_data, ck_params, opt_state, width = tckpt.restore(
        str(tmp_path / "qmcjax_ckpt_000000.npz"))
    assert (t, opt_state, width) == (1, None, None)
    assert ck_data.shape == data.shape and np.isfinite(ck_data).all()  # before burn-in
    np.testing.assert_array_equal(flat(ck_params), flat(params))

    again, steps = [], []
    tprocess.process(h2_run_cfg(tmp_path, 2, 20), device="cpu",
                     on_pretrain=lambda *a: again.append(a),
                     on_iteration=lambda t, row, s: steps.append((t, row["energy"])))
    # the step-0 handoff restores as iteration 0 (burn-in, no pretraining)
    assert again == []
    assert [t for t, _ in steps] == [0, 1] and np.isfinite([e for _, e in steps]).all()
    assert sorted(os.listdir(tmp_path)) == [
        "qmcjax_ckpt_000000.npz", "qmcjax_ckpt_000001.npz", "train_stats.csv"]


def test_restored_inference_run_does_not_pretrain_or_burn_in(tmp_path, monkeypatch):
    """An inference run restarts its own clock at 0 from a restored
    checkpoint; as in the JAX package it neither pretrains nor burns in."""
    tprocess.process(h2_run_cfg(tmp_path, 1, 3), device="cpu")  # step 0 with adam's state
    cfg = h2_run_cfg(tmp_path, 1, 3)
    cfg.optim.optimizer = "none"
    cfg.log.restore_path, cfg.log.save_path = str(tmp_path), str(tmp_path / "inference")
    _, want, _, state, _ = tckpt.restore(str(tmp_path / "qmcjax_ckpt_000000.npz"))
    assert state is not None
    moves = []
    monkeypatch.setattr(tpretrain, "pretrain", lambda *a, **k: moves.append("pretrain"))
    steps = []
    tprocess.process(cfg, device="cpu",
                     on_iteration=lambda t, row, s: steps.append(t))
    assert moves == [] and steps == [0]
    cfg.optim.iterations, cfg.mcmc.steps = 0, 0  # no iteration: the walkers as restored
    _, data, _ = tprocess.process(cfg, device="cpu")
    np.testing.assert_array_equal(data.numpy(), want)


def test_unsupported_basis_is_a_hard_error():
    cfg = port_cfg()
    cfg.system.basis = "6-31g"  # neither package builds it (et-dz is generated)
    tsc = port_system()[0]
    with pytest.raises(NotImplementedError, match="planewave"):
        tpretrain.make_orbital_source(cfg, tsc)
    cfg.system.basis = "planewave"
    src = tpretrain.make_orbital_source(cfg, tsc)
    assert isinstance(src, tpretrain.PlaneWaveOrbitals)
    mats = src.orbital_mats(t64(walkers(3, 4)))
    assert [m.shape for m in mats] == [(3, 2, 2), (3, 2, 2)]
