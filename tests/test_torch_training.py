"""The port's training step against the JAX package, on the CPU in float64.

Same parameters and walkers (seeded numpy) go through both: the slogdet
backward rule, the loss value and its gradient estimator, the adam
update, three training iterations of process(), and checkpoints written
by one package and read by the other. Tolerances are stated at each
comparison; rank workers at module level import no JAX.
"""

import os

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import config as tconfig
from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.models import network as tnet_lib
from deepsolid_tpu_torch.ops import slogdet as tslog
from deepsolid_tpu_torch.optim import adam as tadam
from deepsolid_tpu_torch.scf.free_electron import free_electron_klist
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell
from deepsolid_tpu_torch.train import loss as tloss
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import checkpoint as tckpt

F64 = torch.float64
NET = dict(hidden_dims=((16, 4), (16, 4)), determinants=2)
RANK_TIMEOUT = 300.0  # seconds: run_ranks ends the ranks and fails after it


def torch_lih_supercell():
    L = 2 / 0.529177
    return make_supercell(Cell.from_atoms(
        [Atom("Li", (0, 0, 0)), Atom("H", (L / 2,) * 3)],
        (1 - np.eye(3)) * L / 2), np.eye(3))


def torch_cfg(save_path, optimizer="adam", iterations=3, batch=8, **optim):
    cfg = tconfig.default()
    cfg.system.cell = torch_lih_supercell()
    cfg.batch_size = batch
    cfg.precision = "float64"
    cfg.optim.optimizer = optimizer
    cfg.optim.iterations = iterations
    cfg.optim.laplacian_mode = "forward"  # as jax_cfg's
    cfg.optim.lr.rate = 1e-2
    for key, value in optim.items():
        cfg.optim[key] = value
    cfg.mcmc.burn_in = 0
    cfg.mcmc.steps = 0  # fixed walkers: the two packages' samplers draw differently
    cfg.pretrain.iterations = 0  # the start checkpoint is iteration 0: no pretraining
    cfg.pretrain.method = "none"
    cfg.network.detnet.hidden_dims = NET["hidden_dims"]
    cfg.network.detnet.determinants = NET["determinants"]
    cfg.log.save_path = str(save_path)
    cfg.log.save_frequency = 1e9
    cfg.debug.deterministic = True
    return cfg


def jax_cfg(save_path, jsc, optimizer="adam", iterations=3, batch=8, **optim):
    from deepsolid_tpu import config as jconfig

    cfg = jconfig.default()
    cfg.system.cell = jsc
    cfg.batch_size = batch
    cfg.precision = "float64"
    cfg.optim.optimizer = optimizer
    cfg.optim.iterations = iterations
    cfg.optim.laplacian_mode = "forward"
    cfg.optim.lr.rate = 1e-2
    for key, value in optim.items():
        cfg.optim[key] = value
    cfg.mcmc.burn_in = 0
    cfg.mcmc.steps = 0
    cfg.pretrain.iterations = 0
    cfg.pretrain.method = "none"
    cfg.network.detnet.hidden_dims = NET["hidden_dims"]
    cfg.network.detnet.determinants = NET["determinants"]
    cfg.log.save_path = str(save_path)
    cfg.log.save_frequency = 1e9
    cfg.debug.deterministic = True
    return cfg


@pytest.fixture
def one_device_jax(monkeypatch):
    """The JAX process() on a one-device mesh: its complex clip takes the
    median per device, so only an unsplit batch compares with one
    process of the port."""
    import jax
    from jax.sharding import Mesh

    from deepsolid_tpu.train import process as jprocess

    monkeypatch.setattr(
        jprocess, "make_mesh",
        lambda deriv_devices=1: Mesh(np.asarray(jax.devices()[:1]), ("data",)))


def seed_state(n_walkers=8, seed=0):
    """(numpy params, numpy walkers) of the LiH network, made without JAX."""
    sc = torch_lih_supercell()
    net = tnet_lib.make_network(sc, free_electron_klist(sc),
                                tnet_lib.NetworkConfig(**NET))
    params = net.init(np.random.default_rng(seed))
    x = np.random.RandomState(seed).randn(n_walkers, 3 * sum(sc.nelec)) * 2.0
    return net, sc, params, x


def write_start(path, params, x):
    """A checkpoint both packages restore as iteration 0 with no
    optimizer state."""
    os.makedirs(path, exist_ok=True)
    return tckpt.save(str(path), -1, x, params, None, 0.02)


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(v)) for v in tadam.tree_leaves(
        tadam.tree_map(lambda a: a.detach().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a), tree))])


def jflat(tree):
    """A JAX parameter tree flattened in the port's leaf order (dicts by
    insertion order, as the port's tree_map walks them)."""
    return flat(tadam.tree_map(np.asarray, _as_lists(tree)))


def _as_lists(tree):
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_lists(v) for v in tree]
    return tree


def same_order(ref, tree):
    """`tree` with its dicts reordered to `ref`'s key order."""
    if isinstance(ref, dict):
        return {k: same_order(ref[k], tree[k]) for k in ref}
    if isinstance(ref, (list, tuple)):
        return [same_order(r, t) for r, t in zip(ref, tree)]
    return tree


# ---- (c) slogdet backward -----------------------------------------------------


def _complex(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape) + 1j * rng.randn(*shape)


@pytest.mark.parametrize("shape", [(3, 5, 5), (2, 3, 4, 4), (4, 1, 1)])
def test_slogdet_backward_matches_torch_linalg(shape):
    """PyTorch's convention for gradients of complex tensors, held
    against torch.linalg.slogdet's own autograd. 1e-12: float64."""
    a_np = _complex(shape, 1)
    g_sign = torch.tensor(_complex(shape[:-2], 2))
    g_log = torch.tensor(np.random.RandomState(3).randn(*shape[:-2]))
    grads = []
    for fn in (tslog.slogdet_op, torch.linalg.slogdet):
        a = torch.tensor(a_np, requires_grad=True)
        sign, logabs = fn(a)
        loss = torch.sum((torch.conj(g_sign) * sign).real) + torch.sum(g_log * logabs)
        grads.append(torch.autograd.grad(loss, a)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-12, atol=1e-12)


def test_slogdet_backward_matches_jax_grad():
    """d/dA of a real function of (sign, log|det|): JAX returns the
    conjugate of PyTorch's gradient for a real loss of a complex input."""
    import jax
    import jax.numpy as jnp

    a_np = _complex((3, 4, 4), 4)
    c = _complex((3,), 5)

    def jloss(a):
        sign, logabs = jnp.linalg.slogdet(a)
        return jnp.sum((jnp.conj(c) * sign).real) + jnp.sum(logabs**2)

    want = np.conj(np.asarray(jax.grad(jloss)(jnp.asarray(a_np))))
    a = torch.tensor(a_np, requires_grad=True)
    sign, logabs = tslog.slogdet_op(a)
    loss = torch.sum((torch.conj(torch.tensor(c)) * sign).real) + torch.sum(logabs**2)
    got = torch.autograd.grad(loss, a)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)


def test_slogdet_backward_is_first_order_only(monkeypatch):
    """The kernel runs once, in the forward: the backward rule is first
    order in the kernel's outputs, and differentiating it again (which it
    now allows) flows through the same rule without a second launch. The
    second derivative equals torch.linalg.slogdet's. 1e-10: float64."""
    from deepsolid_tpu_torch.ops.cuda import det_kernels

    calls = []
    plain = det_kernels.gj_inverse_slogdet

    def counted(x):
        calls.append(x.shape)
        return plain(x)

    monkeypatch.setattr(tslog, "gj_inverse_slogdet", counted)
    grads = []
    for fn in (tslog.slogdet_op, torch.linalg.slogdet):
        a = torch.tensor(_complex((2, 3, 3), 6), requires_grad=True)
        _, logabs = fn(a)
        (g,) = torch.autograd.grad(logabs.sum(), a, create_graph=True)
        grads.append(torch.autograd.grad((g * torch.conj(g)).real.sum(), a)[0])
    assert calls == [(2, 3, 3)]
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-10, atol=1e-10)


def test_log_psi_gradient_matches_jax():
    """d Re/Im log psi / d params through the whole network. rtol 1e-9."""
    import jax
    import jax.numpy as jnp

    from torch_helpers import networks

    jnet, tnet, params, tparams, _ = networks(**NET)
    x = np.random.RandomState(7).randn(3, 12) * 2.0
    c = _complex((3,), 8)

    def jloss(p):
        return jnp.sum((c * jnp.conj(jnet.batch_logdet(p, jnp.asarray(x)))).real)

    want = jax.grad(jloss)(params)
    leaves = tadam.tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    loss = torch.sum((torch.tensor(c) * torch.conj(
        tnet.logdet(leaves, torch.tensor(x)))).real)
    loss.backward()
    got = tadam.tree_map(lambda t: t.grad, leaves)
    np.testing.assert_allclose(flat(got), jflat(same_order(got, want)),
                               rtol=1e-9, atol=1e-12)


# ---- (d) loss value and gradient ------------------------------------------------

BAD_X = 50.0  # a walker whose first coordinate exceeds this gets E_L = inf


def _poison_torch(monkeypatch):
    orig = tloss.make_local_energy

    def make(*args, **kwargs):
        el = orig(*args, **kwargs)

        def local_energy(params, x):
            ke, ew = el(params, x)
            return ke, torch.where(x[:, 0] > BAD_X, torch.inf, ew)

        return local_energy

    monkeypatch.setattr(tloss, "make_local_energy", make)


def _poison_jax(monkeypatch):
    import jax.numpy as jnp

    from deepsolid_tpu.train import loss as jloss

    orig = jloss.make_local_energy

    def make(*args, **kwargs):
        el = orig(*args, **kwargs)

        def local_energy(params, x):
            ke, ew = el(params, x)
            return ke, jnp.where(x[0] > BAD_X, jnp.inf, ew)

        return local_energy

    monkeypatch.setattr(jloss, "make_local_energy", make)


@pytest.mark.parametrize("clip_type,psi_chunk", [("real", 0), ("complex", 2)])
def test_loss_value_and_gradient_match_jax(clip_type, psi_chunk, monkeypatch):
    """Loss, statistics and the clipped covariance gradient against
    jax.value_and_grad(make_loss(...)), with one walker whose local
    energy is not finite (its log psi is). rtol 1e-9."""
    import jax
    import jax.numpy as jnp

    from deepsolid_tpu.train import loss as jloss_lib
    from torch_helpers import networks

    _poison_torch(monkeypatch)
    _poison_jax(monkeypatch)
    jnet, tnet, params, tparams, jsc = networks(**NET)
    tsc = torch_lih_supercell()
    x = np.random.RandomState(9).randn(6, 12) * 2.0
    x[2, 0] = BAD_X + 1.0
    clip = 1.5  # narrow enough that several walkers are clipped

    jtotal = jloss_lib.make_loss(
        jnet.logdet, jnet.batch_logdet, jsc, clip_local_energy=clip,
        clip_type=clip_type, mode="forward", network_obj=jnet, el_chunk=3,
        psi_chunk=psi_chunk)
    (jl, jaux), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        params, jnp.asarray(x))

    ttotal = tloss.make_loss(tnet, tsc, el_chunk=3, clip_local_energy=clip,
                             clip_type=clip_type, psi_chunk=psi_chunk)
    (tl, taux), tgrad = ttotal.value_and_grad(tparams, torch.tensor(x))

    assert float(taux.finite.sum()) == 5.0 and float(jaux.finite.sum()) == 5.0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    np.testing.assert_allclose(float(taux.variance), float(jaux.variance), rtol=1e-9)
    np.testing.assert_allclose(taux.local_energy.numpy(),
                               np.asarray(jaux.local_energy), rtol=1e-9)
    g, want = flat(tgrad), jflat(same_order(tgrad, jgrad))
    assert np.all(np.isfinite(g)) and np.linalg.norm(g) > 0
    np.testing.assert_allclose(g, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())
    # the parameters handed in are left without a gradient of their own
    assert all(t.grad is None for t in tadam.tree_leaves(tparams))


def test_psi_chunk_must_divide_the_batch():
    net, sc, params, x = seed_state(n_walkers=6)
    total = tloss.make_loss(net, sc, psi_chunk=4)
    with pytest.raises(ValueError, match="psi_chunk"):
        total.value_and_grad(tnet_lib.params_from_jax(params, dtype=F64),
                             torch.tensor(x))
    with pytest.raises(ValueError, match="psi_chunk"):
        tloss.chunk_batch_fn(net.slogdet, 4)(
            tnet_lib.params_from_jax(params, dtype=F64), torch.tensor(x))


def test_chunked_gradient_equals_whole_batch():
    net, sc, params, x = seed_state(n_walkers=6)
    tparams = tnet_lib.params_from_jax(params, dtype=F64)
    whole = tloss.make_loss(net, sc).value_and_grad(tparams, torch.tensor(x))[1]
    parts = tloss.make_loss(net, sc, psi_chunk=2).value_and_grad(
        tparams, torch.tensor(x))[1]
    np.testing.assert_allclose(flat(parts), flat(whole), rtol=1e-10, atol=1e-14)


# ---- adam against optax ---------------------------------------------------------


@pytest.mark.parametrize("gradient_clip,ministeps", [(0.0, 1), (0.5, 1), (0.5, 2)])
def test_adam_matches_optax(gradient_clip, ministeps):
    """The updates and the state of optax's chain, 1e-12 in float64, over
    enough steps for two emitted updates when ministeps accumulate."""
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(10)
    params = {"a": [rng.randn(3, 2), rng.randn(4)], "b": {"w": rng.randn(2, 2)}}
    hyper = dict(b1=0.9, b2=0.99, eps=1e-8, eps_root=1e-10)

    def schedule(t):
        return 0.05 * (1.0 / (1.0 + t / 3.0)) ** 1.0

    chain = []
    if gradient_clip > 0:
        chain.append(optax.clip_by_global_norm(gradient_clip))
    chain += [optax.scale_by_adam(**hyper), optax.scale_by_schedule(schedule),
              optax.scale(-1.0)]
    jopt = optax.chain(*chain)
    if ministeps > 1:
        jopt = optax.MultiSteps(jopt, every_k_schedule=ministeps)
    jparams = tadam.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)

    topt = tadam.Adam(schedule, **hyper, gradient_clip=gradient_clip,
                      ministeps=ministeps)
    tparams = tadam.tree_map(torch.tensor, params)
    tstate = topt.init(tparams)
    for step in range(3 * ministeps):
        grads = tadam.tree_map(lambda p: rng.randn(*p.shape) * (1 + step), params)
        jupd, jstate = jopt.update(tadam.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = topt.update(tadam.tree_map(torch.tensor, grads), tstate)
        tparams = tadam.apply_updates(tparams, tupd)
        np.testing.assert_allclose(flat(tparams), jflat(jparams), rtol=1e-12,
                                   atol=1e-14, err_msg=f"step {step}")
    # optax's state converts to the port's, field by field, and back
    converted = tadam.state_from_numpy(jstate, "cpu", F64)
    assert tprocess._same_structure(converted, tstate)
    inner = converted.inner_opt_state if ministeps > 1 else converted
    mine = tstate.inner_opt_state if ministeps > 1 else tstate
    at = 1 if gradient_clip > 0 else 0
    assert int(inner[at].count) == int(mine[at].count) == 3
    np.testing.assert_allclose(flat(inner[at].nu), flat(mine[at].nu), rtol=1e-12)


# ---- (e) three adam steps of process() ---------------------------------------------


@pytest.mark.parametrize("clip_type", ["real", "complex"])
def test_three_adam_steps_match_jax(tmp_path, clip_type, one_device_jax):
    """process() of both packages from one starting checkpoint, walkers
    fixed (mcmc.steps = 0): parameters after three adam iterations to
    rtol 1e-8, and the logged energies."""
    from deepsolid_tpu.train import process as jprocess
    from torch_helpers import lih_cells

    _, _, params, x = seed_state(n_walkers=8, seed=2)
    for side in ("jax", "torch"):
        write_start(tmp_path / side, params, x)
    optim = dict(clip_type=clip_type, clip_el=2.0, el_chunk=4, psi_chunk=4)
    jsc, _ = lih_cells()
    jparams, _, jenergy = jprocess.process(jax_cfg(tmp_path / "jax", jsc, **optim))
    energies = []
    tparams, tdata, tenergy = tprocess.process(
        torch_cfg(tmp_path / "torch", **optim), device="cpu",
        on_iteration=lambda t, row, s: energies.append((row["energy"],
                                                         row["grad_norm"])))
    assert len(energies) == 3 and all(np.isfinite(e).all() for e in energies)
    np.testing.assert_allclose(tenergy, jenergy, rtol=1e-8)
    np.testing.assert_allclose(flat(tparams), jflat(same_order(tparams, jparams)),
                               rtol=1e-8, atol=1e-12)
    assert np.abs(flat(tparams) - flat(tnet_lib.params_from_jax(params, dtype=F64))
                  ).max() > 1e-4  # the parameters moved
    np.testing.assert_array_equal(tdata.numpy(), x)  # fixed walkers

    jrows = open(tmp_path / "jax" / "train_stats.csv").read().strip().split("\n")
    trows = open(tmp_path / "torch" / "train_stats.csv").read().strip().split("\n")
    assert jrows[0] == trows[0] and len(jrows) == len(trows) == 4
    for jr, tr in zip(jrows[1:], trows[1:]):
        je, te = float(jr.split(",")[1]), float(tr.split(",")[1])
        np.testing.assert_allclose(te, je, rtol=1e-8)


# ---- (f) checkpoints ---------------------------------------------------------------


def test_checkpoints_are_interchangeable(tmp_path, one_device_jax):
    """The port's end-of-run checkpoint restores in the JAX package and
    JAX continues training from it; JAX's restores in the port, adam
    state included, and the port continues to the same parameters."""
    from deepsolid_tpu.train import process as jprocess
    from deepsolid_tpu.utils import checkpoint as jckpt
    from torch_helpers import lih_cells

    _, _, params, x = seed_state(n_walkers=8, seed=3)
    jsc, _ = lih_cells()
    optim = dict(el_chunk=4)

    # port writes (2 iterations); JAX reads and continues to 4
    write_start(tmp_path / "a", params, x)
    tparams2, _, _ = tprocess.process(torch_cfg(tmp_path / "a", iterations=2, **optim),
                                      device="cpu")
    files = sorted(f for f in os.listdir(tmp_path / "a") if "qmcjax_ckpt_" in f)
    assert files == ["qmcjax_ckpt_-00001.npz", "qmcjax_ckpt_000001.npz"]
    t, data, jp, jstate, width = jckpt.restore(str(tmp_path / "a" / files[-1]))
    assert t == 2 and data.shape == (8, 12) and float(width) == 0.02
    np.testing.assert_allclose(jflat(same_order(tparams2, jp)), flat(tparams2), rtol=0)
    assert int(jstate[1].count) == 2  # clip, adam, schedule, sign
    ja, _, _ = jprocess.process(jax_cfg(tmp_path / "a", jsc, iterations=4, **optim))

    # JAX writes (2 iterations); the port reads and continues to 4
    write_start(tmp_path / "b", params, x)
    jprocess.process(jax_cfg(tmp_path / "b", jsc, iterations=2, **optim))
    t, data, _, state, _ = tckpt.restore(str(tmp_path / "b" / "qmcjax_ckpt_000001.npz"))
    assert t == 2 and type(state[1]).__name__ == "ScaleByAdamState"
    tb, _, _ = tprocess.process(torch_cfg(tmp_path / "b", iterations=4, **optim),
                                device="cpu")

    # both continued runs equal four uninterrupted iterations of the port
    write_start(tmp_path / "c", params, x)
    tc, _, _ = tprocess.process(torch_cfg(tmp_path / "c", iterations=4, **optim),
                                device="cpu")
    # (a tree that went through JAX comes back with its keys sorted)
    np.testing.assert_allclose(flat(same_order(tc, tb)), flat(tc), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(jflat(same_order(tc, ja)), flat(tc), rtol=1e-8,
                               atol=1e-12)


def test_adam_ignores_another_optimizers_state(tmp_path, caplog):
    _, _, params, x = seed_state(n_walkers=4)
    os.makedirs(tmp_path / "k")
    tckpt.save(str(tmp_path / "k"), 6, x, params, {"damping": np.float64(1e-3)}, 0.02)
    seen = []
    tprocess.process(torch_cfg(tmp_path / "k", iterations=8, batch=4), device="cpu",
                     on_iteration=lambda t, row, s: seen.append(t))
    assert seen == [7]
    assert "another optimizer" in caplog.text


# ---- (g) misconfigurations -----------------------------------------------------------


def test_deriv_devices_misconfiguration_raises(tmp_path):
    cfg = torch_cfg(tmp_path, iterations=1)
    cfg.parallel.deriv_devices = 5  # does not divide 3N = 12 tangents
    with pytest.raises(ValueError, match="tangent"):
        tprocess.process(cfg, device="cpu")
    cfg = torch_cfg(tmp_path, iterations=1)
    cfg.parallel.deriv_devices = 2
    cfg.optim.laplacian_mode = "partition"
    with pytest.raises(ValueError, match="forward"):
        tprocess.process(cfg, device="cpu")
    cfg = torch_cfg(tmp_path, iterations=1)
    cfg.parallel.deriv_devices = 2  # no process group with two ranks
    with pytest.raises(ValueError, match="deriv_devices"):
        tprocess.process(cfg, device="cpu")


def test_kfac_and_unknown_optimizers_raise(tmp_path):
    """'kfac' runs (its parity with JAX is tests/test_torch_kfac.py's); an
    optimizer the port does not know raises."""
    seen = []
    tprocess.process(torch_cfg(tmp_path / "k", optimizer="kfac", iterations=1,
                               batch=4), device="cpu",
                     on_iteration=lambda t, row, s: seen.append((row, s)))
    assert len(seen) == 1 and seen[0][0]["optimizer_step"] == 0
    assert np.isfinite(seen[0][0]["grad_norm"]) and "curvature" in seen[0][1]
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tprocess.process(torch_cfg(tmp_path, optimizer="sgd"), device="cpu")


# ---- ranks: sharded E_L inside the training step, and the data axis ---------------------


def training_rank(rank, world_size, save_path, deriv_devices, batch, iterations):
    torch.set_num_threads(1)
    cfg = torch_cfg(save_path, iterations=iterations, batch=batch, el_chunk=2)
    cfg.parallel.deriv_devices = deriv_devices
    rows = []
    params, data, energy = tprocess.process(
        cfg, device="cpu", on_iteration=lambda t, row, s: rows.append(
            {k: row[k] for k in ("energy", "grad_norm")}))
    return flat(params), data.numpy(), rows


@pytest.mark.parametrize("world,deriv", [(2, 2), (2, 1), (4, 2)])
def test_ranks_train_like_one_process(tmp_path, world, deriv):
    """Adam steps on a (data x deriv) mesh of gloo ranks against one
    process on the same global batch: every rank ends with the single
    process's parameters (the deriv ranks shard E_L's tangents, the data
    ranks split the walkers and average statistics and gradients), and
    rank 0 alone writes the files. rtol 1e-9."""
    _, _, params, x = seed_state(n_walkers=8, seed=4)
    write_start(tmp_path / "one", params, x)
    write_start(tmp_path / "many", params, x)
    want, _, want_rows = training_rank(0, 1, str(tmp_path / "one"), 1, 8, 2)
    out = parallel.run_ranks(training_rank, world,
                             (str(tmp_path / "many"), deriv, 8, 2),
                             timeout=RANK_TIMEOUT)
    per_rank = 8 // (world // deriv)
    for rank, (got, data, rows) in enumerate(out):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-13,
                                   err_msg=f"rank {rank}")
        lo = (rank // deriv) * per_rank
        np.testing.assert_array_equal(data, x[lo:lo + per_rank])
        for row, want_row in zip(rows, want_rows):
            np.testing.assert_allclose(row["energy"], want_row["energy"], rtol=1e-9)
            np.testing.assert_allclose(row["grad_norm"], want_row["grad_norm"],
                                       rtol=1e-9)
    _, data, _, state, _ = tckpt.restore(str(tmp_path / "many" / "qmcjax_ckpt_000001.npz"))
    np.testing.assert_array_equal(data, x)  # the global batch, gathered
    assert int(state[1].count) == 2
    assert len(open(tmp_path / "many" / "train_stats.csv").read().strip().split("\n")) == 3
