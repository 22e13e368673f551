"""Tangent-sharded forward-Laplacian of the port against the unsharded
port and the JAX package.

The ranks are real processes joined by a gloo process group
(deepsolid_tpu_torch.parallel.run_ranks); each holds 3N / size of the 12
tangent columns of the LiH cell. Sizes 3 and 4 put a rank boundary inside
a spin channel's slab (and size 3 inside one electron's three tangents),
which size 2 would hide: there the boundary falls between the channels.

Rank workers are module-level functions that import no JAX, so a spawned
rank starts without it; JAX is imported inside the tests that compare
with it. float64 throughout; tolerances: rtol 1e-9 (sums over tangents
are taken in another order when sharded).
"""

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.models import fwdlap_forward as tff
from deepsolid_tpu_torch.models import network as tnet_lib
from deepsolid_tpu_torch.ops import fwdlap as tfl
from deepsolid_tpu_torch.scf.free_electron import free_electron_klist
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell

F64 = torch.float64
NET = dict(hidden_dims=((16, 4), (16, 4)), determinants=2)
RANK_TIMEOUT = 240.0  # seconds: run_ranks ends the ranks and fails after it


def torch_lih_net(**cfg):
    L = 2 / 0.529177
    sc = make_supercell(Cell.from_atoms(
        [Atom("Li", (0, 0, 0)), Atom("H", (L / 2,) * 3)],
        (1 - np.eye(3)) * L / 2), np.eye(3))
    net = tnet_lib.make_network(sc, free_electron_klist(sc),
                                tnet_lib.NetworkConfig(**{**NET, **cfg}))
    return net, sc


def kinetic_rank(rank, world_size, params_np, x_np, cfg):
    """One rank's sharded kinetic energy (every rank must agree)."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh(world_size)
    assert mesh.shard.index == rank and mesh.shard.size == world_size
    net, _ = torch_lih_net(**cfg)
    kin = tff.make_kinetic_forward(net, shard=mesh.shard)
    with torch.no_grad():
        ke = kin(tnet_lib.params_from_jax(params_np, dtype=F64),
                 torch.tensor(x_np, dtype=F64))
    return ke.numpy()


def failing_rank(rank, world_size):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def _case(seed=0, n_walkers=3, **cfg):
    net, sc = torch_lih_net(**cfg)
    params = net.init(np.random.default_rng(seed))
    x = np.random.RandomState(seed).randn(n_walkers, 3 * sum(sc.nelec)) * 2.0
    return net, params, x


@pytest.mark.parametrize("size", [2, 3, 4])
def test_sharded_kinetic_matches_unsharded_and_jax(size):
    import jax

    from deepsolid_tpu.models import fwdlap_forward as jff
    from torch_helpers import lih_cells
    from deepsolid_tpu.models import network as jnet_lib
    from deepsolid_tpu.scf.free_electron import free_electron_klist as jklist

    net, params, x = _case()
    with torch.no_grad():
        want = tff.make_kinetic_forward(net)(
            tnet_lib.params_from_jax(params, dtype=F64),
            torch.tensor(x, dtype=F64)).numpy()
    got = parallel.run_ranks(kinetic_rank, size, (params, x, {}),
                             timeout=RANK_TIMEOUT)
    for rank, ke in enumerate(got):
        np.testing.assert_allclose(ke, want, rtol=1e-9, err_msg=f"rank {rank}")

    jsc, _ = lih_cells()
    jnet = jnet_lib.make_network(jsc, jklist(jsc), jnet_lib.NetworkConfig(**NET))
    jkin = jax.vmap(jff.make_kinetic_forward(jnet), in_axes=(None, 0))
    np.testing.assert_allclose(got[0], np.asarray(jkin(params, x)), rtol=1e-9)


def test_sharded_kinetic_full_det_and_last_layer():
    """The other trunk ending (use_last_layer: the orbital head takes the
    mixed features through dense_mix) and one full determinant."""
    cfg = dict(use_last_layer=True, full_det=True)
    net, params, x = _case(seed=1, n_walkers=2, **cfg)
    with torch.no_grad():
        want = tff.make_kinetic_forward(net)(
            tnet_lib.params_from_jax(params, dtype=F64),
            torch.tensor(x, dtype=F64)).numpy()
    got = parallel.run_ranks(kinetic_rank, 4, (params, x, cfg),
                             timeout=RANK_TIMEOUT)
    np.testing.assert_allclose(got[0], want, rtol=1e-9)
    np.testing.assert_allclose(got[3], want, rtol=1e-9)


def test_a_failing_rank_raises_in_the_parent():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        parallel.run_ranks(failing_rank, 2, timeout=60.0)


class _FakeShard:
    """A deriv axis played in one process: every rank's tensors are
    computed in turn and `all_sum` adds what the ranks recorded."""

    def __init__(self, index, size, book):
        self.index, self.size, self.book = index, size, book

    def t0(self, t_loc):
        return self.index * t_loc

    def all_sum(self, t):
        self.book.append(t)
        return t


@pytest.mark.parametrize("size", [2, 3, 4, 6])
def test_mul_row_window_matches_dense_rule(size):
    """The slab update and cross term window by window against the whole
    tangent axis (which tests/test_torch_network.py holds against JAX):
    jac rows agree window by window and the ranks' cross terms add up."""
    rng = np.random.RandomState(4)
    n_total, rows, offset, b_, d_, f_ = 4, 2, 1, 2, 3, 5
    t_dim = 3 * n_total

    def c(*s):
        return torch.tensor(rng.randn(*s) + 1j * rng.randn(*s))

    a = tfl.Jet(c(b_, d_, rows, f_), c(t_dim, b_, d_, rows, f_), c(b_, d_, rows, f_))
    bv, bj, bl = c(b_, d_, rows, f_), c(3, b_, d_, rows, f_), c(b_, d_, rows, f_)
    want = tfl.mul_row(a, bv, bj, bl, n_total, offset)
    t_loc = t_dim // size
    base = a.lap * bv + a.val * bl
    cross_sum = torch.zeros_like(base)
    for k in range(size):
        book = []
        part = tfl.Jet(a.val, a.jac[k * t_loc:(k + 1) * t_loc], a.lap)
        got = tfl.mul_row(part, bv, bj, bl, n_total, offset,
                          shard=_FakeShard(k, size, book))
        torch.testing.assert_close(got.jac, want.jac[k * t_loc:(k + 1) * t_loc],
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got.val, want.val, rtol=0, atol=0)
        (cross,) = book
        cross_sum = cross_sum + cross
    torch.testing.assert_close(base + 2.0 * cross_sum, want.lap,
                               rtol=1e-12, atol=1e-12)


def test_shard_must_divide_the_tangents_and_needs_forward_mode():
    from deepsolid_tpu_torch.hamiltonian import make_local_energy

    net, sc = torch_lih_net()
    with pytest.raises(ValueError, match="tangent"):
        tff.make_kinetic_forward(net, shard=parallel.TangentShard(0, 5))
    with pytest.raises(ValueError, match="forward"):
        make_local_energy(net, sc, mode="partition",
                          shard=parallel.TangentShard(0, 2))


def test_make_mesh_without_ranks():
    mesh = parallel.make_mesh(1)
    assert (mesh.world_size, mesh.num_data, mesh.shard) == (1, 1, None)
    t = torch.arange(3.0)
    assert mesh.all_mean(t) is t
    with pytest.raises(ValueError, match="deriv_devices"):
        parallel.make_mesh(2)
