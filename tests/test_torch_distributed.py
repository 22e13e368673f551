"""Joining a world of ranks (deepsolid_tpu_torch/parallel/distributed.py)
and the command line over every card.

Counterpart of tests/test_distributed.py: a real two-process bootstrap
over localhost TCP (gloo, CPU), a request that fails, torchrun driving
`python -m deepsolid_tpu_torch` as two data ranks against one process,
and, with torch.cuda's queries replaced (no GPU here), the choice of
backend, the card each rank binds and the command line's one rank per
card.
"""

import json
import os
import queue
import re
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepsolid_tpu_torch import cli, parallel
from deepsolid_tpu_torch.optim.adam import tree_leaves
from deepsolid_tpu_torch.parallel import distributed
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import checkpoint as tckpt
from test_torch_cli import CONFIGS, REPO, four_cards  # noqa: F401  (a fixture)
from test_torch_training import NET, seed_state, write_start

H2 = os.path.join(CONFIGS, "two_hydrogen_cell.py") + ":H,1,1,1,2.0,0,sto-3g"
# the LiH cell of tests/test_torch_training.py (rock salt, 2 Angstrom, no
# basis: no orbital source) with torch_cfg's settings
LIH = os.path.join(CONFIGS, "rock_salt.py") + ":Li,H,2.0,1,"
LIH_OVERRIDES = {
    "batch_size": 8, "precision": "float64", "optim.optimizer": "adam",
    "optim.iterations": 2, "optim.laplacian_mode": "forward", "optim.lr.rate": 1e-2,
    "mcmc.burn_in": 0, "mcmc.steps": 0, "pretrain.iterations": 0,
    "pretrain.method": "none", "network.detnet.hidden_dims": NET["hidden_dims"],
    "network.detnet.determinants": NET["determinants"], "log.save_frequency": 1e9,
    "debug.deterministic": True,
}


def _env():
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in distributed.LAUNCHER_ENV}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_launcher(monkeypatch):
    for key in distributed.LAUNCHER_ENV + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)


@pytest.mark.parametrize("device_type,local_world,cards,want", [
    ("cuda", 1, 1, "nccl"),   # one rank, one card
    ("cuda", 2, 1, "gloo"),   # two ranks share the card
    ("cuda", 4, 8, "nccl"),   # every rank owns a card
    ("cuda", 8, 8, "nccl"),
    ("cpu", 2, 0, "gloo"),
    ("cpu", 1, 8, "gloo"),
])
def test_choose_backend(device_type, local_world, cards, want):
    assert distributed.choose_backend(device_type, local_world, cards) == want


def test_initialize_alone_is_one_process(no_launcher):
    distributed.initialize()
    distributed.initialize(device="cpu")
    assert not dist.is_initialized()


@pytest.fixture
def fake_join(monkeypatch):
    """init_process_group recorded instead of joining."""
    joined = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append({"backend": backend, **kw}))
    return joined


@pytest.mark.parametrize("env,args,card,backend", [
    # torchrun on the second host of two, four cards each
    ({"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"},
     {}, 1, "nccl"),
    # eight ranks on a four-card host share the cards
    ({"RANK": "6", "WORLD_SIZE": "8", "LOCAL_RANK": "6", "LOCAL_WORLD_SIZE": "8"},
     {}, 2, "gloo"),
    # an explicit request: the card from process_id % device_count
    ({}, {"coordinator_address": "10.0.0.1:1234", "num_processes": 4,
          "process_id": 3}, 3, "nccl"),
    ({}, {"coordinator_address": "10.0.0.1:1234", "num_processes": 4,
          "process_id": 3, "local_rank": 0}, 0, "nccl"),
    # two hosts of four cards, explicitly: every rank owns a card
    ({}, {"coordinator_address": "10.0.0.1:1234", "num_processes": 8,
          "process_id": 5}, 1, "nccl"),
    # eight ranks on one four-card host, explicitly: they share the cards
    ({}, {"coordinator_address": "10.0.0.1:1234", "num_processes": 8,
          "process_id": 5, "local_world_size": 8}, 1, "gloo"),
])
def test_initialize_binds_the_ranks_card(four_cards, fake_join, no_launcher, monkeypatch,
                                         env, args, card, backend):
    """A rank makes its card current before it joins, and NCCL is bound
    to that card (device_id), so that no collective guesses the card from
    the global rank."""
    if env:
        for key, value in {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", **env}.items():
            monkeypatch.setenv(key, value)
    distributed.initialize(**args, timeout=5.0)
    want = torch.device("cuda", card)
    assert four_cards == [want]
    (join,) = fake_join
    assert join["backend"] == backend
    assert join["device_id"] == (want if backend == "nccl" else None)
    assert join["init_method"] == ("env://" if env else "tcp://10.0.0.1:1234")
    assert (join["rank"], join["world_size"]) == (
        (int(env["RANK"]), 8) if env else (args["process_id"], args["num_processes"]))


@pytest.mark.parametrize("backend,card", [("nccl", 1), ("gloo", None)])
def test_rank_main_binds_nccl_to_its_card(four_cards, fake_join, monkeypatch, tmp_path,
                                          backend, card):
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    results = queue.Queue()
    parallel._rank_main(1, 2, backend, str(tmp_path / "store"), rank_of, (), results)
    assert results.get_nowait() == (1, True, 1)
    assert four_cards == [torch.device("cuda", 1)]
    want = None if card is None else torch.device("cuda", card)
    assert [j["device_id"] for j in fake_join] == [want]


def rank_of(rank, world_size):
    return rank


def test_nccl_collectives_take_only_the_ranks_card(four_cards, monkeypatch):
    """Under NCCL a tensor that is not on the rank's card raises before
    any collective runs: nothing is staged through the host unseen."""
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: pytest.fail("reduced"))
    with pytest.raises(ValueError, match="rank's card cuda:2, got one on cpu"):
        parallel._reduce_sum(torch.ones(3), None)
    with pytest.raises(ValueError, match="broadcast_int"):
        parallel.Mesh(0, 2).broadcast_int(7)  # the mesh's device: the CPU


_CHILD = textwrap.dedent("""
    import collections, json, logging, re, sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    from deepsolid_tpu_torch import parallel
    from deepsolid_tpu_torch.parallel import distributed, mesh

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="%(message)s")
    tensors, staged = collections.Counter(), mesh._staged

    def counting(t, group, kind):  # tensors handed to a collective
        tensors[kind + "/" + t.device.type] += 1
        return staged(t, group, kind)

    mesh._staged = counting
    coord, pid = sys.argv[1], int(sys.argv[2])
    distributed.initialize(coord, 2, pid, device="cpu", timeout=60.0)
    x = torch.tensor([1 + 2j, 3 - 1j], dtype=torch.complex128) * (pid + 1)
    total = parallel._reduce_sum(x, dist.group.WORLD)
    print(json.dumps({{"rank": dist.get_rank(), "world": dist.get_world_size(),
                      "backend": dist.get_backend(),
                      "sum": [[v.real, v.imag] for v in total.tolist()],
                      "tensors": tensors}}))
    dist.destroy_process_group()
""")


def test_two_process_bootstrap():
    """Two processes join one gloo world through tcp://127.0.0.1:<free
    port> and sum a complex tensor; each logs the joined line."""
    coord = f"127.0.0.1:{_free_port()}"
    code = _CHILD.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, coord, str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(), cwd=REPO)
             for pid in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        joined = re.search(distributed.JOINED_PATTERN, out).groupdict()
        assert joined == {"rank": str(pid), "world": "2", "local_rank": str(pid),
                          "backend": "gloo", "device": "cpu"}
        got = json.loads(out.strip().splitlines()[-1])
        assert (got["rank"], got["world"], got["backend"]) == (pid, 2, "gloo")
        np.testing.assert_allclose(got["sum"], [[3, 6], [9, -3]], rtol=0, atol=0)
        assert got["tensors"] == {"all_sum/cpu": 1}


def test_a_requested_bootstrap_that_fails_raises(no_launcher):
    """Process 1 of 2 with no coordinator listening: RuntimeError naming
    the request once the timeout has passed, never one process."""
    coord = f"127.0.0.1:{_free_port()}"
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="bootstrap was requested .*num_processes=2"):
        distributed.initialize(coord, 2, 1, device="cpu", timeout=5.0)
    assert time.monotonic() - start < 60.0
    assert not dist.is_initialized()


def _lih_argv(save_path):
    argv = [f"--config={LIH}", "--device", "cpu"]
    for key, value in {**LIH_OVERRIDES, "log.save_path": str(save_path)}.items():
        argv += [f"--config.{key}", str(value)]
    return argv


def _checkpointed_params(save_path):
    _, _, params, _, _ = tckpt.restore(str(save_path / "qmcjax_ckpt_000001.npz"))
    return np.concatenate([np.ravel(np.asarray(v)) for v in tree_leaves(params)])


def test_torchrun_two_data_ranks_train_like_one_process(tmp_path, no_launcher):
    """torchrun --standalone --nproc-per-node=2 -m deepsolid_tpu_torch:
    two gloo data ranks of the LiH cell take 2 adam iterations from one
    start checkpoint and checkpoint the parameters of one process on the
    same global batch (rtol 1e-9); rank 0 alone writes train_stats.csv."""
    _, _, params, x = seed_state(n_walkers=8, seed=4)
    for name in ("one", "two"):
        write_start(tmp_path / name, params, x)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node=2", "-m", "deepsolid_tpu_torch", *_lih_argv(tmp_path / "two")]
    out = subprocess.run(argv, capture_output=True, text=True, cwd=REPO, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    joined = [m.groupdict() for m in re.finditer(distributed.JOINED_PATTERN, out.stderr)]
    assert sorted((j["rank"], j["world"], j["backend"]) for j in joined) == [
        ("0", "2", "gloo"), ("1", "2", "gloo")]

    cfg, device = cli.parse(_lih_argv(tmp_path / "one"))
    tprocess.process(cfg, device=device)
    np.testing.assert_allclose(_checkpointed_params(tmp_path / "two"),
                               _checkpointed_params(tmp_path / "one"),
                               rtol=1e-9, atol=1e-13)
    energies = []
    for name in ("two", "one"):
        rows = (tmp_path / name / "train_stats.csv").read_text().strip().splitlines()
        assert len(rows) == 3  # the header and one row an iteration, written once
        energies.append([float(row.split(",")[1]) for row in rows[1:]])
    np.testing.assert_allclose(*energies, rtol=1e-9)


@pytest.mark.parametrize("cards", [4, 1])
def test_cli_runs_one_rank_per_card(four_cards, no_launcher, monkeypatch, cards):
    """`--device cuda` on a host with more than one card starts one NCCL
    rank per card, each running the same command line; on one card the
    run stays in this process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    started, ran = [], []
    monkeypatch.setattr(parallel, "run_ranks", lambda fn, n, args=(), backend="gloo",
                        timeout=600.0: started.append((fn, n, args, backend, timeout)))
    monkeypatch.setattr(tprocess, "process",
                        lambda cfg, device="cuda": ran.append((cfg.batch_size, device)))
    argv = [f"--config={H2}", "--config.batch_size", "16"]
    cli.main(argv)
    if cards == 1:
        assert (started, ran) == ([], [(16, "cuda")])
        return
    assert (started, ran) == ([(cli._rank, 4, (argv,), "nccl", None)], [])
    cli._rank(2, 4, argv)  # what each rank runs
    assert ran == [(16, "cuda")]
