"""The port's command line (deepsolid_tpu_torch/cli.py, `python -m
deepsolid_tpu_torch`) and the binding of each rank to its own GPU.

The command line follows deepsolid_tpu/cli.py: --config=path:ARGS, then
--config.a.b value overrides coerced to the replaced value's type, an
unknown key raising. No GPU here: the device binding is checked with
torch.cuda's queries replaced, and the CLI run passes --device cpu.
"""

import os
import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import cli, parallel
from deepsolid_tpu_torch import config as tconfig
from deepsolid_tpu_torch.device import rank_device, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "deepsolid_tpu_torch", "configs")
BCC_LI = (f"--config={os.path.join(CONFIGS, 'read_poscar.py')}:"
          f"{os.path.join(CONFIGS, 'poscar', 'bcc_li.vasp')},3,sto-3g")


@pytest.mark.parametrize("local_rank,count,index", [
    (0, 1, 0), (1, 1, 0), (3, 4, 3), (5, 4, 1), (7, 8, 7)])
def test_rank_device(local_rank, count, index):
    """Ranks take the cards in turn; two ranks on a one-card host share it."""
    assert rank_device(local_rank, count) == torch.device("cuda", index)


@pytest.fixture
def four_cards(monkeypatch):
    """torch.cuda reporting four cards, the current one cuda:2 until
    set_device (recorded) makes another current."""
    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: bound[-1].index if bound else 2)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    return bound


def test_resolve_device_takes_the_ranks_card(four_cards):
    assert resolve_device("cuda") == torch.device("cuda", 2)  # the current card
    assert resolve_device("cuda:3") == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")
    four_cards.append(rank_device(5, 4))  # as run_ranks binds rank 5
    assert resolve_device("cuda") == torch.device("cuda", 1)


def rank_answer(rank, world_size):
    return rank, resolve_device("cuda")


def test_rank_main_binds_its_card(four_cards, tmp_path):
    """A rank started by run_ranks sets its own card before it joins the
    process group, and process()'s 'cuda' resolves to it; the mesh keeps
    the device it is given."""
    results = queue.Queue()
    parallel._rank_main(0, 1, "gloo", str(tmp_path / "store"), rank_answer, (), results)
    assert results.get_nowait() == (0, True, (0, torch.device("cuda", 0)))
    assert four_cards == [torch.device("cuda", 0)]
    assert parallel.make_mesh(1, "cpu").device == torch.device("cpu")
    assert not torch.distributed.is_initialized()  # no process group left behind


@pytest.mark.parametrize("key,text,want", [
    ("batch_size", "1024", 1024),
    ("optim.lr.rate", "3e-4", 3e-4),
    ("optim.optimizer", "adam", "adam"),
    ("optim.kfac.adaptive_damping", "True", True),
    ("debug.deterministic", "false", False),
    ("network.detnet.hidden_dims", "((16, 4), (16, 4))", ((16, 4), (16, 4))),
    ("network.twist", "(0.5, 0, 0)", (0.5, 0, 0)),
    ("system.klist", "[[[0, 0, 0]], [[0, 0, 0]]]", [[[0, 0, 0]], [[0, 0, 0]]]),
])
def test_override_coerces_to_the_replaced_type(key, text, want):
    cfg = tconfig.default()
    cli.override(cfg, key, text)
    node = cfg
    for name in key.split("."):
        node = node[name]
    assert node == want and type(node) is type(want)


@pytest.mark.parametrize("key,text,error", [
    ("optim.no_such_key", "1", AttributeError),   # ConfigDict refuses new keys
    ("no_such_section.x", "1", AttributeError),
    ("debug.deterministic", "yes", ValueError),
    ("batch_size", "1.5", ValueError),
    ("network.twist", "3", ValueError),
    ("optim", "1", ValueError),                   # a section, not a value
])
def test_override_refuses(key, text, error):
    with pytest.raises(error):
        cli.override(tconfig.default(), key, text)


def test_parse_loads_a_config_file_with_overrides():
    """bcc-Li from the port's POSCAR copy, overrides in both spellings and
    in order (the later one wins)."""
    cfg, device = cli.parse([
        BCC_LI, "--config.batch_size", "512", "--config.optim.el_chunk=32",
        "--config.network.detnet.hidden_dims", "((16, 4),)",
        "--device", "cpu", "--config.batch_size", "1024"])
    assert device == "cpu"
    assert cfg.system.cell.nelec == (81, 81) and cfg.system.basis == "sto-3g"
    assert (cfg.batch_size, cfg.optim.el_chunk) == (1024, 32)
    assert cfg.network.detnet.hidden_dims == ((16, 4),)
    assert cli.parse([BCC_LI])[1] == "cuda"  # the default device
    with pytest.raises(AttributeError):
        cli.parse([BCC_LI, "--config.optim.no_such_key", "1"])
    with pytest.raises(ValueError, match="Supercell"):  # an object, not a value
        cli.parse([BCC_LI, "--config.system.cell", "None"])
    for stray in (["--bogus"], ["--config.batch_size"]):
        with pytest.raises(SystemExit):
            cli.parse([BCC_LI, *stray])


def test_cli_runs_two_hydrogen_cell_on_the_cpu(tmp_path):
    """python -m deepsolid_tpu_torch: H2 in a box from scratch (2
    pretraining iterations, then 1 KFAC iteration) writes its statistics
    and checkpoints."""
    save = tmp_path / "run"
    config = os.path.join(CONFIGS, "two_hydrogen_cell.py") + ":H,1,1,1,2.0,0,sto-3g"
    overrides = {
        "optim.iterations": 1, "batch_size": 4, "pretrain.iterations": 2,
        "mcmc.burn_in": 2, "mcmc.steps": 2, "network.detnet.determinants": 1,
        "network.detnet.hidden_dims": "((8, 4),)", "debug.deterministic": True,
        "log.save_path": str(save),
    }
    argv = [sys.executable, "-m", "deepsolid_tpu_torch", f"--config={config}",
            "--device", "cpu"]
    for key, value in overrides.items():
        argv += [f"--config.{key}", str(value)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(argv, capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = (save / "train_stats.csv").read_text().splitlines()
    assert len(lines) == 2 and np.isfinite(float(lines[1].split(",")[1]))
    assert sorted(p.name for p in save.glob("qmcjax_ckpt_*.npz")) == [
        "qmcjax_ckpt_000000.npz"]
