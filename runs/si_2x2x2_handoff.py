"""Writes the step-0 handoff of Si 2x2x2 that the benchmark's
si-diamond-2x2x2 configuration starts from:

    python runs/si_2x2x2_handoff.py

runs/ckpt_si_2x2x2/qmcjax_ckpt_000000.npz holds t = 0, no optimizer state
and no MCMC width, as pretraining saves a handoff: the port's network
init at seed 0 (net.init(np.random.default_rng(0)), the network that
portbench/configs/si-diamond-2x2x2.json builds), stored in float16 so that
the file stays small, and WALKERS walkers from sampling/init.init_electrons
over the 16 atoms of the simulation cell (torch generator seed 0), one for
each walker of the cell's batch: tiled from fewer, near-copies of a walker
would feed the first KFAC step's factors near-null directions that float32
rounding swings. No pretraining. The run restores it at iteration 0 and
burns in.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from deepsolid_tpu_torch.sampling.init import init_electrons  # noqa: E402
from deepsolid_tpu_torch.train import process as process_mod  # noqa: E402
from deepsolid_tpu_torch.utils import checkpoint as checkpoint_lib  # noqa: E402
from deepsolid_tpu_torch.utils.tree import tree_map  # noqa: E402
from portbench import harness, spec  # noqa: E402

CONFIG = ROOT / "portbench" / "configs" / "si-diamond-2x2x2.json"
TRAFFIC = ROOT / "portbench" / "traffic" / "f32-kfac-512-el32.json"
OUT = ROOT / "runs" / "ckpt_si_2x2x2"
WALKERS = 512


def main():
    conf, traffic = spec.load_json(CONFIG), spec.load_json(TRAFFIC)
    cfg = harness.program_config(conf, traffic, OUT)
    sc = cfg.system.cell
    net = process_mod.build_network(cfg, sc)
    params = tree_map(lambda a: np.asarray(a, np.float16), net.init(np.random.default_rng(0)))
    gen = torch.Generator().manual_seed(0)
    data = init_electrons(gen, sc, sc.nelec, WALKERS, cfg.mcmc.init_width,
                          dtype=torch.float32)
    OUT.mkdir(parents=True, exist_ok=True)
    print(checkpoint_lib.save(str(OUT), 0, data.numpy(), params, None, None))


if __name__ == "__main__":
    main()
