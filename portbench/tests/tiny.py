"""A tiny cell for the CPU tests: C-diamond or bcc-Li in one primitive
cell with a narrow network (widths (8, 4), two determinants), parameters
and walkers drawn from the seed, eight walkers (or `batch`) in E_L chunks
of four, two MCMC steps, KFAC (or `optimizer`)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench import spec

HERE = Path(__file__).resolve().parent.parent


def free_electron_klist(conf: dict):
    """The occupied k-vectors the port would choose for the cell (its
    'auto' policy without a basis), for the configuration file."""
    from portbench.harness import program_config
    from deepsolid_tpu_torch.train import process as process_mod

    conf = {**conf, "klist": [[[0.0, 0.0, 0.0]]] * 2}
    traffic = spec.load_json(HERE / "traffic" / "f64-kfac-1024.json")
    cfg = program_config(conf, traffic, Path("unused"))
    cfg.system.klist_policy = "auto"
    return [np.asarray(k).tolist() for k in process_mod.resolve_klist(cfg, cfg.system.cell)]


def make_cell(tmp: Path, config="c-diamond-2x2x2", precision="float64", limits=None,
              name="tiny-cell", batch=8, optimizer="kfac") -> spec.Cell:
    conf = spec.load_json(HERE / "configs" / f"{config}.json")
    conf.update(name="tiny", supercell=[[1, 0, 0], [0, 1, 0], [0, 0, 1]], checkpoint=None,
                mcmc_burn_in=1,
                network={**conf["network"], "hidden_dims": [[8, 4], [8, 4], [8, 4]],
                         "determinants": 2})
    conf["klist"] = free_electron_klist(conf)
    traffic = spec.load_json(HERE / "traffic" / "f64-kfac-1024.json")
    traffic.update(precision=precision, batch_size=batch, el_chunk=4, psi_chunk=4,
                   reference_chunk=4, mcmc_steps=2, optimizer=optimizer)
    traffic["kfac"] = {**traffic["kfac"], "damping_adaptation_interval": 1}
    for sub in ("configs", "traffic", "limits"):
        (tmp / sub).mkdir(exist_ok=True)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(conf))
    (tmp / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    if limits is not None:
        (tmp / "limits" / f"{name}.json").write_text(json.dumps(limits))
    bench = spec.benchmark()
    bench = {**bench, "workloads": [{"name": name, "config": "tiny", "traffic": "tiny",
                                     "chips": 1, "why": "a CPU test"}]}
    for group in ("end_to_end", "per_layer"):
        bench[group] = [{k: v for k, v in m.items() if k != "workloads"}
                        for m in bench[group]]
    return spec.Cell(name, bench, here=tmp)
