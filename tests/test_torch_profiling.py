"""The port's profiling hooks (utils/profiling.py) and their config keys:
StepTracer records its window only, process() writes a trace under
log.trace_path, `trace`, `annotate` and `timed` work on the CPU, and the
keys log.trace_* and system.ndim are accepted (ndim other than 3 is
refused)."""

import json
import logging
import os

import pytest
import torch

from deepsolid_tpu_torch import config as tconfig
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import profiling
from test_torch_training import seed_state, torch_cfg, write_start


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_step_tracer_records_its_window_only(tmp_path):
    tracer = profiling.StepTracer(str(tmp_path), start=2, steps=2)
    names = []
    for i in range(6):
        tracer.step(i)
        with profiling.annotate(f"iteration_{i}"):
            torch.ones(4).sum()
        names.append(os.listdir(tmp_path))
    tracer.close()
    # nothing before the window, one file once it has closed at i = 4
    assert names[:4] == [[], [], [], []] and len(names[4]) == 1
    assert os.listdir(tmp_path) == names[4] and tracer.path.endswith(names[4][0])
    seen = {e.get("name") for e in _events(tracer.path)}
    assert {"iteration_2", "iteration_3"} <= seen
    assert not seen & {"iteration_0", "iteration_1", "iteration_4", "iteration_5"}


def test_step_tracer_without_a_directory_records_nothing(tmp_path):
    tracer = profiling.StepTracer("", start=0, steps=1)
    for i in range(3):
        tracer.step(i)
    tracer.close()
    assert tracer.path is None


def test_trace_annotate_and_timed(tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        with profiling.trace(str(tmp_path / "t")):
            with profiling.annotate("span"), profiling.timed("span"):
                torch.ones(8) @ torch.ones(8)
    (path,) = os.listdir(tmp_path / "t")
    assert "span" in {e.get("name") for e in _events(tmp_path / "t" / path)}
    assert "span:" in caplog.text


def test_process_writes_a_trace_of_its_window(tmp_path):
    """Three iterations with trace_start 1, trace_steps 1: one trace file,
    closed when the third iteration begins, holding the second."""
    _, _, params, x = seed_state(n_walkers=4, seed=1)
    write_start(tmp_path / "run", params, x)
    cfg = torch_cfg(tmp_path / "run", optimizer="adam", iterations=3, batch=4)
    cfg.log.trace_path = str(tmp_path / "trace")
    cfg.log.trace_start = 1
    cfg.log.trace_steps = 1
    seen = []
    tprocess.process(cfg, device="cpu", on_iteration=lambda t, row, s: seen.append(t))
    assert seen == [0, 1, 2]
    (path,) = os.listdir(tmp_path / "trace")
    names = {e.get("name") for e in _events(tmp_path / "trace" / path)}
    assert any(n and n.startswith("aten::") for n in names)


def test_trace_keys_are_accepted_and_ndim_must_be_three(tmp_path):
    cfg = tconfig.default()
    assert (cfg.log.trace_path, cfg.log.trace_start, cfg.log.trace_steps) == ("", 10, 5)
    assert cfg.system.ndim == 3
    assert cfg.optim.laplacian_mode == "partition" and cfg.optim.partition_number == 3
    cfg = torch_cfg(tmp_path, iterations=1)
    cfg.system.ndim = 2
    with pytest.raises(ValueError, match="ndim"):
        tprocess.process(cfg, device="cpu")
