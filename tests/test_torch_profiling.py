"""The port's profiling hooks (utils/profiling.py) and their config keys:
StepTracer records its window only, process() writes a trace under
log.trace_path that holds its phase spans, `trace` and `annotate` work on
the CPU, `annotate` enters no record_function while no profiler records,
the program's spans nest layer in layer through a training run, and the
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
    assert {"deepsolid.iteration_2", "deepsolid.iteration_3"} <= seen
    assert not seen & {f"deepsolid.iteration_{i}" for i in (0, 1, 4, 5)}


def test_step_tracer_without_a_directory_records_nothing(tmp_path):
    tracer = profiling.StepTracer("", start=0, steps=1)
    for i in range(3):
        tracer.step(i)
    tracer.close()
    assert tracer.path is None


def test_trace_annotate_and_timed(tmp_path, caplog):
    """`trace` writes one file and logs it; an `annotate` span inside is
    named deepsolid.<name> there."""
    with caplog.at_level(logging.INFO):
        with profiling.trace(str(tmp_path / "t")):
            with profiling.annotate("span", 3):
                torch.ones(8) @ torch.ones(8)
    (path,) = os.listdir(tmp_path / "t")
    assert "deepsolid.span" in {e.get("name") for e in _events(tmp_path / "t" / path)}
    assert "Profiler trace written" in caplog.text


def test_annotate_enters_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording, a span is the shared no-op context:
    record_function, made to raise here, is never entered; under a
    profiler it is."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.annotate("iteration", 7):
        torch.ones(2).sum()
    assert profiling.annotate("a") is profiling.annotate("b", 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function entered"):
            profiling.annotate("iteration", 7)


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
    # the traced iteration's span and its phases'
    assert {f"deepsolid.{phase}" for phase in (
        "iteration", "mcmc", "local_energy", "gradient", "stats", "el.chunk",
        "el.trunk", "el.orbitals", "el.det_head")} <= names


def _spans(path):
    """{name without `deepsolid.`: [(start, end)]} of the complete spans."""
    out = {}
    for e in _events(path):
        name = e.get("name") or ""
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and name.startswith("deepsolid.")
                and e.get("args", {}).get("finished", True)):
            out.setdefault(name[len("deepsolid."):], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    return out


def _inside(spans, name, outer):
    lo, hi = outer
    return [s for s in spans.get(name, []) if lo <= s[0] and s[1] <= hi]


def test_process_spans_nest_layer_in_layer(tmp_path):
    """A CPU profile of two KFAC iterations of the forward engine: two
    iteration spans, batch / el_chunk el.chunk spans in each local_energy,
    the trunk, the orbital head and the determinant head in every
    el.chunk, mcmc.steps moves (each with its value path and acceptance)
    in each mcmc, and the KFAC stages in each iteration."""
    batch, el_chunk, steps = 4, 2, 3
    _, _, params, x = seed_state(n_walkers=batch, seed=2)
    write_start(tmp_path / "run", params, x)
    cfg = torch_cfg(tmp_path / "run", optimizer="kfac", iterations=2, batch=batch,
                    el_chunk=el_chunk)
    cfg.mcmc.steps = steps
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tprocess.process(cfg, device="cpu")
    prof.export_chrome_trace(str(path))
    spans = _spans(path)
    assert len(spans["iteration"]) == 2
    for it in spans["iteration"]:
        (mcmc,) = _inside(spans, "mcmc", it)
        moves = _inside(spans, "mcmc.move", mcmc)
        assert len(moves) == steps
        for move in moves:
            assert len(_inside(spans, "mcmc.logpsi", move)) == 1
            assert len(_inside(spans, "mcmc.accept", move)) == 1
        (energy,) = _inside(spans, "local_energy", it)
        chunks = _inside(spans, "el.chunk", energy)
        assert len(chunks) == batch // el_chunk
        for chunk in chunks:
            assert _inside(spans, "el.kinetic", chunk) and _inside(spans, "el.ewald", chunk)
            assert len(_inside(spans, "el.trunk", chunk)) == 1
            # one orbital head a spin channel; one det head each and the sum
            assert len(_inside(spans, "el.orbitals", chunk)) == 2
            assert len(_inside(spans, "el.det_head", chunk)) == 3
        assert len(_inside(spans, "gradient", it)) == 1
        for stage in ("kfac.curvature", "kfac.capture", "kfac.update", "kfac.inverse",
                      "stats"):
            assert len(_inside(spans, stage, it)) == 1, stage
    assert "checkpoint" in spans  # the run's last iteration saves


def test_trace_keys_are_accepted_and_ndim_must_be_three(tmp_path):
    cfg = tconfig.default()
    assert (cfg.log.trace_path, cfg.log.trace_start, cfg.log.trace_steps) == ("", 10, 5)
    assert cfg.system.ndim == 3
    assert cfg.optim.laplacian_mode == "partition" and cfg.optim.partition_number == 3
    cfg = torch_cfg(tmp_path, iterations=1)
    cfg.system.ndim = 2
    with pytest.raises(ValueError, match="ndim"):
        tprocess.process(cfg, device="cpu")
