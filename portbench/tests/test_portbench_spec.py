"""BENCHMARK.json against the contract's form, and every name it holds
found in a file of its own."""

import json
import re

import numpy as np
import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_texts(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for entry in BENCH[group]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert TEXT.match(entry[key]), (entry["name"], key)
        for key in entry.get("reduced", []):
            assert NAME.match(key)


def test_metrics_form():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert names == {"train_walkers_per_s", "peak_mem_gib", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "train_walkers_per_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.Cell(cell)
    assert c.chips == 1
    assert c.config["name"] == c.entry["config"]
    assert {m["name"] for m in c.end_to_end} >= {"train_walkers_per_s", "setup_s"}
    assert c.per_layer
    assert c.limits, f"limits/{cell}.json"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_every_config_is_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        conf = spec.load_json(spec.ROOT / c["file"])
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert set(conf["reduced"]) == set(conf["source_values"])


@pytest.mark.parametrize("name,config_fn", [
    ("c-diamond-2x2x2", ("diamond", "C,C,3.567,2,sto-3g")),
    ("bcc-li-3x3x3", ("read_poscar", "deepsolid_tpu_torch/configs/poscar/bcc_li.vasp,3,sto-3g")),
])
def test_config_geometry_is_the_sources(name, config_fn):
    """The configuration's solid is the one the port's own config of the
    source builds, and its k-list the port's free-electron choice."""
    import importlib

    from portbench.tests.tiny import free_electron_klist

    conf = spec.load_json(spec.ROOT / "portbench" / "configs" / f"{name}.json")
    module = importlib.import_module(f"deepsolid_tpu_torch.configs.{config_fn[0]}")
    arg = config_fn[1]
    if config_fn[0] == "read_poscar":
        arg = str(spec.ROOT / arg)
    sc = module.get_config(arg).system.cell
    np.testing.assert_allclose(sc.prim.lattice, conf["lattice_bohr"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(sc.prim.atom_coords,
                               [a["coords_bohr"] for a in conf["atoms"]], atol=1e-9)
    assert sc.S.tolist() == conf["supercell"]
    for got, want in zip(conf["klist"], free_electron_klist(conf)):
        np.testing.assert_allclose(got, want, atol=1e-12)
