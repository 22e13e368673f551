"""The port's metric writers against the JAX package's
(deepsolid_tpu/utils/writers.py): the same rows through both give equal
files."""

import os

import numpy as np
import pytest

from deepsolid_tpu.utils import writers as jwriters
from deepsolid_tpu_torch.utils import writers as twriters

SCHEMA = {"energy": (), "sk": (4,), "density": (2, 3)}


def _rows(seed):
    rng = np.random.default_rng(seed)
    return [(t, {"energy": rng.normal(), "sk": rng.normal(size=4),
                 "density": rng.normal(size=(2, 3)).astype(np.float32)})
            for t in (0, 5, 10)]


def test_h5_writer_matches_jax(tmp_path):
    """Two sessions appending to one file (a restart), through each
    package's H5Writer: equal datasets, the index included."""
    h5py = pytest.importorskip("h5py")
    for name, module in (("jax", jwriters), ("torch", twriters)):
        for seed in (0, 1):
            with module.H5Writer("stats.h5", SCHEMA, directory=str(tmp_path / name)) as w:
                for t, data in _rows(seed):
                    w.write(t, data)
    with h5py.File(tmp_path / "jax" / "stats.h5") as want, \
            h5py.File(tmp_path / "torch" / "stats.h5") as got:
        assert sorted(got) == sorted(want) == sorted(["t", *SCHEMA])
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key][()], want[key][()])
        np.testing.assert_array_equal(got["t"][()], [0, 5, 10, 0, 5, 10])


def test_csv_writer_matches_jax(tmp_path):
    for name, module in (("jax", jwriters), ("torch", twriters)):
        for seed in (0, 1):
            with module.Writer("train_stats", ["energy", "pmove"],
                               directory=str(tmp_path / name)) as w:
                for t, data in _rows(seed):
                    w.write(t, energy=data["energy"], pmove=data["sk"][0])
    files = [open(os.path.join(tmp_path, name, "train_stats.csv")).read()
             for name in ("jax", "torch")]
    assert files[0] == files[1] and len(files[0].splitlines()) == 7
