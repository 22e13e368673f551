"""Metric writers: schema'd CSV, and HDF5 where h5py is installed
(mirrors deepsolid_tpu/utils/writers.py).

Both append, the CSV with a header written on create, so restarts keep
one file.
"""

from __future__ import annotations

import contextlib
import os
from typing import Mapping, Optional, Sequence

import numpy as np


class Writer(contextlib.AbstractContextManager):
    """CSV writer with a fixed schema."""

    def __init__(self, name: str, schema: Sequence[str], directory: str = "logs",
                 iteration_key: Optional[str] = "t"):
        self._schema = list(schema)
        os.makedirs(directory, exist_ok=True)
        self._filename = os.path.join(directory, f"{name}.csv")
        self._iteration_key = iteration_key
        self._file = None

    def __enter__(self):
        exists = os.path.exists(self._filename) and os.path.getsize(self._filename) > 0
        self._file = open(self._filename, "a", encoding="utf-8")
        if not exists:
            if self._iteration_key:
                self._file.write(f"{self._iteration_key},")
            self._file.write(",".join(self._schema) + "\n")
        return self

    def write(self, t: int, **data):
        row = [str(data.pop(key, "")) for key in self._schema]
        if data:
            raise ValueError(f"Unexpected keys: {list(data)}")
        if self._iteration_key:
            row.insert(0, str(t))
        self._file.write(",".join(row) + "\n")
        self._file.flush()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._file is not None:
            self._file.close()
            self._file = None
        return False


class H5Writer(contextlib.AbstractContextManager):
    """Appends fixed-shape arrays, one row per `write`, to an HDF5 file:
    `schema` maps each dataset's name to the shape of one row, and the
    dataset `index_key` holds each row's t. h5py is an optional
    dependency, imported at construction."""

    def __init__(self, name: str, schema: Mapping[str, Sequence[int]],
                 directory: str = "logs", index_key: str = "t",
                 compression_level: int = 5):
        import h5py

        self._h5py = h5py
        os.makedirs(directory, exist_ok=True)
        self._filename = os.path.join(directory, name)
        self._schema = schema
        self._index_key = index_key
        self._complevel = compression_level
        self._file = None

    def __enter__(self):
        self._file = self._h5py.File(self._filename, "a")
        if self._index_key not in self._file:
            self._file.create_dataset(self._index_key, shape=(0,), maxshape=(None,),
                                      dtype="i8")
        for key, shape in self._schema.items():
            if key not in self._file:
                self._file.create_dataset(
                    key, shape=(0, *shape), maxshape=(None, *shape),
                    compression="gzip", compression_opts=self._complevel)
        return self

    def write(self, t: int, data: Mapping):
        index = self._file[self._index_key]
        n = index.shape[0]
        index.resize((n + 1,))
        index[n] = t
        for key, value in data.items():
            dataset = self._file[key]
            dataset.resize((n + 1, *dataset.shape[1:]))
            dataset[n] = np.asarray(value)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._file is not None:
            self._file.close()
            self._file = None
        return False
