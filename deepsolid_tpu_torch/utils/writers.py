"""Schema'd CSV writer (mirrors deepsolid_tpu/utils/writers.py, CSV only).

Appends with a header written on create, so restarts keep one file.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence


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
