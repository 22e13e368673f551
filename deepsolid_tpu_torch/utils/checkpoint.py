"""Checkpoint save, lookup and restore (npz with pickled trees).

Mirrors deepsolid_tpu/utils/checkpoint.py, numpy only and in the same
file layout, so either package restores the other's checkpoints. Walker
data is one global (batch, 3N) array; a restore onto another batch size
tiles or truncates it (elastic resize).
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import zipfile
from typing import Optional

import numpy as np


def find_last_checkpoint(ckpt_path: Optional[str] = None) -> Optional[str]:
    """Most recent readable checkpoint in a directory (skips corrupt files)."""
    if ckpt_path and os.path.exists(ckpt_path):
        files = [f for f in os.listdir(ckpt_path) if "qmcjax_ckpt_" in f]
        for f in sorted(files, reverse=True):
            fname = os.path.join(ckpt_path, f)
            try:
                with open(fname, "rb") as fh:
                    np.load(fh, allow_pickle=True)
                return fname
            except (OSError, EOFError, ValueError, zipfile.BadZipFile,
                    pickle.UnpicklingError):
                continue
    return None


def create_save_path(save_path: Optional[str]) -> str:
    if not save_path:
        timestamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        save_path = os.path.join(os.getcwd(), f"deepsolid_tpu_torch_{timestamp}")
    os.makedirs(save_path, exist_ok=True)
    return save_path


def _as_object_scalar(tree):
    """A tree of numpy arrays in a 0-d object array, so np.savez pickles
    it whole (tuples of named tuples do not coerce to arrays)."""
    out = np.empty((), dtype=object)
    out[()] = tree
    return out


def save(save_path: str, t: int, data, params, opt_state, mcmc_width) -> str:
    """Write qmcjax_ckpt_{t}.npz. `data` is the global walker batch;
    `params` and `opt_state` are trees with numpy leaves."""
    ckpt = os.path.join(save_path, f"qmcjax_ckpt_{t:06d}.npz")
    with open(ckpt, "wb") as f:
        np.savez(
            f,
            t=t,
            data=np.asarray(data),
            params=_as_object_scalar(params),
            opt_state=_as_object_scalar(opt_state),
            mcmc_width=np.asarray(mcmc_width) if mcmc_width is not None else None,
        )
    return ckpt


def restore(restore_filename: str, batch_size: Optional[int] = None):
    """Returns (t, data, params, opt_state, mcmc_width), all numpy.

    The file is unpickled: restore only checkpoints this program (or the
    JAX package) wrote.
    """
    with open(restore_filename, "rb") as f:
        ckpt = np.load(f, allow_pickle=True)
        t = ckpt["t"].tolist() + 1  # iterations completed
        data = ckpt["data"]
        if data.ndim > 2:  # tolerate per-device-stacked layouts
            data = data.reshape(-1, data.shape[-1])
        params = ckpt["params"].tolist()
        opt_state = ckpt["opt_state"].tolist()
        mcmc_width = ckpt["mcmc_width"].tolist()
    if batch_size and data.shape[0] != batch_size:
        # elastic resize: tile (or truncate) the walker axis; tiled copies
        # beyond the first are jittered so no walker is duplicated exactly
        n = data.shape[0]
        if batch_size > n:
            logging.warning(
                "Elastic restore: growing the walker batch %d -> %d by "
                "jittered tiling; statistics are correlated until the "
                "chain re-equilibrates.", n, batch_size,
            )
        reps = -(-batch_size // n)
        tiled = np.tile(data, (reps, 1))[:batch_size]
        if batch_size > n:
            width = mcmc_width if np.ndim(mcmc_width) == 0 else None
            sigma = 0.3 * float(width) if width else 1e-2
            rng = np.random.default_rng(t)
            tiled[n:] = tiled[n:] + sigma * rng.standard_normal(
                tiled[n:].shape
            ).astype(tiled.dtype)
        data = tiled
    return t, data, params, opt_state, mcmc_width
