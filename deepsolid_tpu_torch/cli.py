"""Console entry point (mirrors deepsolid_tpu/cli.py).

Usage:
  deepsolid-tpu-torch --config=path/to/config.py:ARGS [--config.key value ...]
                      [--device cuda|cpu]
  python -m deepsolid_tpu_torch --config=...

The interface of the JAX package's absl/ml_collections entry point, on
argparse and this package's ConfigDict: the config file is loaded by
path and its `get_config(ARGS)` called (`get_config()` when no ':ARGS'
is given); each `--config.a.b value` (or `--config.a.b=value`) then
replaces cfg.a.b, in the order given, coerced to the type of the value
it replaces as ml_collections.config_flags does (tuples and lists
through ast.literal_eval, booleans from true/false). A key the config
does not hold raises. `--device` defaults to 'cuda'.

Ranks, as the JAX command line's mesh over `jax.devices()`:
  - under a launcher (`torchrun --nproc-per-node=N -m deepsolid_tpu_torch
    ...`, on one host or with `--nnodes` on several) each process is one
    rank of the launcher's world, SPMD;
  - launched plainly with `--device cuda` on a host with more than one
    visible card (CUDA_VISIBLE_DEVICES narrows them), it starts one rank
    per card itself (parallel.run_ranks; NCCL);
  - otherwise (one card, `--device cpu` or a numbered card) it runs in
    this process.
Only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import logging
import os
import sys
from typing import Sequence

from deepsolid_tpu_torch.config import ConfigDict

_PREFIX = "--config."


def load_config(spec: str) -> ConfigDict:
    """The ConfigDict of 'path/to/config.py[:ARGS]'."""
    path, _, args = spec.partition(":")
    name = "deepsolid_tpu_torch_config_" + os.path.splitext(os.path.basename(path))[0]
    module_spec = importlib.util.spec_from_file_location(name, path)
    if module_spec is None:
        raise FileNotFoundError(f"no config file {path!r}")
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.get_config(args) if args else module.get_config()


def _parse_bool(text: str) -> bool:
    if text.lower() in ("true", "1"):
        return True
    if text.lower() in ("false", "0"):
        return False
    raise ValueError(f"not a boolean: {text!r}")


def coerce(text: str, current, key: str):
    """`text` as a value of `current`'s type."""
    if isinstance(current, dict):
        raise ValueError(f"--config.{key} is a section, not a value")
    if isinstance(current, bool):
        return _parse_bool(text)
    if isinstance(current, (int, float, str)):
        return type(current)(text)
    if current is None or isinstance(current, (tuple, list)):
        value = ast.literal_eval(text)
        if isinstance(current, (tuple, list)):
            if not isinstance(value, (tuple, list)):
                raise ValueError(f"--config.{key} takes a tuple, got {text!r}")
            value = type(current)(value)
        return value
    raise ValueError(f"--config.{key} holds a {type(current).__name__}, which "
                     "cannot be set from the command line")


def override(cfg: ConfigDict, key: str, text: str) -> None:
    """cfg.<key> = `text` coerced; an unknown key raises AttributeError."""
    *sections, last = key.split(".")
    node = cfg
    for name in sections:
        node = getattr(node, name)
    setattr(node, last, coerce(text, getattr(node, last), key))


def _overrides(rest: Sequence[str]):
    """(key, text) pairs of the `--config.a.b value` arguments."""
    out, i = [], 0
    while i < len(rest):
        arg = rest[i]
        if not arg.startswith(_PREFIX):
            raise SystemExit(f"unrecognized argument {arg!r}")
        key, eq, text = arg[len(_PREFIX):].partition("=")
        if not eq:
            if i + 1 >= len(rest):
                raise SystemExit(f"{arg} needs a value")
            i += 1
            text = rest[i]
        out.append((key, text))
        i += 1
    return out


def parse(argv: Sequence[str]):
    """(cfg, device) of a command line (without the program name)."""
    parser = argparse.ArgumentParser(prog="deepsolid-tpu-torch",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True,
                        help="path/to/config.py[:ARGS]; then --config.a.b value ...")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args, rest = parser.parse_known_args(argv)
    cfg = load_config(args.config)
    for key, text in _overrides(rest):
        override(cfg, key, text)
    return cfg, args.device


def _rank(rank: int, world_size: int, argv: Sequence[str]) -> None:
    """One rank the command line started: the same run as every other."""
    from deepsolid_tpu_torch.train import process

    logging.basicConfig(level=logging.INFO)
    cfg, device = parse(argv)
    process.process(cfg, device=device)


def main(argv: Sequence[str] | None = None) -> None:
    import torch
    import torch.distributed as dist

    from deepsolid_tpu_torch import parallel
    from deepsolid_tpu_torch.parallel import distributed
    from deepsolid_tpu_torch.train import process

    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg, device = parse(argv)
    distributed.initialize(device=device)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if not dist.is_initialized() and cards > 1:
        logging.info("One rank per card: %d ranks", cards)
        parallel.run_ranks(_rank, cards, (argv,),
                           backend=distributed.choose_backend("cuda", cards, cards),
                           timeout=None)
        return
    logging.info("System config:\n%s", cfg)
    try:
        process.process(cfg, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
