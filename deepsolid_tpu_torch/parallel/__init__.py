"""Ranks and the (data, deriv) mesh (mesh.py), and joining a world of
ranks on one host or several (distributed.py)."""

from deepsolid_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    TangentShard,
    _rank_main,
    _reduce_sum,
    make_mesh,
    run_ranks,
)
