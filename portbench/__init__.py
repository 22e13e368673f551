"""The benchmark of deepsolid_tpu_torch on one NVIDIA H100.

`run.py` runs one cell of BENCHMARK.json (a configuration under a traffic
mix) through deepsolid_tpu_torch.train.process.process on the card and
prints one JSON line. Everything it reads is found by name: configs/,
traffic/, limits/ and metrics/ hold one file per configuration, mix, cell
and metric. reference/ is the plain PyTorch reference that decides
`correct`; counts/ holds the peaks and the operation and byte counts.
Nothing here imports JAX or the JAX package.
"""
