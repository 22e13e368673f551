"""The plain reference of the production training step.

Plain PyTorch only, written from the published method (periodic FermiNet
of DeepSolid, forward Laplacian, Ewald sum, KFAC with pi-adjusted damping)
and imports nothing of deepsolid_tpu_torch: no kernel, no helper, no
weights or tables that the program made. It reads the configuration's
file and the raw checkpoint, and the program's sampled walkers as inputs.

  system.py    geometry, k-list, feature lattice vectors
  network.py   the wavefunction: orbitals, log psi, KFAC taps
  laplacian.py the local kinetic energy by a forward Laplacian of jets
  ewald.py     the periodic Coulomb energy
  step.py      energy, gradient and the KFAC update
"""
