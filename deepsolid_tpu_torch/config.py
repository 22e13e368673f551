"""Default run configuration, as plain nested dicts with attribute access.

Key names follow deepsolid_tpu/config.py so run scripts carry over; only
the keys this port reads are present. No ml_collections: `cfg.a.b` and
`cfg["a"]["b"]` both work, and `cfg.get(key, default)` is a dict's.
"""

from __future__ import annotations


class ConfigDict(dict):
    """A dict whose keys are also attributes; nested dicts convert."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for key, value in dict(*args, **kwargs).items():
            self[key] = value

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        super().__setitem__(key, value)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key, value):
        if key not in self:
            raise AttributeError(f"unknown config key {key!r}")
        self[key] = value


def default() -> ConfigDict:
    return ConfigDict(
        {
            "batch_size": 4096,
            "precision": "float32",  # 'float32' | 'float64'
            "optim": {
                "iterations": 1000000,
                # 'kfac' (production), 'adam', or 'none' (inference: MCMC +
                # local energy, no update)
                "optimizer": "kfac",
                "lr": {
                    "rate": 5.0e-2,
                    "decay": 1.0,
                    "delay": 10000.0,
                },
                "clip_el": 5.0,
                "clip_type": "real",  # 'real' | 'complex'
                "gradient_clip": 5.0,  # global-norm clip on adam grads; <=0 off
                "adam": {
                    "b1": 0.9,
                    "b2": 0.999,
                    "eps": 1.0e-8,
                    "eps_root": 0.0,
                },
                "kfac": {
                    "invert_every": 1,
                    "cov_update_every": 1,
                    "damping": 0.001,
                    "cov_ema_decay": 0.95,
                    "momentum": 0.0,
                    "min_damping": 1.0e-4,
                    "norm_constraint": 0.001,
                    "l2_reg": 0.0,
                    # Levenberg-Marquardt adaptive damping: every
                    # `damping_adaptation_interval` steps the loss is
                    # evaluated again on the same walkers after the update
                    # and compared with the quadratic model's prediction,
                    # rho = dl / (g.d + d.F.d/2 + damping |d|^2/2); damping
                    # shrinks by decay^interval when rho > 3/4 and grows
                    # when rho < 1/4
                    "adaptive_damping": False,
                    "damping_adaptation_interval": 5,
                    "damping_adaptation_decay": 0.9,
                    "max_damping": 1.0,
                    # 'fisher_exact' (two backward passes, on Re and Im of
                    # log psi) is the only estimation mode ported
                    "estimation_mode": "fisher_exact",
                },
                "ministeps": 1,
                # kinetic engine: 'partition' (the JAX package's default),
                # 'vmap', 'for', 'hessian' (ops/laplacian.py) or 'forward'
                # (the forward Laplacian, which the run scripts set)
                "laplacian_mode": "partition",
                # tangent chunks of the 'partition' engine; divides 3N
                "partition_number": 3,
                # walkers per local-energy sweep (0 = whole batch at once)
                "el_chunk": 0,
                # walkers per sweep of the log psi gradient, of KFAC's
                # curvature capture and of the sampler's log|psi|
                # evaluations (0 = whole batch)
                "psi_chunk": 0,
            },
            "log": {
                "stats_frequency": 1,
                "save_frequency": 10.0,  # minutes
                "save_frequency_in_step": -1,
                "save_path": "",
                "restore_path": "",
                "stats_file_name": "train_stats",
                # per-walker local energies (Re, Im interleaved) at
                # stats_frequency into local_energies.csv
                "local_energies": False,
                # <exp(i b . sum_i r_i)> as a train_stats column
                "complex_polarization": False,
                # S(k) on a 4^3 reciprocal mesh into structure_factor.csv,
                # every iteration
                "structure_factor": False,
                # non-empty: a torch.profiler trace (host and card) of
                # iterations [trace_start, trace_start + trace_steps) of
                # the run, written into this directory
                "trace_path": "",
                "trace_start": 10,
                "trace_steps": 5,
            },
            "system": {
                "cell": None,  # deepsolid_tpu_torch.system.Supercell
                "ndim": 3,  # three dimensions only
                "klist_policy": "auto",  # 'auto'|'uniform'|'fermi'|'explicit'
                "klist": None,  # used when klist_policy == 'explicit'
                "basis": "",
            },
            "mcmc": {
                "burn_in": 100,
                "steps": 20,
                "init_width": 0.8,
                "move_width": 0.02,
                "adapt_frequency": 100,
                # Langevin-drift proposals (value and gradient of log|psi|
                # per move, chunked by optim.psi_chunk)
                "importance_sampling": False,
                # one electron per move, nelec moves per step
                "one_electron": False,
            },
            "network": {
                "detnet": {
                    "envelope_type": "isotropic",
                    "bias_orbitals": False,
                    "use_last_layer": False,
                    "full_det": False,
                    "hidden_dims": ((256, 32), (256, 32), (256, 32)),
                    "determinants": 8,
                    "distance_type": "nu",
                },
                "twist": (0.0, 0.0, 0.0),
            },
            "parallel": {
                # ranks that share one walker batch and split the 3N
                # Laplacian tangent columns among them ('forward' mode
                # only); the remaining ranks form the data (walker) axis
                "deriv_devices": 1,
            },
            "debug": {
                # discard an iteration whose update leaves a non-finite
                # parameter or loss, and go on from the state before it
                "check_nan": False,
                "deterministic": False,
            },
            "pretrain": {
                "method": "net",  # 'net' | 'hf' | 'none'
                "iterations": 1000,
                "lr": 3e-4,
                "steps": 1,
                # orbital-source SCF level: 'core' (core-Hamiltonian
                # bands), 'hf' (self-consistent UHF, scf/hf.run_uhf), or
                # 'rhf' (restricted KRHF, closed shells)
                "scf": "core",
            },
        }
    )
