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
                # 'adam' and 'none' (inference: MCMC + local energy, no
                # update) are ported; 'kfac' is the next slice
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
                "ministeps": 1,
                "laplacian_mode": "forward",  # the port's only engine
                # walkers per local-energy sweep (0 = whole batch at once)
                "el_chunk": 0,
                # walkers per sweep of the log psi gradient and of the
                # sampler's log|psi| evaluations (0 = whole batch)
                "psi_chunk": 0,
            },
            "log": {
                "stats_frequency": 1,
                "save_frequency": 10.0,  # minutes
                "save_frequency_in_step": -1,
                "save_path": "",
                "restore_path": "",
                "stats_file_name": "train_stats",
            },
            "system": {
                "cell": None,  # deepsolid_tpu_torch.system.Supercell
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
                "deterministic": False,
            },
        }
    )
