"""Multiplicative decay envelopes shaping orbitals around nuclei.

Mirrors deepsolid_tpu/models/envelopes.py. Inputs carry any leading
axes (walkers, electrons) before the atom axis.
"""

from __future__ import annotations

import numpy as np
import torch


def isotropic_envelope(r_ae: torch.Tensor, params) -> torch.Tensor:
    """out[..., p] = sum_a pi[a, p] * exp(-|sigma[a, p] * r[..., a]|).

    r_ae: (..., natom, 1) -> (..., nparam).
    """
    decay = torch.exp(-torch.abs(params["sigma"] * r_ae))
    return torch.einsum("...ap,ap->...p", decay, params["pi"])


def diagonal_envelope(ae: torch.Tensor, params) -> torch.Tensor:
    """Per-axis scaled decay; ae: (..., natom, 3) -> (..., nparam)."""
    r = torch.linalg.norm(ae[..., None] * params["sigma"], dim=-2)
    return torch.sum(torch.exp(-r) * params["pi"], dim=-2)


def full_envelope(ae: torch.Tensor, params, name=None, eps=None,
                  taps=None) -> torch.Tensor:
    """Anisotropic decay with a (3, 3) matrix per atom and orbital.

    sigma: (3, 3, natom, nparam); ae: (..., natom, 3) -> (..., nparam).
    `name` / `eps` / `taps` hook the bilinear sigma product into KFAC's
    capture as the dense layers' are: taps[name] records the input ae,
    eps[name] (..., 3, natom, nparam) is added to ae . sigma.
    """
    ae_sigma = torch.einsum("...ak,kmap->...map", ae, params["sigma"])
    if name is not None:
        if eps is not None and name in eps:
            ae_sigma = ae_sigma + eps[name]
        if taps is not None:
            taps[name] = ae
    r = torch.linalg.norm(ae_sigma, dim=-3)  # (..., natom, nparam)
    return torch.sum(torch.exp(-r) * params["pi"], dim=-2)


ENVELOPES = {
    "isotropic": isotropic_envelope,
    "diagonal": diagonal_envelope,
    "full": full_envelope,
}


def init_envelope_params(natom: int, nparam: int, envelope_type: str):
    """Numpy initial values (the same as the JAX package's)."""
    params = {"pi": np.ones((natom, nparam))}
    if envelope_type == "isotropic":
        params["sigma"] = np.ones((natom, nparam))
    elif envelope_type == "diagonal":
        params["sigma"] = np.ones((natom, 3, nparam))
    elif envelope_type == "full":
        params["sigma"] = np.tile(np.eye(3)[..., None, None], [1, 1, natom, nparam])
    else:
        raise ValueError(f"Unknown envelope type: {envelope_type}")
    return params
