"""Periodic complex FermiNet-style wavefunction for solids.

Mirrors deepsolid_tpu/models/network.py (value path, its derivatives
with respect to the parameters and the electrons, and the KFAC tap hooks
of the dense layers and of the full envelope):
  periodic nu/tri input features -> two-stream permutation-equivariant MLP
  -> per-spin complex orbital heads -> multiplicative envelopes -> Bloch
  phase factors e^{i k.r} from the occupied k-list -> log-sum-exp over
  determinants.

Every function takes a walker batch x of shape (B, 3N). Parameters are
the JAX package's tree (dicts and lists) with torch tensors as leaves;
`params_from_jax` converts a numpy tree such as a checkpoint's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepsolid_tpu_torch.device import constant
from deepsolid_tpu_torch.models import envelopes as envelopes_lib
from deepsolid_tpu_torch.models import features as features_lib
from deepsolid_tpu_torch.ops.slogdet import logdet_matmul
from deepsolid_tpu_torch.system.cell import Supercell
from deepsolid_tpu_torch.utils.tree import tree_map

ParamTree = Any


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Architecture hyperparameters (same fields as the JAX package's)."""

    hidden_dims: Tuple[Tuple[int, int], ...] = ((256, 32), (256, 32), (256, 32))
    determinants: int = 8
    envelope_type: str = "isotropic"
    bias_orbitals: bool = False
    use_last_layer: bool = False
    full_det: bool = False
    distance_type: str = "nu"

    def __post_init__(self):
        hd = tuple(tuple(h) for h in self.hidden_dims)
        object.__setattr__(self, "hidden_dims", hd)
        if self.distance_type == "tri" and self.envelope_type != "isotropic":
            raise ValueError(
                "tri features provide 6-dim relative coords; only the "
                "isotropic envelope is defined for them"
            )


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Static (host/numpy) system geometry closed over by the network."""

    atoms: np.ndarray  # (natom, 3) primitive-cell atom positions
    spins: Tuple[int, int]  # (nalpha, nbeta) in the simulation cell
    prim_lattice: np.ndarray
    prim_av: np.ndarray
    prim_bv: np.ndarray
    sim_lattice: np.ndarray
    sim_av: np.ndarray
    sim_bv: np.ndarray
    klist: Tuple[np.ndarray, ...]  # occupied k-vectors per spin channel

    @classmethod
    def from_supercell(cls, sc: Supercell, klist: Sequence[np.ndarray]) -> "SystemSpec":
        prim = sc.prim
        return cls(
            atoms=np.asarray(prim.atom_coords),
            spins=tuple(sc.nelec),
            prim_lattice=prim.lattice,
            prim_av=prim.AV,
            prim_bv=prim.BV,
            sim_lattice=sc.lattice,
            sim_av=sc.AV,
            sim_bv=sc.BV,
            klist=tuple(np.asarray(k) for k in klist),
        )

    @property
    def nelectron(self) -> int:
        return sum(self.spins)

    @property
    def active_spins(self) -> Tuple[int, ...]:
        return tuple(s for s in self.spins if s > 0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(rng: np.random.Generator, spec: SystemSpec,
                cfg: NetworkConfig) -> ParamTree:
    """Random initialization with the JAX package's scales, as a numpy
    tree (JAX and numpy draw different numbers from the same seed)."""
    natom = spec.atoms.shape[0]
    in_one, in_two = features_lib.input_feature_dims(natom, cfg.distance_type)
    spins = spec.spins
    active = spec.active_spins
    nch = len(active)

    dims_one_in = [(nch + 1) * in_one + nch * in_two] + [
        (nch + 1) * h[0] + nch * h[1] for h in cfg.hidden_dims
    ]
    if not cfg.use_last_layer:
        dims_one_in[-1] = cfg.hidden_dims[-1][0]
    dims_one_out = [h[0] for h in cfg.hidden_dims]
    dims_two = [in_two] + [h[1] for h in cfg.hidden_dims]
    len_double = (
        len(cfg.hidden_dims) if cfg.use_last_layer else len(cfg.hidden_dims) - 1
    )

    def layer(d_in, d_out, bias=True):
        p = {"w": rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)}
        if bias:
            p["b"] = rng.standard_normal((d_out,))
        return p

    params = {"single": [], "double": [], "orbital": [], "envelope": []}
    for i in range(len(cfg.hidden_dims)):
        params["single"].append(layer(dims_one_in[i], dims_one_out[i]))
        if i < len_double:
            params["double"].append(layer(dims_two[i], dims_two[i + 1]))
    for spin in active:
        nparam = (sum(spins) if cfg.full_det else spin) * cfg.determinants
        params["orbital"].append(
            layer(dims_one_in[-1], 2 * nparam, bias=cfg.bias_orbitals))
        params["envelope"].append(
            envelopes_lib.init_envelope_params(natom, nparam, cfg.envelope_type))
    return params


def params_from_jax(tree, device="cpu", dtype=torch.float32) -> ParamTree:
    """The JAX package's parameter tree (numpy arrays in dicts and lists,
    as init_params or a checkpoint gives them) as torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def params_to_numpy(tree) -> ParamTree:
    """The inverse of params_from_jax: torch leaves as numpy arrays, for
    a checkpoint or for handing parameters to the JAX package."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def param_shapes(tree) -> ParamTree:
    """The tree with each leaf replaced by its shape (for restore checks)."""
    if isinstance(tree, dict):
        return {k: param_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [param_shapes(v) for v in tree]
    return tuple(np.shape(tree))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, layer_params: Dict[str, torch.Tensor],
          name: Optional[str] = None,
          eps: Optional[Dict[str, torch.Tensor]] = None,
          taps: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """A named dense layer with KFAC tap and perturbation hooks.

    y = x @ w (+ b) (+ eps[name]); records taps[name] = x when capturing.
    x, eps[name] and the tap carry the walker axis in front.
    """
    y = x @ layer_params["w"]
    if "b" in layer_params:
        y = y + layer_params["b"]
    if eps is not None and name in eps:
        y = y + eps[name]
    if taps is not None:
        taps[name] = x
    return y


def _channels(spins):
    channels = [(0, spins[0]), (spins[0], spins[0] + spins[1])]
    return [(lo, hi) for lo, hi in channels if hi > lo]


def construct_symmetric_features(
    h_one: torch.Tensor, h_two: torch.Tensor, spins: Tuple[int, int]
) -> torch.Tensor:
    """Permutation-equivariant mixing of one- and two-electron streams.

    h_one (B, n, f1), h_two (B, n, n, f2). Row i of the output is
    [h_one[i], per-channel means of h_one, per-channel means over j of
    h_two[j, i]].
    """
    channels = _channels(spins)
    chan_one = [torch.mean(h_one[:, lo:hi], dim=1, keepdim=True).expand_as(h_one)
                for lo, hi in channels]
    chan_two = [torch.mean(h_two[:, lo:hi], dim=1) for lo, hi in channels]
    return torch.cat([h_one, *chan_one, *chan_two], dim=-1)


def eval_phases(x: torch.Tensor, klist, spins: Tuple[int, int],
                full_det: bool) -> List[torch.Tensor]:
    """Bloch phase factors e^{i k.r} per active spin channel, (B, n_s, norb)."""
    pos = x.reshape(x.shape[0], -1, 3)
    ks = [constant(k, x) for k in klist]
    out = []
    for ch, (lo, hi) in enumerate([(0, spins[0]), (spins[0], sum(spins))]):
        if hi == lo:
            continue
        k = torch.cat(ks, dim=0) if full_det else ks[ch]
        out.append(torch.exp(1j * (pos[:, lo:hi] @ k.T)))
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def orbital_matrices(params: ParamTree, x: torch.Tensor, spec: SystemSpec,
                     cfg: NetworkConfig,
                     eps: Optional[Dict[str, torch.Tensor]] = None,
                     taps: Optional[Dict[str, torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
    """Orbital matrices with envelopes and Bloch phases applied.

    One (B, ndet, n, n) matrix when full_det, else one (B, ndet, n_s,
    n_s) per active spin channel.
    """
    spins = spec.spins
    ae_rel, ee_rel, r_ae, r_ee = features_lib.periodic_input_features(
        x,
        spec.atoms,
        prim_lattice=spec.prim_lattice,
        prim_av=spec.prim_av,
        prim_bv=spec.prim_bv,
        sim_lattice=spec.sim_lattice,
        sim_av=spec.sim_av,
        sim_bv=spec.sim_bv,
        distance_type=cfg.distance_type,
    )
    batch, n = r_ae.shape[:2]
    h_one = torch.cat([r_ae, ae_rel], dim=-1).reshape(batch, n, -1)
    h_two = torch.cat([r_ee, ee_rel], dim=-1)
    to_env = r_ae if cfg.envelope_type == "isotropic" else ae_rel
    envelope_fn = envelopes_lib.ENVELOPES[cfg.envelope_type]

    def residual(old, new):
        return (old + new) / np.sqrt(2.0) if old.shape == new.shape else new

    n_double = len(params["double"])
    for i in range(n_double):
        h_one_in = construct_symmetric_features(h_one, h_two, spins)
        h_one_next = torch.tanh(
            dense(h_one_in, params["single"][i], f"single_{i}", eps, taps))
        h_two_next = torch.tanh(
            dense(h_two, params["double"][i], f"double_{i}", eps, taps))
        h_one = residual(h_one, h_one_next)
        h_two = residual(h_two, h_two_next)

    if n_double != len(params["single"]):
        h_one_in = construct_symmetric_features(h_one, h_two, spins)
        i = len(params["single"]) - 1
        h_one_next = torch.tanh(
            dense(h_one_in, params["single"][i], f"single_{i}", eps, taps))
        h_to_orbitals = residual(h_one, h_one_next)
    else:
        h_to_orbitals = construct_symmetric_features(h_one, h_two, spins)

    orbitals = []
    for i, (lo, hi) in enumerate(_channels(spins)):
        spin = hi - lo
        raw = dense(h_to_orbitals[:, lo:hi], params["orbital"][i],
                    f"orbital_{i}", eps, taps)
        nparam = raw.shape[-1] // 2
        orb = torch.complex(raw[..., :nparam], raw[..., nparam:])
        if cfg.envelope_type == "full":
            env = envelope_fn(to_env[:, lo:hi], params["envelope"][i],
                              name=f"envelope_{i}", eps=eps, taps=taps)
        else:
            env = envelope_fn(to_env[:, lo:hi], params["envelope"][i])
        orb = env * orb
        norb = sum(spins) if cfg.full_det else spin
        orb = orb.reshape(batch, spin, cfg.determinants, norb).transpose(1, 2)
        orbitals.append(orb)

    phases = eval_phases(x, spec.klist, spins, cfg.full_det)
    orbitals = [o * p[:, None] for o, p in zip(orbitals, phases)]
    if cfg.full_det:
        orbitals = [torch.cat(orbitals, dim=2)]
    return orbitals


def apply_network(params: ParamTree, x: torch.Tensor, spec: SystemSpec,
                  cfg: NetworkConfig, method: str = "slogdet",
                  eps: Optional[Dict[str, torch.Tensor]] = None,
                  taps: Optional[Dict[str, torch.Tensor]] = None):
    """Evaluate the wavefunction head `method` on a walker batch.

      'slogdet'           -> log|psi| (B,)
      'logdet'            -> log psi (B,) complex
      'phase_and_slogdet' -> (psi/|psi|, log|psi|)
      'mats'              -> orbital matrices
    """
    orbitals = orbital_matrices(params, x, spec, cfg, eps=eps, taps=taps)
    if method == "mats":
        return orbitals
    phase, slog = logdet_matmul(orbitals)
    if method == "slogdet":
        return slog
    if method == "logdet":
        return torch.log(phase) + slog
    if method == "phase_and_slogdet":
        return phase, slog
    raise ValueError(f"Unknown method: {method}")


@dataclasses.dataclass(frozen=True)
class Network:
    """A system and architecture with batched heads."""

    spec: SystemSpec
    cfg: NetworkConfig

    def init(self, rng: np.random.Generator) -> ParamTree:
        return init_params(rng, self.spec, self.cfg)

    def slogdet(self, params, x):
        return apply_network(params, x, self.spec, self.cfg, "slogdet")

    def logdet(self, params, x):
        """Complex log psi (B,), differentiable with respect to params
        (the determinants' gradient runs through ops.slogdet)."""
        return apply_network(params, x, self.spec, self.cfg, "logdet")

    def phase_and_slogdet(self, params, x):
        return apply_network(params, x, self.spec, self.cfg, "phase_and_slogdet")

    def orbitals(self, params, x):
        return apply_network(params, x, self.spec, self.cfg, "mats")

    # KFAC hooks ---------------------------------------------------------------
    def logdet_with_taps(self, params, x, eps=None):
        """(log psi (B,), taps) for a walker batch, with the output
        perturbations eps[name] (walker axis in front) added to the named
        dense layers; taps[name] is that layer's input."""
        taps: Dict[str, torch.Tensor] = {}
        out = apply_network(params, x, self.spec, self.cfg, "logdet",
                            eps=eps, taps=taps)
        return out, taps

    def layer_registry(self, params) -> Dict[str, Dict[str, Any]]:
        """name -> {'path': tree path, 'has_bias': bool} of every dense
        layer, for KFAC's Kronecker blocks."""
        reg = {}
        for group in ("single", "double", "orbital"):
            for i, layer in enumerate(params[group]):
                reg[f"{group}_{i}"] = {"path": (group, i), "has_bias": "b" in layer}
        return reg

    def envelope_registry(self, params) -> Dict[str, Dict[str, Any]]:
        """name -> {'path': tree path} of the full envelope's sigma, which
        KFAC gives per-atom Kronecker blocks; empty for the other
        envelopes (their parameters take diagonal blocks)."""
        if self.cfg.envelope_type != "full":
            return {}
        return {f"envelope_{i}": {"path": ("envelope", i, "sigma")}
                for i in range(len(params["envelope"]))}


def make_network(supercell: Supercell, klist, cfg: NetworkConfig = None,
                 **cfg_kwargs) -> Network:
    """Build a `Network` for a simulation supercell and occupied k-list."""
    cfg = cfg or NetworkConfig(**cfg_kwargs)
    return Network(spec=SystemSpec.from_supercell(supercell, klist), cfg=cfg)
