"""Complex-aware KFAC natural-gradient optimizer.

Counterpart of deepsolid_tpu/optim/kfac.py, method for method and state
key for key. The VMC Fisher F = E[(d log psi*)(d log psi*)^T] is
approximated per dense layer as extra_scale * (A kron G) with
  A = E[x^T x] over (walkers x repeats)      (layer inputs, bias-augmented)
  G = Re E[dy^H dy]                          (complex output tangents),
per atom of the full envelope's sigma the same way (its bilinear map
ae . sigma, `env_blocks`), and per remaining parameter (the other
envelope parameters) as a diagonal. dy is the per-walker tangent of a
layer's output for a 1-D normal predictive distribution of variance 0.5.
`estimation_mode` 'fisher_exact' takes cotangent sqrt(2) per walker, once
on Re log psi and once on Im log psi; the Monte Carlo modes take one
backward pass seeded with sqrt(2) z per (walker, Re/Im), z ~ N(0, 1)
('fisher_gradients') or Rademacher ('fisher_curvature_prop'), whose
factor expectation is the exact mode's.

Layers are tapped by the network (models/network.py `dense`,
models/envelopes.py `full_envelope`): one forward on a walker chunk
records every layer's input and adds a zero `eps` to every layer's
output; the backward passes over that one graph give d/d eps (the
tangents, walker by walker) and the batch-summed gradients of the
diagonal parameters. The network is batched, so no vmap is needed. There
is no kernel of its own here: the reference's KFAC reaches no Pallas
kernel either (its products and Cholesky solves are plain XLA), so the
factor products are torch.matmul and the inverses torch.linalg's Cholesky.

What differs from the reference, and why:
  * the Monte Carlo draws come from a torch.Generator seeded from the
    optimizer step and the data rank (`mc_seed`), where JAX folds the step
    and the data axis into PRNGKey(230); each capture chunk takes the next
    draws of that generator. update_curvature(draws=...) takes them from
    the caller instead (the tests hand in JAX's);
  * the data axis is a process group, not a shard_map axis: `all_mean`
    (parallel.Mesh.all_mean) averages over the data ranks and `num_data`
    turns that mean into the sum the diagonal factor needs;
  * the step counter is read on the host to schedule the curvature update,
    the learning rate, the inverse refresh and the damping adaptation; every
    other scalar (damping, rho, the norm-constraint coefficient) stays a
    tensor on the device, and the zero-factor guard of the pi-adjusted
    inverse is a torch.where, so the update enqueues without waiting.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepsolid_tpu_torch.utils import profiling
from deepsolid_tpu_torch.utils.tree import tree_leaves, tree_map


def _identity(t):
    return t


def _tree_get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _leaf_paths(tree, prefix=()):
    """(path, leaf) of every leaf, dicts by key order, lists by index."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaf_paths(value, prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaf_paths(value, prefix + (i,))
    else:
        yield prefix, tree


_MC_MODES = ("fisher_gradients", "fisher_curvature_prop")
_ESTIMATION_MODES = ("fisher_exact",) + _MC_MODES
_MC_SEED = 230
_MC_RANK_STRIDE = 1000003  # folds the data rank into the step's seed


def mc_seed(step: int, data_index: int) -> int:
    """The Monte Carlo draws' seed of an optimizer step on a data rank."""
    return (_MC_SEED + step) * _MC_RANK_STRIDE + data_index


def _key_path(key: str):
    return tuple(int(p) if p.isdigit() else p for p in key.split("/"))


def _inner_product(a, b):
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# rows of a float32 factor's products taken to float64 at a time (256 MB):
# C-diamond's capture at 4096 walkers peaks at 54.16 GB so, and at 57.69 GB
# with every row taken to float64 at once (one H100)
_GRAM_CHUNK_BYTES = 1 << 28


def _gram(*xs: torch.Tensor) -> torch.Tensor:
    """sum_x x^T x over the rows of each (R, d) x, in x's dtype. float32
    rows are multiplied and summed in float64, a chunk of rows at a time:
    summed in float32 over Si 2x2x2's 114,688 rows (512 walkers x 224
    electrons) a one-electron layer's input factor read eigenvalues of
    -4e-6 of its trace, below the pi-adjusted damping of 6e-7, and its
    Cholesky failed."""
    dtype = xs[0].dtype
    if dtype == torch.float64:
        return sum(x.T @ x for x in xs)
    out = None
    for x in xs:
        for part in x.split(max(1, _GRAM_CHUNK_BYTES // (8 * x.shape[1]))):
            part = part.double()
            out = part.T @ part if out is None else out.addmm_(part.T, part)
    return out.to(dtype)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def psd_inv_cholesky(factor: torch.Tensor, damping) -> torch.Tensor:
    """inv(factor + damping * I) by a Cholesky solve, for (..., d, d)
    factors and a damping of their leading shape. A factor that is not
    positive definite gives non-finite entries, as in the reference, and
    no exception (cholesky_ex: no wait for the device)."""
    eye = torch.eye(factor.shape[-1], dtype=factor.dtype, device=factor.device)
    damping = torch.as_tensor(damping, dtype=factor.dtype, device=factor.device)
    chol, _ = torch.linalg.cholesky_ex(factor + damping[..., None, None] * eye)
    return torch.cholesky_solve(eye.expand_as(factor), chol)


def pi_adjusted_inverse(factor_0, factor_1, damping,
                        all_mean: Callable = _identity):
    """Pi-adjusted damped Kronecker inverse: each factor is normalized by
    its trace and damped by its share of `damping`. Factors whose traces
    multiply to zero (a layer that saw no curvature yet) give identity /
    sqrt(damping) for both. Leading axes of the factors are independent
    blocks (the full envelope's atoms)."""
    damping = torch.as_tensor(damping, dtype=factor_0.dtype, device=factor_0.device)
    norm_0 = all_mean(_trace(factor_0))
    norm_1 = all_mean(_trace(factor_1))
    scale = norm_0 * norm_1
    ok = scale > 0.0
    # the guarded branch is computed on harmless stand-ins and discarded
    one = torch.ones_like(scale)
    s, n0, n1 = (torch.where(ok, v, one) for v in (scale, norm_0, norm_1))
    dim_0, dim_1 = factor_0.shape[-1], factor_1.shape[-1]
    d0 = torch.sqrt(damping * dim_1 / (s * dim_0))
    inv0 = psd_inv_cholesky(factor_0 / n0[..., None, None], d0) / torch.sqrt(s)[..., None, None]
    d1 = torch.sqrt(damping * dim_0 / (s * dim_1))
    inv1 = psd_inv_cholesky(factor_1 / n1[..., None, None], d1) / torch.sqrt(s)[..., None, None]

    def guard(inv):
        eye = torch.eye(inv.shape[-1], dtype=inv.dtype, device=inv.device)
        return torch.where(ok[..., None, None], inv, eye / torch.sqrt(damping))

    return guard(inv0), guard(inv1)


class KfacOptimizer:
    """KFAC with Kronecker blocks for the dense layers and diagonal blocks
    for the rest. Hyperparameters are cfg.optim.kfac's (see `from_config`).

    The state is the reference's dict: 'step' (int32), 'velocities' (a tree
    like the parameters), 'blocks' {layer: a_raw, g_raw, weight, a_inv,
    g_inv, extra_scale}, 'env_blocks' {envelope_i: the same, per atom:
    a_* (natom, 3, 3), g_* (natom, 3 nparam, 3 nparam); empty unless the
    envelope is 'full'}, 'diag' {path: raw, weight}, 'damping' and 'rho'.
    `data_index` is this rank's index on the data axis (the Monte Carlo
    draws' seed).
    """

    def __init__(self, network, learning_rate_schedule: Callable,
                 damping: float = 1e-3, norm_constraint: Optional[float] = 1e-3,
                 cov_ema_decay: float = 0.95, invert_every: int = 1,
                 cov_update_every: int = 1, min_damping: float = 1e-4,
                 momentum: float = 0.0, l2_reg: float = 0.0,
                 adaptive_damping: bool = False,
                 damping_adaptation_interval: int = 5,
                 damping_adaptation_decay: float = 0.9,
                 max_damping: float = 1.0, capture_chunk: int = 0,
                 estimation_mode: str = "fisher_exact",
                 all_mean: Optional[Callable] = None, num_data: int = 1,
                 data_index: int = 0):
        if estimation_mode not in _ESTIMATION_MODES:
            raise ValueError(
                f"Unknown optim.kfac.estimation_mode={estimation_mode!r}; "
                f"one of {_ESTIMATION_MODES}")
        self.network = network
        self.learning_rate_schedule = learning_rate_schedule
        self.damping = damping
        self.norm_constraint = norm_constraint
        self.cov_ema_decay = cov_ema_decay
        self.invert_every = invert_every
        self.cov_update_every = cov_update_every
        self.min_damping = min_damping
        self.momentum = momentum
        self.l2_reg = l2_reg
        self.adaptive_damping = adaptive_damping
        self.damping_adaptation_interval = damping_adaptation_interval
        self.damping_adaptation_decay = damping_adaptation_decay
        self.max_damping = max_damping
        self.capture_chunk = capture_chunk
        self.estimation_mode = estimation_mode
        self.all_mean = all_mean or _identity
        self.num_data = num_data
        self.data_index = data_index

    @classmethod
    def from_config(cls, cfg, network, learning_rate_schedule: Callable,
                    mesh=None) -> "KfacOptimizer":
        """The optimizer cfg.optim.kfac describes; walkers are captured
        optim.psi_chunk at a time, and `mesh` (parallel.Mesh) names the
        data ranks the factors are averaged over."""
        k = cfg.optim.kfac
        return cls(
            network, learning_rate_schedule, damping=k.damping,
            norm_constraint=k.norm_constraint, cov_ema_decay=k.cov_ema_decay,
            invert_every=k.invert_every, cov_update_every=k.cov_update_every,
            min_damping=k.min_damping, momentum=k.momentum, l2_reg=k.l2_reg,
            adaptive_damping=k.get("adaptive_damping", False),
            damping_adaptation_interval=k.get("damping_adaptation_interval", 5),
            damping_adaptation_decay=k.get("damping_adaptation_decay", 0.9),
            max_damping=k.get("max_damping", 1.0),
            capture_chunk=cfg.optim.get("psi_chunk", 0),
            estimation_mode=k.get("estimation_mode", "fisher_exact"),
            all_mean=mesh.all_mean if mesh is not None else None,
            num_data=mesh.num_data if mesh is not None else 1,
            data_index=mesh.data_index if mesh is not None else 0)

    # ---------------- layout helpers -----------------------------------------
    def _registry(self, params):
        return self.network.layer_registry(params)

    def _env_registry(self, params):
        """The full envelope's sigma parameters, with per-atom Kronecker
        blocks (empty for the other envelopes)."""
        return self.network.envelope_registry(params)

    def _dense_paths(self, params):
        reg = self._registry(params)
        paths = set()
        for info in reg.values():
            paths.add(info["path"] + ("w",))
            if info["has_bias"]:
                paths.add(info["path"] + ("b",))
        for info in self._env_registry(params).values():
            paths.add(info["path"])
        return reg, paths

    def _diag_paths(self, params, dense_paths):
        """All leaf paths not covered by Kronecker blocks (the envelopes'
        other parameters)."""
        return [path for path, _ in _leaf_paths(params) if path not in dense_paths]

    def _tap_shapes(self, params):
        """(input, output) shapes of every tapped layer for one walker: the
        one-electron layers act on n rows, the two-electron layers on n x n
        pairs, the orbital heads and the full envelope on their spin
        channel's electrons (the envelope's input ae (n_s, natom, 3), its
        output ae . sigma (n_s, 3, natom, nparam))."""
        spec = self.network.spec
        n = spec.nelectron
        shapes = {}
        for name, info in self._registry(params).items():
            group, i = info["path"]
            lead = {"single": (n,), "double": (n, n)}.get(group) or (
                spec.active_spins[i],)
            w = _tree_get(params, info["path"])["w"]
            shapes[name] = (lead + (w.shape[0],), lead + (w.shape[1],))
        for name, info in self._env_registry(params).items():
            k, m, natom, npar = _tree_get(params, info["path"]).shape
            n_s = spec.active_spins[info["path"][1]]
            shapes[name] = ((n_s, natom, k), (n_s, m, natom, npar))
        return shapes

    # ---------------- state ---------------------------------------------------
    def init(self, params, data=None) -> Dict[str, Any]:
        """A fresh state for `params`. `data` is accepted as in the
        reference and not read: the tap shapes follow from the network."""
        leaf = tree_leaves(params)[0]
        dtype, device = leaf.dtype, leaf.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        reg, dense_paths = self._dense_paths(params)
        shapes = self._tap_shapes(params)
        blocks = {}
        for name, info in reg.items():
            w = _tree_get(params, info["path"])["w"]
            d_in = w.shape[0] + (1 if info["has_bias"] else 0)
            d_out = w.shape[1]
            # repeats = elements the layer is applied to per walker
            extra_scale = float(np.prod(shapes[name][0][:-1], dtype=np.float64)) or 1.0
            blocks[name] = {
                "a_raw": zeros(d_in, d_in), "g_raw": zeros(d_out, d_out),
                "weight": zeros(),
                "a_inv": zeros(d_in, d_in), "g_inv": zeros(d_out, d_out),
                "extra_scale": torch.tensor(extra_scale, dtype=dtype, device=device),
            }
        env_blocks = {}
        for name, info in self._env_registry(params).items():
            k, m, natom, npar = _tree_get(params, info["path"]).shape
            env_blocks[name] = {
                "a_raw": zeros(natom, k, k), "g_raw": zeros(natom, m * npar, m * npar),
                "weight": zeros(),
                "a_inv": zeros(natom, k, k), "g_inv": zeros(natom, m * npar, m * npar),
                # repeats = electrons the bilinear map is applied to
                "extra_scale": torch.tensor(float(shapes[name][0][0]), dtype=dtype,
                                            device=device),
            }
        diag = {}
        for path in self._diag_paths(params, dense_paths):
            diag["/".join(map(str, path))] = {
                "raw": torch.zeros_like(_tree_get(params, path)), "weight": zeros()}
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "velocities": tree_map(torch.zeros_like, params),
            "blocks": blocks,
            "env_blocks": env_blocks,
            "diag": diag,
            # dynamic damping and the last reduction ratio (adaptive
            # damping); with fixed damping they stay at these values
            "damping": torch.tensor(self.damping, dtype=dtype, device=device),
            "rho": zeros(),
        }

    # ---------------- curvature capture ---------------------------------------
    def _capture(self, params, data, draws=None):
        """(taps, dy, diag_grads) of a walker chunk: taps[name] the layer's
        input (B, ..., d_in), dy[name] = (dy_re, dy_im) the tangents of its
        output (B, ..., d_out) under cotangent sqrt(2) on Re and on Im of
        log psi, diag_grads[key] = (g_re, g_im) the same two gradients of
        each diagonal parameter, summed over the chunk's walkers.

        In a Monte Carlo mode `draws` (B, 2) are the chunk's z per (walker,
        Re/Im): one backward pass with cotangent sqrt(2) z gives the first
        of each pair, and the second is zero."""
        reg, dense_paths = self._dense_paths(params)
        shapes = self._tap_shapes(params)
        batch = data.shape[0]
        eps = {name: torch.zeros((batch,) + out_shape, dtype=data.dtype,
                                 device=data.device, requires_grad=True)
               for name, (_, out_shape) in shapes.items()}
        leaves = tree_map(lambda t: t.detach(), params)
        diag_params = {}
        for path in self._diag_paths(params, dense_paths):
            leaf = _tree_get(params, path).detach().requires_grad_(True)
            _tree_get(leaves, path[:-1])[path[-1]] = leaf
            diag_params["/".join(map(str, path))] = leaf
        names = list(eps)
        inputs = [eps[n] for n in names] + list(diag_params.values())
        cot = math.sqrt(2.0)
        with torch.enable_grad():
            out, taps = self.network.logdet_with_taps(leaves, data, eps=eps)
            if self.estimation_mode in _MC_MODES:
                z = draws.to(dtype=out.real.dtype, device=out.device)
                seed = cot * (z[:, 0] * out.real + z[:, 1] * out.imag)
                grads = (torch.autograd.grad(seed.sum(), inputs, allow_unused=True),
                         (None,) * len(inputs))
            else:
                # one forward graph, two backward passes over it
                grads = (torch.autograd.grad(cot * out.real.sum(), inputs,
                                             retain_graph=True, allow_unused=True),
                         torch.autograd.grad(cot * out.imag.sum(), inputs,
                                             allow_unused=True))
        pairs = [tuple(torch.zeros_like(x) if g is None else g for g in gs)
                 for x, *gs in zip(inputs, *grads)]
        dy = dict(zip(names, pairs[:len(names)]))
        diag_grads = dict(zip(diag_params, pairs[len(names):]))
        return {k: v.detach() for k, v in taps.items()}, dy, diag_grads

    def _factor_sums(self, params, data, draws=None):
        """Curvature factor SUMS over this walker chunk: (dense {name:
        (a_sum, g_sum)}, env {name: (a_sum, g_sum)} per atom, diag {key:
        (g_re_sum, g_im_sum)}). All add up over walkers, so chunked
        capture equals whole-batch capture."""
        taps, dy, diag_grads = self._capture(params, data, draws)
        dense = {}
        for name, info in self._registry(params).items():
            x = taps[name]
            x2 = x.reshape(-1, x.shape[-1])
            if info["has_bias"]:
                x2 = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=1)
            d_re, d_im = (d.reshape(-1, d.shape[-1]) for d in dy[name])
            dense[name] = (_gram(x2), _gram(d_re, d_im))
        env = {}
        for name in self._env_registry(params):
            x = taps[name]  # (B, n_s, natom, k)
            # (B, n_s, m, natom, np) -> (B, n_s, natom, m np)
            d_re, d_im = (d.permute(0, 1, 3, 2, 4).flatten(-2) for d in dy[name])
            env[name] = (torch.einsum("bnak,bnal->akl", x, x),
                         torch.einsum("bnak,bnal->akl", d_re, d_re)
                         + torch.einsum("bnak,bnal->akl", d_im, d_im))
        return dense, env, diag_grads

    def mc_draws(self, step: int, batch: int, device) -> torch.Tensor:
        """The Monte Carlo modes' z (batch, 2) of an optimizer step on this
        data rank: N(0, 1) ('fisher_gradients') or Rademacher
        ('fisher_curvature_prop'), in capture order (chunk after chunk)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(mc_seed(step, self.data_index))
        if self.estimation_mode == "fisher_curvature_prop":
            bits = torch.randint(0, 2, (batch, 2), generator=gen, device=device)
            return 2.0 * bits.double() - 1.0
        return torch.randn((batch, 2), generator=gen, device=device,
                           dtype=torch.float64)

    def update_curvature(self, state, params, data, draws=None):
        """EMA update of every curvature factor from this rank's walkers,
        `capture_chunk` of them at a time (each chunk's graph is freed
        before the next), averaged over the data ranks. A Monte Carlo mode
        takes `draws` (batch, 2), or this step's `mc_draws`."""
        ema_old = self.cov_ema_decay
        batch = data.shape[0]
        chunk = self.capture_chunk
        if self.estimation_mode in _MC_MODES and draws is None:
            draws = self.mc_draws(int(state["step"]), batch, data.device)
        if not (chunk and 0 < chunk < batch):
            chunk = batch
        if batch % chunk != 0:
            raise ValueError(
                f"kfac capture_chunk={chunk} must divide the per-rank "
                f"walker batch ({batch})")
        sums = None
        for i, part in enumerate(data.split(chunk)):
            part_draws = None if draws is None else draws[i * chunk:(i + 1) * chunk]
            with profiling.annotate("kfac.capture", i):
                part_sums = self._factor_sums(params, part, part_draws)
            sums = part_sums if sums is None else tree_map(torch.add, sums, part_sums)
        dense_s, env_s, diag_s = sums

        shapes = self._tap_shapes(params)
        blocks = dict(state["blocks"])
        for name, block in blocks.items():
            n_rep = batch * (int(np.prod(shapes[name][0][:-1], dtype=np.int64)) or 1)
            a_sum, g_sum = dense_s[name]
            blocks[name] = {
                **block,
                "a_raw": block["a_raw"] * ema_old + self.all_mean(a_sum / n_rep),
                "g_raw": block["g_raw"] * ema_old + self.all_mean(g_sum / n_rep),
                "weight": block["weight"] * ema_old + 1.0,
            }
        env_blocks = dict(state["env_blocks"])
        for name, block in env_blocks.items():
            n_rep = batch * shapes[name][0][0]
            a_sum, g_sum = env_s[name]
            env_blocks[name] = {
                **block,
                "a_raw": block["a_raw"] * ema_old + self.all_mean(a_sum / n_rep),
                "g_raw": block["g_raw"] * ema_old + self.all_mean(g_sum / n_rep),
                "weight": block["weight"] * ema_old + 1.0,
            }

        # the diagonal factor squares batch-SUMMED gradients, and squaring
        # is not linear: the sum is completed over the data ranks BEFORE
        # squaring, so that (sum over ranks g)^2 / B_global equals one
        # process's (sum g)^2 / B whatever the number of ranks
        global_batch = batch * self.num_data
        diag = dict(state["diag"])
        for key, entry in diag.items():
            g_re, g_im = (self.all_mean(g) * self.num_data for g in diag_s[key])
            diag[key] = {
                "raw": entry["raw"] * ema_old + (g_re**2 + g_im**2) / global_batch,
                "weight": entry["weight"] * ema_old + 1.0,
            }
        return {**state, "blocks": blocks, "env_blocks": env_blocks, "diag": diag}

    def refresh_inverses(self, state, damping):
        out = {}
        for key in ("blocks", "env_blocks"):  # env blocks: one per atom
            blocks = dict(state[key])
            for name, block in blocks.items():
                w = torch.clamp(block["weight"], min=1e-30)
                a_inv, g_inv = pi_adjusted_inverse(
                    block["a_raw"] / w, block["g_raw"] / w,
                    damping / block["extra_scale"], self.all_mean)
                blocks[name] = {**block, "a_inv": a_inv, "g_inv": g_inv}
            out[key] = blocks
        return {**state, **out}

    @staticmethod
    def _env_matrix(sigma):
        """(k, m, natom, np) -> per atom (natom, k, m np)."""
        k, m, natom, npar = sigma.shape
        return sigma.permute(2, 0, 1, 3).reshape(natom, k, m * npar)

    @staticmethod
    def _layer_matrix(tree, info):
        """A layer's weight (rows flattened) with its bias as a last row."""
        layer = _tree_get(tree, info["path"])
        mat = layer["w"].reshape(-1, layer["w"].shape[-1])
        if info["has_bias"]:
            mat = torch.cat([mat, layer["b"][None]], dim=0)
        return mat

    def precondition(self, state, params, grads, damping):
        """F^-1 g from the cached Kronecker inverses and the diagonals."""
        out = tree_map(lambda x: x, grads)  # new containers, same leaves
        for name, info in self._registry(params).items():
            block = state["blocks"][name]
            result = block["a_inv"] @ self._layer_matrix(grads, info) @ block["g_inv"]
            result = result / block["extra_scale"]
            node = _tree_get(out, info["path"])
            if info["has_bias"]:
                node["w"] = result[:-1].reshape(node["w"].shape)
                node["b"] = result[-1]
            else:
                node["w"] = result.reshape(node["w"].shape)
        for name, info in self._env_registry(params).items():
            block = state["env_blocks"][name]
            sig = _tree_get(grads, info["path"])
            k, m, natom, npar = sig.shape
            res = block["a_inv"] @ self._env_matrix(sig) @ block["g_inv"]
            res = res / block["extra_scale"]
            _tree_get(out, info["path"][:-1])[info["path"][-1]] = (
                res.reshape(natom, k, m, npar).permute(1, 2, 0, 3))
        for key, entry in state["diag"].items():
            path = _key_path(key)
            factor = entry["raw"] / torch.clamp(entry["weight"], min=1e-30)
            _tree_get(out, path[:-1])[path[-1]] = (
                _tree_get(grads, path) / (factor + damping))
        return out

    def fisher_quadratic(self, state, params, vec):
        """v^T F v under the block approximation F = extra_scale * (A kron
        G) + diagonals: the quadratic term of the Levenberg-Marquardt model
        that adaptive damping compares the loss change with."""
        total = torch.zeros((), dtype=tree_leaves(vec)[0].dtype,
                            device=tree_leaves(vec)[0].device)
        for name, info in self._registry(params).items():
            block = state["blocks"][name]
            w = torch.clamp(block["weight"], min=1e-30)
            v = self._layer_matrix(vec, info)
            total = total + (torch.sum(v * ((block["a_raw"] / w) @ v @ (block["g_raw"] / w)))
                             * block["extra_scale"])
        for name, info in self._env_registry(params).items():
            block = state["env_blocks"][name]
            w = torch.clamp(block["weight"], min=1e-30)
            v = self._env_matrix(_tree_get(vec, info["path"]))
            total = total + (torch.sum(v * ((block["a_raw"] / w) @ v @ (block["g_raw"] / w)))
                             * block["extra_scale"])
        for key, entry in state["diag"].items():
            w = torch.clamp(entry["weight"], min=1e-30)
            v = _tree_get(vec, _key_path(key))
            total = total + torch.sum((entry["raw"] / w) * v * v)
        return total

    # ---------------- the step -------------------------------------------------
    def step_fn(self, params, state, grads, damping):
        """One update from gradients already averaged over the data ranks."""
        leaf = tree_leaves(params)[0]
        damping = torch.clamp(
            torch.as_tensor(damping, dtype=leaf.dtype, device=leaf.device),
            min=self.min_damping)
        step = int(state["step"])  # the update's one host read
        lr = self.learning_rate_schedule(step)
        if step % self.invert_every == 0:
            with profiling.annotate("kfac.inverse"):
                state = self.refresh_inverses(state, damping)
        if self.l2_reg > 0.0:
            grads = tree_map(lambda g, p: g + self.l2_reg * p, grads, params)
        precond = self.precondition(state, params, grads, damping)
        if self.norm_constraint is not None:
            sq_norm = self.all_mean(_inner_product(precond, grads) * lr**2)
            coeff = torch.clamp(torch.sqrt(self.norm_constraint / sq_norm), max=1.0)
            precond = tree_map(lambda v: v * coeff, precond)
        delta = tree_map(lambda v, vel: -lr * v + self.momentum * vel,
                         precond, state["velocities"])
        params = tree_map(torch.add, params, delta)
        return params, {**state, "velocities": delta, "step": state["step"] + 1}

    def adapt_damping(self, state, old_params, params, grads, old_loss, new_loss):
        """Levenberg-Marquardt damping update (the rho rule):
        rho = (new_loss - old_loss) / (g.d + d.F.d/2 + damping |d|^2/2) on
        the SAME walkers before and after the update; damping shrinks by
        decay^interval when rho > 3/4 and grows by it when rho < 1/4."""
        delta = tree_map(torch.sub, params, old_params)
        damping = state["damping"]
        quad = (_inner_product(grads, delta)
                + 0.5 * self.fisher_quadratic(state, params, delta)
                + 0.5 * damping * _inner_product(delta, delta))
        rho = torch.where(quad < 0.0, (new_loss - old_loss) / quad,
                          -torch.ones_like(quad))
        omega = self.damping_adaptation_decay ** self.damping_adaptation_interval
        damping = torch.where(rho > 0.75, damping * omega,
                              torch.where(rho < 0.25, damping / omega, damping))
        damping = torch.clamp(damping, self.min_damping, self.max_damping)
        return {**state, "damping": damping, "rho": rho.to(damping.dtype)}

    def step(self, params, state, grads, data, loss=None, loss_fn=None,
             lap: Optional[Callable] = None):
        """The training step's optimizer part, after the sampler, the loss
        and the averaged gradient: the curvature update when due, the
        update, and, when due, the loss again on the same walkers with the
        new parameters for the damping adaptation. The state's own step
        counter schedules all three, so a restored state continues its
        schedule. `loss_fn(params, data)` returns (loss, aux); without it
        the damping is not adapted. `lap(name)`, when given, is called as
        each part ('curvature', 'update', 'adapt') has been enqueued, for
        the caller's clock. Returns (params, state)."""
        lap = lap or _identity
        t = int(state["step"])
        if self.cov_update_every <= 1 or t % self.cov_update_every == 0:
            with profiling.annotate("kfac.curvature"):
                state = self.update_curvature(state, params, data)
        lap("curvature")
        old_params = params
        with profiling.annotate("kfac.update"):
            params, state = self.step_fn(params, state, grads, state["damping"])
        lap("update")
        if (self.adaptive_damping and loss_fn is not None
                and t % self.damping_adaptation_interval == 0):
            with profiling.annotate("kfac.adapt"):
                new_loss, _ = loss_fn(params, data)
                state = self.adapt_damping(state, old_params, params, grads, loss,
                                           new_loss)
            lap("adapt")
        return params, state


# ---------------------------------------------------------------------------
# checkpoint form
# ---------------------------------------------------------------------------


def is_kfac_state(state) -> bool:
    """Whether a checkpoint's optimizer state is a KFAC one (of either
    package, of any schema version)."""
    return isinstance(state, dict) and "blocks" in state and "step" in state


def state_to_numpy(state):
    """The state with numpy leaves, in the layout the JAX package writes."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), state)


def state_from_numpy(state, device, dtype):
    """A checkpoint's KFAC state on `device`: floating leaves take `dtype`,
    the step counter stays int32."""

    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return torch.tensor(a, dtype=dtype, device=device)
        return torch.tensor(a, dtype=torch.int32, device=device)

    return tree_map(leaf, state)


def merge_restored(fresh, restored):
    """A restored state over a fresh one, key by key at the top level, so
    that a checkpoint written before the state gained a key (the adaptive
    damping's) still restores."""
    return {**fresh, **restored}
