"""Subspace DGO: the zoo's models tuned by DGO, the twin of
``repro.core.subspace``.

The paper's mechanics stay exactly as they are (Gray-code children,
argmin selection, resolution schedule); only the decode target changes:

    theta(z) = theta_0 + (alpha / sqrt(d)) * sum_j z_j * eps_j

with z the d-dimensional DGO search point and eps_j unit Gaussian
directions, ``eps_j`` of leaf ``i`` (the reference's flatten order, layers
stacked) being ``normal(fold_in(fold_in(key, i), j))`` through the
threefry twin, so a direction is the reference's within its few ulp.
The sum is accumulated over j in order, in float32, as the reference's
scan does.

* :func:`apply_subspace` streams the directions: one leaf and its sum at
  a time, regenerated from the key (for :func:`materialize_winner`).
* :func:`lm_tuning_objective` is the registry's ``subspace-lm:<arch>``:
  its ``fn`` takes a ``(K, d)`` batch of children and returns their
  ``(K,)`` losses.  It holds the directions once per objective and
  device, as a ``(d, P)`` float32 matrix over the model's P parameters,
  beside ``theta_0`` and the batch; at the registry defaults
  (``reduced(qwen2-1.5b)``, P = 164,928, d = 24) that is 15.8 MB.  The
  children are evaluated ``CHUNK`` at a time under ``torch.func.vmap``
  of ``lm_loss``, so at most ``CHUNK`` parameter copies exist at once
  (42 MB at the defaults), whatever K is.  There the sum over j is one
  matrix product ``z @ directions``, so its parameters agree with
  :func:`apply_subspace`'s to float32 rounding, not bit for bit.

``make_dgo_train_step`` (the reference's production-mesh dry-run target)
is not ported yet: it waits with ``launch/steps.py`` and
``launch/dryrun.py`` (ROADMAP queue 1 #9).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.encoding import Encoding, decode
from repro_torch.core.tree import Layers, entries, rebuild

CHUNK = 64              # children evaluated at once by a tuning objective


def _stacked(leaf) -> torch.Tensor:
    return leaf.stacked() if isinstance(leaf, Layers) else leaf


def apply_subspace(params0, z, key, alpha: float = 1.0):
    """theta_0 + alpha/sqrt(d) * sum_j z_j eps_j over the tree
    ``params0`` (a :class:`~repro_torch.models.layers.Params` or its
    plain tree), one leaf at a time, directions regenerated from ``key``
    on each leaf's device.  Non-float leaves pass through.  Returns a
    plain tree (layer lists as views of each stacked leaf)."""
    tree = params0.tree() if hasattr(params0, "tree") else params0
    z = torch.as_tensor(z).detach().float()
    d = z.shape[-1]
    scale = float(np.float32(alpha / math.sqrt(d)))
    index = {k: i for i, (k, _) in enumerate(entries(tree))}

    def leaf_of(k, like):
        leaf = _stacked(like)
        if not leaf.is_floating_point():
            return leaf
        kleaf = prng.fold_in(key, index[k])
        delta = torch.zeros(leaf.shape, device=leaf.device)
        for j, zj in enumerate(z.tolist()):       # in order, as the scan
            eps = prng.normal_torch(prng.fold_in(kleaf, j), leaf.shape,
                                    leaf.device)
            delta = delta + zj * eps
        return (leaf.float() + scale * delta).to(leaf.dtype)

    return rebuild(tree, leaf_of)


def materialize_winner(params0, parent, enc: Encoding | None, key,
                       alpha: float = 1.0):
    """Decode a DGO parent into concrete model parameters: ``parent`` is a
    bit string at ``enc``'s resolution, or — when ``enc`` is None — an
    already-decoded z (the ``best_x`` of a solve)."""
    z = parent if enc is None else decode(torch.as_tensor(parent), enc)
    return apply_subspace(params0, z, key, alpha)


# ---------------------------------------------------------------------------
# the model-zoo tuning family as a registry objective
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where each float leaf of the stacked tree sits in the flat
    parameter vector."""

    keys: tuple
    shapes: tuple
    offsets: tuple
    size: int


class _TuningState:
    """One device's copy of an objective's state: theta_0 flattened (P,),
    the directions (d, P), the batch."""

    def __init__(self, params0, layout: _Layout, key, d: int, data,
                 device: torch.device):
        index = {k: i for i, (k, _) in enumerate(entries(params0))}
        flat = dict(entries(params0))
        self.theta0 = torch.cat([_stacked(flat[k]).reshape(-1).float()
                                 for k in layout.keys]).to(device)
        self.dirs = torch.empty((d, layout.size), dtype=torch.float32,
                                device=device)
        for k, shape, off in zip(layout.keys, layout.shapes,
                                 layout.offsets):
            kleaf = prng.fold_in(key, index[k])
            n = math.prod(shape)
            for j in range(d):
                self.dirs[j, off:off + n] = prng.normal_torch(
                    prng.fold_in(kleaf, j), (n,), device)
        self.data = {name: t.to(device) for name, t in data.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _layout(params0) -> _Layout:
    keys, shapes, offsets, off = [], [], [], 0
    for k, leaf in entries(params0):
        leaf = _stacked(leaf)
        if leaf.is_floating_point():
            keys.append(k)
            shapes.append(tuple(leaf.shape))
            offsets.append(off)
            off += leaf.numel()
    return _Layout(tuple(keys), tuple(shapes), tuple(offsets), off)


def lm_tuning_objective(arch_name: str, *, d: int = 24, bits: int = 4,
                        alpha: float = 3.0, batch: int = 2, seq: int = 16,
                        seed: int = 0, layers: int | None = None):
    """A d-dimensional subspace-DGO tuning objective over one zoo model:
    ``reduced(arch)`` (its layers clamped to ``layers``), the reference's
    initial weights ``init_model(arch, PRNGKey(seed))``, the batch
    ``lm_synthetic_batch(PRNGKey(seed + 1), batch, seq, vocab)`` (with
    ``0.02 * normal(PRNGKey(seed + 2))`` frames or images for the
    frontend stubs, as the reference) and the direction key
    ``PRNGKey(seed + 3)``; ``fn(zs)`` is
    ``lm_loss(apply_subspace(params0, z, key, alpha), ..., float32)`` for
    each row z of ``zs`` (the search box is [-1, 1]^d at ``bits`` bits).

    The objective carries the reference's ``signature`` (``("subspace-lm",
    arch, d, bits, alpha, batch, seq, seed, n_layers)``) and a
    ``materialize`` mapping a winning z to the model's parameters
    (:func:`materialize_winner`).  Nothing is built until the objective
    is first evaluated or materialised, then once per device."""
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.core.objectives import Objective
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.models.lm import init_model, lm_loss

    arch = reduced(REGISTRY[arch_name])
    if layers is not None:
        arch = dataclasses.replace(arch, n_layers=min(arch.n_layers, layers))
    key = prng.PRNGKey(seed + 3)             # direction key
    scale = float(np.float32(alpha / math.sqrt(d)))
    lock = threading.Lock()
    built: dict = {}

    def base():
        if "params0" not in built:
            params0 = init_model(arch, prng.PRNGKey(seed), device="cpu").tree()
            tokens, labels = lm_synthetic_batch(prng.PRNGKey(seed + 1),
                                                batch, seq, arch.vocab_size)
            built["params0"] = params0
            built["layout"] = _layout(params0)
            data = {"tokens": torch.from_numpy(tokens).long(),
                    "labels": torch.from_numpy(labels).long()}
            kf = prng.PRNGKey(seed + 2)          # the frontend stubs' key
            if arch.enc_dec:
                data["frames"] = 0.02 * torch.from_numpy(prng.normal(
                    kf, (batch, arch.n_frames, arch.d_model)))
            if arch.vision_tokens:
                data["images"] = 0.02 * torch.from_numpy(prng.normal(
                    kf, (batch, arch.vision_tokens, arch.d_frontend)))
            built["data"] = data
        return built["params0"], built["layout"], built["data"]

    def state(device: torch.device) -> _TuningState:
        with lock:
            name = str(device)
            if name not in built:
                params0, layout, data = base()
                built[name] = _TuningState(params0, layout, key, d, data,
                                           device)
            return built[name]

    def unflatten(theta: torch.Tensor, layout: _Layout, like):
        """(C, P) flat parameters -> the model tree with a leading child
        axis on every leaf (a stacked leaf as (L, C, ...), split into
        its layers)."""
        blocks = {k: theta[:, off:off + math.prod(shape)].reshape(
            (theta.shape[0],) + shape)
            for k, shape, off in zip(layout.keys, layout.shapes,
                                     layout.offsets)}
        return rebuild(like, lambda k, leaf: blocks[k].movedim(0, 1)
                       if isinstance(leaf, Layers) else blocks[k])

    def loss_one(tree, data):
        return lm_loss(tree, arch, data, dtype=torch.float32)

    def fn(zs: torch.Tensor) -> torch.Tensor:
        st = state(zs.device)
        params0, layout, _ = base()
        out = []
        with torch.no_grad():
            for c0 in range(0, zs.shape[0], CHUNK):
                zc = zs[c0:c0 + CHUNK].float()
                theta = st.theta0 + scale * (zc @ st.dirs)
                tree = unflatten(theta, layout, params0)
                out.append(torch.func.vmap(loss_one, in_dims=(0, None))(
                    tree, st.data))
        return torch.cat(out) if out else zs.new_zeros((0,))

    def materialize(z):
        params0, _, _ = base()
        dev = z.device if isinstance(z, torch.Tensor) else torch.device(
            "cpu")
        on_dev = rebuild(params0, lambda k, leaf: _stacked(leaf).to(dev))
        return materialize_winner(on_dev, z, None, key, alpha)

    return Objective(
        name=f"subspace-lm:{arch_name}",
        fn=fn,
        encoding=Encoding(n_vars=d, bits=bits, lo=-1.0, hi=1.0),
        f_opt=None, tol=None,
        signature=("subspace-lm", arch_name, d, bits, float(alpha),
                   batch, seq, seed, arch.n_layers),
        materialize=materialize)


def lm_tuning_factory(arch_name: str) -> Callable:
    """The objective-registry factory for one arch (its defaults are part
    of the canonical spec — ``objectives.canonical_spec`` introspects
    them)."""

    def factory(d: int = 24, bits: int = 4, alpha: float = 3.0,
                batch: int = 2, seq: int = 16, seed: int = 0,
                layers: int | None = None):
        return lm_tuning_objective(arch_name, d=d, bits=bits, alpha=alpha,
                                   batch=batch, seq=seq, seed=seed,
                                   layers=layers)

    return factory
