"""Objective functions: the paper's benchmark, test functions and ANN losses.

The registry objectives of ``repro.core.objectives``, each written
batched: ``fn`` maps a ``(B, n_vars)`` float32 tensor to ``(B,)``.  The
model-zoo tuning family ``subspace-lm:<arch>`` (``core.subspace``) is
registered for every architecture of the zoo (``configs.REGISTRY``).

Every registry objective also carries its *kernel form*
(:class:`KernelForm`): the id under which ``kernels/popstep/csrc/
objectives.cuh`` evaluates it on the card, plus its constant tensors
(shekel's foxholes, the xor data set, the remote-sensing samples and
one-hot labels).  An objective without a kernel form runs only through
the plain PyTorch inners.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.cache import get_cache
from repro_torch.core.encoding import Encoding

_DEFAULTS = get_cache("objectives.factory_defaults", maxsize=128)

# objective ids shared with kernels/popstep/csrc/objectives.cuh
OBJECTIVE_IDS = {
    "quadratic": 0, "rastrigin": 1, "ackley": 2, "griewank": 3,
    "shekel": 4, "becker_lago": 5, "sample2d": 6, "xor": 7,
    "remote_sensing": 8,
}


@dataclasses.dataclass(frozen=True, eq=False)
class KernelForm:
    """What the popstep kernel needs to evaluate an objective: its id,
    its constant tensors (float32, C-contiguous, on the CPU; the kernel
    wrapper keeps one copy per device) and one scalar parameter."""

    obj_id: int
    consts: tuple = ()
    param: float = 0.0


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]   # (B, n_vars) -> (B,)
    encoding: Encoding                           # search box + start resolution
    f_opt: float | None                          # known global optimum value
    tol: float | None                            # |f - f_opt| counted as success
    kernel: KernelForm | None = None             # device form (registry only)
    # semantic identity: two Objectives with equal non-None signatures are
    # interchangeable, so engine caches and serving buckets may key on it
    # instead of the fn closure (the subspace-tuning family sets it)
    signature: tuple | None = None
    # stateful objectives (subspace tuning) map a search point back to
    # their underlying state (the winner's model parameters)
    materialize: Callable[[torch.Tensor], object] | None = None


def _on_device(consts: tuple) -> Callable:
    """Per-device copies of an objective's constants, made once each."""
    copies: dict[str, tuple] = {}

    def on(device) -> tuple:
        key = str(device)
        if key not in copies:
            copies[key] = tuple(c.to(device) for c in consts)
        return copies[key]

    return on


def _f32(a) -> torch.Tensor:
    """A float32 CPU tensor holding its own copy of ``a``."""
    return torch.tensor(np.asarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# formulated test functions
# ---------------------------------------------------------------------------

def quadratic_nd(n: int, shift: float = 1.2345) -> Objective:
    """Paper Fig. 6 generic benchmark: f(x) = sum (x_i - s)^2, min 0 at x=s."""
    def fn(x):
        d = x - shift
        return (d * d).sum(-1)
    return Objective(f"quadratic{n}d", fn,
                     Encoding(n_vars=n, bits=8, lo=-10.0, hi=10.0), 0.0, 1e-2,
                     KernelForm(OBJECTIVE_IDS["quadratic"], param=shift))


def rastrigin(n: int = 2) -> Objective:
    """Classic multimodal field of local minima; global min 0 at origin."""
    def fn(x):
        return 10.0 * x.shape[-1] + (
            x * x - 10.0 * torch.cos(2 * math.pi * x)).sum(-1)
    return Objective(f"rastrigin{n}d", fn,
                     Encoding(n_vars=n, bits=8, lo=-5.12, hi=5.12), 0.0, 1e-1,
                     KernelForm(OBJECTIVE_IDS["rastrigin"]))


def ackley(n: int = 2) -> Objective:
    def fn(x):
        a, b, c = 20.0, 0.2, 2 * math.pi
        s1 = torch.sqrt((x * x).mean(-1))
        s2 = torch.cos(c * x).mean(-1)
        return -a * torch.exp(-b * s1) - torch.exp(s2) + a + math.e
    return Objective(f"ackley{n}d", fn,
                     Encoding(n_vars=n, bits=8, lo=-5.0, hi=5.0), 0.0, 1e-1,
                     KernelForm(OBJECTIVE_IDS["ackley"]))


def griewank(n: int = 2) -> Objective:
    def fn(x):
        i = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)
        return 1.0 + (x * x).sum(-1) / 4000.0 - torch.cos(
            x / torch.sqrt(i)).prod(-1)
    return Objective(f"griewank{n}d", fn,
                     Encoding(n_vars=n, bits=8, lo=-10.0, hi=10.0), 0.0, 1e-1,
                     KernelForm(OBJECTIVE_IDS["griewank"]))


SHEKEL_A = np.asarray([[4.0, 4, 4, 4], [1, 1, 1, 1], [8, 8, 8, 8],
                       [6, 6, 6, 6], [3, 7, 3, 7], [2, 9, 2, 9],
                       [5, 5, 3, 3], [8, 1, 8, 1], [6, 2, 6, 2],
                       [7, 3.6, 7, 3.6]], np.float32)
SHEKEL_C = np.asarray([0.1, 0.2, 0.2, 0.4, 0.4, 0.6, 0.3, 0.7, 0.5, 0.5],
                      np.float32)
_SHEKEL_F_OPT = {5: -10.1532, 7: -10.4029, 10: -10.5364}


def shekel(m: int = 5) -> Objective:
    """Shekel function (paper ref [7]), 4-D, m foxholes; global min at a_1."""
    return _shekel(m, SHEKEL_A[:m], SHEKEL_C[:m])


def _shekel(m: int, a, c) -> Objective:
    consts = (_f32(a), _f32(c))
    on = _on_device(consts)

    def fn(x):
        a_t, c_t = on(x.device)
        diff = x[:, None, :] - a_t
        d = (diff * diff).sum(-1)
        return -(1.0 / (d + c_t)).sum(-1)
    return Objective(f"shekel{m}", fn,
                     Encoding(n_vars=4, bits=8, lo=0.0, hi=10.0),
                     _SHEKEL_F_OPT.get(m), 0.5,
                     KernelForm(OBJECTIVE_IDS["shekel"], consts))


def becker_lago() -> Objective:
    """Becker & Lago (paper ref [6]): f = sum (|x_i| - 5)^2, 4 global minima."""
    def fn(x):
        d = torch.abs(x) - 5.0
        return (d * d).sum(-1)
    return Objective("becker_lago", fn,
                     Encoding(n_vars=2, bits=8, lo=-10.0, hi=10.0), 0.0, 1e-2,
                     KernelForm(OBJECTIVE_IDS["becker_lago"]))


def sample_2d() -> Objective:
    """Paper Fig. 2-style 2-D surface: sinusoidal ripple on a bowl."""
    def fn(x):
        r2 = (x * x).sum(-1)
        return r2 / 20.0 - torch.cos(2.0 * x[:, 0]) * torch.cos(
            2.0 * x[:, 1]) + 1.0
    return Objective("sample2d", fn,
                     Encoding(n_vars=2, bits=8, lo=-8.0, hi=8.0), 0.0, 1e-1,
                     KernelForm(OBJECTIVE_IDS["sample2d"]))


# ---------------------------------------------------------------------------
# XOR ANN — the paper's 8-variable network (Fig. 4)
# ---------------------------------------------------------------------------
# 2-2-1 tanh network without an output bias: 2x2 input weights + 2 hidden
# biases + 2 output weights = 8 trainable variables.

XOR_X = np.asarray([[0.0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
XOR_Y = np.asarray([0.0, 1, 1, 0], np.float32)


def xor_forward(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The network's output for inputs ``x`` (..., 2) under the weights
    ``w`` (8,)."""
    w1 = w[:4].reshape(2, 2)
    b1 = w[4:6]
    w2 = w[6:8]
    h = torch.tanh(x @ w1 + b1)
    return torch.sigmoid(h @ w2)


def xor_objective() -> Objective:
    return _xor(XOR_X, XOR_Y)


def _xor(x_data, y_data) -> Objective:
    consts = (_f32(x_data), _f32(y_data))
    on = _on_device(consts)

    def fn(w):
        xd, yd = on(w.device)
        w1 = w[:, :4].reshape(-1, 2, 2)
        b1 = w[:, 4:6]
        w2 = w[:, 6:8]
        h = torch.tanh(xd @ w1 + b1[:, None, :])               # (B, 4, 2)
        pred = torch.sigmoid((h @ w2[:, :, None])[..., 0])      # (B, 4)
        err = pred - yd
        return (err * err).mean(-1)
    return Objective("xor_ann8", fn,
                     Encoding(n_vars=8, bits=6, lo=-8.0, hi=8.0), 0.0, 5e-3,
                     KernelForm(OBJECTIVE_IDS["xor"], consts))


# ---------------------------------------------------------------------------
# remote-sensing MLP — the paper's largest problem (Fig. 5)
# ---------------------------------------------------------------------------
# 7 input bands -> 42 hidden (tanh) -> 8 classes, biases everywhere:
# 7*42 + 42 + 42*8 + 8 = 680 variables, trained on 8 Gaussian clusters.

RS_IN, RS_HIDDEN, RS_CLASSES = 7, 42, 8
RS_NVARS = RS_IN * RS_HIDDEN + RS_HIDDEN + RS_HIDDEN * RS_CLASSES + RS_CLASSES


def make_remote_sensing_data(seed: int = 42, n_per_class: int = 32
                             ) -> tuple[np.ndarray, np.ndarray]:
    """8 Gaussian clusters in 7-D band space: centers uniform in [-2, 2],
    noise 0.3 * N(0, 1), ``n_per_class`` samples each.  The draws are
    ``repro.core.objectives.make_remote_sensing_data(PRNGKey(seed))``'s,
    through the threefry twin (:mod:`repro_torch.core.prng`): the centers
    bitwise, the noise within a few ulp of jax's ``normal``."""
    kc, kx = prng.split(prng.PRNGKey(seed))
    centers = prng.uniform(kc, (RS_CLASSES, RS_IN), -2.0, 2.0)
    noise = np.float32(0.3) * prng.normal(kx, (RS_CLASSES, n_per_class,
                                               RS_IN))
    x = (centers[:, None, :] + noise).reshape(-1, RS_IN)
    y = np.repeat(np.arange(RS_CLASSES), n_per_class)
    return x, y


def rs_unpack(w: torch.Tensor):
    """(w1 (7, 42), b1 (42,), w2 (42, 8), b2 (8,)) of the weights (680,)."""
    i = 0
    w1 = w[i:i + RS_IN * RS_HIDDEN].reshape(RS_IN, RS_HIDDEN)
    i += RS_IN * RS_HIDDEN
    b1 = w[i:i + RS_HIDDEN]
    i += RS_HIDDEN
    w2 = w[i:i + RS_HIDDEN * RS_CLASSES].reshape(RS_HIDDEN, RS_CLASSES)
    i += RS_HIDDEN * RS_CLASSES
    b2 = w[i:i + RS_CLASSES]
    return w1, b1, w2, b2


def rs_forward(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The MLP's logits (..., 8) for bands ``x`` (..., 7)."""
    w1, b1, w2, b2 = rs_unpack(w)
    h = torch.tanh(x @ w1 + b1)
    return h @ w2 + b2


def rs_accuracy(w: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """The share of samples whose argmax class is their label ``y``."""
    return (torch.argmax(rs_forward(w, x), dim=-1) == y).float().mean()


def remote_sensing_objective(seed: int = 42,
                             n_per_class: int = 32) -> Objective:
    return _remote_sensing(*make_remote_sensing_data(seed, n_per_class))


def _remote_sensing(x_data, labels) -> Objective:
    labels = np.asarray(labels).astype(np.int64)
    y1h = np.eye(RS_CLASSES, dtype=np.float32)[labels]
    consts = (_f32(x_data), _f32(y1h))
    on = _on_device(consts)
    n_w1 = RS_IN * RS_HIDDEN
    n_w2 = RS_HIDDEN * RS_CLASSES

    def fn(w):
        xd, yd = on(w.device)
        w1 = w[:, :n_w1].reshape(-1, RS_IN, RS_HIDDEN)
        b1 = w[:, n_w1:n_w1 + RS_HIDDEN]
        w2 = w[:, n_w1 + RS_HIDDEN:n_w1 + RS_HIDDEN + n_w2].reshape(
            -1, RS_HIDDEN, RS_CLASSES)
        b2 = w[:, RS_NVARS - RS_CLASSES:]
        h = torch.tanh(xd @ w1 + b1[:, None, :])             # (B, S, 42)
        logits = h @ w2 + b2[:, None, :]                     # (B, S, 8)
        logp = torch.log_softmax(logits, dim=-1)
        return -(yd * logp).sum(-1).mean(-1)

    return Objective(f"remote_sensing{RS_NVARS}", fn,
                     Encoding(n_vars=RS_NVARS, bits=4, lo=-4.0, hi=4.0),
                     0.0, 0.35,
                     KernelForm(OBJECTIVE_IDS["remote_sensing"], consts))


# ---------------------------------------------------------------------------
# string-keyed registry
# ---------------------------------------------------------------------------

_DIMENSIONED = True
_FIXED = False

# name -> (factory, accepts n)
_REGISTRY: dict[str, tuple[Callable[..., Objective], bool]] = {
    "quadratic": (lambda n=2, **kw: quadratic_nd(n, **kw), _DIMENSIONED),
    "rastrigin": (rastrigin, _DIMENSIONED),
    "ackley": (ackley, _DIMENSIONED),
    "griewank": (griewank, _DIMENSIONED),
    "shekel": (shekel, _FIXED),          # 4-D by construction; kw m=5|7|10
    "becker_lago": (becker_lago, _FIXED),
    "sample2d": (sample_2d, _FIXED),
    "xor": (lambda: xor_objective(), _FIXED),
    "remote_sensing": (lambda **kw: remote_sensing_objective(**kw), _FIXED),
}

_SUBSPACE = "subspace-lm:"


_zoo_registered = False


def _registry() -> dict:
    """The registry, with one ``subspace-lm:<arch>`` entry per
    architecture of the port's zoo (``configs.REGISTRY``): a subspace-DGO
    tuning objective over the reduced model
    (``core.subspace.lm_tuning_objective``).  Those entries are added on
    first use: the zoo's modules import ``core``, so ``core`` cannot
    import them while it is being imported."""
    global _zoo_registered
    if not _zoo_registered:
        from repro_torch.configs import ARCH_NAMES
        from repro_torch.core.subspace import lm_tuning_factory

        for arch_name in ARCH_NAMES:
            _REGISTRY[_SUBSPACE + arch_name] = (
                lm_tuning_factory(arch_name), _FIXED)
        _zoo_registered = True
    return _REGISTRY


def _unknown(name: str) -> Exception:
    return ValueError(f"unknown objective {name!r}; "
                      f"valid names: {', '.join(names())}")


def names() -> tuple[str, ...]:
    """Registered objective names, sorted."""
    return tuple(sorted(_registry()))


def accepts_n(name: str) -> bool:
    """Whether ``get(name, n=...)`` honours a variable count."""
    if name not in _registry():
        raise _unknown(name)
    return _registry()[name][1]


def _factory_defaults(name: str) -> tuple:
    """(param, default) pairs of a registry factory, introspected once."""
    return _DEFAULTS.get(name, lambda: _introspect_defaults(name))


def _introspect_defaults(name: str) -> tuple:
    import inspect

    return tuple(
        (pname, p.default)
        for pname, p in inspect.signature(
            _registry()[name][0]).parameters.items()
        if p.kind not in (inspect.Parameter.VAR_POSITIONAL,
                          inspect.Parameter.VAR_KEYWORD)
        and p.default is not inspect.Parameter.empty)


def canonical_spec(name: str, n: int | None = None, **kwargs) -> tuple:
    """One hashable key per semantic objective spec, factory defaults
    filled in (``("rastrigin",)`` and ``("rastrigin", n=2)`` are one)."""
    accepts_n(name)                  # validates the name
    merged = dict(kwargs)
    if n is not None:
        merged["n"] = n
    for pname, default in _factory_defaults(name):
        merged.setdefault(pname, default)
    return (name, tuple(sorted(merged.items())))


def get(name: str, n: int | None = None, **kwargs) -> Objective:
    """Build a registered objective by name (``get("rastrigin", n=5)``).

    ``n`` sets the variable count for dimensioned families; passing it
    for a fixed-dimensional objective is an error."""
    if name not in _registry():
        raise _unknown(name)
    factory, dimensioned = _registry()[name]
    if n is not None:
        if not dimensioned:
            raise ValueError(
                f"objective {name!r} has a fixed dimensionality; omit n "
                f"(dimensioned objectives: "
                f"{', '.join(k for k in names() if _registry()[k][1])})")
        kwargs["n"] = n
    return factory(**kwargs)


# objectives whose state is data, and the arrays that carry it
_STATE = {
    "shekel": (("a", "c"), lambda arrays, m=5: _shekel(
        m, arrays["a"], arrays["c"])),
    "xor": (("X", "Y"), lambda arrays: _xor(arrays["X"], arrays["Y"])),
    "remote_sensing": (("x", "y"), lambda arrays: _remote_sensing(
        arrays["x"], arrays["y"])),
}


def load_reference_state(name: str, arrays: Mapping[str, np.ndarray],
                         **spec) -> Objective:
    """Build the registry objective ``name`` from another implementation's
    constants, given as numpy arrays: ``a``/``c`` for shekel (``m`` from
    ``spec``), ``X``/``Y`` for xor, ``x`` (S, 7) samples and ``y`` (S,)
    integer labels for remote_sensing.  Objectives without data state take
    an empty mapping and build as :func:`get` does."""
    keys, build = _STATE.get(name, ((), None))
    if set(arrays) != set(keys):
        raise ValueError(f"objective {name!r} takes arrays {sorted(keys)}, "
                         f"got {sorted(arrays)}")
    if build is None:
        return get(name, **spec)
    return build(arrays, **spec)
