"""The plain reference of DGO and the comparison that decides ``correct``.

This module imports nothing of the program.  It states DGO's semantics
again from the paper and the configuration: a point is a lattice of
``2**bits`` levels a variable over ``[lo, hi]``, decoded in float32 as
``level * scale + lo`` (two roundings); its ``n_vars * bits`` bits are
the levels MSB first; child ``c`` of a parent flips the Gray-code segment
``[s, e)`` of the preorder segment tree over the bits, which in binary
space flips bit ``j`` of ``[s, e)`` when ``j - s`` is even and every bit
past ``e`` when ``e - s`` is odd; a step takes the child of least value,
if it is below the parent, and a request stops after a step without one
or at its budget.  The objective is the configuration's plain reference
(``configs/<name>.py``), evaluated in float64 at the float32 points.

The comparison (:meth:`Judge.numbers`), each number against its limit:

* ``start_gap``: over every answer compared, the gap between the
  program's value at the start (``trace[0]``) and the reference's at the
  request's own start point, relative to ``max(1, |reference|)``.  An
  answer handed to another request's handle shows here.
* ``final_gap``: the same for the program's ``best_f`` against the
  reference's value at the program's ``best_x``.
* ``step_gap``: on a sample, the reference follows the program step by
  step from the start: at each step, the gap between the program's new
  value and the least of the parent's and its best child's reference
  values, for the nearest of the states followed.  The states followed
  are the children whose reference value lies within ``follow_bar`` of
  the program's new value (exact and near ties: the program picks among
  them by float32 rounding), at most ``beam`` of them.
* ``iters_off``: over every answer compared, those that took more steps
  than the budget, or fewer while their last step still improved (on
  the sample, ``step_gap`` also holds that last step to the reference).
* ``stall_gap``: over the answers that stopped before their budget (all
  of them, up to ``stall_checks`` drawn from the seed), how far the best
  of the 2N-1 children of the final point lies below the final point's
  value, by the reference, relative to ``max(1, |value|)`` (0 where
  none lies below): a stop the program claims is held to the
  reference, so a request stopped early shows whatever its trace says.
* ``off_path``: on the sample, answers with a step whose value no child
  of the states followed has within ``follow_bar``, or whose followed
  states were never cut to ``beam`` and yet do not hold the program's
  final point.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Lattice:
    """The configuration's encoding."""

    n_vars: int
    bits: int
    lo: float
    hi: float

    @classmethod
    def of(cls, config: dict) -> "Lattice":
        return cls(int(config["n_vars"]), int(config["bits"]),
                   float(config["lo"]), float(config["hi"]))

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    @property
    def n_bits(self) -> int:
        return self.n_vars * self.bits

    @property
    def scale(self) -> float:
        return (self.hi - self.lo) / (self.levels - 1)

    def points_np(self, levels: np.ndarray) -> np.ndarray:
        """float32 points of integer levels: two float32 roundings."""
        lv = np.asarray(levels).astype(np.float32)
        return lv * np.float32(self.scale) + np.float32(self.lo)

    def points(self, levels: torch.Tensor) -> torch.Tensor:
        lv = levels.to(torch.float32)
        return (lv * torch.tensor(self.scale, dtype=torch.float32,
                                  device=lv.device)
                + torch.tensor(self.lo, dtype=torch.float32, device=lv.device))

    def levels_np(self, x: np.ndarray) -> np.ndarray:
        """The nearest level of each coordinate of float32 points."""
        lv = np.rint((np.asarray(x, np.float64) - self.lo) / self.scale)
        return np.clip(lv, 0, self.levels - 1).astype(np.int64)


def segment_table(n_bits: int) -> np.ndarray:
    """(2N-1, 2) [start, end) of the Gray segments, in preorder: the
    root [0, N), then its halves [lo, mid) and [mid, hi) with
    ``mid = (lo + hi + 1) // 2``, down to single bits."""
    segs: list[tuple[int, int]] = []
    stack = [(0, n_bits)]
    while stack:
        lo, hi = stack.pop()
        segs.append((lo, hi))
        if hi - lo > 1:
            mid = (lo + hi + 1) // 2
            stack.append((mid, hi))
            stack.append((lo, mid))
    return np.asarray(segs, dtype=np.int64)


def child_masks(lat: Lattice, device, chunk: int = 1024) -> torch.Tensor:
    """(2N-1, n_vars) int64: the XOR of each child's levels with its
    parent's (the binary-space flips of its Gray segment, a variable's
    bits MSB first)."""
    table = torch.as_tensor(segment_table(lat.n_bits), device=device)
    j = torch.arange(lat.n_bits, device=device)
    weights = torch.as_tensor(1 << np.arange(lat.bits - 1, -1, -1),
                              device=device)
    out = []
    for c0 in range(0, table.shape[0], chunk):
        s, e = table[c0:c0 + chunk, :1], table[c0:c0 + chunk, 1:]
        flip = (((j >= s) & (j < e) & ((j - s) % 2 == 0))
                | ((j >= e) & ((e - s) % 2 == 1)))
        out.append((flip.reshape(-1, lat.n_vars, lat.bits).to(torch.int64)
                    * weights).sum(-1))
    return torch.cat(out)


@dataclasses.dataclass
class Answer:
    """What the program returned for one request, and the request's start
    (its levels, as the benchmark drew them)."""

    levels0: np.ndarray      # (n_vars,) int64
    trace: np.ndarray        # (iterations + 1,) the parent's value a step
    iterations: int
    best_x: np.ndarray       # (n_vars,) float32
    best_f: float


def steps_off(ans: Answer, budget: int) -> int:
    """1 when an answer took more steps than its budget, or fewer while
    its last step still improved (a request stops early only after a
    step without an improvement)."""
    it, trace = ans.iterations, np.asarray(ans.trace)
    stalled = 1 <= it < trace.shape[0] and trace[it] == trace[it - 1]
    return int(it > budget or (it < budget and not stalled))


def _rel(a: float, b: float) -> float:
    """|a - b| relative to max(1, |b|); NaN stays NaN."""
    return abs(a - b) / max(1.0, abs(b))


class Judge:
    """The reference for one configuration on one device, and the
    comparison of the program's answers with it."""

    def __init__(self, config: dict, reference, device="cpu"):
        self.config = config
        self.lat = Lattice.of(config)
        self.check = config["check"]
        self.device = torch.device(device)
        self.ref = reference
        self.state = {k: torch.as_tensor(v, device=self.device)
                      for k, v in reference.state(config).items()}
        self.masks = child_masks(self.lat, self.device)

    # -- values --------------------------------------------------------

    def _chunked(self, fn, x: torch.Tensor) -> torch.Tensor:
        step = int(self.ref.CHUNK)
        return torch.cat([fn(x[i:i + step], self.state)
                          for i in range(0, x.shape[0], step)])

    def values(self, x32: torch.Tensor) -> torch.Tensor:
        """float64 values at float32 points (B, n_vars)."""
        return self._chunked(self.ref.values, x32.to(torch.float64))

    def values_at_levels(self, levels: torch.Tensor) -> torch.Tensor:
        return self.values(self.lat.points(levels))

    def control_values(self, levels: torch.Tensor) -> torch.Tensor:
        """The control's values: the reference computed in the precision
        below the configuration's (``configs/<name>.py``)."""
        return self._chunked(self.ref.control_values,
                             self.lat.points(levels)).to(torch.float64)

    # -- following the program ------------------------------------------

    def follow(self, ans: Answer) -> dict:
        """Follow one answer's steps (module docstring): its largest step
        gap, and whether its final point is off the followed states."""
        bar, width = float(self.check["follow_bar"]), int(self.check["beam"])
        dev = self.device
        start = torch.as_tensor(ans.levels0, device=dev)
        beam = [(start, float(self.values_at_levels(start[None])[0]))]
        trace = np.asarray(ans.trace, np.float64)
        worst, cut, broken, evaluated = 0.0, False, False, 0
        for k in range(min(ans.iterations, trace.shape[0] - 1)):
            nxt = float(trace[k + 1])
            improved = nxt < float(trace[k])
            gap, cands = math.inf, []
            for levels, val in beam:
                evaluated += 1
                kids = self.values_at_levels(levels[None] ^ self.masks)
                low = float(kids.min())
                gap = min(gap, _rel(nxt, min(val, low)))
                if improved:
                    dist = (kids - nxt).abs() / max(1.0, abs(nxt))
                    for c in torch.nonzero(dist <= bar).flatten().tolist():
                        cands.append((float(dist[c]), c, levels,
                                      float(kids[c])))
            worst = max(worst, gap) if not math.isnan(gap) else math.nan
            if not improved:
                break                  # the program's stall: it stops here
            if not cands:
                broken = True
                break
            cands.sort(key=lambda t: (t[0], t[1]))
            seen, beam = set(), []
            for _, c, levels, val in cands:
                kid = levels ^ self.masks[c]
                key = kid.cpu().numpy().tobytes()
                if key in seen:
                    continue
                if len(beam) == width:
                    cut = True
                    break
                seen.add(key)
                beam.append((kid, val))
        final = self.lat.levels_np(ans.best_x).tobytes()
        off_path = int(broken or (not cut and all(
            levels.cpu().numpy().tobytes() != final for levels, _ in beam)))
        return {"step_gap": worst, "off_path": off_path,
                "states": evaluated}

    def stall_gap(self, ans: Answer) -> float:
        """How far the best child of an answer's final point lies below
        the point's reference value (module docstring)."""
        levels = torch.as_tensor(self.lat.levels_np(ans.best_x),
                                 device=self.device)
        val = float(self.values_at_levels(levels[None])[0])
        low = float(self.values_at_levels(levels[None] ^ self.masks).min())
        return max(0.0, val - low) / max(1.0, abs(val)) if not (
            math.isnan(val) or math.isnan(low)) else math.nan

    def numbers(self, answers: list[Answer], sample: list[int],
                budget: int, stalls: list[int] = ()) -> dict:
        """The numbers compared, over ``answers`` (start and final gaps,
        step counts), the answers at ``sample`` (the followed steps) and
        at ``stalls`` (stopped before ``budget``), and ``states``, the
        parents whose children the reference evaluated in following
        them."""
        out = {"start_gap": 0.0, "final_gap": 0.0, "step_gap": 0.0,
               "iters_off": 0, "off_path": 0, "stall_gap": 0.0,
               "states": 0}
        if answers:
            lv0 = torch.as_tensor(np.stack([a.levels0 for a in answers]),
                                  device=self.device)
            v0 = self.values_at_levels(lv0).cpu().numpy()
            xb = torch.as_tensor(np.stack([a.best_x for a in answers]),
                                 device=self.device)
            vb = self.values(xb).cpu().numpy()
            out["start_gap"] = max(_rel(float(a.trace[0]), float(v))
                                   for a, v in zip(answers, v0))
            out["final_gap"] = max(_rel(a.best_f, float(v))
                                   for a, v in zip(answers, vb))
            out["iters_off"] = sum(steps_off(a, budget) for a in answers)
        for i in sample:
            f = self.follow(answers[i])
            out["step_gap"] = max(out["step_gap"], f["step_gap"])
            out["off_path"] += f["off_path"]
            out["states"] += f["states"]
        for i in stalls:
            g = self.stall_gap(answers[i])
            out["stall_gap"] = g if math.isnan(g) else max(
                out["stall_gap"], g)
        return out

    def verdict(self, numbers: dict) -> tuple[bool, dict]:
        """(correct, {name: (number, limit)}): every number at or under
        its limit (a NaN fails)."""
        limits = self.check["limits"]
        pairs = {k: (numbers[k], float(limits[k])) for k in limits}
        return all(v <= lim for v, lim in pairs.values()), pairs

    # -- the control -----------------------------------------------------

    def control_answers(self, starts: list[np.ndarray], budget: int,
                        stop_at: int | None = None) -> list[Answer]:
        """The reference in the program's place, in the precision below
        the configuration's: the same requests, each step taking the
        child of least control value.  With ``stop_at`` it is the
        reference itself, in the configuration's precision, with a
        planted fault: every request stops after ``stop_at`` steps and
        one more without a move, as a stall would leave it."""
        values = self.control_values if stop_at is None else (
            self.values_at_levels)
        out = []
        for lv0 in starts:
            levels = torch.as_tensor(lv0, device=self.device)
            val = float(values(levels[None])[0])
            trace, it = [val], 0
            for k in range(budget):
                if k == stop_at:
                    it += 1
                    trace.append(val)
                    break
                kids = values(levels[None] ^ self.masks)
                c = int(torch.argmin(kids))
                it += 1
                if float(kids[c]) < val:
                    levels, val = levels ^ self.masks[c], float(kids[c])
                    trace.append(val)
                else:
                    trace.append(val)
                    break
            out.append(Answer(np.asarray(lv0), np.asarray(trace), it,
                              self.lat.points_np(levels.cpu().numpy()), val))
        return out
