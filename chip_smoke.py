#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. build   — compile every kernel library of ``src/repro_torch/kernels``
             (popstep, graycode, fixedpoint, popmin, flash_attention)
             with nvcc for sm_90a, one nvcc each, all started together,
             and print the ptxas register/spill report;
2. kernel  — ``population_step_ids`` through the CUDA kernel (one launch
             a step) vs its plain PyTorch version on the same CUDA
             tensors, for the nine registry objectives at their registry
             encodings (the remote-sensing MLP is the full 680-variable,
             5,439-child step) and for rastrigin n=9 at every resolution
             of the second main path (8..16 bits, 143..287 children),
             and for the schedule phase's remote-sensing MLP at every
             resolution of its 4 -> 16 bit schedule (5,439..21,759
             children), from random parents (values of order one), with
             the engine's virtual blocks, as one run (the fused engine's
             step) and, for the schedule, with blocks planned at the
             folded engine's p_max (4 -> 8 and 4 -> 16 bits): the winner,
             every child's value from the kernel's value buffer, and, for
             the remote-sensing MLP, those values bitwise against the
             kernel with every hidden unit recomputed; each schedule
             step's shape timed beside its bound (``by_shape``);
2b. table  — Rastrigin at 8 bits, n = 9, 64 and 1,000, the engines' rows,
             one parent and R = 128 (the r1000 cell's wave), with the
             term table forced at every n: its values bitwise the cosine
             path's and within the bar of the plain version's, both paths
             timed beside 6 operations a term at 67 TFLOP/s, the blocks
             an SM holds, ptxas's registers and spills (``term_table``
             in the popstep entry; the probe behind ``ops.TABLE_MIN_VARS``);
3. fold    — the cross-block rule the kernel applies in its last block,
             launched alone (``ops.fold_partials``, counted in
             ``ops.fold_launches``, which the main path reads as 0) vs
             the plain rule on partials of every main-path step's shape
             and on crafted partials holding NaNs, ties, signed zeros and
             all-+inf blocks;
4. main    — ``solve(remote_sensing, Distributed(inner="popstep"))`` on
             the device driver and ``solve(rastrigin n=9,
             Distributed(driver="host", max_bits=16))``, each with both
             launch counts set to 0 before and read after: one kernel
             launch per DGO step and no fold launch; then the
             remote-sensing solve again with ``inner="fused"`` (plain
             PyTorch on the card), whose history must match step for
             step unless a step's two winners are a near-tie;
4b. schedule — the resolution schedule: ``solve(remote_sensing,
             Fused(), max_iters=64)`` at full width, 4 -> 16 bits in 7
             resolutions, and ``Distributed(max_bits=8)`` on the device
             driver, each with both launch counts set to 0 before and
             read after: one popstep launch per bound-step call, no fold
             launch, and between ``iterations`` and ``iterations + 16 x
             resolutions`` launches; the fused solve again through the
             plain tensor step on the card, held against a host replay of
             both steps on the same parents (the same children step for
             step up to a parting step, where every child's value must
             agree within ``value_bar`` and the two choices be a
             near-tie), and under the profiler (idle share, device
             activities per step); the folded history equal to
             ``Distributed(driver="host", max_bits=8)``'s step for step;
             ``Clustered(n_clusters=8)`` on rastrigin n=9, whose winner
             and evaluations must be the best and the sum of 8 ``Fused``
             runs from its starts; ``Sequential`` from the first start
             within 1e-3 (the reference's strategy-parity spread) of
             ``Fused``;
5. packed  — the packed-word kernels vs their plain versions, bitwise:
             ``generate_population_packed`` (graycode) at N = 9..2,720
             (odd and even W), ``graycode_children`` on a subset of the
             children at an N near the kernel's shared-memory budget,
             ``decode_packed`` (fixedpoint) at 1..32 bits (both of its
             paths, output rows off 16-byte boundaries), at the
             remote-sensing encoding, at populations past one grid wave
             and with rows too long to stage, ``population_min``
             (popmin, one launch: one block up to ``ONE_BLOCK_MAX``
             values, else a grid whose last block folds) at P = 1..2^24
             with a NaN at the last index, all NaN, ties and -0.0/0.0
             ties (value bits and index), at the switch +-1 and on views
             off 16-byte boundaries, the shapes of the main path below
             among them; the popmin fold alone on crafted partials
             (``ops.fold_partials``, counted in ``ops.fold_launches``);
             graycode and fixedpoint timed at the remote-sensing shape
             and at rastrigin n=9, 16 bits, graycode at N = 1 (a
             near-empty launch), popmin and ``torch.min`` at P = 287,
             5,439, 2^20 and 2^24; then their main path: generate ->
             decode -> objective -> ``population_min`` for a few DGO
             steps at remote_sensing and at rastrigin n=9, 16 bits,
             with the four launch counts set to 0 before and read
             after; each step's words, points and (min, argmin) held
             against the plain versions and oracles on the same inputs,
             and its result against popstep's ``population_step_ids``
             on the same parent (same id unless a near-tie);
6. flash   — the flash-attention kernels vs their plain version and
             ref.py (max |err| <= 1e-4 in f32, 2e-2 in bf16) at the
             reference kernel tests' shapes, at S = 100 and 160 without
             the causal mask, hd 16 at S = 200, window 64 with MQA, and
             the serving shape (B=4, S=1024, Hq=12, Hkv=2, hd=128), each
             in f32 (the CUDA-core kernel) and in bf16 (the wgmma/TMA
             tensor-core kernel); each kernel's device time at the
             serving shape and at S = 32,768, B = 1, beside its bound
             (f32 at 67 TFLOP/s, bf16 at 989),
             ``scaled_dot_product_attention`` and the plain version;
7. serve   — ``serve_lm`` on full-width qwen2-1.5b with
             ``use_flash_attention=True`` (f32, B=4, prompt 1024, 16
             tokens, 2 waves), the kernel's count set to 0 before and
             read after (28 launches a wave); one layer's captured q/k/v
             through kernel and plain version; one prefill under the
             profiler; the same weights and prompts served through the
             chunked plain attention: prefill logits within 1e-3 x
             max |logit|, greedy tokens equal but at near-ties; then one
             bf16 prefill (``lm_prefill``'s default type) with the count
             set to 0 around it (28 launches), its wall and flash share,
             its logits within 2e-2 x max |logit| of the bf16 prefill
             through the chunked plain attention, argmax equal but at
             near-ties.

8. dgo-serve — the batched engine, meshes and serving: (a) one popstep
             launch for R parents (``prepare_step_ids(..., restarts=R)``)
             vs its plain version (the one-parent plain step on each live
             parent) on the same CUDA tensors — remote_sensing at R = 1, 3
             and 8 with parents not live, at the folded schedule's 16-bit
             rows (21,759 children) at R = 8, remote_sensing (R = 1 and 8,
             parents not live: the mesh path's shape) and rastrigin n=9 at
             16 bits (R = 8), each on 8 shards with two dead at every
             rotation phase, rastrigin n=9 at its 8-bit registry encoding
             on one shard at R = 8 with parents not live (serve --dgo's
             shape), and the XOR
             net with a NaN-making sample on shards of one block (the
             step's value NaN) and of several (the NaN block dropped):
             winner ids equal (or a near-tie), values and every child's
             value within ``RTOL``/``ATOL``, each parent's result bitwise
             a one-parent launch's; each shape timed beside R one-parent
             launches and R times its bound (``by_restarts``); (b)
             ``solve_many`` of 8 remote-sensing requests with mixed caps
             and seeds in a wave of 8 and a partial second wave, the counts
             set to 0 around it: one launch per batched step, no fold
             launch, and every slot bit for bit its per-request
             ``solve(..., Batched(restarts=1))``; one wave under the
             profiler (idle share, the batched step's device time); (c)
             the folded batched wave (4 -> 8 bits, R = 8) through the
             kernel and through the plain tensor step, each slot held
             against a host replay of both steps (the same children up to
             a parting step, which must be a near-tie: ``judge_parting``);
             (d) ``Distributed(mesh=8)`` with two dead shards on both
             drivers (histories equal) and the host driver with a
             ``FailureInjector``, each descending; (e)
             ``python -m repro_torch.launch.serve --dgo`` (its ``main``, in
             this process) on remote_sensing and rastrigin n=9, waves of
             8, pipelined and then ``--no-pipeline``: every request
             completes, the same best_f per request.
9. train / subspace — the train path and subspace DGO, which no kernel
             of the repository is on (the reference trains without its
             flash kernel, which has no backward pass, and a subspace
             objective has no device form): (a) ``launch.train``'s
             ``run_training`` on full-width qwen2-1.5b, f32, 4 steps of
             B = 4, S = 512, a checkpoint at step 4 in a temporary
             directory (removed after): the weights drawn on the card by
             the threefry twin, one leaf (``wk``) bit for bit the numpy
             twin's; every loss finite; the first within
             ``TRAIN_F64_BAR`` of ``lm_loss`` in float64 on the same
             parameters and batch; the checkpoint restored bit for bit;
             one more step from the restored state and from the state in
             memory, the losses after it within ``TRAIN_RESUME_BAR`` (the
             embedding's backward adds with atomics); step seconds,
             tokens/s, peak memory, the checkpoint's bytes and seconds and
             the free disk printed; (b) ``solve(subspace-lm:qwen2-1.5b,
             Fused(), seed=0)`` on the card and on the CPU, following each
             other under the tests' near-tie rule, ``materialize(best_x)``
             finite, and ``serve --dgo --problems
             subspace-lm:qwen2-1.5b,rastrigin:9 --ckpt-dir``, whose tuning
             winner's checkpoint restores to ``materialize(best_x)`` bit
             for bit; (c) ``meta_objective`` on the reference test's
             quadratic short-train through ``Fused(max_bits=7)``, best_f
             below 1e-2.
10. zoo    — five more architectures of the registry on the card, one at a
             time, each freed before the next (``ZOO``): codeqwen1.5-7b
             (32 layers, B = 2, prompt 1,024), gemma3-27b (its first 12
             layers at full width, B = 1, prompt 2,048 over 1,024-token
             windows), granite-34b (MQA, its first 16 layers, B = 2,
             prompt 1,024), whisper-medium (B = 4, 1,500 stub frames,
             prompt 128) and phi-3-vision-4.2b (hd 96, B = 2, 576 stub
             image tokens and a prompt of 448), f32 with random weights
             from a seeded generator: (a) ``serve_lm`` with the flash
             route on, 8 tokens, 2 waves, the kernel's count set to 0
             just before and read just after (``ZOO_LAUNCHES`` a
             prefill: every global full-sequence self-attention, the
             encoder's bidirectional layers among them); (b) the same
             weights, prompts and stub inputs through the chunked plain
             attention: prefill logits within 1e-3 x max |logit|, greedy
             tokens equal but at near-ties; one prefill under the
             profiler (the kernel's share of the device time); (c) the
             first q/k/v of each attention shape a model gave the kernel
             through the f32 and bf16 kernels against the plain version
             and ref.py (f32 within ``FLASH_TOL``, bf16 by
             ``check_flash_scaled``), each timed beside its bound,
             the plain version and ``scaled_dot_product_attention``
             (``by_model`` in the kernels line); (d) ``run_training`` of
             ``reduced()`` whisper-medium and phi-3-vision, 2 steps,
             finite losses; (e) ``solve(subspace-lm:whisper-medium,
             Fused(), max_iters=4)`` on the card: best_f finite, no
             popstep launch.
11. zoo, part 2 — the last four architectures (``ZOO2``), the same way,
             one at a time, each freed before the next: xlstm-125m (all
             12 layers, B = 4, prompt 1,024: the chunked mLSTM and the
             sLSTM's loop over the prompt), zamba2-1.2b (all 38 Mamba2
             layers and the shared attention block's 7 applications,
             B = 4, prompt 1,024), deepseek-v2-236b (its first 3 of 60
             layers: 1 dense + 2 MoE, B = 2, prompt 512) and
             deepseek-v3-671b (its first 4 of 61: 3 dense + 1 MoE, MTP
             weights allocated, B = 1, prompt 512), f32: (a)
             ``serve_lm`` with the flash route on, 8 tokens, 2 waves, the
             count 0 around it (``ZOO2_LAUNCHES`` a prefill: zamba2's
             shared block, none for the others); an MoE model's routing
             in one more wave, untimed: each layer's expert loads and
             drops equal to ``torch.topk`` + ``torch.bincount`` of its
             router's softmax, the loads, the pairs dropped a wave and
             the tokens' mean cosine printed; (b) the same weights through the chunked plain
             attention (for the three models with no kernel on their
             path the same computation again: it is deterministic),
             logits and tokens as in phase 10; (c) zamba2's first q/k/v
             through both kernels against the plain version, timed beside
             the bound and SDPA; (d) ``run_training`` of ``reduced()`` of
             each, 2 steps, finite losses, deepseek-v3's MTP term in
             each; (e) ``solve(subspace-lm:xlstm-125m, Fused(),
             max_iters=4)`` on the card: best_f finite, no popstep
             launch;
12. launch — the launch layer on ``torch.distributed``: (a) the fleet:
             ``python -m repro_torch.launch.launcher --processes 2
             --devices 4`` solving remote_sensing at full width with
             ``Distributed()``, 64 iterations, each worker's popstep on
             the one card and the (value, id) pairs over gloo: both
             workers' best_f and history ``==`` one process of 8 shards;
             launches a worker (``by_path`` ``fleet``) and the wall a step
             against the single process; (b) ``build_cell`` on a (1, 1)
             NCCL mesh, qwen2-1.5b at full width in bf16 through the
             steps: train_4k at global batch 8 (two microbatches of 4;
             the loss ``lm_loss``'s within 1e-6, the parameters move),
             prefill_32k at batch 1 through the bf16 flash kernel (28
             launches, ``flash_attention_bf16``'s ``by_path`` ``steps``;
             logits within 2e-2 x max(1, |x|) of the step without it),
             decode_32k at batch 8 against a 32,768-token cache (the
             plain route's greedy token); each cell's wall, peak memory
             and argument bytes against the dry run's arithmetic for the
             cell; (c) ``make_dgo_train_step`` on one rank: xlstm-125m at
             full width and depth in bf16, d_sub 64 at 4 bits (511
             children), B 8, S 512, two steps: ``improved`` iff
             ``new_val < parent_val``, ``new_val`` the step's own
             evaluation of the winner alone within ``DGO_OWN_BAR``, the
             decision against float32, the last winner's ``lm_loss`` at
             ``materialize_winner`` within ``DGO_BF16_BAR``, seconds a
             step and children a second; (d) the meta-device dry run of
             qwen2-1.5b and deepseek-v3-671b train_4k and the
             subspace-DGO cell on pod16x16 (256 fake ranks), started
             first in a process of its own at a lower priority: argument
             bytes a device, policy, collectives by kind; the DGO cell's
             only its (value, id) all-gathers.

The last lines are the card's name and power limit, a JSON line with
every kernel's measurements (``popstep`` — its launches summed over
phases 4, 4b, 8 and 12a, each path's count under ``by_path`` —, ``popstep_fold``
— merged into
``popstep``'s launch, timed through the check entry —, ``graycode``,
``fixedpoint``, ``popmin``, ``popmin_fold`` — merged into ``popmin``'s
launch, timed through the check entry —, ``flash_attention`` — f32, its
launches summed over phases 7, 10 and 11 (``by_path``), the shapes of
phases 10 and 11 under ``by_model`` — and ``flash_attention_bf16`` —
phase 7's prefill and phase 12b's, under ``by_path``; each entry's
``clock`` is ``"profiler"`` when every one of its times is the
profiler's device time over whole records, else it names each time that
is not), and
``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the repository's
``src/repro_torch`` beside this file, it exits non-zero and prints no
result.  It imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

RTOL = ATOL = 1e-5          # the reference kernel's bar (tests/test_popstep.py)
FP32_PEAK_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12    # H100 SXM, bf16 on the tensor cores, dense
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int, dev) -> float:
    """Mean milliseconds per call after one warm-up: CUDA events on the
    card (the wall of the stream, host work included when the host is the
    slower side), the host clock elsewhere."""
    import torch

    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


TAIL_KERNEL = "spin_kernel"   # torch.cuda._sleep's kernel: profiled's tail
TAIL_LAUNCHES = 3


def _device_activity(prof, name: str | None = None) -> tuple[float, int]:
    """(microseconds, count) of the CUDA activities a profiler recorded
    (kernels and copies; only kernels whose name contains ``name``, when
    given), :func:`profiled`'s tail kernels left out."""
    from torch.autograd import DeviceType

    times = [getattr(e, "self_device_time_total", 0)
             for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and TAIL_KERNEL not in e.name
             and (name is None or name in e.name)]
    return sum(times), len(times)


PROFILE_TRIES = 6     # profiler sessions before a short count is accepted
PROFILE_PAUSE_S = 1.0  # between them (see profiled)


def profiled(fn, name: str | None = None, want: int | None = None, *,
             calls: int = 1, cpu: bool = True, tries: int | None = None):
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity, and CPU
    activity unless ``cpu`` is false), ending in a synchronize; returns
    (the profiler, wall seconds).  The profiler loses records: on an H100
    every session's for up to half a second about every ten seconds, and
    some of the session's just before (``probe_profiler.py``).  So a
    session is run again, after ``PROFILE_PAUSE_S``, up to
    ``PROFILE_TRIES`` sessions, each retry printed, when it saw no device
    activity (of kernels named ``name``, when given), other than ``want``
    of them, or a count that ``calls`` calls of ``fn``, each making the
    same launches, cannot give.  On some machines every session loses its
    last record (one of 20 launches, every session of a run): each
    session ends with ``TAIL_LAUNCHES`` tiny ``torch.cuda._sleep``
    kernels after the timed work, which :func:`_device_activity` leaves
    out, so that such a loss takes one of them.  ``tries`` overrides
    ``PROFILE_TRIES``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    tries = tries or PROFILE_TRIES
    for attempt in range(1, tries + 1):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for _ in range(TAIL_LAUNCHES):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        us, n = _device_activity(prof, name)
        if us > 0 and n % calls == 0 and want in (None, n):
            break
        print(f"[time] profiler session {attempt} recorded {n} "
              f"{name or 'device'} activities (want {want or 'some'}"
              f"{f' in {calls} equal calls' if calls > 1 else ''})"
              + ("; profiling again" if attempt < tries else ""))
        if attempt < tries:
            time.sleep(PROFILE_PAUSE_S)
    return prof, wall


# the clock behind each kernel entry's times in the kernels JSON line:
# device_ms notes, under the entry set by timing_for, every time it could
# not take from whole profiler records ("clock" in the line)
CLOCK_NOTES: dict = {}
_TIMING_FOR = ["popstep"]


def timing_for(entry: str) -> None:
    """The kernel entry whose times the next device_ms calls take."""
    _TIMING_FOR[0] = entry


def clock_of(entry: str) -> str:
    """``"profiler"`` when every time of ``entry`` is the profiler's
    device time over whole records, else what it was instead."""
    notes = CLOCK_NOTES.get(entry)
    return "profiler" if not notes else "profiler; " + "; ".join(notes)


def device_ms(fn, reps: int, dev, name: str | None = None, *,
              tries: int | None = None) -> float:
    """Mean device milliseconds per call: the CUDA activity that
    ``torch.profiler`` records over ``reps`` calls, or, when ``name`` is
    given, the mean of the recorded launches of kernels whose name
    contains it (one a call; see :func:`profiled` for dropped records).
    When every session of :func:`profiled` recorded no device time (on
    some machines the profiler loses whole sessions' records, e.g. every
    launch of a run of three 85 ms kernels), the time is taken with CUDA
    events around the calls instead (:func:`time_ms`; host work between
    launches included when the host is the slower side).  That, and a
    total over records of which some were lost, is noted in
    ``CLOCK_NOTES`` and printed.  ``tries``: :func:`profiled`'s
    sessions.  (Off the card, for a rehearsal, the host clock.)"""
    import torch

    if dev.type != "cuda":
        return time_ms(fn, reps, dev)
    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(lambda: [fn() for _ in range(reps)], name,
                       reps if name else None, calls=reps, tries=tries)
    us, n = _device_activity(prof, name)
    what = name or "plain/library"
    notes = CLOCK_NOTES.setdefault(_TIMING_FOR[0], [])
    if us > 0:
        ms = us / 1e3 / (reps if name is None else n)
        if name is None and n % reps:
            notes.append(f"{what} {ms:.4f} ms: {n} records for {reps} "
                         f"calls")
            print(f"[time] {what}: {n} records for {reps} equal calls, "
                  f"some lost: {ms:.4f} ms a call counts only the others")
        return ms
    ms = time_ms(fn, reps, dev)
    notes.append(f"{what} {ms:.4f} ms by CUDA events")
    print(f"[time] the profiler recorded no device time for {what} in "
          f"{tries or PROFILE_TRIES} sessions: {ms:.4f} ms a call by CUDA "
          f"events instead")
    return ms


def long_sum_atol(name: str, enc) -> tuple[float, str]:
    """Absolute tolerance for objectives whose value is a long float32 sum
    taken in another order by the kernel: n terms x |largest term| x 2^-23,
    with the reason."""
    if name == "rastrigin":
        big = max(abs(enc.lo), abs(enc.hi)) ** 2 + 10.0
        n = enc.n_vars
    elif name == "remote_sensing":   # logits: 42 terms h * w2 with |h| <= 1
        big, n = max(abs(enc.lo), abs(enc.hi)), 42
    else:
        return ATOL, ""
    atol = max(ATOL, 4 * n * big * 2.0**-23)
    return atol, (f"atol widened to {atol:.3g}: a sum of {n} terms up to "
                  f"{big:.3g} in another order (4 * n * term * 2^-23)")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

KERNEL_PACKAGES = ("popstep", "graycode", "fixedpoint", "popmin",
                   "flash_attention")


# each library's ptxas report from phase_build ("" when it was built before)
PTXAS: dict = {}


def phase_build() -> None:
    import importlib

    from repro_torch.kernels._build import build_all

    libs = [importlib.import_module(f"repro_torch.kernels.{name}.kernel")
            .LIBRARY for name in KERNEL_PACKAGES]
    t0 = time.perf_counter()
    built = build_all(libs)
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s (one nvcc each, in parallel)")
    for lib, (path, log) in zip(libs, built):
        PTXAS[lib.name] = log
        shown = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
        print(f"[build] {lib.name}: {shown}")
        for line in log.splitlines():
            if "Compiling entry function" in line:     # names what follows
                print(f"[build] {line.split(chr(39))[1]}:")
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"[build]   {line.strip()}")
        lib.load()


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

REGISTRY = ("quadratic", "rastrigin", "ackley", "griewank", "shekel",
            "becker_lago", "sample2d", "xor", "remote_sensing")
RAST_SCHEDULE = (8, 10, 12, 14, 16)     # the second main path's resolutions


def _step_inputs(enc, dev, plan_pop=None):
    """A step's inputs at the engines' default virtual block of 256, the
    blocks planned over ``plan_pop`` ids (default: the step's own
    population; the folded engine plans every resolution at its finest,
    p_max): (clipped ids, valid mask, block)."""
    import torch

    from repro_torch.core.distributed import _shard_plan

    plan = _shard_plan(plan_pop or enc.population, 1, 256)
    ids = torch.arange(plan.n_blocks * plan.block, device=dev)
    valid = ids < enc.population
    return ids.clamp(max=enc.population - 1), valid, plan.block


def _one_run(enc, dev):
    """The fused engine's step inputs: every child as one run."""
    import torch

    ids = torch.arange(enc.population, device=dev)
    return ids, torch.ones_like(ids, dtype=torch.bool), None


def _geometries(enc, dev, p_maxes=()):
    """The step geometries the engines bind at ``enc``: (label, ids,
    valid, virtual block) for the distributed engine's own-width virtual
    blocks, one run (the fused engine's; a NaN child wins) and, for each
    p_max in ``p_maxes``, the folded engine's blocks planned at it."""
    out = [("virtual blocks", *_step_inputs(enc, dev)),
           ("one run", *_one_run(enc, dev))]
    for p_max in p_maxes:
        out.append((f"blocks at p_max {p_max}",
                    *_step_inputs(enc, dev, p_max)))
    return out


def compare_step(obj, enc, parent, dev, ids, valid, vb):
    """One step through the kernel and the plain version on the same
    tensors; returns (kernel (val, id), plain (val, id), the kernel's
    per-child values, the plain per-child values)."""
    from repro_torch.kernels.popstep import ops

    step = ops.prepare_step_ids(obj, ids, enc, valid=valid, virtual_block=vb)
    kv, ki = step(parent)
    # the launch's value buffer (off the card, a rehearsal: the plain values)
    kvals = (step.values if dev.type == "cuda"
             else ops.child_values(obj, parent, ids, enc, valid))
    pv, pi = ops.population_step_ids_plain(obj, parent, ids, enc,
                                           valid=valid, virtual_block=vb)
    vals = ops.child_values_plain(obj, parent, ids, enc, valid)
    return (float(kv), int(ki)), (float(pv), int(pi)), kvals, vals


def time_step(obj, enc, parent, dev, ids, valid, vb, reps: int = 20):
    """(kernel device ms, wrapper-call ms, plain-version device ms, bind
    ms) of one step at the given geometry; binding the step
    (``prepare_step_ids``, host work and its device copies) is timed on
    the host clock, from one synchronize to the next."""
    import torch

    from repro_torch.kernels.popstep import ops

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step = ops.prepare_step_ids(obj, ids, enc, valid=valid, virtual_block=vb)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    b_ms = (time.perf_counter() - t0) * 1e3
    k_ms = device_ms(lambda: step(parent), reps, dev, name="popstep_kernel")
    c_ms = time_ms(lambda: step(parent), reps, dev)
    p_ms = device_ms(lambda: ops.population_step_ids_plain(
        obj, parent, ids, enc, valid=valid, virtual_block=vb), reps, dev)
    return k_ms, c_ms, p_ms, b_ms


def check_step(label, name, obj, enc, parent, dev, p_maxes=()) -> float:
    """Kernel vs plain on one step at each of the engines' geometries
    (:func:`_geometries`): the winner and every child's value (the values
    of masked rows are +inf in both); for the remote-sensing MLP the
    kernel's values also bitwise against the kernel with every hidden unit
    recomputed.  Returns the largest |error| of a child's value."""
    import torch

    from repro_torch.kernels.popstep import ops

    atol, why = long_sum_atol(name, enc)
    max_err = 0.0
    for mode, ids, valid, vb in _geometries(enc, dev, p_maxes):
        (kv, ki), (pv, pi), kvals, vals = compare_step(obj, enc, parent, dev,
                                                       ids, valid, vb)
        check(kvals.shape == vals.shape and bool(torch.isclose(
            kvals, vals, rtol=RTOL, atol=atol).all()),
              f"{label} {mode}: a child's value differs from the plain "
              f"version's beyond the bar (atol {atol:.3g})")
        fin = torch.isfinite(vals)
        err = (float((kvals[fin].double() - vals[fin].double()).abs().max())
               if bool(fin.any()) else 0.0)
        max_err = max(max_err, err)
        check(np.isclose(kv, pv, rtol=RTOL, atol=atol),
              f"{label} {mode}: kernel {kv!r} vs plain {pv!r} (atol "
              f"{atol:.3g})")
        if ki != pi:     # a near-tie: both winners within the bar
            a, b = float(vals[ki]), float(vals[pi])
            check(np.isclose(a, b, rtol=RTOL, atol=atol),
                  f"{label} {mode}: kernel id {ki} ({a!r}) vs plain id "
                  f"{pi} ({b!r}) is not a near-tie")
        print(f"[kernel] {label:<22} pop {enc.population:>5} {mode:<20} "
              f"kernel ({kv:.7g}, {ki}) plain ({pv:.7g}, {pi}); "
              f"{kvals.shape[0]} child values, max |err| {err:.3g}"
              + (f"  [{why}]" if why else ""))
    if name == "remote_sensing":
        ids, valid, _ = _step_inputs(enc, dev)
        reused = ops.child_values(obj, parent, ids, enc, valid)
        full = ops.child_values(obj, parent, ids, enc, valid, reuse=False)
        same = torch.equal(reused.view(torch.int32), full.view(torch.int32))
        check(same, f"{label}: reusing the parent's hidden units changed a "
                    f"child's value")
        print(f"[kernel] {label:<22} {ids.shape[0]} child values with the "
              f"parent's hidden units reused == every unit recomputed, "
              f"bitwise")
    return max_err


def _random_parent(rng, enc, dev):
    import torch

    return torch.as_tensor(rng.integers(0, 2, enc.n_bits).astype(np.int8),
                           device=dev)


def sched_resolutions():
    """The schedule phase's problem, its Fused resolutions and its folded
    Distributed run's (``FOLDED_EXTRA_BITS`` above the start)."""
    from repro_torch.core.solver import Fused, Problem

    name, kw = SCHED_PROBLEM
    prob = Problem.get(name, **kw)
    res = Fused()._config(prob, SCHED_ITERS, None, 2).resolutions()
    folded = [b for b in res if b <= prob.encoding.bits + FOLDED_EXTRA_BITS]
    return name, prob, res, folded


def phase_kernel_vs_plain(dev) -> dict:
    """Every registry objective at its registry encoding, then the second
    main path's problem (rastrigin n=9) at every resolution of its
    8 -> 16 bit schedule and the schedule phase's problem (the
    remote-sensing MLP) at every resolution of its 4 -> 16 bit schedule,
    from random parents, at each geometry its engines bind; times at
    remote_sensing (registry encoding and every schedule step's shape)
    and at rastrigin n=9, 16 bits."""
    from repro_torch.core import objectives

    rng = np.random.default_rng(0)
    max_err = 0.0
    rs = None
    for name in REGISTRY:
        obj = objectives.get(name)
        enc = obj.encoding
        parent = _random_parent(rng, enc, dev)
        max_err = max(max_err, check_step(name, name, obj, enc, parent, dev))
        ids, valid, block = _step_inputs(enc, dev)
        k_ms, c_ms, p_ms, b_ms = time_step(obj, enc, parent, dev, ids, valid,
                                           block)
        print(f"[time] {name:<15} kernel {k_ms:.4f} ms (device), wrapper "
              f"call {c_ms:.4f} ms (CUDA events), plain {p_ms:.4f} ms "
              f"(device); binding the step {b_ms:.3f} ms (host)")
        if name == "remote_sensing":
            rs = dict(obj=obj, enc=enc, ids=ids, valid=valid, block=block,
                      ms=k_ms, plain_ms=p_ms)
    rast = objectives.get("rastrigin", n=9)
    for b in RAST_SCHEDULE:
        enc_b = rast.encoding.with_bits(b)
        parent = _random_parent(rng, enc_b, dev)
        max_err = max(max_err, check_step(f"rastrigin n=9 {b} bits",
                                          "rastrigin", rast, enc_b, parent,
                                          dev))
    ids, valid, block = _step_inputs(enc_b, dev)
    k_ms, c_ms, p_ms, b_ms = time_step(rast, enc_b, parent, dev, ids, valid,
                                       block)
    print(f"[time] rastrigin n=9 16 bits (pop {enc_b.population}) kernel "
          f"{k_ms:.4f} ms (device), wrapper call {c_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms (device); binding the step {b_ms:.3f} ms (host)")
    rs["rastrigin_ms"] = k_ms

    # the schedule phase's steps: Fused's one run at every resolution, the
    # folded engine's blocks planned at its p_max (and at the full
    # schedule's, Distributed(max_bits=16)'s)
    name, prob, res, folded = sched_resolutions()
    obj, enc0 = prob.objective, prob.encoding
    p_full = 2 * enc0.n_vars * res[-1] - 1
    p_fold = 2 * enc0.n_vars * folded[-1] - 1
    rs["by_shape"] = {}
    for b in res:
        enc_b = enc0.with_bits(b)
        parent = _random_parent(rng, enc_b, dev)
        p_maxes = (p_full,) + ((p_fold,) if b in folded else ())
        max_err = max(max_err, check_step(f"{name} {b} bits", name, obj,
                                          enc_b, parent, dev, p_maxes))
        shapes = [("fused one run", *_one_run(enc_b, dev))]
        if b in folded:
            shapes.append((f"folded, p_max {p_fold}",
                           *_step_inputs(enc_b, dev, p_fold)))
        for mode, ids, valid, vb in shapes:
            k_ms, c_ms, p_ms, b_ms = time_step(obj, enc_b, parent, dev, ids,
                                               valid, vb)
            bound, by = popstep_work_bound(name, obj, enc_b, ids, valid,
                                           vb)[1]
            label = f"{name} {b} bits {mode}"
            rs["by_shape"][label] = {"ms": k_ms, "plain_ms": p_ms,
                                     "bound_ms": bound, "bound_by": by}
            print(f"[time] {label} (pop {enc_b.population}, {ids.shape[0]} "
                  f"rows) kernel {k_ms:.4f} ms (device), wrapper call "
                  f"{c_ms:.4f} ms, plain {p_ms:.4f} ms (device), bound "
                  f"{bound:.4f} ms ({by}); binding the step {b_ms:.3f} ms "
                  f"(host)")
    rs["max_abs_err"] = max_err
    return rs


def popstep_work_bound(name, obj, enc, ids, valid, vb) -> tuple:
    """Least time for one step of ``obj`` over ``ids`` (virtual blocks of
    ``vb``, one run when None): ((full-work ms, by), (needed-work ms, by)).
    For the remote-sensing MLP the needed work counts layer 2 for every
    live child, layer 1 for the hidden units its mask marks (the others
    are bitwise the parent's) and the parent's layer 1 once; the full work
    both layers for every live child; multiply-adds (2 FLOPs each) over
    the float32 peak vs inputs and outputs over the memory rate.  Other
    objectives: the bytes alone.  Transcendentals are not counted."""
    from repro_torch.core.objectives import RS_CLASSES, RS_HIDDEN, RS_IN
    from repro_torch.kernels.popstep import ops

    n_rows = ids.shape[0]
    n_live = int(valid.sum())
    n_vblocks = n_rows // (vb or n_rows)
    # parent bits, then starts/ends/ok/order per row, its mask, its value
    # written, one id read per virtual block, the constants and the
    # (value, id) written out
    nbytes = (enc.n_bits + n_rows * (4 * 4 + 8 + 4) + 4 * n_vblocks
              + sum(c.numel() * 4 for c in obj.kernel.consts) + 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if name == "remote_sensing":
        m = obj.kernel.consts[0].shape[0]
        masks = ops.hidden_unit_masks(enc.n_bits, enc.bits)
        live = ids.cpu().numpy()[valid.cpu().numpy()]
        units = int(((masks[live, None] >> np.arange(RS_HIDDEN)) & 1).sum())
        flops = n_live * m * (RS_IN * RS_HIDDEN + RS_HIDDEN * RS_CLASSES) * 2
        reused = (n_live * m * RS_HIDDEN * RS_CLASSES
                  + (units + RS_HIDDEN) * m * RS_IN) * 2
    else:
        flops = reused = 0
    out = []
    for f in (flops, reused):
        t_ops = f / FP32_PEAK_FLOPS * 1e3
        out.append((t_ops, "operations") if t_ops >= t_bytes
                   else (t_bytes, "bytes"))
    return tuple(out)


def popstep_bound_ms(rs: dict) -> tuple[float, str]:
    """Least time for the registry remote-sensing step
    (:func:`popstep_work_bound`'s needed work); the full work, both layers
    for every live child, goes to ``rs["full_work_bound_ms"]``."""
    full, needed = popstep_work_bound("remote_sensing", rs["obj"], rs["enc"],
                                      rs["ids"], rs["valid"], rs["block"])
    rs["full_work_bound_ms"] = full[0]
    print(f"[kernel] remote_sensing bound: full work -> "
          f"{full[0] * 1e3:.2f} us ({full[1]}); needed work -> "
          f"{needed[0] * 1e3:.2f} us ({needed[1]})")
    return needed


# ---------------------------------------------------------------------------
# phase 2b: Rastrigin's term table
# ---------------------------------------------------------------------------

TABLE_NS = (9, 64, 1000)     # rastrigin at 8 bits: serve --dgo's, the rule's
                             # threshold, the r1000 cell's
TABLE_RESTARTS = (1, 128)    # one parent, and the r1000 cell's wave


def ptxas_of(lib: str, entry: str) -> str:
    """The ptxas lines (registers, spills) of the entry function whose
    mangled name contains ``entry``, from phase_build's report."""
    lines, take = [], False
    for line in PTXAS.get(lib, "").splitlines():
        if "Compiling entry function" in line:
            take = entry in line
        elif take and ("registers" in line or "spill" in line):
            lines.append(" ".join(line.replace("ptxas info    :", "").split()))
    return "; ".join(lines) or "not in this run's build report"


def phase_term_table(dev) -> dict:
    """Rastrigin at 8 bits, n in ``TABLE_NS``, the engines' rows, one
    parent and R = 128 random parents: the table path's values bitwise
    the cosine path's (``reuse=False``) and the plain version's within the
    long-sum bar, each path's device time a launch beside the bound of 6
    operations a term at 67 TFLOP/s, the blocks the card holds per SM with
    each path's shared memory.  The table path is forced at every n
    (``ops.TABLE_MIN_VARS`` lowered for the probe), so the times set the
    shape rule's threshold."""
    import torch

    from repro_torch.core import objectives
    from repro_torch.kernels.popstep import ops
    from repro_torch.kernels.popstep.kernel import LIBRARY

    rng = np.random.default_rng(28)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    print(f"[table] popstep_kernel<1> ptxas: "
          f"{ptxas_of('popstep', 'popstep_kernelILi1E')}")
    out, threshold = {}, ops.TABLE_MIN_VARS
    ops.TABLE_MIN_VARS = 1
    try:
        for n in TABLE_NS:
            obj = objectives.get("rastrigin", n=n)
            enc = obj.encoding
            ids, valid, block = _step_inputs(enc, dev)
            atol, _ = long_sum_atol("rastrigin", enc)
            for r in TABLE_RESTARTS:
                parents = torch.as_tensor(rng.integers(
                    0, 2, (r, enc.n_bits)).astype(np.int8), device=dev)
                steps = {path: ops._prepare_cuda(
                    obj, ids, enc, valid, ids.shape[0] // block, restarts=r,
                    reuse=path == "table") for path in ("table", "cosine")}
                res = {path: step(parents) for path, step in steps.items()}
                tv, cv = steps["table"].values, steps["cosine"].values
                check(steps["table"].table and not steps["cosine"].table,
                      f"n={n} R={r}: the paths were not the ones asked for")
                check(torch.equal(tv.view(torch.int32), cv.view(torch.int32))
                      and torch.equal(res["table"][1], res["cosine"][1]),
                      f"n={n} R={r}: the table path's values are not the "
                      f"cosine path's, bitwise")
                want = torch.stack([ops.child_values_plain(
                    obj, parents[i], ids, enc, valid) for i in range(r)])
                check(bool(torch.isclose(tv, want, rtol=RTOL,
                                         atol=atol).all()),
                      f"n={n} R={r}: a child's value differs from the plain "
                      f"version's beyond the bar (atol {atol:.3g})")
                bound = (r * enc.population * n * 6) / FP32_PEAK_FLOPS * 1e3
                entry = {"bound_ms": bound}
                for path, step in steps.items():
                    ms = device_ms(lambda: step(parents), 10, dev,
                                   name="popstep_kernel")
                    smem = step._grid[1]
                    per_sm = (ops._resident_blocks(step._lib, ops._RAST_ID,
                                                   smem, dev) / sms
                              if dev.type == "cuda" else float("nan"))
                    entry[path] = {"ms": ms, "share": bound / ms,
                                   "smem": smem, "blocks_per_sm": per_sm}
                    print(f"[table] rastrigin n={n} 8 bits R={r} "
                          f"({ids.shape[0]} rows) {path:<6} {ms:.4f} ms "
                          f"(device), bound {bound:.4f} ms ({bound / ms:.1%}"
                          f"), {smem} B shared a block, {per_sm:g} blocks "
                          f"an SM")
                print(f"[table] rastrigin n={n} R={r}: table == cosine "
                      f"bitwise, {r * ids.shape[0]} child values; cosine / "
                      f"table {entry['cosine']['ms'] / entry['table']['ms']:.2f}"
                      f"x")
                out[f"n={n} R={r}"] = entry
    finally:
        ops.TABLE_MIN_VARS = threshold
    return out


# ---------------------------------------------------------------------------
# phase 3: fold
# ---------------------------------------------------------------------------

def _same(kv, ki, rv, ri) -> bool:
    """Identical (value with its sign, or both NaN) and the same id."""
    kv, rv = float(kv), float(rv)
    return ((np.isnan(kv) and np.isnan(rv))
            or (kv == rv and np.signbit(kv) == np.signbit(rv))) \
        and int(ki) == int(ri)


FOLD_CHUNK = 4      # rows a partial stands for in the crafted partials


def main_path_partials(rng, pop: int, dev):
    """Partials over the virtual blocks of one engine step of population
    ``pop`` (each partial the winner of ``FOLD_CHUNK`` rows of its block),
    with values drawn so that ties and NaNs occur and one virtual block
    is all NaN: (values, rows, ids, n_vblocks, sentinel)."""
    import torch

    from repro_torch.core.distributed import _shard_plan

    plan = _shard_plan(pop, 1, 256)
    cpv = -(-plan.block // FOLD_CHUNK)
    vals = rng.integers(0, 40, (plan.n_blocks, cpv)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.01] = np.nan
    vals[rng.random(vals.shape) < 0.05] = np.inf
    if plan.n_blocks > 1:
        vals[-1] = np.nan
    first = (np.arange(plan.n_blocks)[:, None] * plan.block
             + np.arange(cpv)[None, :] * FOLD_CHUNK)
    last = np.minimum(first + FOLD_CHUNK,
                      (np.arange(plan.n_blocks)[:, None] + 1) * plan.block)
    rows = rng.integers(first, last).astype(np.int32)
    ids = np.minimum(np.arange(plan.n_blocks * plan.block), pop - 1)
    return (torch.as_tensor(vals.reshape(-1), device=dev),
            torch.as_tensor(rows.reshape(-1), device=dev),
            torch.as_tensor(ids, device=dev), plan.n_blocks, pop)


def phase_fold(dev, rs_pop: int) -> dict:
    """The kernel's cross-block rule launched alone (``fold_partials``,
    the thin kernel over the same ``fold_vblocks``) vs the plain rule, on
    crafted partials and on partials of every main-path step's shape;
    times it at the remote-sensing shape."""
    import torch

    from repro_torch.kernels.popstep import ops

    rng = np.random.default_rng(5)
    shapes = [("remote_sensing", rs_pop)] + [
        (f"rastrigin n=9 {b} bits", 2 * 9 * b - 1) for b in RAST_SCHEDULE]
    max_err = 0.0
    for label, pop in shapes:
        for _ in range(3):
            args = main_path_partials(rng, pop, dev)
            kv, ki = ops.fold_partials(*args[:4], sentinel=args[4])
            rv, ri = ops.fold_partials_plain(*args[:4], sentinel=args[4])
            check(_same(kv, ki, rv, ri), f"fold {label}: kernel "
                  f"({float(kv)}, {int(ki)}) vs plain ({float(rv)}, "
                  f"{int(ri)})")
            if np.isfinite(float(kv)):
                max_err = max(max_err, abs(float(kv) - float(rv)))
        print(f"[fold] {label:<20} {args[3]} virtual blocks x "
              f"{args[0].shape[0] // args[3]} partials: "
              f"({float(kv)}, {int(ki)}) == plain")
    args = main_path_partials(rng, rs_pop, dev)
    fold = dict(n_parts=args[0].shape[0], n_vblocks=args[3],
                max_abs_err=max_err)
    fold["ms"] = device_ms(lambda: ops.fold_partials(*args[:4],
                                                     sentinel=args[4]),
                           20, dev, name="popstep_fold")
    fold["plain_ms"] = device_ms(lambda: ops.fold_partials_plain(
        *args[:4], sentinel=args[4]), 20, dev)
    print(f"[time] fold at the remote-sensing shape: kernel "
          f"{fold['ms']:.4f} ms, plain {fold['plain_ms']:.4f} ms (device)")

    nan, inf = float("nan"), float("inf")
    ppv = 7
    vals = np.array([
        [3.0, 2.0, 5.0, 2.0, 9.0, 4.0, 6.0],            # tie inside a block
        [1.0, nan, 0.5, nan, 2.0, 3.0, 7.0],            # NaNs hide the block
        [2.0, 8.0, 2.0, 9.0, 2.0, 8.0, 8.0],            # ties with block 0
        [inf] * ppv,                                    # all masked
        [-0.0, 0.0, 1.0, 1.0, 0.5, 0.0, 4.0],            # signed zeros
    ], np.float32)
    n_vb = vals.shape[0]
    rows = np.arange(n_vb * ppv, dtype=np.int32)[::-1].copy()
    ids = np.random.default_rng(3).permutation(n_vb * ppv).astype(np.int32)
    cases = [("five blocks", vals, n_vb), ("one block with NaN", vals[1:2], 1),
             ("one block", vals[0:1], 1), ("all NaN blocks",
                                           np.full((3, ppv), nan, np.float32), 3)]
    for label, v, nb in cases:
        pv = torch.as_tensor(v.reshape(-1), device=dev)
        pr = torch.as_tensor(rows[: pv.shape[0]], device=dev)
        t_ids = torch.as_tensor(ids, device=dev)
        kv, ki = ops.fold_partials(pv, pr, t_ids, nb, sentinel=10_000)
        rv, ri = ops.fold_partials_plain(pv, pr, t_ids, nb, sentinel=10_000)
        check(_same(kv, ki, rv, ri), f"fold {label}: kernel ({float(kv)}, "
              f"{int(ki)}) vs plain ({float(rv)}, {int(ri)})")
        print(f"[fold] {label:<20} ({float(kv)}, {int(ki)}) == plain")
    return fold


def fold_bound_ms(fold: dict) -> tuple[float, str]:
    """Least time for the fold at the remote-sensing shape: each partial
    (value, row) read once, one id read per virtual block, (value, id)
    written, over the memory rate vs one comparison per partial over the
    float32 peak."""
    nbytes = fold["n_parts"] * 8 + fold["n_vblocks"] * 4 + 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = fold["n_parts"] / FP32_PEAK_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _winner_ids(step, pat, x0, enc, n_steps, obj, dev):
    """Replay ``n_steps`` host steps and return each step's chosen child
    id (None where the parent was kept) and value."""
    import torch

    from repro_torch.core.encoding import decode, encode

    bits = encode(torch.as_tensor(x0, device=dev), enc)
    val = obj.fn(decode(bits, enc)[None])[0]
    out = []
    for it in range(n_steps):
        new_bits, new_val, improved = step(bits, val, None, it)
        if bool(improved):
            diff = torch.bitwise_xor(new_bits, bits)
            cid = int(torch.nonzero((pat == diff).all(1))[0, 0])
        else:
            cid = None
        out.append((cid, float(new_val)))
        bits, val = new_bits, new_val
    return out


def histories_match(h_a, h_b, problem, x0, dev) -> str:
    """'' if two histories agree within the bar step for step; else the
    first differing step is replayed with both inners and accepted only
    as a near-tie (both winners' values within the bar)."""
    from repro_torch.core.distributed import make_distributed_step
    from repro_torch.core.population import table_on

    n = min(len(h_a), len(h_b))
    close = np.isclose(h_a[:n], h_b[:n], rtol=RTOL, atol=ATOL)
    if close.all() and len(h_a) == len(h_b):
        return ""
    t = int(np.argmin(close)) if not close.all() else n
    obj, enc = problem.objective, problem.encoding
    pat = table_on("patterns", enc.n_bits, dev)
    runs = [_winner_ids(make_distributed_step(obj, enc, inner=inner,
                                              device=dev), pat, x0, enc, t,
                        obj, dev) for inner in ("popstep", "fused")]
    for s, ((ia, va), (ib, vb)) in enumerate(zip(*runs), start=1):
        if ia != ib:
            check(np.isclose(va, vb, rtol=RTOL, atol=ATOL),
                  f"histories diverge at step {s}: child {ia} ({va!r}) vs "
                  f"child {ib} ({vb!r}) is not a near-tie")
            return f"near-tie at step {s}: child {ia} ({va!r}) vs {ib} ({vb!r})"
    fail(f"histories differ from step {t} without a differing winner")
    return ""


def _solve_timed(problem, strategy, x0, max_iters, dev):
    import torch

    from repro_torch.core.solver import solve

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    # on the card, the entry point's default device (None -> CUDA)
    res = solve(problem, strategy, x0=x0, max_iters=max_iters,
                device=None if on_card else dev)
    if on_card:
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def _counted_solve(problem, strategy, x0, max_iters, dev):
    """A main-path solve with the kernel's launch counts set to 0 just
    before it and read just after, and its DGO steps counted (the calls of
    every step the engine binds through ``ops.prepare_step_ids``):
    (result, wall s, (launches, fold launches, steps))."""
    from repro_torch.kernels.popstep import ops

    steps, undo = _count_steps()
    try:
        ops.launches = ops.fold_launches = 0
        res, wall = _solve_timed(problem, strategy, x0, max_iters, dev)
        counts = (ops.launches, ops.fold_launches, steps[0])
    finally:
        undo()
    return res, wall, counts


def _count_steps():
    """Wrap ``ops.prepare_step_ids`` so that every call of a step it binds
    is counted: (the count, a list of one int; undo)."""
    from repro_torch.kernels.popstep import ops

    bind = ops.prepare_step_ids
    calls = [0]

    def counting_bind(*args, **kwargs):
        step = bind(*args, **kwargs)

        def counted(*a, **k):
            calls[0] += 1
            return step(*a, **k)
        return counted

    ops.prepare_step_ids = counting_bind

    def undo():
        ops.prepare_step_ids = bind
    return calls, undo


def phase_main_path(dev, rs_ms: float, rast_ms: float) -> dict:
    """The two main-path solves; returns each one's (launches, fold
    launches) by path."""
    from repro_torch.core.solver import Distributed, Problem

    rs_prob = Problem.get("remote_sensing")
    rast = Problem.get("rastrigin", n=9)
    rng = np.random.default_rng(0)
    x0_rs = rng.uniform(-4.0, 4.0, rs_prob.encoding.n_vars).astype(np.float32)
    x0_ra = rng.uniform(-5.12, 5.12, rast.encoding.n_vars).astype(np.float32)

    res_rs, wall_rs, n_rs = _counted_solve(
        rs_prob, Distributed(inner="popstep"), x0_rs, 64, dev)
    res_ra, wall_ra, n_ra = _counted_solve(
        rast, Distributed(driver="host", max_bits=16), x0_ra, None, dev)

    for label, res, wall, (n, n_fold, n_steps), prob in (
            ("remote_sensing popstep device", res_rs, wall_rs, n_rs,
             rs_prob),
            ("rastrigin n=9 host 8->16 bits", res_ra, wall_ra, n_ra,
             rast)):
        best = float(res.best_f)
        print(f"[main] {label}: {res.iterations} iterations, best_f "
              f"{best:.7g}, wall {wall:.3f} s, {n_steps} DGO steps, "
              f"launches: popstep {n}, fold alone {n_fold}; finite "
              f"{res.extras['finite']}")
        check(n > 0, f"{label}: the popstep kernel was never launched")
        check(n == n_steps, f"{label}: {n} popstep launches for {n_steps} "
                            f"DGO steps (one each wanted)")
        check(n_fold == 0, f"{label}: the fold was launched on its own "
                           f"{n_fold} times")
        check(res.extras["finite"] and np.isfinite(best),
              f"{label}: non-finite result")
        check(res.trace.shape == (res.iterations + 1,),
              f"{label}: trace shape {res.trace.shape}")
        check(tuple(res.best_x.shape) == (prob.encoding.n_vars,)
              and bool(res.best_x.isfinite().all()),
              f"{label}: best_x {tuple(res.best_x.shape)}")
    res_warm, wall_warm = _solve_timed(rs_prob, Distributed(inner="popstep"),
                                       x0_rs, 64, dev)
    check(res_warm.extras["history"] == res_rs.extras["history"],
          "remote_sensing: a repeated solve gave another history")
    print(f"[main] remote_sensing kernel time per step {rs_ms:.4f} ms "
          f"(device, phase 2); solve wall per step "
          f"{wall_rs / max(n_rs[0], 1) * 1e3:.3f} ms first run "
          f"(first-use table builds included; per step launched), "
          f"{wall_warm / max(n_rs[0], 1) * 1e3:.3f} ms repeated")
    if dev.type == "cuda":
        solved = []
        prof, _ = profiled(lambda: solved.append(_solve_timed(
            rs_prob, Distributed(inner="popstep"), x0_rs, 64, dev)),
            "popstep_kernel", cpu=False)
        res_prof, wall_prof = solved[-1]
        busy_us, n_acts = _device_activity(prof)
        busy = busy_us / 1e6
        # on the card itself: the step kernel ran, the fold kernel did not
        _, n_step_dev = _device_activity(prof, "popstep_kernel")
        _, n_fold_dev = _device_activity(prof, "popstep_fold")
        print(f"[main] remote_sensing repeated under the profiler: wall "
              f"{wall_prof:.4f} s, device busy {busy:.4f} s, idle share "
              f"{1 - busy / wall_prof:.3f}, {n_acts} device activities "
              f"({n_acts / max(res_prof.iterations, 1):.1f} per step); "
              f"recorded launches: popstep_kernel {n_step_dev}, "
              f"popstep_fold_kernel {n_fold_dev}")
        check(n_step_dev > 0, "the profiler recorded no popstep_kernel "
                              "launch in the repeated solve")
        check(n_fold_dev == 0, f"the repeated solve launched "
                               f"popstep_fold_kernel {n_fold_dev} times")
    print(f"[main] rastrigin n=9 kernel time per step {rast_ms:.4f} ms at "
          f"16 bits (device, phase 2); solve wall per step "
          f"{wall_ra / max(n_ra[0], 1) * 1e3:.3f} ms")
    check(res_ra.extras["schedule"] == (8, 10, 12, 14, 16),
          f"rastrigin schedule {res_ra.extras['schedule']}")

    res_fused, wall_f = _solve_timed(rs_prob, Distributed(inner="fused"),
                                     x0_rs, 64, dev)
    print(f"[main] remote_sensing fused device: {res_fused.iterations} "
          f"iterations, best_f {float(res_fused.best_f):.7g}, wall "
          f"{wall_f:.3f} s")
    note = histories_match(np.asarray(res_rs.extras["history"]),
                           np.asarray(res_fused.extras["history"]),
                           rs_prob, x0_rs, dev)
    print(f"[main] popstep vs fused histories: "
          f"{note or 'match step for step'}")
    return {"main: remote_sensing distributed device": n_rs[:2],
            "main: rastrigin n=9 distributed host 8->16": n_ra[:2]}


# ---------------------------------------------------------------------------
# phase 4b: the resolution schedule
# ---------------------------------------------------------------------------

SCHED_ITERS = 64          # max_iters of the remote-sensing schedule solves
SCHED_PROBLEM = ("remote_sensing", {})      # full width: 680 vars, 4->16 bits
FOLDED_EXTRA_BITS = 4     # the folded Distributed run: start -> start + 4 bits
CLUSTER_PROBLEM = ("rastrigin", {"n": 9})
N_CLUSTERS = 8
SEQ_TOTAL_ITERS = 1024    # Sequential's total-iteration guard
STRATEGY_SPREAD = 1e-3    # the reference's strategy-parity bar


SUM_FLOOR = 2.0**-20   # the remote-sensing loss's float32 floor (value_bar)


def value_bar(name, enc, v, atol=ATOL):
    """|kernel - plain| allowed for a value ``v`` (scalar or array) of
    objective ``name``: ``RTOL * |v| + atol``, and for the remote-sensing
    MLP at most ``SUM_FLOOR + 2 * dz * min(1, |v|)``.  There a sample's
    loss is ``log(se)`` with ``se`` the sum of its 8 class exps, the
    largest exactly 1: each of the 7 other additions rounds by up to 2^-24
    near 1, so two orders differ by < 2^-20 (``SUM_FLOOR``); a logit error
    ``dz`` (``long_sum_atol``) moves the loss by at most 2 dz (1 - p_y) <=
    2 dz min(1, loss).  Below the floor a loss counts the samples whose
    ``se`` rounds above 1 (quanta of 2^-23 / 256 = 4.66e-10), which two
    evaluation orders may count differently."""
    v = np.abs(np.asarray(v, np.float64))
    bar = RTOL * v + atol
    if name == "remote_sensing":
        dz = long_sum_atol(name, enc)[0]
        bar = np.minimum(bar, SUM_FLOOR + 2 * dz * np.minimum(1.0, v))
    return bar


def replay_schedule(problem, cfg, x0, dev):
    """The fused engine's schedule replayed on the host with both of its
    steps, the popstep kernel's and the plain tensor step's, on the same
    parent each step, under the engine's rules (a stall or
    ``max_iters_per_resolution`` steps escalate); it stops at the first
    step where the two choose differently.  Returns (each step's
    best-so-far value through the kernel's steps, the same through the
    plain steps, the parting step or None): the parting step is a dict of
    the resolution, the step's number, the parent and both steps'
    results."""
    import torch

    from repro_torch.core import dgo
    from repro_torch.core.distributed import _escalate, _initial_at

    obj = problem.objective
    st, tables = dgo._engine_tables(cfg, dev)
    k_steps = dgo._fused_steps(obj, tables, None, dev)
    p_steps = dgo._fused_steps(obj, tables, "fused", dev)
    bits, val = _initial_at(obj, tables, x0, dev)
    k_val = p_val = val
    start = float(val)
    k_tr, p_tr = [], []
    k_best = p_best = start
    for r in range(tables.n_res):
        if r > 0:
            bits, val = _escalate(obj.fn, tables, bits, r - 1, r)
            k_val = p_val = val
            # a re-encode counts where it beats the best, as in the engine
            v = float(val)
            k_best = v if v < k_best else k_best
            p_best = v if v < p_best else p_best
        for it in range(st.max_iters):
            kb, kv, ki = k_steps[r](bits, k_val, it)
            pb, pv, pi = p_steps[r](bits, p_val, it)
            if bool(ki) != bool(pi) or not torch.equal(kb, pb):
                return k_tr, p_tr, dict(
                    r=r, step=len(k_tr) + 1, bits=bits, k_val=k_val,
                    p_val=p_val, kernel=(kb, kv, bool(ki)),
                    plain=(pb, pv, bool(pi)))
            bits, k_val, p_val = kb, kv, pv
            k_best = float(kv) if float(kv) < k_best else k_best
            p_best = float(pv) if float(pv) < p_best else p_best
            k_tr.append(np.float32(k_best))
            p_tr.append(np.float32(p_best))
            if not bool(ki):
                break
    return k_tr, p_tr, None


def _choice(pat, parent, new_bits, improved):
    """The child id a step took (XOR pattern of its new bits), or None
    where it kept the parent."""
    import torch

    if not improved:
        return None
    diff = torch.bitwise_xor(new_bits, parent)
    return int(torch.nonzero((pat == diff).all(1))[0, 0])


def judge_parting(name, problem, cfg, part, dev) -> tuple[bool, str]:
    """The step where the kernel's and the plain step's runs part: every
    child's value at that parent through the kernel and through the plain
    version must agree within :func:`value_bar` (phase 2's ``atol``), and
    each step's choice (a child, or the parent kept) must be valued the
    same by both within the bar (``ATOL``), so that the two choices are a
    near-tie.  Returns (ok, what was seen)."""
    import torch

    from repro_torch.core import dgo
    from repro_torch.core.population import table_on
    from repro_torch.kernels.popstep import ops

    _, tables = dgo._engine_tables(cfg, dev)
    enc = tables.encodings[part["r"]]
    obj, bits = problem.objective, part["bits"]
    ids = torch.arange(enc.population, device=dev)
    if dev.type == "cuda":
        step = ops.prepare_step_ids(obj, ids, enc)
        step(bits)
        k_vals = step.values
    else:
        k_vals = ops.child_values(obj, bits, ids, enc)
    p_vals = ops.child_values_plain(obj, bits, ids, enc)
    k_np, p_np = (k_vals.double().cpu().numpy(),
                  p_vals.double().cpu().numpy())
    atol = long_sum_atol(name, enc)[0]
    fin = np.isfinite(p_np)
    same_fin = np.array_equal(fin, np.isfinite(k_np))
    err = np.abs(k_np[fin] - p_np[fin])
    worst = float((err / value_bar(name, enc, p_np[fin], atol)).max()) \
        if fin.any() else 0.0
    pat = table_on("patterns", enc.n_bits, dev)
    seen, ok = [], same_fin and worst <= 1.0
    for who, (nb, _, imp) in (("kernel", part["kernel"]),
                              ("plain", part["plain"])):
        c = _choice(pat, bits, nb, imp)
        kv = float(part["k_val"]) if c is None else float(k_np[c])
        pv = float(part["p_val"]) if c is None else float(p_np[c])
        bar = float(value_bar(name, enc, pv))
        ok = ok and abs(kv - pv) <= bar
        seen.append((who, "parent kept" if c is None else f"child {c}", kv,
                     pv, bar))
    (_, _, _, pv_k, bar_k), (_, _, _, pv_p, bar_p) = seen
    ok = ok and abs(pv_k - pv_p) <= bar_k + bar_p
    note = (f"part at step {part['step']} ({enc.bits} bits): " + "; ".join(
        f"{who} took {c} (kernel {kv!r}, plain {pv!r}, bar {bar:.3g})"
        for who, c, kv, pv, bar in seen)
        + f"; all {enc.population} children within the bar (worst "
        f"{worst:.3g} of it{'' if same_fin else ', NON-FINITE MISMATCH'})")
    return ok, note


def schedule_runs_match(name, problem, cfg, x0, trace_k, trace_p,
                        dev) -> tuple[bool, str]:
    """Two fused runs of ``problem`` from ``x0``, through the popstep
    kernel (``trace_k``) and through the plain tensor step (``trace_p``),
    agree when both traces equal the host replay's step for step
    (:func:`replay_schedule`), to the end when the replay never parts,
    else up to the parting step, which must be a near-tie
    (:func:`judge_parting`).  Returns (ok, what was seen)."""
    k_tr, p_tr, part = replay_schedule(problem, cfg, x0, dev)
    n = len(k_tr)
    trace_k = np.asarray(trace_k, np.float32)
    trace_p = np.asarray(trace_p, np.float32)
    if part is None:
        ok = (np.array_equal(trace_k, np.asarray(k_tr, np.float32))
              and np.array_equal(trace_p, np.asarray(p_tr, np.float32)))
        return ok, (f"both runs == the host replay step for step ({n} "
                    f"steps, the same children)" if ok else
                    f"a run differs from the host replay ({len(trace_k)} "
                    f"and {len(trace_p)} steps vs {n})")
    same = (len(trace_k) >= n and len(trace_p) >= n
            and np.array_equal(trace_k[:n], np.asarray(k_tr, np.float32))
            and np.array_equal(trace_p[:n], np.asarray(p_tr, np.float32)))
    if not same:
        return False, (f"a run differs from the host replay before its "
                       f"parting step {n + 1}")
    ok, note = judge_parting(name, problem, cfg, part, dev)
    return ok, (f"the same children for {n} steps, then a {note}; "
                f"{len(trace_k)} vs {len(trace_p)} steps in all, best "
                f"{float(trace_k[-1])!r} vs {float(trace_p[-1])!r}")


def _report(label, res, wall, counts, n_res, steps=None) -> int:
    """Print a counted schedule solve and hold its counts: one launch a
    bound-step call, no fold launch, between ``steps`` (the steps taken:
    ``iterations`` unless given) and ``steps + STALL_CHECK_EVERY x
    resolutions`` launches (steps after a stall are predicated no-ops
    until the host reads the flag)."""
    from repro_torch.core.distributed import STALL_CHECK_EVERY

    n, n_fold, n_steps = counts
    it = res.iterations if steps is None else steps
    print(f"[schedule] {label}: {it} iterations, best_f "
          f"{float(res.best_f):.7g}, wall {wall:.4f} s, {n_steps} bound-"
          f"step calls, launches: popstep {n}, fold alone {n_fold}; wall "
          f"per step {wall / max(n, 1) * 1e3:.4f} ms per launch, "
          f"{wall / max(it, 1) * 1e3:.4f} ms per iteration")
    check(n > 0, f"{label}: the popstep kernel was never launched")
    check(n == n_steps, f"{label}: {n} launches for {n_steps} step calls")
    check(n_fold == 0, f"{label}: the fold was launched alone {n_fold} "
                       f"times")
    check(it <= n <= it + STALL_CHECK_EVERY * n_res,
          f"{label}: {n} launches for {it} iterations over {n_res} "
          f"resolutions")
    check(res.extras["finite"] and np.isfinite(float(res.best_f)),
          f"{label}: non-finite result")
    return n


def phase_schedule(dev) -> dict:
    """The resolution schedule on the card: Fused and the folded
    Distributed engine on the remote-sensing MLP at full width, Clustered
    and Sequential on rastrigin n=9.  Returns each path's (launches, fold
    launches)."""
    from repro_torch.core import dgo, prng
    from repro_torch.core.solver import (Clustered, Distributed, Fused,
                                         Problem, Sequential)

    name, kw = SCHED_PROBLEM
    rs = Problem.get(name, **kw)
    enc = rs.encoding
    x0 = np.random.default_rng(2).uniform(enc.lo, enc.hi,
                                          enc.n_vars).astype(np.float32)
    counts = {}

    # Fused: the default schedule, 4 -> 16 bits in 7 resolutions
    fused = Fused()
    cfg = fused._config(rs, SCHED_ITERS, None, 2)
    n_res = len(cfg.resolutions())
    res_f, wall_f, n_f = _counted_solve(rs, fused, x0, SCHED_ITERS, dev)
    label = f"{name} fused {enc.bits}->{cfg.max_bits} bits"
    _report(label, res_f, wall_f, n_f, n_res)
    counts[f"schedule: {label}"] = n_f[:2]
    check(res_f.trace.shape == (res_f.iterations,)
          and tuple(res_f.best_x.shape) == (enc.n_vars,)
          and bool(res_f.best_x.isfinite().all()),
          f"{label}: trace {res_f.trace.shape}, best_x "
          f"{tuple(res_f.best_x.shape)}")
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    plain = dgo._fused_result(rs.objective, cfg, x0=x0,
                              device=None if on_card else dev, inner="fused")
    if on_card:
        import torch
        torch.cuda.synchronize(dev)
    wall_p = time.perf_counter() - t0
    print(f"[schedule] {label} through the plain tensor step: "
          f"{plain.iterations} iterations, best_f {float(plain.value):.7g}, "
          f"wall {wall_p:.3f} s")
    ok, note = schedule_runs_match(name, rs, cfg, x0, res_f.trace,
                                   plain.trace, dev)
    print(f"[schedule] {label} kernel vs plain runs: {note}")
    check(ok, f"{label}: the kernel's and the plain step's runs part "
              f"beyond a near-tie: {note}")
    res_w, wall_w = _solve_timed(rs, fused, x0, SCHED_ITERS, dev)
    check(np.array_equal(res_w.trace, res_f.trace),
          f"{label}: a repeated solve gave another trace")
    print(f"[schedule] {label} repeated: wall {wall_w:.4f} s, "
          f"{wall_w / max(res_w.iterations, 1) * 1e3:.4f} ms per iteration")
    if on_card:
        solved = []
        prof, _ = profiled(lambda: solved.append(_solve_timed(
            rs, fused, x0, SCHED_ITERS, dev)), "popstep_kernel", cpu=False)
        res_prof, wall_prof = solved[-1]
        busy_us, n_acts = _device_activity(prof)
        step_us, n_step_dev = _device_activity(prof, "popstep_kernel")
        _, n_fold_dev = _device_activity(prof, "popstep_fold")
        print(f"[schedule] {label} repeated under the profiler: popstep "
              f"{step_us / 1e3 / max(n_step_dev, 1):.4f} ms a launch on "
              f"average ({step_us / max(busy_us, 1e-9):.3f} of the device "
              f"time)")
        print(f"[schedule] {label} repeated under the profiler: wall "
              f"{wall_prof:.4f} s, device busy {busy_us / 1e6:.4f} s, idle "
              f"share {1 - busy_us / 1e6 / wall_prof:.3f}, {n_acts} device "
              f"activities ({n_acts / max(res_prof.iterations, 1):.1f} per "
              f"iteration, {n_acts / max(n_step_dev, 1):.1f} per launch); "
              f"recorded launches: popstep_kernel {n_step_dev}, "
              f"popstep_fold_kernel {n_fold_dev}")
        check(n_step_dev > 0, "the profiler recorded no popstep_kernel "
                              "launch in the repeated fused solve")
        check(n_fold_dev == 0, f"the repeated fused solve launched "
                               f"popstep_fold_kernel {n_fold_dev} times")

    # the folded Distributed engine, 4 -> 8 bits, against host chaining
    top = enc.bits + FOLDED_EXTRA_BITS
    folded = Distributed(max_bits=top)
    res_d, wall_d, n_d = _counted_solve(rs, folded, x0, SCHED_ITERS, dev)
    label = f"{name} distributed folded {enc.bits}->{top} bits"
    _report(label, res_d, wall_d, n_d, len(res_d.extras["schedule"]))
    counts[f"schedule: {label}"] = n_d[:2]
    res_h, wall_h = _solve_timed(
        rs, Distributed(max_bits=top, driver="host"), x0,
        SCHED_ITERS, dev)
    check(res_d.extras["history"] == res_h.extras["history"],
          f"{label}: the folded history differs from host chaining")
    check(res_d.extras["bits_resolution"] == res_h.extras["bits_resolution"]
          and float(res_d.best_f) == float(res_h.best_f),
          f"{label}: best ({float(res_d.best_f)}, "
          f"{res_d.extras['bits_resolution']}) vs host chaining "
          f"({float(res_h.best_f)}, {res_h.extras['bits_resolution']})")
    print(f"[schedule] {label}: history == host chaining step for step "
          f"({len(res_h.extras['history']) - 1} steps, host-chained wall "
          f"{wall_h:.4f} s)")

    # Clustered: 8 starts, against 8 Fused runs from the same starts
    name, kw = CLUSTER_PROBLEM
    rast = Problem.get(name, **kw)
    starts = rast.random_x0(prng.PRNGKey(0), batch=N_CLUSTERS)
    clustered = Clustered(n_clusters=N_CLUSTERS)
    res_c, wall_c, n_c = _counted_solve(rast, clustered, starts, None, dev)
    singles = [_solve_timed(rast, Fused(), starts[c], None, dev)[0]
               for c in range(N_CLUSTERS)]
    cfg_c = clustered._config(rast, None, None, 2)
    label = f"{name} {kw} clustered x{N_CLUSTERS}"
    # the clusters run one after another: their steps add up
    _report(label, res_c, wall_c, n_c, N_CLUSTERS * len(cfg_c.resolutions()),
            steps=sum(r.iterations for r in singles))
    counts[f"schedule: {label}"] = n_c[:2]
    best = min(float(r.best_f) for r in singles)
    evals = sum(r.extras["evaluations"] for r in singles)
    check(float(res_c.best_f) == best,
          f"{label}: winner {float(res_c.best_f)!r} vs best of the fused "
          f"runs {best!r}")
    check(res_c.extras["evaluations"] == evals,
          f"{label}: {res_c.extras['evaluations']} evaluations vs "
          f"{evals} in the fused runs")
    print(f"[schedule] {label}: winner {res_c.extras['winner']} "
          f"{float(res_c.best_f):.7g} == best of {N_CLUSTERS} fused runs; "
          f"{evals} evaluations == their sum")

    # Sequential (the numpy loop, one point at a time) against Fused
    seq = Sequential(max_total_iters=SEQ_TOTAL_ITERS)
    res_s, wall_s = _solve_timed(rast, seq, starts[0], None, dev)
    fin = float(singles[0].best_f)
    print(f"[schedule] {label.split(' clustered')[0]} sequential: "
          f"{res_s.iterations} iterations, {res_s.extras['evaluations']} "
          f"evaluations, best_f {float(res_s.best_f):.7g}, wall "
          f"{wall_s:.3f} s ({wall_s / max(res_s.iterations, 1) * 1e3:.3f} "
          f"ms per iteration); fused from the same start {fin:.7g}")
    check(res_s.iterations < SEQ_TOTAL_ITERS,
          f"sequential ran into its guard of {SEQ_TOTAL_ITERS} iterations")
    check(abs(float(res_s.best_f) - fin) < STRATEGY_SPREAD,
          f"sequential {float(res_s.best_f)!r} vs fused {fin!r}: beyond "
          f"the strategy-parity spread {STRATEGY_SPREAD}")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the packed-word kernels
# ---------------------------------------------------------------------------

# the listed shapes, and the packed main path's own: N = 144, (9 vars,
# 16 bits) and P = 287 (rastrigin n=9 at 16 bits), N = 2,720, (680, 4) and
# P = 5,439 (remote_sensing).  graycode: even and odd W (1,100: W = 35),
# 12,100 (W = 379: a warp's lanes walk a span's word pairs more than once),
# and a subset of the children (first, last, random; an odd count) at
# GRAY_LIMIT_N, odd W = 12,287 and a partial last word, next to the
# kernel's shared-memory budget (ops.MAX_SMEM, 12,288 words).
# fixedpoint: widths dividing 32 at 9 vars, whose output rows start off
# 16-byte boundaries, straddling fields at 7 and 6 bits, rows of 1, 127,
# 128 and 129 vars around a block's step of 128 points (its walk's carry
# into the next row), and FIX_POPS: (n_vars, bits, P) at populations past
# one wave of the card's blocks whose words are staged (9 x 16 bits: runs
# of 2,275 words, odd, so every other block starts 8 bytes off a 16-byte
# boundary), and with rows longer than the kernel stages (12,288 words:
# read in place).
GRAY_NS = (9, 32, 63, 100, 128, 144, 257, 680, 1100, 2720, 12100)
GRAY_LIMIT_N, GRAY_LIMIT_K = 393_180, 255
FIX_SHAPES = ((2, 8), (9, 7), (8, 6), (680, 4), (3, 16), (9, 16), (5, 32),
              (9, 1), (9, 2), (9, 4), (9, 8), (9, 32), (1, 7), (127, 3),
              (128, 2), (129, 1))
FIX_POPS = ((9, 16, 1_000_000), (9, 7, 1_000_000), (680, 4, 20_000),
            (13_000, 32, 9), (60_000, 7, 9))
# popmin: P = 1..9 (less than one 16-byte load), the packed main path's
# 287 and 5,439, 512 +1 and 8,192 +1 (the one block widens past them), the
# one-block launch's limit +-1 (ops.ONE_BLOCK_MAX, added in check_popmin),
# 2^20, and 2^24 (64 MB, past the L2); views v[k:] for k = 1..3 at
# POPMIN_VIEW_PS
POPMIN_PS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 17, 125, 287, 512, 513, 1000, 4096,
             5439, 8192, 8193, 10000, 2**20, 2**24)
POPMIN_VIEW_PS = (5439, 2**20)
POPMIN_TIME_PS = (287, 5439, 2**20, 2**24)
POPMIN_FOLD_KS = (1, 6, 10, 1024)   # crafted partials; 1,024: more than
#                                     the grid launch's blocks
PACKED_STEPS = 4        # DGO steps of the packed main path per problem


def _bits_on(rng, shape, dev):
    import torch

    return torch.as_tensor(rng.integers(0, 2, shape).astype(np.int8),
                           device=dev)


def _max_abs(a, b) -> float:
    """Largest |a - b| over two equal-shaped tensors, as float64."""
    return float((a.double() - b.double()).abs().max())


def check_graycode(rng, dev) -> float:
    """The graycode kernel vs its plain version and the unpacked oracle,
    bitwise, at every N of ``GRAY_NS``, and on ``GRAY_LIMIT_K`` of the
    children at ``GRAY_LIMIT_N``."""
    import torch

    from repro_torch.core.population import table_on
    from repro_torch.kernels.graycode import ops, ref

    err = 0.0
    for n in GRAY_NS:
        parent = _bits_on(rng, n, dev)
        got = ops.generate_population_packed(parent)
        table = table_on("table", n, dev)
        plain = ops.graycode_children_plain(parent, table[:, 0], table[:, 1])
        oracle = ref.graycode_children_ref(
            parent, torch.arange(2 * n - 1, device=dev), (n + 31) // 32)
        check(got.shape == plain.shape and torch.equal(got, plain),
              f"graycode N={n}: kernel differs from the plain version")
        check(torch.equal(got, oracle), f"graycode N={n}: kernel differs "
                                        f"from the unpacked oracle")
        err = max(err, _max_abs(got, plain))
        print(f"[packed] graycode   N={n:<5} {tuple(got.shape)} words == "
              f"plain == oracle, bitwise")
    n, k = GRAY_LIMIT_N, GRAY_LIMIT_K
    parent = _bits_on(rng, n, dev)
    ids = torch.as_tensor(np.concatenate([
        np.arange(64), np.arange(2 * n - 65, 2 * n - 1),
        rng.choice(np.arange(64, 2 * n - 65), k - 128, replace=False)]),
        device=dev)
    table = table_on("table", n, dev)[ids]
    got = ops.graycode_children(parent, table[:, 0], table[:, 1])
    plain = ops.graycode_children_plain(parent, table[:, 0], table[:, 1])
    oracle = ref.graycode_children_ref(parent, ids, (n + 31) // 32)
    check(torch.equal(got, plain) and torch.equal(got, oracle),
          f"graycode N={n}, {k} children: kernel differs from the plain "
          f"version or the oracle")
    err = max(err, _max_abs(got, plain))
    print(f"[packed] graycode   N={n} {k} of its children "
          f"{tuple(got.shape)} words == plain == oracle, bitwise")
    return err


def check_fixedpoint(rng, dev) -> float:
    """The fixedpoint kernel vs its plain version and the unpacked
    oracle, bitwise, at the shapes of ``FIX_SHAPES`` on [-3, 7], at the
    remote-sensing encoding and at the populations of ``FIX_POPS``."""
    import torch

    from repro_torch.core.encoding import Encoding, pack_bits
    from repro_torch.kernels.fixedpoint import ops, ref

    err = 0.0
    cases = [(Encoding(nv, b, -3.0, 7.0), None) for nv, b in FIX_SHAPES]
    cases += [(Encoding(680, 4, -4.0, 4.0), None)]
    cases += [(Encoding(nv, b, -3.0, 7.0), p) for nv, b, p in FIX_POPS]
    for enc, pop in cases:
        if pop is None:
            pop = enc.population
            words = pack_bits(_bits_on(rng, (pop, enc.n_bits), dev))
        else:   # whole random words: the bits past n_bits are ignored
            words = torch.as_tensor(rng.integers(
                0, 2**32, (pop, (enc.n_bits + 31) // 32)), device=dev)
        got = ops.decode_packed(words, enc)
        plain = ops.decode_words_plain(words, enc)
        oracle = ref.fixedpoint_decode_ref(words, enc)
        for label, want in (("plain version", plain), ("oracle", oracle)):
            check(got.shape == want.shape and torch.equal(
                got.view(torch.int32), want.view(torch.int32)),
                  f"fixedpoint {enc}: kernel differs from the {label}")
        err = max(err, _max_abs(got, plain))
        print(f"[packed] fixedpoint {enc.n_vars:>3} vars x {enc.bits:>2} "
              f"bits on [{enc.lo:g}, {enc.hi:g}], {pop} rows "
              f"== plain == oracle, bitwise")
    return err


def _popmin_cases(rng, p: int, dev) -> dict:
    """Random values, a NaN at the last index after a smaller value, all
    NaN, all +inf, a 0.0 before a -0.0 and the reverse, and a three-way
    tie."""
    import torch

    vals = torch.as_tensor(rng.standard_normal(p).astype(np.float32),
                           device=dev)
    last_nan = vals.clone()
    last_nan[p // 2] = -10.0
    last_nan[p - 1] = float("nan")
    cases = {"random": vals, "last NaN": last_nan,
             "all NaN": torch.full_like(vals, float("nan")),
             "all +inf": torch.full_like(vals, float("inf"))}
    if p > 2:
        at = [p // 3, p // 2] if p > 5 else [1, 2]
        for label, pair in (("0.0, -0.0", [0.0, -0.0]),
                            ("-0.0, 0.0", [-0.0, 0.0])):
            v = vals.abs() + 1.0
            v[at] = torch.tensor(pair, device=dev)
            cases[label] = v
        ties = vals.clone()
        ties[[p - 1, p // 2, p // 3]] = -10.0
        cases["ties"] = ties
    return cases


def check_popmin(rng, dev) -> float:
    """``population_min`` vs the plain version and the oracle, exactly,
    at every P of ``POPMIN_PS`` and at the one-block launch's
    limit +-1 (the cases of :func:`_popmin_cases`), and on views v[k:],
    k = 1..3, with the minimum first or last, at ``POPMIN_VIEW_PS``; a
    value is held with its sign (:func:`_same`).  Each call is one launch
    and no fold launch."""
    import torch

    from repro_torch.kernels.popmin import ops, ref

    def held(v, label):
        before = (ops.launches, ops.fold_launches)
        kv, ki = ops.population_min(v)
        check((ops.launches, ops.fold_launches)
              == (before[0] + 1, before[1]),
              f"popmin {label}: launches {before} -> "
              f"{(ops.launches, ops.fold_launches)}, want one launch")
        pv, pi = ops.population_min_plain(v)
        rv, ri = ref.popmin_ref(v)
        check(_same(kv, ki, pv, pi) and _same(kv, ki, rv, ri),
              f"popmin {label}: kernel ({float(kv)}, {int(ki)}) plain "
              f"({float(pv)}, {int(pi)}) oracle ({float(rv)}, {int(ri)})")
        return abs(float(kv) - float(pv)) if np.isfinite(float(kv)) else 0.0

    err = 0.0
    limit = ops.ONE_BLOCK_MAX
    for p in sorted({*POPMIN_PS, limit - 1, limit, limit + 1}):
        cases = _popmin_cases(rng, p, dev)
        for label, v in cases.items():
            err = max(err, held(v, f"P={p} {label}"))
        print(f"[packed] popmin     P={p:<8} {', '.join(cases)}: one launch,"
              f" == plain == oracle")
    for p in POPMIN_VIEW_PS:
        for k in (1, 2, 3):
            base = torch.as_tensor(rng.standard_normal(p + k).astype(
                np.float32), device=dev)
            for at in (k, p + k - 1):
                v = base.clone()
                v[at] = -10.0
                check(v[k:].data_ptr() % 16 != 0, "view is aligned")
                err = max(err, held(v[k:], f"P={p} v[{k}:] min at {at - k}"))
        print(f"[packed] popmin     P={p:<8} views v[1:], v[2:], v[3:], the "
              f"minimum first and last: == plain == oracle")
    return err


def check_popmin_fold(rng, dev) -> float:
    """The popmin fold launch on its own vs its plain rule
    (``_plain.nan_first_rows`` on the same CUDA tensors) and vs the
    oracle, exactly, on crafted partials with unordered indices: random,
    NaNs, ties, a -0.0 beside a 0.0, all +inf; at the partial counts of
    ``POPMIN_FOLD_KS``.  Each launch counts in ``ops.fold_launches``."""
    import torch

    from repro_torch.kernels._plain import nan_first_rows
    from repro_torch.kernels.popmin import ops, ref

    err = 0.0
    for k in POPMIN_FOLD_KS:
        base = rng.integers(-20, 20, k).astype(np.float32)
        rows = rng.permutation(4 * k)[:k].astype(np.int32)
        nans, ties, zeros = base.copy(), base.copy(), np.abs(base) + 1.0
        nans[[k - 1, k // 2]] = np.nan
        ties[[k // 3, 0, k - 1]] = -50.0
        zeros[[k - 1, 0]] = [-0.0, 0.0]
        cases = (("random", base), ("NaNs", nans), ("ties", ties),
                 ("-0.0 and 0.0", zeros),
                 ("all +inf", np.full(k, np.inf, np.float32)))
        order = np.argsort(rows)
        for label, v in cases:
            pv = torch.as_tensor(v, device=dev)
            pr = torch.as_tensor(rows, device=dev)
            kv, ki = ops.fold_partials(pv, pr)
            wv, wi = nan_first_rows(pv[None], pr.long()[None])
            j = int(ref.popmin_ref(torch.as_tensor(v[order]))[1])
            check(_same(kv, ki, wv[0], wi[0])
                  and _same(kv, ki, v[order][j], rows[order][j]),
                  f"popmin fold K={k} {label}: kernel ({float(kv)}, "
                  f"{int(ki)}) plain ({float(wv[0])}, {int(wi[0])}) oracle "
                  f"({float(v[order][j])}, {int(rows[order][j])})")
            if np.isfinite(float(kv)):
                err = max(err, abs(float(kv) - float(wv[0])))
        print(f"[packed] popmin fold K={k:<5} random, NaNs, ties, -0.0, "
              f"+inf; unordered indices: == plain == oracle")
    return err


def time_packed(dev, rs_enc, rs_obj) -> dict:
    """Device times (``torch.profiler``, mean of 20) of the three kernels
    and their plain versions at the remote-sensing shape; graycode and
    fixedpoint also at rastrigin n=9, 16 bits, and graycode at N = 1;
    popmin, its plain version and ``torch.min(vals, dim=0)`` (its library
    call) at every P of ``POPMIN_TIME_PS`` (5,439: the remote-sensing
    population's values), and the popmin fold alone on 1,024 partials."""
    import torch

    from repro_torch.core import objectives
    from repro_torch.core.population import table_on
    from repro_torch.kernels._plain import nan_first_rows
    from repro_torch.kernels.fixedpoint import ops as fops
    from repro_torch.kernels.graycode import ops as gops
    from repro_torch.kernels.popmin import ops as mops

    n = rs_enc.n_bits
    parent = _bits_on(np.random.default_rng(9), n, dev)
    table = table_on("table", n, dev)
    words = gops.generate_population_packed(parent)
    vals = rs_obj.fn(fops.decode_packed(words, rs_enc))
    t = dict(n_bits=n, pop=rs_enc.population, n_words=words.shape[1],
             n_vars=rs_enc.n_vars)
    t["graycode"] = device_ms(lambda: gops.generate_population_packed(
        parent), 20, dev, name="graycode_kernel")
    t["graycode_plain"] = device_ms(lambda: gops.graycode_children_plain(
        parent, table[:, 0], table[:, 1]), 20, dev)
    t["fixedpoint"] = device_ms(lambda: fops.decode_packed(words, rs_enc),
                                20, dev, name="fixedpoint_kernel")
    t["fixedpoint_plain"] = device_ms(
        lambda: fops.decode_words_plain(words, rs_enc), 20, dev)
    # the packed main path's other shape, rastrigin n=9 at 16 bits (287 x 5
    # words), and a near-empty launch: graycode at N = 1 (one word)
    r_enc = objectives.get("rastrigin", n=9).encoding.with_bits(16)
    r_parent = _bits_on(np.random.default_rng(13), r_enc.n_bits, dev)
    r_words = gops.generate_population_packed(r_parent)
    one = _bits_on(np.random.default_rng(14), 1, dev)
    t["graycode_rastrigin"] = device_ms(
        lambda: gops.generate_population_packed(r_parent), 20, dev,
        name="graycode_kernel")
    t["fixedpoint_rastrigin"] = device_ms(
        lambda: fops.decode_packed(r_words, r_enc), 20, dev,
        name="fixedpoint_kernel")
    t["graycode_empty"] = device_ms(
        lambda: gops.generate_population_packed(one), 20, dev,
        name="graycode_kernel")
    rng = np.random.default_rng(10)
    for p in POPMIN_TIME_PS:
        v = vals if p == t["pop"] else torch.as_tensor(
            rng.standard_normal(p).astype(np.float32), device=dev)
        t[f"popmin_{p}"] = device_ms(lambda: mops.population_min(v), 20,
                                     dev, name="popmin_kernel")
        t[f"popmin_plain_{p}"] = device_ms(
            lambda: mops.population_min_plain(v), 20, dev)
        t[f"popmin_library_{p}"] = device_ms(lambda: torch.min(v, dim=0),
                                             20, dev)
        print(f"[time] popmin P={p}: {t[f'popmin_{p}']:.4f} ms (plain "
              f"{t[f'popmin_plain_{p}']:.4f}, torch.min "
              f"{t[f'popmin_library_{p}']:.4f}); device time, mean of 20")
    for key in ("", "_plain", "_library"):
        t["popmin" + key] = t[f"popmin{key}_{t['pop']}"]
    k = POPMIN_FOLD_KS[-1]
    fold_args = (torch.as_tensor(rng.standard_normal(k).astype(np.float32),
                                 device=dev),
                 torch.arange(k, dtype=torch.int32, device=dev))
    t["popmin_parts"] = k
    t["popmin_fold"] = device_ms(lambda: mops.fold_partials(*fold_args), 20,
                                 dev, name="popmin_fold")
    t["popmin_fold_plain"] = device_ms(lambda: nan_first_rows(
        fold_args[0][None], fold_args[1].long()[None]), 20, dev)
    print(f"[time] remote-sensing shape ({t['pop']} children x "
          f"{t['n_words']} words, {t['n_vars']} vars): graycode "
          f"{t['graycode']:.4f} ms (plain {t['graycode_plain']:.4f}); "
          f"fixedpoint {t['fixedpoint']:.4f} ms (plain "
          f"{t['fixedpoint_plain']:.4f}); popmin fold alone on {k} "
          f"partials {t['popmin_fold']:.4f} ms (plain "
          f"{t['popmin_fold_plain']:.4f}); device time, mean of 20")
    print(f"[time] rastrigin n=9 16 bits ({r_enc.population} children x "
          f"{r_words.shape[1]} words): graycode "
          f"{t['graycode_rastrigin']:.4f} ms, fixedpoint "
          f"{t['fixedpoint_rastrigin']:.4f} ms; graycode at N=1 (a "
          f"near-empty launch) {t['graycode_empty']:.4f} ms; device time, "
          f"mean of 20")
    return t


def packed_step(obj, enc, parent):
    """One DGO population step through the packed-word entry points:
    generate -> decode -> the objective -> (min, argmin).  Returns (the
    children's words, their points, their values, min, argmin)."""
    from repro_torch.kernels.fixedpoint.ops import decode_packed
    from repro_torch.kernels.graycode.ops import generate_population_packed
    from repro_torch.kernels.popmin.ops import population_min

    words = generate_population_packed(parent)
    points = decode_packed(words, enc)
    vals = obj.fn(points)
    best, idx = population_min(vals)
    return words, points, vals, best, idx


def _packed_counts() -> dict:
    from repro_torch.kernels.fixedpoint import ops as fops
    from repro_torch.kernels.graycode import ops as gops
    from repro_torch.kernels.popmin import ops as mops

    return {"graycode": gops.launches, "fixedpoint": fops.launches,
            "popmin": mops.launches, "popmin_fold": mops.fold_launches}


def _zero_packed_counts() -> None:
    from repro_torch.kernels.fixedpoint import ops as fops
    from repro_torch.kernels.graycode import ops as gops
    from repro_torch.kernels.popmin import ops as mops

    gops.launches = fops.launches = mops.launches = mops.fold_launches = 0


def phase_packed_main(dev) -> dict:
    """The packed path's main run: ``PACKED_STEPS`` DGO steps (move to the
    best child while it improves) at remote_sensing and at rastrigin n=9,
    16 bits, with the four launch counts set to 0 just before and read
    just after.  Then every step's three kernel outputs are held against
    the plain versions and the oracles on the same inputs (bitwise;
    exactly for the (min, argmin)), and its result against popstep's
    ``population_step_ids`` on the same parent, one run over all
    children: same id (or a near-tie), values within the bar.  Returns
    the counts and each kernel's largest error over the steps."""
    import torch

    from repro_torch.core import objectives
    from repro_torch.core.encoding import decode, unpack_bits
    from repro_torch.core.population import table_on
    from repro_torch.kernels.fixedpoint import ops as fops
    from repro_torch.kernels.fixedpoint import ref as fref
    from repro_torch.kernels.graycode import ops as gops
    from repro_torch.kernels.graycode import ref as gref
    from repro_torch.kernels.popmin import ops as mops
    from repro_torch.kernels.popmin import ref as mref
    from repro_torch.kernels.popstep import ops as sops

    rast = objectives.get("rastrigin", n=9)
    rs = objectives.get("remote_sensing")
    problems = (("remote_sensing", rs, rs.encoding),
                ("rastrigin n=9 16 bits", rast, rast.encoding.with_bits(16)))
    rng = np.random.default_rng(12)
    parents = [_bits_on(rng, enc.n_bits, dev) for _, _, enc in problems]

    _zero_packed_counts()
    runs = []
    for (label, obj, enc), parent in zip(problems, parents):
        val = float(obj.fn(decode(parent, enc)[None])[0])
        steps = []
        for _ in range(PACKED_STEPS):
            words, points, vals, best, idx = packed_step(obj, enc, parent)
            steps.append((parent, words, points, vals, float(best),
                          int(idx)))
            if not float(best) < val:
                break
            parent = unpack_bits(words[int(idx)], enc.n_bits)
            val = float(best)
        runs.append((label, obj, enc, steps, val))
    counts = _packed_counts()

    errs = dict.fromkeys(("graycode", "fixedpoint", "popmin"), 0.0)
    for label, obj, enc, steps, val in runs:
        ids = torch.arange(enc.population, device=dev)
        table = table_on("table", enc.n_bits, dev)
        for k, (parent, words, points, vals, best, idx) in enumerate(steps):
            check(tuple(vals.shape) == (enc.population,)
                  and bool(vals.isfinite().all()),
                  f"packed {label} step {k}: values {tuple(vals.shape)}")
            g_plain = gops.graycode_children_plain(parent, table[:, 0],
                                                   table[:, 1])
            g_oracle = gref.graycode_children_ref(parent, ids, words.shape[1])
            for what, want in (("plain version", g_plain),
                               ("oracle", g_oracle)):
                check(words.shape == want.shape and torch.equal(words, want),
                      f"packed {label} step {k}: graycode words differ from "
                      f"the {what}")
            f_plain = fops.decode_words_plain(words, enc)
            f_oracle = fref.fixedpoint_decode_ref(words, enc)
            for what, want in (("plain version", f_plain),
                               ("oracle", f_oracle)):
                check(points.shape == want.shape and torch.equal(
                    points.view(torch.int32), want.view(torch.int32)),
                      f"packed {label} step {k}: fixedpoint points differ "
                      f"from the {what}")
            pv, pi = mops.population_min_plain(vals)
            rv, ri = mref.popmin_ref(vals)
            check(_same(best, idx, pv, pi) and _same(best, idx, rv, ri),
                  f"packed {label} step {k}: popmin ({best!r}, {idx}) plain "
                  f"({float(pv)!r}, {int(pi)}) oracle ({float(rv)!r}, "
                  f"{int(ri)})")
            errs["graycode"] = max(errs["graycode"], _max_abs(words, g_plain))
            errs["fixedpoint"] = max(errs["fixedpoint"],
                                     _max_abs(points, f_plain))
            errs["popmin"] = max(errs["popmin"], abs(best - float(pv)))
            sv, si = sops.population_step_ids(obj, parent, ids, enc)
            sv, si = float(sv), int(si)
            check(np.isclose(best, sv, rtol=RTOL, atol=ATOL),
                  f"packed {label} step {k}: ({best!r}, {idx}) vs popstep "
                  f"({sv!r}, {si})")
            if idx != si:   # a near-tie: both winners within the bar
                a, b = float(vals[idx]), float(vals[si])
                check(np.isclose(a, b, rtol=RTOL, atol=ATOL),
                      f"packed {label} step {k}: id {idx} ({a!r}) vs "
                      f"popstep id {si} ({b!r}) is not a near-tie")
            print(f"[packed] main {label:<22} step {k}: ({best:.7g}, {idx})"
                  f" popstep ({sv:.7g}, {si}); words, points and (min, "
                  f"argmin) == plain == oracle")
        print(f"[packed] main {label}: {len(steps)} steps, best {val:.7g}")
    print(f"[packed] main launches: {counts}")
    steps_run = sum(len(r[3]) for r in runs)
    # one launch of each kernel a step; popmin's fold runs inside its launch
    want = dict.fromkeys(("graycode", "fixedpoint", "popmin"), steps_run)
    check(steps_run > 0 and counts == {**want, "popmin_fold": 0},
          f"packed main path: {steps_run} steps but launches {counts}")

    rs_parent = parents[0]
    step_ms = device_ms(lambda: packed_step(rs, rs.encoding, rs_parent), 20,
                        dev)
    print(f"[time] packed step at remote_sensing (three kernels and the "
          f"plain objective): {step_ms:.4f} ms device time, mean of 20")
    return counts, errs


def packed_bounds(t: dict) -> dict:
    """(bound ms, bound by) of each packed kernel at the shapes it was
    timed at: bytes (each input read once, each output written once;
    int64 words) over the memory rate vs operations over the float32
    peak (the integer work counted as one operation per output word)."""
    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_PEAK_FLOPS * 1e3
        return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")

    pop, w, nv = t["pop"], t["n_words"], t["n_vars"]
    return {
        # parent bits, two int32 segment bounds per child; the words out
        "graycode": bound(t["n_bits"] + pop * 8 + pop * w * 8, pop * w),
        # the words in, the float32 points out; a multiply and an add each
        "fixedpoint": bound(pop * w * 8 + pop * nv * 4, 2 * pop * nv),
        # the values in, (min, argmin) out; one comparison per value
        **{f"popmin_{p}": bound(p * 4 + 8, p) for p in POPMIN_TIME_PS},
        "popmin": bound(pop * 4 + 8, pop),
        # the partials in, (min, argmin) out
        "popmin_fold": bound(t["popmin_parts"] * 8 + 8, t["popmin_parts"]),
    }


def phase_packed(dev) -> tuple[dict, dict, dict]:
    """Phase 5: every packed kernel vs its plain version, their times at
    the remote-sensing shape, then their main path."""
    from repro_torch.core import objectives

    rng = np.random.default_rng(8)
    errs = {"graycode": check_graycode(rng, dev),
            "fixedpoint": check_fixedpoint(rng, dev),
            "popmin": check_popmin(rng, dev),
            "popmin_fold": check_popmin_fold(rng, dev)}
    rs = objectives.get("remote_sensing")
    t = time_packed(dev, rs.encoding, rs)
    bounds = packed_bounds(t)
    for name, (ms, by) in bounds.items():
        print(f"[packed] bound {name}: {ms * 1e3:.4f} us ({by})")
    counts, main_errs = phase_packed_main(dev)
    for name, err in main_errs.items():
        errs[name] = max(errs[name], err)
    return errs, t, dict(bounds=bounds, counts=counts)


# ---------------------------------------------------------------------------
# phase 6: flash attention
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # tests/test_kernels.py:65
# (B, S, Hq, Hkv, hd, causal): the cases of tests/test_kernels.py:49-55;
# S = 100 and 160 without the causal mask (not tile multiples); hd 16 at
# S = 200; window 64 with MQA at full head width; the serving shape (the
# main path's).  Each runs in float32 (the CUDA-core kernel) and in
# bfloat16 (the tensor-core kernel), so every head dim, ragged S, the
# window and MQA pass through both.
_FLASH_SHAPES = (
    (2, 128, 4, 4, 32, True, 0),
    (1, 256, 8, 2, 64, True, 0),
    (2, 192, 4, 1, 32, True, 64),
    (1, 128, 4, 4, 32, False, 0),
    (1, 256, 4, 2, 64, True, 0),
    (1, 100, 4, 2, 32, False, 0),
    (1, 160, 4, 2, 32, False, 0),
    (2, 200, 4, 2, 16, True, 0),
    (2, 300, 12, 1, 128, True, 64),
    (4, 1024, 12, 2, 128, True, 0),
)
FLASH_CASES = tuple(c + (dt,) for dt in ("float32", "bfloat16")
                    for c in _FLASH_SHAPES)
FLASH_KERNELS = {"float32": "flash_attention_f32_kernel",
                 "bfloat16": "flash_attention_bf16_kernel"}
FLASH_PEAKS = {"float32": FP32_PEAK_FLOPS, "bfloat16": BF16_PEAK_FLOPS}
SERVE_SHAPE = (4, 1024, 12, 2, 128)         # B, S, Hq, Hkv, hd
LONG_SHAPE = (1, 32768, 12, 2, 128)         # prefill_32k at batch 1


def _qkv(shape, dtype, dev, seed):
    import torch

    b, s, hq, hkv, hd = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, h, hd, generator=g, device=dev).to(dtype)
                 for h in (hq, hkv, hkv))


def _flash_oracle(q, k, v, causal, window):
    from repro_torch.kernels.flash_attention import ref

    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)


def flash_bound_ms(shape, causal, window, elem_bytes,
                   peak) -> tuple[float, str]:
    """Least time of one launch: 4 * hd FLOPs (q.k and p.v) for every
    (query, key) pair the mask keeps, per head, over ``peak`` (FLOP/s of
    the units the kernel runs on), vs q, k, v read once and o written
    once over the memory rate."""
    b, s, hq, hkv, hd = shape
    qp = np.arange(s)
    hi = qp + 1 if causal else np.full(s, s)
    lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros(s, int)
    pairs = int((hi - lo).sum())
    t_ops = 4 * b * hq * hd * pairs / peak * 1e3
    t_bytes = (2 * b * s * (hq + hkv) * hd * elem_bytes
               / HBM_BYTES_PER_S * 1e3)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(q, k, v, causal, window, tol, label) -> float:
    """Kernel vs its plain version and vs ref.py on the same CUDA tensors;
    returns the largest |kernel - plain|."""
    from repro_torch.kernels.flash_attention import ops

    got = ops.flash_sdpa(q, k, v, causal=causal, window=window)
    plain = ops.flash_sdpa_plain(q, k, v, scale=q.shape[-1] ** -0.5,
                                 causal=causal, window=window)
    oracle = _flash_oracle(q, k, v, causal, window)
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"flash {label}: output {tuple(got.shape)} {got.dtype}")
    e_plain, e_ref = _max_abs(got, plain), _max_abs(got, oracle)
    check(e_plain <= tol and e_ref <= tol,
          f"flash {label}: |kernel - plain| {e_plain:.3g}, |kernel - ref| "
          f"{e_ref:.3g} (bar {tol:g})")
    print(f"[flash] {label}: |kernel - plain| {e_plain:.3g}, |kernel - ref| "
          f"{e_ref:.3g} (bar {tol:g})")
    return e_plain


def phase_flash(dev) -> dict:
    """Phase 6: the flash-attention kernels vs their plain version and
    ref.py at every case of ``FLASH_CASES``, then device times
    (torch.profiler) of each kernel at the serving shape and at
    S = 32,768 beside its bound, ``scaled_dot_product_attention`` as the
    library call and, at the serving shape, the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    t = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0}
    for i, (b, s, hq, hkv, hd, causal, window, dt) in enumerate(FLASH_CASES):
        q, k, v = _qkv((b, s, hq, hkv, hd), getattr(torch, dt), dev, 20 + i)
        label = (f"B={b} S={s} Hq={hq} Hkv={hkv} hd={hd} "
                 f"{'causal' if causal else 'bidirectional'} window={window}"
                 f" {dt}")
        key = "max_abs_err" + ("_bf16" if dt == "bfloat16" else "")
        t[key] = max(t[key], check_flash(q, k, v, causal, window,
                                         FLASH_TOL[dt], label))

    f32, bf16 = FLASH_KERNELS["float32"], FLASH_KERNELS["bfloat16"]
    for key, shape, reps in (("serve", SERVE_SHAPE, 20),
                             ("long", LONG_SHAPE, 3)):
        q, k, v = _qkv(shape, torch.float32, dev, 40)
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        t[key] = device_ms(lambda: ops.flash_sdpa(q, k, v), reps, dev, f32)
        t[key + "_events"] = time_ms(lambda: ops.flash_sdpa(q, k, v), reps,
                                     dev)
        t[key + "_bf16"] = device_ms(lambda: ops.flash_sdpa(qb, kb, vb), reps,
                                     dev, bf16)
        t[key + "_bf16_events"] = time_ms(lambda: ops.flash_sdpa(qb, kb, vb),
                                          reps, dev)
        qt, kt, vt = (x.transpose(1, 2) for x in (qb, kb, vb))
        t[key + "_sdpa_bf16"] = device_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps, dev)
        # float32 with enable_gqa has only PyTorch's unfused math backend,
        # which would hold the (S, S) scores (51.5 GB at S = 32,768); the
        # fused float32 backend wants K/V heads expanded to Hq, done here
        # once, outside the timing
        g = shape[2] // shape[3]
        qt, ke, ve = (q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(
            g, 1), v.transpose(1, 2).repeat_interleave(g, 1))
        t[key + "_sdpa_f32_expanded"] = device_ms(
            lambda: F.scaled_dot_product_attention(qt, ke, ve, is_causal=True),
            reps, dev)
        if key == "serve":
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            t["serve_sdpa_f32"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), reps, dev)
            t["serve_plain"] = device_ms(lambda: ops.flash_sdpa_plain(
                q, k, v, scale=shape[4] ** -0.5, causal=True), 5, dev)
            t["serve_plain_bf16"] = device_ms(lambda: ops.flash_sdpa_plain(
                qb, kb, vb, scale=shape[4] ** -0.5, causal=True), 5, dev)
        for suffix, dt, nbytes in (("", "float32", 4), ("_bf16", "bfloat16",
                                                        2)):
            bound, by = flash_bound_ms(shape, True, 0, nbytes,
                                       FLASH_PEAKS[dt])
            t[key + suffix + "_bound"] = bound
            t[key + suffix + "_bound_by"] = by
        del q, k, v, qb, kb, vb, qt, kt, vt, ke, ve
        torch.cuda.empty_cache()
    for key, shape in (("serve", SERVE_SHAPE), ("long", LONG_SHAPE)):
        sdpa = (f"SDPA bf16 {t[key + '_sdpa_bf16']:.4f} ms, f32 with K/V "
                f"expanded {t[key + '_sdpa_f32_expanded']:.4f} ms")
        if key == "serve":
            sdpa += (f", f32 enable_gqa {t['serve_sdpa_f32']:.4f} ms; plain "
                     f"version f32 {t['serve_plain']:.4f} ms, bf16 "
                     f"{t['serve_plain_bf16']:.4f} ms")
        print(f"[time] flash B={shape[0]} S={shape[1]} Hq=12 Hkv=2 hd=128 "
              f"causal: kernel f32 {t[key]:.4f} ms (CUDA events "
              f"{t[key + '_events']:.4f} ms; bound "
              f"{t[key + '_bound']:.4f} ms, {t[key + '_bound_by']}, "
              f"{t[key + '_bound'] / t[key]:.3f} of it), bf16 "
              f"{t[key + '_bf16']:.4f} ms (CUDA events "
              f"{t[key + '_bf16_events']:.4f} ms; bound "
              f"{t[key + '_bf16_bound']:.4f} ms, "
              f"{t[key + '_bf16_bound_by']}, "
              f"{t[key + '_bf16_bound'] / t[key + '_bf16']:.3f} of it); "
              f"{sdpa}; device time")
    return t


# ---------------------------------------------------------------------------
# phase 7: serving qwen2-1.5b through the flash kernel
# ---------------------------------------------------------------------------

SERVE = dict(batch=4, prompt_len=1024, gen_len=16, waves=2, seed=0)


def tokens_match(tok_a, tok_b, logits_b) -> list:
    """Positions (row, step) where two greedy runs first part; each must
    be a near-tie in run b's logits (the two tokens within rtol = atol =
    1e-5, the rule of tests/test_torch_solver.py).  A row is not compared
    after it parts."""
    parted = []
    for row in range(tok_b.shape[0]):
        diff = np.nonzero(tok_a[row] != tok_b[row])[0]
        if diff.size:
            t = int(diff[0])
            a = float(logits_b[t, row, tok_a[row, t]])
            b = float(logits_b[t, row, tok_b[row, t]])
            check(np.isclose(a, b, rtol=RTOL, atol=ATOL),
                  f"serve: greedy tokens part at row {row} step {t} "
                  f"({tok_a[row, t]}: {a!r} vs {tok_b[row, t]}: {b!r}), not "
                  f"a near-tie")
            parted.append((row, t))
    return parted


def phase_serve(dev) -> dict:
    """Phase 7: ``serve_lm`` on full-width qwen2-1.5b with
    ``use_flash_attention=True`` (f32, random weights from a seeded
    generator), with the kernel's count set to 0 just before and read just
    after: 28 launches a wave.  Then one layer's captured q/k/v through
    the kernel vs the plain version, and the same weights and prompts
    served through the port's chunked plain attention: prefill logits
    within 1e-3 x max |logit|, the same greedy tokens but at near-ties."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import init_model, lm_decode, lm_prefill

    arch = dataclasses.replace(get_arch("qwen2-1.5b"),
                               use_flash_attention=True)
    captured = []
    real = ops.flash_sdpa

    def capture(q, k, v, **kw):      # keeps the first call's inputs
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), kw))
        return real(q, k, v, **kw)

    torch.cuda.reset_peak_memory_stats()
    ops.flash_sdpa = capture
    ops.launches = 0
    res = serve_lm(arch, **SERVE)            # device None: the card
    n_launch = ops.launches
    ops.flash_sdpa = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = arch.n_layers * SERVE["waves"]
    print(f"[serve] qwen2-1.5b f32 B={SERVE['batch']} prompt "
          f"{SERVE['prompt_len']} gen {SERVE['gen_len']}, "
          f"{SERVE['waves']} waves: flash launches {n_launch} (want {want}); "
          f"prefill wall {', '.join(f'{s:.4f}' for s in res.prefill_s)} s; "
          f"decode {res.decode_tokens_per_s:.1f} tokens/s "
          f"({res.decode_tokens} tokens in {res.decode_s:.4f} s); peak "
          f"memory {peak:.2f} GiB")
    check(n_launch == want, f"serve: {n_launch} flash launches, want {want}")
    for toks, logits in zip(res.tokens, res.logits):
        check(tuple(toks.shape) == (SERVE["batch"], SERVE["gen_len"])
              and bool(logits.isfinite().all()),
              f"serve: tokens {tuple(toks.shape)} or non-finite logits")

    q, k, v, kw = captured[0]
    err = check_flash(q, k, v, kw["causal"], kw["window"], FLASH_TOL[
        "float32"], "serve layer 0 q/k/v (captured)")

    params = init_model(arch, torch.Generator(device=dev).manual_seed(
        SERVE["seed"]))
    batch0 = {"tokens": res.prompts[0].to(dev)}
    cache_len = SERVE["prompt_len"] + SERVE["gen_len"]
    lm_prefill(params, arch, batch0, cache_len, dtype=torch.float32)
    torch.cuda.synchronize()
    f32 = FLASH_KERNELS["float32"]
    prof, wall = profiled(lambda: lm_prefill(
        params, arch, batch0, cache_len, dtype=torch.float32), f32,
        arch.n_layers)
    k_us, k_n = _device_activity(prof, f32)
    all_us, _ = _device_activity(prof)
    print(f"[serve] one prefill under the profiler: wall {wall:.4f} s, "
          f"device {all_us / 1e3:.3f} ms, of which {k_n} flash launches "
          f"{k_us / 1e3:.3f} ms ({k_us / max(all_us, 1e-9):.3f} of it)")
    check(k_n == arch.n_layers, f"serve: {k_n} flash launches in a prefill")
    logits, cache = lm_prefill(params, arch, batch0, cache_len,
                               dtype=torch.float32)
    tok = torch.argmax(logits, dim=-1)
    lm_decode(params, arch, tok, cache, dtype=torch.float32)
    torch.cuda.synchronize()
    prof, wall = profiled(lambda: lm_decode(params, arch, tok, cache,
                                            dtype=torch.float32))
    d_us, d_n = _device_activity(prof)
    print(f"[serve] one decode step under the profiler: wall "
          f"{wall * 1e3:.3f} ms, device {d_us / 1e3:.3f} ms in {d_n} device "
          f"activities ({d_n / arch.n_layers:.1f} a layer)")
    del logits, cache

    plain = serve_lm(dataclasses.replace(arch, use_flash_attention=False),
                     device=dev, params=params, **SERVE)
    notes = []
    for w, (pa, pb) in enumerate(zip(res.prompts, plain.prompts)):
        check(torch.equal(pa, pb), f"serve wave {w}: prompts differ")
        la, lb = res.logits[w][0], plain.logits[w][0]
        d, big = _max_abs(la, lb), float(lb.abs().max())
        check(d <= 1e-3 * big, f"serve wave {w}: prefill logits differ by "
                               f"{d:.3g} > 1e-3 x {big:.3g}")
        parted = tokens_match(res.tokens[w].cpu().numpy(),
                              plain.tokens[w].cpu().numpy(),
                              plain.logits[w].cpu().numpy())
        notes.append(f"wave {w}: max |logit diff| {d:.3g} (max |logit| "
                     f"{big:.3g}), tokens "
                     + (f"part at near-ties {parted}" if parted
                        else "identical"))
    print(f"[serve] flash vs chunked plain attention: {'; '.join(notes)}")
    bf16 = bf16_prefill(params, arch, batch0, cache_len)
    return dict(launches=n_launch, max_abs_err=err, kernel_ms=k_us / 1e3,
                bf16_launches=bf16)


def bf16_prefill(params, arch, batch, cache_len) -> int:
    """One full-width prefill in bfloat16 (``lm_prefill``'s own default
    type) through the tensor-core kernel, its launch count set to 0 just
    before and read just after (one a layer wanted); its wall and, under
    the profiler, the kernel's share of the device time; its logits
    against the same prefill through the chunked plain attention within
    2e-2 x max |logit| (the bf16 bar of FLASH_TOL), each row's argmax
    equal unless the plain run's two logits lie within that bar.  Returns
    the launch count."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm_prefill

    lm_prefill(params, arch, batch, cache_len)          # warm-up
    torch.cuda.synchronize()
    ops.launches = 0
    t0 = time.perf_counter()
    got, _ = lm_prefill(params, arch, batch, cache_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = ops.launches
    check(n_launch == arch.n_layers,
          f"serve bf16: {n_launch} flash launches in a prefill, want "
          f"{arch.n_layers}")
    name = FLASH_KERNELS["bfloat16"]
    prof, p_wall = profiled(lambda: lm_prefill(params, arch, batch,
                                               cache_len), name,
                            arch.n_layers)
    k_us, k_n = _device_activity(prof, name)
    all_us, _ = _device_activity(prof)
    want, _ = lm_prefill(params, dataclasses.replace(
        arch, use_flash_attention=False), batch, cache_len)
    d, big = _max_abs(got, want), float(want.abs().max())
    bar = FLASH_TOL["bfloat16"] * big
    check(bool(got.isfinite().all()) and d <= bar,
          f"serve bf16: prefill logits differ by {d:.3g} > 2e-2 x {big:.3g}")
    ta, tb = got.argmax(-1), want.argmax(-1)
    parted = []
    for row in torch.nonzero(ta != tb).flatten().tolist():
        gap = abs(float(want[row, ta[row]]) - float(want[row, tb[row]]))
        check(gap <= bar, f"serve bf16: row {row} argmax {int(ta[row])} vs "
                          f"{int(tb[row])}, {gap:.3g} apart: not a near-tie")
        parted.append(row)
    print(f"[serve] qwen2-1.5b bf16 prefill B={batch['tokens'].shape[0]} "
          f"prompt {batch['tokens'].shape[1]}: flash launches {n_launch} "
          f"(want {arch.n_layers}); wall {wall:.4f} s; under the profiler "
          f"wall {p_wall:.4f} s, device {all_us / 1e3:.3f} ms, of which "
          f"{k_n} flash launches {k_us / 1e3:.3f} ms "
          f"({k_us / max(all_us, 1e-9):.3f} of it); vs chunked plain "
          f"attention: max |logit diff| {d:.3g} (max |logit| {big:.3g}), "
          f"argmax " + (f"parts at near-ties in rows {parted}" if parted
                        else "identical"))
    return n_launch


# ---------------------------------------------------------------------------
# phase 8: dgo-serve — the batched engine, meshes and serving
# ---------------------------------------------------------------------------

DGO_PROBLEM = ("remote_sensing", {})      # full width: 680 vars, 5,439
DGO_SECOND = ("rastrigin", {"n": 9})      # children at 4 bits
DGO_WAVE = 8                  # the serving wave: R = 8 restarts
DGO_ITERS = 64
DGO_MESH = 8                  # virtual shards of the mesh checks
DGO_DEAD = (1, 4)             # the two dead shards
DGO_FOLDED_BITS = 8           # the folded batched wave: 4 -> 8 bits
DGO_SLOT_CAPS = (64, 24, 40, 16)          # mixed caps of the slot check
DGO_EXTRA = 3                 # requests of the partial second wave
DGO_INJECT = (0.05, 3)        # FailureInjector(rate, seed) on the host
DGO_SERVE_ARGS = ("--dgo", "--problems", "remote_sensing,rastrigin:9",
                  "--restarts", "8", "--waves", "2", "--max-iters", "64",
                  "--max-in-flight", "2")


def _alive_of(n_shards, dead):
    return tuple(s not in dead for s in range(n_shards))


def restart_inputs(obj, enc, n_shards, dead, phase, vb, dev, p_max=None):
    """The rows an engine binds for one step of ``n_shards`` shards (the
    ones in ``dead`` masked) at rotation ``phase``, virtual blocks of at
    most ``vb``; with ``p_max`` the folded schedule's rows (shards planned
    at the finest resolution): (ids, valid, block)."""
    from repro_torch.core.distributed import _shard_plan, _shard_rows

    plan = _shard_plan(p_max or enc.population, n_shards, vb)
    ids, valid = _shard_rows(enc, plan, _alive_of(n_shards, dead), phase,
                             p_max is not None, dev)
    return ids, valid, plan.block


def _same_pick(kv, ki, pv, pi, atol) -> bool:
    """(value, id) pairs agree: both NaN with the same id, or values
    within the bar and the same id."""
    if np.isnan(kv) or np.isnan(pv):
        return bool(np.isnan(kv) and np.isnan(pv)) and ki == pi
    return ki == pi and bool(np.isclose(kv, pv, rtol=RTOL, atol=atol))


def check_restarts(label, name, obj, enc, parents, live, dev, *,
                   n_shards=1, dead=(), phase=0, vb=256, p_max=None,
                   timed=False) -> dict:
    """One R-restart popstep launch vs its plain version (the one-parent
    plain step on each live parent) on the same CUDA tensors: each live
    parent's winner id, its value within the bar and every child's value;
    each live parent's result also bitwise equal to a one-parent launch
    on it.  With ``timed``, every parent live: the launch's device time
    beside R one-parent launches and beside R times the work bound."""
    import torch

    from repro_torch.kernels.popstep import ops

    ids, valid, block = restart_inputs(obj, enc, n_shards, dead, phase, vb,
                                       dev, p_max)
    r = parents.shape[0]
    kw = dict(valid=valid, virtual_block=block, n_shards=n_shards)
    step = ops.prepare_step_ids(obj, ids, enc, restarts=r, **kw)
    live_t = torch.as_tensor(np.asarray(live, bool), device=dev)
    kv, ki = step(parents, live_t)
    kvals = (step.values if dev.type == "cuda" else torch.stack(
        [ops.child_values(obj, p, ids, enc, valid) for p in parents]))
    pv, pi = ops.population_steps_plain(obj, parents, ids, enc, live=live_t,
                                        **kw)
    one = ops.prepare_step_ids(obj, ids, enc, **kw)
    atol, _ = long_sum_atol(name, enc)
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    err, n_nan = 0.0, 0
    for s in np.flatnonzero(np.asarray(live, bool)):
        vals = ops.child_values_plain(obj, parents[s], ids, enc, valid)
        k_s = kvals[s]
        same_nan = torch.equal(torch.isnan(k_s), torch.isnan(vals))
        fin = torch.isfinite(vals)
        close = bool(torch.isclose(k_s[fin], vals[fin], rtol=RTOL,
                                   atol=atol).all())
        check(same_nan and close and torch.equal(torch.isinf(k_s),
                                                 torch.isinf(vals)),
              f"{label}: parent {s}: a child's value differs from the "
              f"plain version's beyond the bar (atol {atol:.3g})")
        if bool(fin.any()):
            err = max(err, float((k_s[fin].double()
                                  - vals[fin].double()).abs().max()))
        n_nan += int(torch.isnan(vals).sum())
        if not _same_pick(kv[s], ki[s], pv[s], pi[s], atol):
            # a near-tie: both winners within the bar of each other
            a, b = float(vals[int(ki[s])]), float(vals[int(pi[s])])
            check(bool(np.isclose(a, b, rtol=RTOL, atol=atol)),
                  f"{label}: parent {s}: kernel ({kv[s]!r}, {ki[s]}) vs "
                  f"plain ({pv[s]!r}, {pi[s]}) is not a near-tie")
        v1, i1 = one(parents[s])
        same = (int(i1) == int(ki[s]) and np.float32(float(v1)).tobytes()
                == np.float32(kv[s]).tobytes())
        check(same, f"{label}: parent {s}: the R-restart launch gave "
                    f"({kv[s]!r}, {ki[s]}), a one-parent launch "
                    f"({float(v1)!r}, {int(i1)})")
    n_live = int(np.asarray(live, bool).sum())
    print(f"[dgo] {label:<40} R {r} live {n_live} shards {n_shards} dead "
          f"{list(dead)} phase {phase}: {ids.shape[0]} rows a parent, "
          f"winners == plain, == one-parent launches bitwise; max |err| "
          f"{err:.3g}" + (f"; {n_nan} NaN children" if n_nan else ""))
    out = {"max_abs_err": err}
    if timed:
        every = torch.ones(r, dtype=torch.bool, device=dev)
        k_ms = device_ms(lambda: step(parents, every), 20, dev,
                         name="popstep_kernel")
        s_ms = device_ms(lambda: one(parents[0]), 20, dev,
                         name="popstep_kernel")
        p_ms = device_ms(lambda: ops.population_steps_plain(
            obj, parents, ids, enc, **kw), 3, dev)
        _, (b_ms, b_by) = popstep_work_bound(name, obj, enc, ids, valid,
                                             block)
        out.update(ms=k_ms, one_ms=s_ms, plain_ms=p_ms, bound_ms=b_ms * r,
                   bound_by=b_by)
        print(f"[time] popstep R={r} {label}: {k_ms:.4f} ms a launch "
              f"({k_ms / r:.4f} a parent) vs {r} one-parent launches "
              f"{s_ms * r:.4f} ms ({s_ms:.4f} each); bound {b_ms * r:.4f} "
              f"ms ({b_by}, {r} x {b_ms:.4f}); plain {p_ms:.4f} ms")
    return out


def _xor_with_nan_sample():
    """The registry's XOR net with sample 0 moved to (+inf, -inf): a
    hidden unit's input is inf - inf (NaN) where its two weights on that
    sample share a sign, +-inf (tanh +-1) where they do not — so a child
    that flips the sign of one of those weights is NaN, and the others
    are finite."""
    from repro_torch.core import objectives

    x = objectives.XOR_X.copy()
    x[0] = (np.inf, -np.inf)
    return objectives._xor(x, objectives.XOR_Y)


def phase_restart_kernel(dev) -> dict:
    """8a: the R-restart popstep launch against its plain version at the
    shapes of every path of this phase; returns its times and errors."""
    import torch

    from repro_torch.core import objectives
    from repro_torch.core.encoding import encode

    rng = np.random.default_rng(8)
    name, kw = DGO_PROBLEM
    obj = objectives.get(name, **kw)
    enc = obj.encoding
    times, err = {}, 0.0
    for r, live in ((1, [True]), (3, [True, False, True]),
                    (DGO_WAVE, [True] * 5 + [False, True, False])):
        par = torch.as_tensor(rng.integers(0, 2, (r, enc.n_bits)).astype(
            np.int8), device=dev)
        res = check_restarts(f"{name} {enc.bits} bits", name, obj, enc, par,
                             live, dev)
        err = max(err, res["max_abs_err"])
        res = check_restarts(f"{name} {enc.bits} bits (all live)", name, obj,
                             enc, par, [True] * r, dev, timed=True)
        times[f"{name}_{enc.bits}bit_R{r}"] = res
        err = max(err, res["max_abs_err"])
    # the folded schedule's finest resolution: 21,759 children at 16 bits
    enc16 = enc.with_bits(16)
    par = torch.as_tensor(rng.integers(0, 2, (DGO_WAVE, enc16.n_bits))
                          .astype(np.int8), device=dev)
    res = check_restarts(f"{name} 16 bits (folded rows)", name, obj, enc16,
                         par, [True] * DGO_WAVE, dev,
                         p_max=enc16.population, timed=True)
    times[f"{name}_16bit_R{DGO_WAVE}"] = res
    err = max(err, res["max_abs_err"])
    # rastrigin n=9, 16 bits, 8 shards of one block, two dead: every phase
    name2, kw2 = DGO_SECOND
    obj2 = objectives.get(name2, **kw2)
    enc2 = obj2.encoding.with_bits(16)
    par = torch.as_tensor(rng.integers(0, 2, (DGO_WAVE, enc2.n_bits))
                          .astype(np.int8), device=dev)
    for phase in range(DGO_MESH):
        res = check_restarts(f"{name2} {kw2} 16 bits", name2, obj2, enc2,
                             par, [True] * DGO_WAVE, dev, n_shards=DGO_MESH,
                             dead=DGO_DEAD, phase=phase,
                             timed=phase == 0)
        err = max(err, res["max_abs_err"])
        if phase == 0:
            times[f"{name2}_16bit_R{DGO_WAVE}_mesh{DGO_MESH}"] = res
    # the mesh path (8d) at full width: 8 shards of 680 children in three
    # virtual blocks each, two dead, at every rotation phase
    for r, live in ((1, [True]), (DGO_WAVE, [True] * 5 + [False, True,
                                                          False])):
        par = torch.as_tensor(rng.integers(0, 2, (r, enc.n_bits)).astype(
            np.int8), device=dev)
        for phase in range(DGO_MESH):
            timed = r == DGO_WAVE and phase == 0
            res = check_restarts(f"{name} {enc.bits} bits mesh", name, obj,
                                 enc, par, live, dev, n_shards=DGO_MESH,
                                 dead=DGO_DEAD, phase=phase, timed=timed)
            err = max(err, res["max_abs_err"])
            if timed:
                times[f"{name}_{enc.bits}bit_R{r}_mesh{DGO_MESH}"] = res
    # serve --dgo's second problem: rastrigin n=9 at its registry
    # encoding, one shard
    enc9 = obj2.encoding
    par = torch.as_tensor(rng.integers(0, 2, (DGO_WAVE, enc9.n_bits))
                          .astype(np.int8), device=dev)
    res = check_restarts(f"{name2} {kw2} {enc9.bits} bits", name2, obj2,
                         enc9, par, [True] * 5 + [False, True, False], dev,
                         timed=True)
    times[f"{name2}_{enc9.bits}bit_R{DGO_WAVE}"] = res
    err = max(err, res["max_abs_err"])
    # a NaN child: shards of one block stall on it, shards of several
    # blocks drop its block
    xor = _xor_with_nan_sample()
    xenc = xor.encoding
    safe = torch.as_tensor(np.asarray([4, 4, -4, -4, 0.1, 0.1, 1, 1],
                                      np.float32), device=dev)
    par = torch.stack([encode(safe, xenc)] * 2 + [torch.as_tensor(
        rng.integers(0, 2, xenc.n_bits).astype(np.int8), device=dev)])
    for shards, vb in ((DGO_MESH, 256), (2, xenc.population // 4)):
        res = check_restarts(f"xor, a NaN sample, vb {vb}", "xor", xor,
                             xenc, par, [True, True, True], dev,
                             n_shards=shards, vb=vb)
        err = max(err, res["max_abs_err"])
    ids, valid, block = restart_inputs(xor, xenc, DGO_MESH, (), 0, 256, dev)
    from repro_torch.kernels.popstep import ops
    vals = ops.child_values_plain(xor, par[0], ids, xenc, valid)
    check(bool(torch.isnan(vals).any()) and bool(torch.isfinite(vals).any()),
          "the NaN-sample XOR parent has no NaN child, or no finite one")
    v, i = ops.prepare_step_ids(xor, ids, xenc, valid=valid,
                                virtual_block=block,
                                n_shards=DGO_MESH)(par[0])
    check(bool(torch.isnan(v)) and int(i) == xenc.population,
          f"one-block shards with a NaN child: ({float(v)}, {int(i)}), "
          f"want (nan, {xenc.population})")
    ids2, valid2, block2 = restart_inputs(xor, xenc, 2, (), 0,
                                          xenc.population // 4, dev)
    v2, _ = ops.prepare_step_ids(xor, ids2, xenc, valid=valid2,
                                 virtual_block=block2, n_shards=2)(par[0])
    check(bool(torch.isfinite(v2)),
          f"shards of several blocks did not drop the NaN block: {float(v2)}")
    print(f"[dgo] xor, a NaN sample: one-block shards -> (nan, "
          f"{xenc.population}); two-block shards -> {float(v2):.7g}")
    return {"by_restarts": times, "max_abs_err": err}


def _counted(fn):
    """Run ``fn`` with the engine cache cleared (its steps are bound
    anew), both popstep counts set to 0 and every bound-step call
    counted: (result, wall s, (launches, fold launches, step calls))."""
    import torch

    from repro_torch.core import cache
    from repro_torch.kernels.popstep import ops

    cache.get_cache("distributed.engine").clear()
    calls, undo = _count_steps()
    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        ops.launches = ops.fold_launches = 0
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (ops.launches, ops.fold_launches, calls[0])
    finally:
        undo()
    return out, wall, counts


def _bitwise(a, b) -> bool:
    return (np.float32(float(a.best_f)).tobytes()
            == np.float32(float(b.best_f)).tobytes()
            and np.array_equal(np.asarray(a.best_x.cpu()).view(np.int32),
                               np.asarray(b.best_x.cpu()).view(np.int32))
            and a.iterations == b.iterations
            and np.array_equal(np.asarray(a.trace, np.float32).view(np.int32),
                               np.asarray(b.trace, np.float32).view(np.int32)))


def phase_dgo_slots(dev) -> dict:
    """8b: solve_many of a full wave and a partial one; each slot equal
    bit for bit to its per-request Batched(restarts=1) solve; one launch
    per batched step."""
    from repro_torch.core.solver import Batched, Problem, SolveRequest
    from repro_torch.core.solver import solve, solve_many

    name, kw = DGO_PROBLEM
    prob = Problem.get(name, **kw)
    reqs = [SolveRequest(prob, seed=100 + i,
                         max_iters=DGO_SLOT_CAPS[i % len(DGO_SLOT_CAPS)])
            for i in range(DGO_WAVE + DGO_EXTRA)]
    device = None if dev.type == "cuda" else dev
    outs, wall, (n, n_fold, n_calls) = _counted(
        lambda: solve_many(reqs, pad_to=DGO_WAVE, device=device))
    waves = [outs[:DGO_WAVE], outs[DGO_WAVE:]]
    steps = [max(o.iterations for o in w) for w in waves]
    print(f"[dgo] solve_many {name}: {len(reqs)} requests in waves of "
          f"{DGO_WAVE} (the second padded), {steps} steps a wave, wall "
          f"{wall:.4f} s ({wall / len(waves):.4f} s a wave); launches: "
          f"popstep {n} for {n_calls} batched steps, fold alone {n_fold}")
    check(n > 0, "the batched waves launched no popstep kernel")
    check(n == n_calls, f"{n} popstep launches for {n_calls} batched steps")
    check(n_fold == 0, f"the fold was launched alone {n_fold} times")
    check(sum(steps) <= n_calls <= sum(steps) + 16 * len(waves),
          f"{n_calls} batched steps for waves of {steps} steps")
    for req, out in zip(reqs, outs):
        one = solve(prob, Batched(restarts=1), seed=req.seed,
                    max_iters=req.max_iters, device=device)
        check(_bitwise(out, one),
              f"slot {out.extras['wave_slot']} (seed {req.seed}, cap "
              f"{req.max_iters}) differs from its per-request solve: "
              f"{float(out.best_f)!r}/{out.iterations} vs "
              f"{float(one.best_f)!r}/{one.iterations}")
        check(np.isfinite(float(out.best_f)) and out.extras["finite"]
              and out.trace[-1] < out.trace[0],
              f"slot {out.extras['wave_slot']} did not descend")
    print(f"[dgo] solve_many {name}: every slot == its per-request "
          f"Batched(restarts=1) solve, bit for bit (best_x, best_f, "
          f"iterations, trace)")
    return {"counts": (n, n_fold), "wall_per_wave": wall / len(waves),
            "reqs": reqs}


def replay_batched_slot(problem, cfg, x0, cap, dev):
    """One slot of the folded batched wave replayed on the host with the
    popstep kernel's step and the plain tensor step (the engine's rows:
    shards planned at the finest resolution) on the same parent each
    step, under the engine's rules (a stall or ``cap`` steps escalate; no
    re-encode after the last resolution): (the kernel's best-so-far trace,
    the plain one's, the parting step or None), as
    :func:`replay_schedule`."""
    import torch

    from repro_torch.core import dgo
    from repro_torch.core.distributed import (_build_shard_step,
                                              _parent_vals, _shard_plan)
    from repro_torch.core.encoding import decode, encode

    obj = problem.objective
    _, tables = dgo._engine_tables(cfg, dev)
    plan = _shard_plan(tables.p_max, 1, 256)
    k_steps = [_build_shard_step(obj, e, plan, "popstep", dev,
                                 bounded=True)(None)
               for e in tables.encodings]
    p_steps = [_build_shard_step(obj, e, plan, "fused", dev,
                                 bounded=True)(None)
               for e in tables.encodings]
    enc0 = cfg.encoding
    x = torch.as_tensor(np.asarray(x0, np.float32), device=dev)
    val = _parent_vals(obj, decode(encode(x, enc0), enc0)[None])[0]
    bits = tables.encode(x, 0)[: tables.encodings[0].n_bits]
    k_val = p_val = val
    k_best = p_best = float(val)
    k_tr, p_tr = [np.float32(k_best)], [np.float32(p_best)]
    for r in range(tables.n_res):
        if r > 0:
            bits = tables.reencode(bits, r - 1, r)[
                : tables.encodings[r].n_bits]
            val = _parent_vals(obj, tables.decode(bits, r)[None])[0]
            k_val = p_val = val
        for it in range(cap):
            kb, kv, ki = k_steps[r](bits, k_val, it)
            pb, pv, pi = p_steps[r](bits, p_val, it)
            if bool(ki) != bool(pi) or not torch.equal(kb, pb):
                return k_tr, p_tr, dict(
                    r=r, step=len(k_tr), bits=bits, k_val=k_val,
                    p_val=p_val, kernel=(kb, kv, bool(ki)),
                    plain=(pb, pv, bool(pi)))
            bits, k_val, p_val = kb, kv, pv
            k_best = min(k_best, float(kv))
            p_best = min(p_best, float(pv))
            k_tr.append(np.float32(k_best))
            p_tr.append(np.float32(p_best))
            if not bool(ki):
                break
    return k_tr, p_tr, None


def phase_dgo_folded(dev) -> dict:
    """8c: the folded batched wave (4 -> DGO_FOLDED_BITS bits, R = 8)
    through the kernel and through the plain tensor step on the card,
    each slot held against the host replay of both steps."""
    from repro_torch.core import distributed as tdist
    from repro_torch.core.dgo import DGOConfig
    from repro_torch.core.solver import Problem, SolveRequest, _request_x0

    name, kw = DGO_PROBLEM
    prob = Problem.get(name, **kw)
    enc = prob.encoding
    cfg = DGOConfig(encoding=enc, max_bits=DGO_FOLDED_BITS, bits_step=2,
                    max_iters_per_resolution=DGO_ITERS)
    schedule = tuple(cfg.resolutions())
    x0s = np.stack([_request_x0(prob, SolveRequest(prob, seed=200 + i))
                    for i in range(DGO_WAVE)])
    device = None if dev.type == "cuda" else dev
    res_k, wall_k, (n, n_fold, n_calls) = _counted(
        lambda: tdist._run_batched(prob.objective, enc, x0s,
                                   max_iters=DGO_ITERS, res_bits=schedule,
                                   device=device))
    res_p = tdist._run_batched(prob.objective, enc, x0s,
                               max_iters=DGO_ITERS, res_bits=schedule,
                               inner="fused", device=dev)
    label = f"{name} folded {enc.bits}->{DGO_FOLDED_BITS} bits R {DGO_WAVE}"
    its = np.asarray(res_k.iterations)
    print(f"[dgo] {label}: {int(its.sum())} slot steps ({its.tolist()}), "
          f"wall {wall_k:.4f} s; launches: popstep {n} for {n_calls} "
          f"batched steps, fold alone {n_fold}")
    check(n > 0 and n == n_calls and n_fold == 0,
          f"{label}: {n} launches, {n_calls} batched steps, {n_fold} fold "
          f"launches")
    parted = 0
    for s in range(DGO_WAVE):
        k_tr, p_tr, part = replay_batched_slot(prob, cfg, x0s[s], DGO_ITERS,
                                               dev)
        t_k = res_k.trace[s][: int(its[s]) + 1]
        t_p = res_p.trace[s][: int(np.asarray(res_p.iterations)[s]) + 1]
        m = len(k_tr)
        if part is None:
            check(np.array_equal(t_k, np.asarray(k_tr, np.float32))
                  and np.array_equal(t_p, np.asarray(p_tr, np.float32)),
                  f"{label}: slot {s} differs from the host replay")
            continue
        parted += 1
        check(len(t_k) >= m and len(t_p) >= m
              and np.array_equal(t_k[:m], np.asarray(k_tr, np.float32))
              and np.array_equal(t_p[:m], np.asarray(p_tr, np.float32)),
              f"{label}: slot {s} differs from the host replay before its "
              f"parting step {m}")
        ok, note = judge_parting(name, prob, cfg, part, dev)
        print(f"[dgo] {label}: slot {s}: the same children for {m - 1} "
              f"steps, then a {note}")
        check(ok, f"{label}: slot {s} parts beyond a near-tie: {note}")
    print(f"[dgo] {label}: every slot == the host replay of both steps "
          f"({parted} part at a near-tie); best {float(res_k.values.min()):.7g}"
          f" (kernel) vs {float(res_p.values.min()):.7g} (plain)")
    return {"counts": (n, n_fold)}


def phase_dgo_mesh(dev) -> dict:
    """8d: Distributed(mesh=8, two dead shards) on both drivers at full
    width (the device history == the host's), and the host driver with a
    FailureInjector; each must descend."""
    from repro_torch.core.solver import Distributed, Problem
    from repro_torch.runtime import FailureInjector

    name, kw = DGO_PROBLEM
    prob = Problem.get(name, **kw)
    enc = prob.encoding
    x0 = np.random.default_rng(9).uniform(enc.lo, enc.hi,
                                          enc.n_vars).astype(np.float32)
    mask = list(_alive_of(DGO_MESH, DGO_DEAD))
    counts, hist = {}, {}
    for label, strat in (
            ("device", Distributed(mesh=DGO_MESH, quorum_mask=mask)),
            ("host", Distributed(mesh=DGO_MESH, quorum_mask=mask,
                                 driver="host")),
            ("host + injector", Distributed(
                mesh=DGO_MESH, driver="host",
                injector=FailureInjector(*DGO_INJECT[:1],
                                         seed=DGO_INJECT[1])))):
        res, wall, (n, n_fold, n_calls) = _counted(
            lambda: _solve_timed(prob, strat, x0, DGO_ITERS, dev)[0])
        h = res.extras["history"]
        hist[label] = h
        print(f"[dgo] {name} mesh {DGO_MESH} {label}"
              + (f" dead {list(DGO_DEAD)}" if "injector" not in label
                 else "") + f": {res.iterations} steps, {h[0]:.7g} -> "
              f"{float(res.best_f):.7g}, wall {wall:.4f} s; launches: "
              f"popstep {n} for {n_calls} step calls, fold alone {n_fold}")
        check(n > 0 and n == n_calls and n_fold == 0,
              f"mesh {label}: {n} launches, {n_calls} step calls, {n_fold} "
              f"fold launches")
        check(float(res.best_f) < h[0] and res.extras["finite"],
              f"mesh {label}: did not descend ({h[0]} -> "
              f"{float(res.best_f)})")
        counts[f"dgo-serve: mesh {label}"] = (n, n_fold)
    check(hist["device"] == hist["host"],
          "the device driver's history differs from the host driver's")
    print(f"[dgo] mesh {DGO_MESH}, dead {list(DGO_DEAD)}: the device "
          f"driver's history == the host driver's ({len(hist['host']) - 1} "
          f"steps)")
    return counts


def _serve_once(argv, dev):
    """``launch.serve``'s CLI in this process: (its printed report, the
    handles, wall s, launches).  Off the card (a rehearsal) the loop runs
    on ``dev``."""
    import contextlib
    import io

    from repro_torch.kernels.popstep import ops
    from repro_torch.launch import serve

    seen = []
    loop = serve._run_serving_loop

    def keep(args, problems, rps, device=None):
        out = loop(args, problems, rps,
                   None if dev.type == "cuda" else dev)
        seen.append(out)
        return out

    buf = io.StringIO()
    serve._run_serving_loop = keep
    try:
        ops.launches = ops.fold_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(list(argv))
        wall = time.perf_counter() - t0
        n = (ops.launches, ops.fold_launches)
    finally:
        serve._run_serving_loop = loop
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    sched, handles, loop_wall, _ = seen[-1]
    return report, handles, loop_wall, wall, n, sched


def phase_dgo_serve_cli(dev) -> dict:
    """8e: ``python -m repro_torch.launch.serve --dgo`` in closed loop,
    pipelined, then with ``--no-pipeline``: every request completes, with
    the same best_f per request."""
    from repro_torch.launch import serve

    cli = serve.build_parser().parse_args(list(DGO_SERVE_ARGS))
    want = cli.restarts * cli.waves
    out, best = {}, {}
    for mode, extra in (("pipelined", ()), ("no-pipeline",
                                            ("--no-pipeline",))):
        report, handles, loop_wall, wall, n, sched = _serve_once(
            DGO_SERVE_ARGS + extra, dev)
        m = sched.metrics()
        print(f"[dgo] serve --dgo {mode}: {json.dumps(report)}")
        check(report["completed"] == want and report["failed"] == 0
              and all(h.done() and h.error is None for h in handles),
              f"serve --dgo {mode}: {report['completed']} of {want} "
              f"requests completed, {report['failed']} failed")
        best[mode] = [float(h.result().best_f) for h in handles]
        per_wave = m["busy_s"] / max(m["waves"], 1)
        print(f"[dgo] serve --dgo {mode}: {m['waves']} waves, wall "
              f"{loop_wall:.4f} s serving ({wall:.4f} s with warm-up), "
              f"{per_wave:.4f} s a wave (busy), launches: popstep {n[0]}, "
              f"fold alone {n[1]}")
        check(n[0] > 0 and n[1] == 0,
              f"serve --dgo {mode}: launches {n}")
        out[f"dgo-serve: serve --dgo {mode}"] = n
    check(best["pipelined"] == best["no-pipeline"],
          "serve --dgo: pipelined and synchronous serving gave different "
          "best_f for a request")
    print("[dgo] serve --dgo: pipelined == no-pipeline best_f for every "
          "request")
    return out


def profile_wave(dev, reqs) -> None:
    """One full wave of the slot check under the profiler: its wall, the
    batched step's device time and the idle share."""
    from repro_torch.core.solver import solve_many

    if dev.type != "cuda":
        return
    wave = reqs[:DGO_WAVE]
    solve_many(wave, pad_to=DGO_WAVE)              # warm: steps bound
    prof, wall = profiled(lambda: solve_many(wave, pad_to=DGO_WAVE),
                          "popstep_kernel", cpu=False)
    busy_us, n_acts = _device_activity(prof)
    step_us, n_steps = _device_activity(prof, "popstep_kernel")
    if n_steps == 0:       # the launch counts hold the path; this only times
        print(f"[dgo] one wave of {DGO_WAVE} under the profiler: wall "
              f"{wall:.4f} s; idle share and step time not measured (the "
              f"profiler recorded no popstep launch in {PROFILE_TRIES} "
              f"sessions)")
        return
    print(f"[dgo] one wave of {DGO_WAVE} under the profiler: wall "
          f"{wall:.4f} s, device busy {busy_us / 1e6:.4f} s, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}; popstep {n_steps} launches, "
          f"{step_us / 1e3 / n_steps:.4f} ms each (the batched step's "
          f"device time), {n_acts / n_steps:.1f} device activities a "
          f"step")


def phase_dgo(dev) -> tuple[dict, dict]:
    """Phase 8: returns (the R-restart kernel's times and errors, each
    main path's (launches, fold launches))."""
    kern = phase_restart_kernel(dev)
    slots = phase_dgo_slots(dev)
    counts = {"dgo-serve: solve_many slots": slots["counts"]}
    profile_wave(dev, slots["reqs"])
    counts["dgo-serve: folded wave"] = phase_dgo_folded(dev)["counts"]
    counts.update(phase_dgo_mesh(dev))
    counts.update(phase_dgo_serve_cli(dev))
    kern["wall_per_wave"] = slots["wall_per_wave"]
    return kern, counts


# ---------------------------------------------------------------------------
# phase 9: the train path and subspace DGO (no kernel of the repo on it)
# ---------------------------------------------------------------------------

TRAIN_ARGV = ("--arch", "qwen2-1.5b", "--steps", "4", "--global-batch", "4",
              "--seq-len", "512", "--ckpt-every", "4", "--log-every", "1",
              "--seed", "0")
TRAIN_F64_BAR = 1e-3      # the first step's f32 loss against float64, relative
TRAIN_RESUME_BAR = 1e-4   # a step from the restored state vs from memory
WK_KEY = "['segments']/['seg0']/['attn']/['wk']"
SUBSPACE = "subspace-lm:qwen2-1.5b"
SUBSPACE_SERVE_ARGS = ("--dgo", "--problems", f"{SUBSPACE},rastrigin:9",
                       "--restarts", "8", "--waves", "1", "--no-pipeline")
META_BAR = 1e-2           # the reference test's bar on best_f


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stacked(leaf):
    return leaf.stacked() if hasattr(leaf, "stacked") else leaf


def _trees_equal(a, b) -> bool:
    import torch

    from repro_torch.core.tree import entries

    ea, eb = list(entries(a)), list(entries(b))
    return [k for k, _ in ea] == [k for k, _ in eb] and all(
        torch.equal(_stacked(x), _stacked(y))
        for (_, x), (_, y) in zip(ea, eb))


def check_init_leaf(params, key) -> None:
    """The device twin's ``wk`` (stacked, 28 x 1536 x 2 x 128) against the
    numpy twin's draw of the same leaf, bit for bit."""
    import math

    from repro_torch.core import prng
    from repro_torch.core.tree import entries

    leaves = list(entries(params.tree()))      # the reference's order
    i = [k for k, _ in leaves].index(WK_KEY)
    got = leaves[i][1].stacked().cpu().numpy()
    std = np.float32(1.0 / math.sqrt(got.shape[0]))
    want = std * prng.normal(prng.fold_in(key, i), got.shape)
    same = np.array_equal(got.view(np.int32), want.view(np.int32))
    print(f"[train] init leaf {WK_KEY} {tuple(got.shape)} (index {i}) "
          f"through the device twin == the numpy twin bit for bit: {same}")
    check(same, f"init leaf {WK_KEY}: the device twin's draw differs from "
                f"the numpy twin's")


def phase_train(dev) -> dict:
    """9a: ``run_training`` at full width (f32, 4 steps, B = 4, S = 512,
    one checkpoint at step 4 in a temporary directory, removed after)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.lm import init_model, lm_loss, n_params
    from repro_torch.optim.gradient import AdamWConfig

    args = train.build_argparser().parse_args(list(TRAIN_ARGV))
    arch = get_arch(args.arch)
    if args.reduced:            # a rehearsal off the card
        arch = reduced(arch)
    key = prng.PRNGKey(args.seed)
    data = SyntheticTokenPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed), device=dev)
    batches = [data.batch_at(k) for k in (0, args.steps, args.steps + 1)]
    data.close()

    t0 = time.perf_counter()
    params = init_model(arch, key, device=dev)
    _sync(dev)
    print(f"[train] init_model(qwen2-1.5b, PRNGKey(0)) through the device "
          f"twin: {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in params.parameters()):,} parameters")
    check_init_leaf(params, key)
    with torch.no_grad():
        l64 = float(lm_loss(params, arch, batches[0], dtype=torch.float64))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        args.ckpt_dir = str(tmp)
        free = shutil.disk_usage(tmp).free
        print(f"[train] free disk at {tmp}: {free / 1e9:.2f} GB (one "
              f"checkpoint: ~{3 * n_params(arch) * 4 / 1e9:.2f} GB)")
        out = train.run_training(args, device=dev, keep_state=True)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        losses = out["losses"]
        tokens = args.global_batch * args.seq_len
        warm = out["step_s"][1:] or out["step_s"]
        print(f"[train] losses {losses}; step seconds {out['step_s']}; "
              f"{tokens / (sum(warm) / len(warm)):.1f} tokens/s after the "
              f"first step; peak device memory {peak / 2**30:.2f} GiB")
        check(len(losses) == args.steps
              and all(np.isfinite(v) for v in losses),
              f"trainer losses {losses}")
        rel64 = abs(losses[0] - l64) / abs(l64)
        print(f"[train] first step: f32 loss {losses[0]!r} vs float64 "
              f"{l64!r} on the same parameters and batch: relative "
              f"{rel64:.3e} (bar {TRAIN_F64_BAR})")
        check(rel64 <= TRAIN_F64_BAR, f"first loss {losses[0]} vs float64 "
                                      f"{l64}: {rel64:.3e}")
        step_dir = tmp / f"step_{args.steps:08d}"
        nbytes = sum(p.stat().st_size for p in step_dir.iterdir())
        print(f"[train] checkpoint {step_dir.name}: {nbytes / 1e9:.3f} GB "
              f"written in {out['ckpt_s'][0]:.2f} s "
              f"({nbytes / 1e9 / out['ckpt_s'][0]:.3f} GB/s)")
        state = out.pop("state")
        t0 = time.perf_counter()
        back = restore_checkpoint(tmp, args.steps, state)
        _sync(dev)
        t_restore = time.perf_counter() - t0
        same = _trees_equal(back, state)
        print(f"[train] restored in {t_restore:.2f} s; equal to the trained "
              f"state bit for bit: {same}")
        check(same, "the restored checkpoint differs from the trained state")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps, weight_decay=0.01)
    after = []
    one_step = train.make_step(arch, opt_cfg, torch.float32)
    for name in ("memory", "restored"):
        src = state if name == "memory" else back
        p1, _, loss = one_step(*src, batches[1])
        if name == "memory":
            del state, src
        else:
            del back, src
        with torch.no_grad():
            after.append(float(lm_loss(p1, arch, batches[2],
                                       dtype=torch.float32)))
        del p1
        print(f"[train] one more step from the state in {name}: step loss "
              f"{float(loss)!r}, loss after it {after[-1]!r}")
    rel = abs(after[0] - after[1]) / abs(after[0])
    print(f"[train] after the extra step, memory vs restored: relative "
          f"{rel:.3e} (bar {TRAIN_RESUME_BAR})")
    check(rel <= TRAIN_RESUME_BAR, f"the extra step from the restored state "
                                   f"parts from memory's: {after}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "step_s": out["step_s"], "peak": peak,
            "ckpt_bytes": nbytes, "ckpt_s": out["ckpt_s"][0],
            "restore_s": t_restore, "f64_rel": rel64, "resume_rel": rel}


def runs_follow(h_a, h_b, atol=1e-5, rtol=1e-5) -> str:
    """The near-tie rule of the port's tests: "same" when two best-so-far
    histories agree step for step within the bar, "near-tie" when they part
    only at a step within the bar of the last and go on through the same
    values; anything else fails."""
    def close(a, b):
        return np.isclose(a, b, rtol=rtol, atol=atol)

    def plateaus(h):
        out = [h[0]]
        for v in h[1:]:
            if not close(v, out[-1]):
                out.append(v)
        return np.asarray(out)

    h_a, h_b = np.asarray(h_a, np.float64), np.asarray(h_b, np.float64)
    if len(h_a) == len(h_b) and close(h_a, h_b).all():
        return "same"
    p_a, p_b = plateaus(h_a), plateaus(h_b)
    check(len(p_a) == len(p_b) and bool(close(p_a, p_b).all()),
          f"the runs part beyond a near-tie: {p_a} vs {p_b}")
    check(any(np.any((np.diff(h) < 0) & close(h[1:], h[:-1]))
              for h in (h_a, h_b)), "the runs part without a near-tie")
    return "near-tie"


def phase_subspace(dev) -> dict:
    """9b: ``solve(subspace-lm:qwen2-1.5b, Fused(), seed=0)`` on the card
    and on the CPU; ``materialize(best_x)``; ``serve --dgo`` with the
    tuning problem and ``--ckpt-dir``."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.solver import Fused, Problem, solve
    from repro_torch.core.tree import entries
    from repro_torch.kernels.popstep import ops
    from repro_torch.launch import serve

    prob = Problem.get(SUBSPACE)
    runs = {}
    for where in ("card", "cpu"):
        d = None if (where == "card" and dev.type == "cuda") else "cpu"
        ops.launches = ops.fold_launches = 0
        t0 = time.perf_counter()
        res = solve(prob, Fused(), seed=0, device=d)
        _sync(dev)
        wall = time.perf_counter() - t0
        ev = res.extras["evaluations"]
        runs[where] = res
        print(f"[subspace] Fused() on the {where}: best_f "
              f"{float(res.best_f)!r}, {res.iterations} steps, {ev} "
              f"evaluations, {wall:.2f} s wall, {ev / wall:.1f} "
              f"evaluations/s (directions and state built in the run); "
              f"popstep launches {ops.launches} (the plain tensor step)")
        check(ops.launches == ops.fold_launches == 0,
              "a subspace objective reached the popstep kernel")
    how = runs_follow(runs["card"].trace, runs["cpu"].trace)
    print(f"[subspace] card vs CPU: {how}")
    check(np.isclose(float(runs["card"].best_f), float(runs["cpu"].best_f),
                     rtol=1e-5, atol=1e-5), "card and CPU best_f differ")
    winner = prob.materialize(runs["card"].best_x)
    finite = all(bool(torch.isfinite(_stacked(v)).all())
                 for _, v in entries(winner))
    print(f"[subspace] materialize(best_x): "
          f"{sum(_stacked(v).numel() for _, v in entries(winner)):,} "
          f"parameters, all finite: {finite}")
    check(finite, "materialize(best_x) is not finite")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    seen = {}
    real = serve._persist_winners

    def persist(ckpt_dir, handles, submitted):
        seen["handles"] = handles
        return real(ckpt_dir, handles, submitted)

    serve._persist_winners = persist
    try:
        args = serve.build_parser().parse_args(
            list(SUBSPACE_SERVE_ARGS) + ["--ckpt-dir", str(tmp)])
        t0 = time.perf_counter()
        report = serve.serve_dgo(args, device=None if dev.type == "cuda"
                                 else dev)
        wall = time.perf_counter() - t0
        want = args.restarts * args.waves
        check(report["completed"] == want and report["failed"] == 0,
              f"serve --dgo: {report['completed']} of {want} completed")
        tuned = [h for h in seen["handles"]
                 if h.request.problem.name == SUBSPACE]
        best = min(tuned, key=lambda h: float(h.result().best_f))
        check(len(report["checkpoints"]) == 1,
              f"checkpoints {report['checkpoints']}")
        path = Path(report["checkpoints"][0])
        params = best.request.problem.materialize(best.result().best_x)
        back = restore_checkpoint(path.parent, int(path.name[5:]), params)
        same = _trees_equal(back, params)
        print(f"[subspace] serve --dgo {' '.join(SUBSPACE_SERVE_ARGS[1:])} "
              f"--ckpt-dir: {report['completed']} requests in {wall:.2f} s "
              f"({len(tuned)} tuning), winner best_f "
              f"{float(best.result().best_f)!r}; {path.name} restores to "
              f"materialize(best_x) bit for bit: {same}")
        check(same, "the tuning winner's checkpoint differs from "
                    "materialize(best_x)")
    finally:
        serve._persist_winners = real
        shutil.rmtree(tmp, ignore_errors=True)
    return {"card": runs["card"], "cpu": runs["cpu"]}


def phase_meta(dev) -> float:
    """9c: the reference test's quadratic short-train through
    ``Fused(max_bits=7)`` on the card."""
    import torch

    from repro_torch.core.meta import HyperBox, meta_objective
    from repro_torch.core.solver import Fused, solve

    def short_train(hypers):
        lr = hypers["lr"]
        w = torch.full_like(lr, 4.0)
        for _ in range(30):
            w = w - lr * 2 * w
        return w * w

    t0 = time.perf_counter()
    res = solve(meta_objective(short_train, HyperBox(bits=5)),
                Fused(max_bits=7), seed=0,
                device=None if dev.type == "cuda" else dev)
    wall = time.perf_counter() - t0
    print(f"[meta] meta_objective through Fused(max_bits=7): best_f "
          f"{float(res.best_f)!r} (bar {META_BAR}), {res.iterations} "
          f"steps, {wall:.2f} s")
    check(float(res.best_f) < META_BAR, f"meta best_f {float(res.best_f)}")
    return float(res.best_f)


# ---------------------------------------------------------------------------
# phase 10: the zoo — five more architectures served on the card
# ---------------------------------------------------------------------------

# (name, depth cut or None for every layer, serve_lm's batch and prompt):
# gemma3-27b is 108 GB in f32 and granite-34b 189 GB, so each keeps its
# full width and takes its first 12 / 16 layers (gemma's 6th and 12th
# global); gemma's prompt of 2,048 is longer than its 1,024-token window
ZOO = (("codeqwen1.5-7b", None, 2, 1024),
       ("gemma3-27b", 12, 1, 2048),
       ("granite-34b", 16, 2, 1024),
       ("whisper-medium", None, 4, 128),
       ("phi-3-vision-4.2b", None, 2, 448))
# flash launches a prefill: every global full-sequence self-attention
# (gemma: 2 of 12 layers; whisper: 24 encoder layers over 1,500 frames
# and 24 decoder layers; cross-attention's queries are not its keys)
ZOO_LAUNCHES = {"codeqwen1.5-7b": 32, "gemma3-27b": 2, "granite-34b": 16,
                "whisper-medium": 48, "phi-3-vision-4.2b": 32}
ZOO_SERVE = dict(gen_len=8, waves=2, seed=0)
ZOO_TRAIN = ("whisper-medium", "phi-3-vision-4.2b")
ZOO_TRAIN_ARGV = ("--reduced", "--steps", "2", "--global-batch", "2",
                  "--seq-len", "16", "--ckpt-every", "100", "--log-every",
                  "100")
ZOO_SUBSPACE = "subspace-lm:whisper-medium"
# profiler sessions of a phase-10 timing: on one H100 every session from
# the third model on lost 2-4 of 10 records, six times in a row, which
# cost two minutes; a kernel's time is the mean over the launches kept
ZOO_PROFILE_TRIES = 2
ZOO_SUBSPACE_ITERS = 4


def zoo_arch(name, depth):
    """The registry's config at full width (its first ``depth`` layers
    when given), with the flash route on."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch = get_arch(name)
    return dataclasses.replace(arch, n_layers=depth or arch.n_layers,
                               use_flash_attention=True)


def check_flash_scaled(q, k, v, causal, window, label) -> float:
    """The bf16 kernel at a model's own activations against its plain
    version and ref.py: ``FLASH_TOL``'s 2e-2 is an absolute bar set on
    unit-scale random inputs, and a model's attention outputs reach 4-8,
    where one bfloat16 step is 2^-5 = 0.031; so each element's error is
    held to 2e-2 x max(1, |plain or ref|), the same bar up to magnitude
    1 and about two and a half bfloat16 steps above it.  Returns the
    largest |kernel - plain|."""
    from repro_torch.kernels.flash_attention import ops

    got = ops.flash_sdpa(q, k, v, causal=causal, window=window).double()
    tol = FLASH_TOL["bfloat16"]
    errs = []
    for want in (ops.flash_sdpa_plain(q, k, v, scale=q.shape[-1] ** -0.5,
                                      causal=causal, window=window),
                 _flash_oracle(q, k, v, causal, window)):
        d = (got - want.double()).abs()
        errs.append((float(d.max()), float(
            (d / want.double().abs().clamp_min(1.0)).max())))
    (a_plain, s_plain), (a_ref, s_ref) = errs
    msg = (f"{label}: |kernel - plain| {a_plain:.3g} ({s_plain:.3g} of "
           f"max(1, |plain|)), |kernel - ref| {a_ref:.3g} ({s_ref:.3g} of "
           f"max(1, |ref|)) (bar {tol:g} of it)")
    check(s_plain <= tol and s_ref <= tol, f"flash {msg}")
    print(f"[flash] {msg}")
    return a_plain


def time_zoo_shape(q, k, v, kw, dev) -> dict:
    """The f32 and bf16 kernels at one shape a model gave them: each held
    against the plain version and ref.py (``check_flash``), timed beside
    its bound, the plain version (f32) and ``scaled_dot_product_attention``
    on the same tensors (one call; ``enable_gqa`` where Hq != Hkv).  The
    kernels' times are the profiler's mean over the launches it kept;
    the plain version and SDPA, many launches a call of which the
    profiler drops some, are timed with CUDA events around the calls."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    b, s, hq, hd = q.shape
    hkv, causal, window = k.shape[2], kw["causal"], kw["window"]
    shape = (b, s, hq, hkv, hd)
    label = (f"B={b} S={s} Hq={hq} Hkv={hkv} hd={hd} "
             f"{'causal' if causal else 'bidirectional'}")
    out = {"shape": list(shape), "causal": causal}
    for dt, elem in (("float32", 4), ("bfloat16", 2)):
        x = [t.to(getattr(torch, dt)) for t in (q, k, v)]
        sfx = "" if dt == "float32" else "_bf16"
        if dt == "float32":
            out["max_abs_err"] = check_flash(*x, causal, window,
                                             FLASH_TOL[dt], f"zoo {label} f32")
        else:
            out["max_abs_err_bf16"] = check_flash_scaled(*x, causal, window,
                                                         f"zoo {label} bf16")
        out["ms" + sfx] = device_ms(lambda: ops.flash_sdpa(
            *x, causal=causal, window=window), 10, dev, FLASH_KERNELS[dt],
            tries=ZOO_PROFILE_TRIES)
        xt = [t.transpose(1, 2) for t in x]
        out["library_ms" + sfx] = time_ms(
            lambda: F.scaled_dot_product_attention(
                *xt, is_causal=causal, enable_gqa=hq != hkv), 10, dev)
        out["bound_ms" + sfx], out["bound_by" + sfx] = flash_bound_ms(
            shape, causal, window, elem, FLASH_PEAKS[dt])
        del x, xt
    out["plain_ms"] = time_ms(lambda: ops.flash_sdpa_plain(
        q, k, v, scale=hd ** -0.5, causal=causal, window=window), 3, dev)
    print(f"[time] zoo flash {label}: f32 {out['ms']:.4f} ms (bound "
          f"{out['bound_ms']:.4f} ms, {out['bound_by']}, "
          f"{out['bound_ms'] / out['ms']:.3f} of it; SDPA "
          f"{out['library_ms']:.4f} ms; plain {out['plain_ms']:.4f} ms), "
          f"bf16 {out['ms_bf16']:.4f} ms (bound {out['bound_ms_bf16']:.4f} "
          f"ms, {out['bound_ms_bf16'] / out['ms_bf16']:.3f} of it; SDPA "
          f"{out['library_ms_bf16']:.4f} ms); the kernels' device time, "
          f"SDPA and plain by CUDA events")
    return out


def _watch_moe_routing(moe):
    """Wrap ``moe._route_group`` to keep, a call, what it routed beside
    an independent count of the same routing (``torch.topk`` of the
    router's softmax, ``torch.bincount``, the capacity applied to the
    counts): tokens, capacity, each expert's load both ways, the pairs
    dropped both ways, the tokens whose k-th and (k+1)-th probabilities
    tie, and the tokens' mean pairwise cosine (device tensors: no
    synchronisation).  Returns (the list, a function that puts the real
    one back)."""
    import torch

    real = moe._route_group
    seen: list = []

    def watched(p, cfg, xt, capacity):
        out = real(p, cfg, xt, capacity)
        e_sort, keep = out[1][0], out[1][4]
        ct = torch.promote_types(xt.dtype, torch.float32)
        probs = torch.softmax(xt.to(ct) @ p["router"].to(ct), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1)
        own = torch.bincount(top.indices[:, :-1].reshape(-1),
                             minlength=cfg.n_experts)
        unit = torch.nn.functional.normalize(xt.to(ct), dim=-1)
        t = xt.shape[0]
        cos = (unit.sum(0).square().sum() - t) / max(t * (t - 1), 1)
        seen.append(dict(
            tokens=t, capacity=capacity,
            load=torch.bincount(e_sort, minlength=cfg.n_experts),
            dropped=(~keep).sum(), own_load=own,
            own_dropped=(own - capacity).clamp_min(0).sum(),
            ties=(top.values[:, -2] == top.values[:, -1]).sum(), cos=cos))
        return out

    moe._route_group = watched

    def restore():
        moe._route_group = real
    return seen, restore


def moe_routing(arch, params, kw, prompt_len, dev) -> dict:
    """One wave of ``serve_lm`` again, untimed, with every routing of its
    MoE layers watched (:func:`_watch_moe_routing`): each must equal the
    independent count (loads and drops; a tie at the k-th choice lets
    them differ by two pairs a tie).  Prints, per MoE layer of the
    prefill, the experts used, the largest load beside the capacity, the
    experts over it, the pairs dropped and the tokens' mean cosine, and
    the pairs dropped a wave.  Returns those, {"prefill": [dropped,
    routed], "decode": [...]}."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import moe

    seen, restore = _watch_moe_routing(moe)
    try:
        serve_lm(arch, params=params, device=dev,
                 **{**kw, "waves": 1, "prompt_len": prompt_len})
    finally:
        restore()
    k, name = arch.moe_top_k, arch.name
    rows = [{x: (v if isinstance(v, int) else v.cpu()) for x, v in r.items()}
            for r in seen]
    for r in rows:
        slack = 2 * int(r["ties"])
        diff = int((r["load"] - r["own_load"]).abs().sum())
        check(diff <= slack
              and abs(int(r["dropped"]) - int(r["own_dropped"])) <= slack,
              f"zoo {name}: routing of {r['tokens']} tokens differs from "
              f"topk + bincount by {diff} pairs, drops {int(r['dropped'])} "
              f"vs {int(r['own_dropped'])} ({int(r['ties'])} ties)")
    t_prefill = kw["batch"] * (prompt_len + arch.vision_tokens)
    pre = [r for r in rows if r["tokens"] == t_prefill]
    dec = [r for r in rows if r["tokens"] == kw["batch"]]
    check(len(pre) + len(dec) == len(rows) and pre and dec,
          f"zoo {name}: {len(rows)} routings, {len(pre)} prefill and "
          f"{len(dec)} decode")
    for i, r in enumerate(pre):
        load = r["load"]
        print(f"[zoo] {name} prefill MoE layer {i}: {t_prefill} tokens x "
              f"top-{k}, {int((load > 0).sum())} of {arch.moe_experts} "
              f"experts used, largest load {int(load.max())} vs capacity "
              f"{r['capacity']}, {int((load > r['capacity']).sum())} "
              f"experts over it, {int(r['dropped'])} of {t_prefill * k} "
              f"pairs dropped (topk + bincount: {int(r['own_dropped'])}, "
              f"{int(r['ties'])} ties); tokens' mean cosine "
              f"{float(r['cos']):.4f}")
    dropped = {phase: [sum(int(r["dropped"]) for r in rs),
                       sum(r["tokens"] for r in rs) * k]
               for phase, rs in (("prefill", pre), ("decode", dec))}
    print(f"[zoo] {name} MoE pairs dropped a wave (an untimed wave; of the "
          f"pairs routed over its {arch.n_layers - arch.moe_dense_layers} "
          f"MoE layers, each equal to topk + bincount): prefill "
          f"{dropped['prefill'][0]} of {dropped['prefill'][1]}, decode "
          f"{dropped['decode'][0]} of {dropped['decode'][1]} (capacity "
          f"factor {arch.moe_capacity}; decode capacity "
          f"{dec[0]['capacity']})")
    return dropped


def serve_zoo_model(name, depth, batch, prompt_len, dev) -> dict:
    """10a-c and 11a-c for one model: ``serve_lm`` through the kernel, its
    count set to 0 just before and read just after; an MoE model's
    routing watched in one more wave, untimed (:func:`moe_routing`); the
    same weights, prompts and stub inputs
    through the chunked plain attention (prefill logits within 1e-3 x
    max |logit|, tokens equal but at near-ties); one prefill under the
    profiler; the kernel at each shape the model gave it (the first call
    of each (S, causal))."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import init_model, lm_prefill, n_params

    arch = zoo_arch(name, depth)
    per_prefill = {**ZOO_LAUNCHES, **ZOO2_LAUNCHES}[name]
    kw = dict(batch=batch, prompt_len=prompt_len, **ZOO_SERVE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(arch, torch.Generator(device=dev).manual_seed(
        kw["seed"]))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    captured: dict = {}
    real = ops.flash_sdpa

    def capture(q, k, v, **kwargs):    # the first call of each shape
        key = (q.shape[1], kwargs["causal"])
        if key not in captured:
            captured[key] = (q.clone(), k.clone(), v.clone(), kwargs)
        return real(q, k, v, **kwargs)

    ops.flash_sdpa = capture
    ops.launches = 0
    try:
        res = serve_lm(arch, params=params, **kw)   # device None: the card
        n_launch = ops.launches
    finally:
        ops.flash_sdpa = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = per_prefill * kw["waves"]
    cut = f", first {depth} of its layers" if depth else ""
    print(f"[zoo] {name} f32 ({n_params(arch):,} parameters{cut}; drawn "
          f"in {t_init:.2f} s) B={batch} prompt {prompt_len}"
          + (f" after {arch.vision_tokens} image tokens"
             if arch.vision_tokens else "")
          + (f", {arch.n_frames} frames" if arch.enc_dec else "")
          + f", gen {kw['gen_len']}, {kw['waves']} waves: flash launches "
          f"{n_launch} (want {want}); prefill wall "
          f"{', '.join(f'{s:.4f}' for s in res.prefill_s)} s; decode "
          f"{res.decode_tokens_per_s:.1f} tokens/s ({res.decode_tokens} "
          f"tokens in {res.decode_s:.4f} s); peak memory {peak:.2f} GiB")
    check(n_launch == want, f"zoo {name}: {n_launch} flash launches, want "
                            f"{want}")
    dropped = (moe_routing(arch, params, kw, prompt_len, dev)
               if arch.moe_experts else None)
    for toks, logits in zip(res.tokens, res.logits):
        check(tuple(toks.shape) == (batch, kw["gen_len"])
              and bool(logits.isfinite().all()),
              f"zoo {name}: tokens {tuple(toks.shape)} or non-finite logits")

    plain = serve_lm(dataclasses.replace(arch, use_flash_attention=False),
                     device=dev, params=params, **kw)
    notes = []
    for w in range(kw["waves"]):
        check(torch.equal(res.prompts[w], plain.prompts[w])
              and all(torch.equal(res.extras[w][x], plain.extras[w][x])
                      for x in res.extras[w]),
              f"zoo {name} wave {w}: inputs differ")
        la, lb = res.logits[w][0], plain.logits[w][0]
        d, big = _max_abs(la, lb), float(lb.abs().max())
        check(d <= 1e-3 * big, f"zoo {name} wave {w}: prefill logits differ "
                               f"by {d:.3g} > 1e-3 x {big:.3g}")
        parted = tokens_match(res.tokens[w].cpu().numpy(),
                              plain.tokens[w].cpu().numpy(),
                              plain.logits[w].cpu().numpy())
        notes.append(f"wave {w}: max |logit diff| {d:.3g} (max |logit| "
                     f"{big:.3g}), tokens "
                     + (f"part at near-ties {parted}" if parted
                        else "identical"))
    print(f"[zoo] {name} flash vs chunked plain attention"
          + ("" if per_prefill else " (no kernel on its path: the same "
             "computation again)") + f": {'; '.join(notes)}")

    inputs = {"tokens": res.prompts[0].to(dev),
              **{x: t.to(dev) for x, t in res.extras[0].items()}}
    cache_len = prompt_len + kw["gen_len"]
    f32 = FLASH_KERNELS["float32"]
    prof, wall = profiled(lambda: lm_prefill(
        params, arch, inputs, cache_len, dtype=torch.float32),
        f32 if per_prefill else None, per_prefill or None,
        tries=ZOO_PROFILE_TRIES)
    k_us, k_n = _device_activity(prof, f32)
    all_us, _ = _device_activity(prof)
    print(f"[zoo] {name} one prefill under the profiler: wall {wall:.4f} s, "
          f"device {all_us / 1e3:.3f} ms ({all_us / 1e6 / wall:.3f} of the "
          f"wall busy), of which {k_n} flash launches "
          f"{k_us / 1e3:.3f} ms ({k_us / max(all_us, 1e-9):.3f} of it)")
    stats = {"peak_gib": peak, "prefill_s": res.prefill_s,
             "decode_tokens_per_s": res.decode_tokens_per_s,
             "device_busy": all_us / 1e6 / wall}
    del params, res, plain, inputs, prof
    torch.cuda.empty_cache()
    shapes = [time_zoo_shape(q, k, v, kwargs, dev)
              for q, k, v, kwargs in captured.values()]
    del captured
    torch.cuda.empty_cache()
    return {"launches": n_launch, "prefill_share": k_us / max(all_us, 1e-9),
            "shapes": shapes, "dropped": dropped, **stats}


def phase_zoo(dev, label, models, train, subspace) -> dict:
    """Phases 10 and 11, the zoo beyond qwen2 on the card: (a-c) each of
    ``models`` served at full width (some cut in depth), one at a time,
    each freed before the next, by :func:`serve_zoo_model`; (d)
    ``run_training`` of ``reduced()`` of each of ``train`` for 2 steps
    (:func:`train_zoo_model`); (e) ``solve(subspace, Fused(),
    max_iters=4)`` on the card (:func:`solve_zoo_subspace`).  Returns
    each served model's measurements by name."""
    import gc

    import torch

    t_phase = time.perf_counter()
    CLOCK_NOTES.setdefault("flash_attention", []).append(
        f"phase {label}'s plain_ms and library_ms by CUDA events")
    by_model = {}
    for name, depth, batch, prompt_len in models:
        gc.collect()
        torch.cuda.empty_cache()
        by_model[name] = serve_zoo_model(name, depth, batch, prompt_len, dev)
    gc.collect()
    torch.cuda.empty_cache()
    for name in train:
        train_zoo_model(name, dev)
    solve_zoo_subspace(subspace, dev)
    print(f"[zoo] phase {label}: {time.perf_counter() - t_phase:.1f} s")
    return by_model


# ---------------------------------------------------------------------------
# phase 11: the zoo, part 2 — xLSTM, zamba2 and the two deepseek models
# ---------------------------------------------------------------------------

# (name, depth cut or None for every layer, serve_lm's batch and prompt):
# deepseek-v2-236b is 943 GB in f32 and deepseek-v3-671b 2.69 TB, so each
# keeps its full width and takes its leading layers: v2's dense layer and
# 2 MoE layers (37.3 GB), v3's 3 dense layers and 1 MoE layer (63.2 GB)
ZOO2 = (("xlstm-125m", None, 4, 1024),
        ("zamba2-1.2b", None, 4, 1024),
        ("deepseek-v2-236b", 3, 2, 512),
        ("deepseek-v3-671b", 4, 1, 512))
# flash launches a prefill: zamba2's shared block, applied before every
# 6 of its 38 Mamba layers (7 times) without a window; xLSTM and Mamba
# have no attention, MLA stays on the chunked plain path (q/k head_dim
# 192, v 128), as in the reference
ZOO2_LAUNCHES = {"xlstm-125m": 0, "zamba2-1.2b": 7, "deepseek-v2-236b": 0,
                 "deepseek-v3-671b": 0}
ZOO2_SUBSPACE = "subspace-lm:xlstm-125m"


def train_zoo_model(name, dev) -> list:
    """``run_training`` of ``reduced(name)`` for ``ZOO_TRAIN_ARGV``'s 2
    steps in a temporary checkpoint directory: finite losses; for an
    MTP model, its head's loss computed once a step, finite and positive
    (so the term is in the loss).  Returns the losses."""
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import lm

    mtp = []
    real = lm._mtp_loss

    def counted(*a, **k):
        out = real(*a, **k)
        mtp.append(out.detach())
        return out

    lm._mtp_loss = counted
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        args = train.build_argparser().parse_args(
            ["--arch", name, *ZOO_TRAIN_ARGV, "--ckpt-dir", tmp])
        out = train.run_training(args, device=dev)
    finally:
        lm._mtp_loss = real
        shutil.rmtree(tmp, ignore_errors=True)
    mtp = [float(v) for v in mtp]
    print(f"[zoo] run_training reduced {name}: losses {out['losses']}, "
          f"step seconds {out['step_s']}"
          + (f"; MTP head's loss a step {mtp} (x 0.3 in the loss)"
             if mtp else ""))
    check(len(out["losses"]) == 2
          and all(np.isfinite(v) for v in out["losses"]),
          f"zoo train {name}: losses {out['losses']}")
    if get_arch(name).mtp:
        check(len(mtp) == 2 and all(np.isfinite(v) and v > 0 for v in mtp),
              f"zoo train {name}: MTP losses {mtp}")
    return out["losses"]


def solve_zoo_subspace(spec, dev) -> None:
    """``solve(spec, Fused(), max_iters=ZOO_SUBSPACE_ITERS)`` on the
    card: best_f finite and no popstep launch (the objective has no
    device form)."""
    from repro_torch.core.solver import Fused, solve
    from repro_torch.kernels.popstep import ops as popstep

    popstep.launches = popstep.fold_launches = 0
    t0 = time.perf_counter()
    res = solve(spec, Fused(), seed=0, max_iters=ZOO_SUBSPACE_ITERS,
                device=None if dev.type == "cuda" else dev)
    wall = time.perf_counter() - t0
    print(f"[zoo] solve({spec}, Fused(), max_iters={ZOO_SUBSPACE_ITERS}) "
          f"on the card: best_f {float(res.best_f)!r}, {res.iterations} "
          f"steps, {res.extras['evaluations']} evaluations in {wall:.2f} s; "
          f"popstep launches {popstep.launches}")
    check(np.isfinite(float(res.best_f)) and popstep.launches == 0
          and popstep.fold_launches == 0,
          f"zoo subspace {spec}: best_f {float(res.best_f)}, popstep "
          f"launches {popstep.launches} + {popstep.fold_launches}")


# ---------------------------------------------------------------------------
# phase 12: the launch layer — a fleet, build_cell's steps, subspace DGO's
# production step, the dry run
# ---------------------------------------------------------------------------

FLEET_PROBLEM = "remote_sensing"        # full width: 680 vars, 5,439 children
FLEET_ITERS = 64
FLEET_SHAPE = (2, 4)                    # --processes 2 x --devices 4
FLEET_DEVICE = None                     # the card (a rehearsal: "cpu")
# each worker: warm-up (binds the kernel step), then the counted solve;
# one JSON line written in one write(2), so the workers' lines do not mix
FLEET_PAYLOAD = """
import json, os, time
from repro_torch.launch.launcher import maybe_initialize_from_env
maybe_initialize_from_env()
import torch
from repro_torch.core.distributed import fleet
from repro_torch.core.solver import Distributed, resolve_mesh, solve
from repro_torch.kernels.popstep import ops
def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
solve(PROBLEM, Distributed(), seed=0, max_iters=2, device=DEVICE)
sync()
ops.launches = ops.fold_launches = 0
t0 = time.perf_counter()
r = solve(PROBLEM, Distributed(), seed=0, max_iters=ITERS, device=DEVICE)
sync()
wall = time.perf_counter() - t0
fl = fleet()
os.write(1, (json.dumps({
    "rank": fl[0] if fl else 0, "world": fl[1] if fl else 1,
    "shards": list(resolve_mesh().sizes), "best_f": float(r.best_f),
    "history": [float(v) for v in r.extras["history"]],
    "iterations": int(r.iterations), "launches": ops.launches,
    "fold_launches": ops.fold_launches, "wall": wall}) + "\\n").encode())
"""
STEPS_ARCH = "qwen2-1.5b"
# (shape, the cut global batch): train_4k 256 -> 8 (microbatches of 4, so
# the accumulation runs two), prefill_32k 32 -> 1, decode_32k 128 -> 8
STEPS_SHAPES = (("train_4k", 8), ("prefill_32k", 1), ("decode_32k", 8))
STEPS_PROMPT = 128          # the decode cell's prompt before its token
# the reference's DGO cell at full width and depth (12 layers, 3 of them
# sLSTM): the (64, P) directions take 37 GB; the cross-entropy's vocab
# chunk is 128 tokens (of 512) so a chunk of children's logits fits beside
# them, and each chunk is bound by the sLSTM's ~25 launches a token
DGO_CELL = dict(arch="xlstm-125m", d_sub=64, bits=4, batch=8, seq=512,
                steps=2, alpha=2.0, loss_chunk=128)
DGO_CHUNK_BYTES = 16 << 30  # float32 parameters of the children at once
DGO_OWN_BAR = 0.0           # new_val vs the step's own evaluation of the
#                             winner (``step.evaluate``: the same product
#                             in a chunk of the step's size): equal
DGO_BF16_BAR = 5e-3         # new_val vs the winner's parameters from
#                             apply_subspace's ordered sum, evaluated
#                             alone: float32 sums that differ in rounding
#                             and bf16 kernels of another shape (measured
#                             3.6e-4 to 2.7e-3 on an H100)
DGO_SAMPLE = 8              # children held against the parent in bf16
#                             and float32 each step
DRY_CELLS = (("qwen2-1.5b", "train_4k"), ("deepseek-v3-671b", "train_4k"))
DRY_LOG = ROOT / "build" / "chip_smoke_dryrun"     # .out / .err


def _fleet_run(args, timeout=600) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    code = FLEET_PAYLOAD.replace("PROBLEM", repr(FLEET_PROBLEM)).replace(
        "ITERS", str(FLEET_ITERS)).replace("DEVICE", repr(FLEET_DEVICE))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.launcher", *args, "--",
         sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=timeout)
    check(out.returncode == 0, f"fleet {args}: rc {out.returncode}: "
                               f"{out.stderr[-3000:]}")
    rows = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    return {row["rank"]: row for row in rows}


def phase_fleet(dev) -> dict:
    """12a: ``solve(remote_sensing, Distributed())`` at full width, 64
    iterations, seed 0, in a launcher fleet of 2 processes x 4 shards
    (each worker's popstep on the one card, the (value, id) pairs over
    gloo) and in one process of 8 shards: both workers' best_f and
    history ``==`` the single process's; each worker's popstep launches
    and wall per step printed.  Returns ``by_path``'s fleet entry."""
    k, n = FLEET_SHAPE
    fleet = _fleet_run(["--processes", str(k), "--devices", str(n)])
    single = _fleet_run(["--devices", str(k * n)])[0]
    check(sorted(fleet) == list(range(k)), f"fleet ranks {sorted(fleet)}")
    per_single = single["wall"] / max(single["iterations"], 1)
    for rank, row in sorted(fleet.items()):
        same = (row["best_f"] == single["best_f"]
                and row["history"] == single["history"])
        per = row["wall"] / max(row["iterations"], 1)
        print(f"[fleet] worker {rank} of {k} (mesh {row['shards']} shards, "
              f"4 stepped here): best_f {row['best_f']!r}, "
              f"{row['iterations']} iterations, popstep launches "
              f"{row['launches']} (fold {row['fold_launches']}), wall "
              f"{row['wall']:.3f} s = {1e3 * per:.3f} ms a step; "
              f"== single process: {same}")
        check(same, f"fleet worker {rank}: best_f {row['best_f']} / "
                    f"history {row['history'][-3:]} vs single "
                    f"{single['best_f']} / {single['history'][-3:]}")
        check(row["shards"] == [k * n] and row["fold_launches"] == 0
              and row["iterations"] <= row["launches"]
              <= row["iterations"] + 16,
              f"fleet worker {rank}: shards {row['shards']}, launches "
              f"{row['launches']} + {row['fold_launches']} for "
              f"{row['iterations']} iterations")
    print(f"[fleet] single process, {k * n} shards: best_f "
          f"{single['best_f']!r}, {single['iterations']} iterations, "
          f"popstep launches {single['launches']}, wall "
          f"{single['wall']:.3f} s = {1e3 * per_single:.3f} ms a step; "
          f"the fleet's per-step exchange costs "
          f"{1e3 * (max(r['wall'] / max(r['iterations'], 1) for r in fleet.values()) - per_single):.3f} ms a step")
    return {"fleet": (sum(r["launches"] for r in fleet.values()),
                      sum(r["fold_launches"] for r in fleet.values()))}


def _nbytes_local(tree) -> int:
    from torch.distributed.tensor import DTensor

    import torch
    if isinstance(tree, DTensor):
        t = tree.to_local()
        return t.numel() * t.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes_local(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes_local(v) for v in tree)
    return 0


def _cell_report(label, cell, args, wall, dev) -> None:
    import torch

    from repro_torch.launch import dryrun
    want = dryrun.cell_bytes(cell)["argument_size_in_bytes"]
    got = _nbytes_local(args)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[steps] {label}: wall {wall:.3f} s, peak memory "
          f"{peak / 2**30:.2f} GiB, arguments {got} bytes a device (the dry "
          f"run's record of this cell on a (1, 1) mesh: {want})")
    check(got == want, f"steps {label}: arguments {got} bytes, the dry run "
                       f"says {want}")


def phase_steps(dev) -> int:
    """12b: ``build_cell`` on a (1, 1) NCCL mesh, qwen2-1.5b at full width
    in bf16 through the steps (each cut printed): train_4k at global batch
    8 (two microbatches of 4; its loss == the mean of ``lm_loss`` over
    them within 1e-6, the parameters move), prefill_32k at batch 1 through
    the bf16 flash kernel (28 launches; logits within 2e-2 x max(1, |x|)
    of the same step without the kernel), decode_32k at batch 8 against a
    32,768-token cache (finite logits, the plain route's greedy token).
    Returns the flash launches of the prefill step."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.launch.mesh import ensure_process_group, make_host_mesh
    from repro_torch.launch.steps import (
        build_cell, make_prefill_step, place)
    from repro_torch.models import init_model, lm_decode, lm_loss, lm_prefill
    from repro_torch.optim.gradient import AdamWConfig, adamw_init

    gc.collect()                 # the earlier phases' tensors, cached blocks
    torch.cuda.empty_cache()
    ensure_process_group(dev)
    mesh = make_host_mesh(model=1)
    arch = get_arch(STEPS_ARCH)
    params = init_model(arch, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16).tree()
    rng = np.random.default_rng(12)
    cuts = dict(STEPS_SHAPES)

    # train_4k
    shape = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=cuts["train_4k"])
    # no warm-up, so the first step's update (lr 3e-4) shows in bf16
    cell = build_cell(arch, shape, mesh,
                      opt_cfg=AdamWConfig(warmup_steps=1))
    print(f"[steps] {STEPS_ARCH} train_4k cut to global batch "
          f"{shape.global_batch} (of {SHAPES['train_4k'].global_batch}): "
          f"policy {cell.meta['policy']}, {cell.meta['n_micro']} "
          f"microbatches of {cell.meta['microbatch']}")
    n_micro, mb = cell.meta["n_micro"], cell.meta["microbatch"]
    toks = torch.from_numpy(rng.integers(0, arch.vocab_size, (
        n_micro, mb, shape.seq_len)).astype(np.int32)).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    with torch.no_grad():
        want = sum(float(lm_loss(params, arch, {
            "tokens": toks[i].long(), "labels": batch["labels"][i].long()}))
            for i in range(n_micro)) / n_micro
    before = params["embed"]["table"].float().clone()
    args = (place(params, cell.in_shardings[0]),
            place(adamw_init(params), cell.in_shardings[1]),
            place(batch, cell.in_shardings[2]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    new_p, _, loss = cell.step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _cell_report("train_4k", cell, args, wall, dev)
    after = new_p["embed"]["table"].to_local().float()
    moved = float((after - before).abs().max())
    print(f"[steps] train_4k loss {float(loss)!r} vs lm_loss over the "
          f"microbatches {want!r}; the embedding moved by up to "
          f"{moved:.3g}")
    check(abs(float(loss) - want) <= 1e-6 * abs(want),
          f"steps train_4k: loss {float(loss)} vs lm_loss {want}")
    check(moved > 0, "steps train_4k: the parameters did not move")
    del args, new_p, loss
    torch.cuda.empty_cache()

    # prefill_32k through the bf16 kernel
    flash_arch = dataclasses.replace(arch, use_flash_attention=True)
    shape = dataclasses.replace(SHAPES["prefill_32k"],
                                global_batch=cuts["prefill_32k"])
    cell = build_cell(flash_arch, shape, mesh)
    plain = build_cell(arch, shape, mesh)
    toks = torch.from_numpy(rng.integers(0, arch.vocab_size, (
        shape.global_batch, shape.seq_len)).astype(np.int32)).to(dev)
    pp = place(params, cell.in_shardings[0])
    b = place({"tokens": toks}, cell.in_shardings[1])
    cell.step(pp, b)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    flash.launches = 0
    t0 = time.perf_counter()
    logits, _ = cell.step(pp, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_flash = flash.launches
    _cell_report(f"prefill_32k (batch {shape.global_batch} of "
                 f"{SHAPES['prefill_32k'].global_batch})", cell, (pp, b),
                 wall, dev)
    want, _ = plain.step(pp, b)
    got, want = logits.to_local().float(), want.to_local().float()
    d = _max_abs(got, want)
    bar = 2e-2 * max(1.0, float(want.abs().max()))
    print(f"[steps] prefill_32k flash launches {n_flash} (want "
          f"{arch.n_layers}); logits vs the step without the kernel: max "
          f"|diff| {d:.3g} (bar {bar:.3g})")
    check(n_flash == arch.n_layers, f"steps prefill: {n_flash} flash "
                                    f"launches, want {arch.n_layers}")
    check(bool(got.isfinite().all()) and d <= bar,
          f"steps prefill: logits differ by {d:.3g} > {bar:.3g}")
    del logits, want, got
    torch.cuda.empty_cache()

    # decode_32k against a 32,768-token cache
    shape = dataclasses.replace(SHAPES["decode_32k"],
                                global_batch=cuts["decode_32k"])
    cell = build_cell(arch, shape, mesh, prompt_len=STEPS_PROMPT)
    prompt = torch.from_numpy(rng.integers(0, arch.vocab_size, (
        shape.global_batch, STEPS_PROMPT))).to(dev)
    prefill = make_prefill_step(arch, shape.seq_len, torch.bfloat16,
                                mesh=mesh, out_layouts=(
                                    cell.in_shardings[1], cell.in_shardings[2]))
    _, cache = prefill(pp, {"tokens": prompt})
    tok = place(prompt[:, -1].to(torch.int32), cell.in_shardings[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, _ = cell.step(pp, tok, cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _cell_report(f"decode_32k (batch {shape.global_batch} of "
                 f"{SHAPES['decode_32k'].global_batch})", cell,
                 (pp, tok, cache), wall, dev)
    got = logits.to_local().float()
    with torch.no_grad():
        _, pc = lm_prefill(params, arch, {"tokens": prompt}, shape.seq_len)
        want, _ = lm_decode(params, arch, prompt[:, -1], pc)
    ta, tb = got.argmax(-1), want.float().argmax(-1)
    bar = 2e-2 * max(1.0, float(want.abs().max()))
    parted = [r for r in torch.nonzero(ta != tb).flatten().tolist()]
    for r in parted:
        gap = abs(float(want[r, ta[r]]) - float(want[r, tb[r]]))
        check(gap <= bar, f"steps decode: row {r} token {int(ta[r])} vs "
                          f"{int(tb[r])}, {gap:.3g} apart: not a near-tie")
    print(f"[steps] decode_32k: logits finite {bool(got.isfinite().all())}, "
          f"greedy tokens vs lm_prefill + lm_decode: "
          + (f"part at near-ties in rows {parted}" if parted
             else "identical"))
    check(bool(got.isfinite().all()), "steps decode: non-finite logits")
    del pp, cache, params
    torch.cuda.empty_cache()
    return n_flash


def phase_dgo_step(dev) -> None:
    """12c: ``make_dgo_train_step`` on one rank: xlstm-125m at full
    width and depth, bf16 weights, d_sub 64 at 4 bits (511 children), B 8,
    S 512, two steps.  Each step: ``improved`` iff ``new_val <
    parent_val``; ``new_val`` == the step's own evaluation of the winner
    (``step.evaluate``) within ``DGO_OWN_BAR``.  Printed, not checked:
    the parent, the winner and ``DGO_SAMPLE`` children in bf16 and in
    float32 through the same product, and how many comparisons with the
    parent float32 reverses.  The last winner's ``new_val`` == ``lm_loss``
    at ``materialize_winner(new_bits)`` within ``DGO_BF16_BAR``.  Seconds
    a step and children a second."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core.encoding import Encoding, encode
    from repro_torch.core.population import schedule_tables
    from repro_torch.core.subspace import (
        make_dgo_train_step, materialize_winner)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_model, lm_loss

    import dataclasses

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = DGO_CELL
    arch = dataclasses.replace(get_arch(c["arch"]),
                               loss_chunk=c["loss_chunk"])
    mesh = make_host_mesh(model=1)
    params = init_model(arch, torch.Generator(device=dev).manual_seed(1),
                        torch.bfloat16).tree()
    enc = Encoding(n_vars=c["d_sub"], bits=c["bits"], lo=-1.0, hi=1.0)
    tables = schedule_tables(enc.n_vars, (enc.bits,), enc.lo, enc.hi,
                             device=dev)
    sample = torch.arange(DGO_SAMPLE, device=dev) * (
        enc.population // DGO_SAMPLE)
    key = prng.PRNGKey(3)
    tokens, labels = lm_synthetic_batch(prng.PRNGKey(2), c["batch"],
                                        c["seq"], arch.vocab_size)
    batch = {"tokens": torch.from_numpy(tokens).long().to(dev),
             "labels": torch.from_numpy(labels).long().to(dev)}

    def loss_fn(p, b):
        return lm_loss(p, arch, b, dtype=torch.bfloat16)

    def loss32(p, b):
        return lm_loss(p, arch, b, dtype=torch.float32)

    step = make_dgo_train_step(loss_fn, enc, mesh,
                               pop_axes=("data", "model"),
                               alpha=c["alpha"],
                               chunk_bytes=DGO_CHUNK_BYTES)
    bits = encode(torch.zeros(enc.n_vars, device=dev), enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = step.evaluate(params, batch, bits[None], key)[0]
    torch.cuda.synchronize()
    n_p = sum(t.numel() for t in tree_leaves(params))
    print(f"[dgo-step] {c['arch']} full width and depth ({arch.n_layers} "
          f"layers, {n_p} parameters), bf16, d_sub {enc.n_vars} x "
          f"{enc.bits} bits = {enc.population} children, B {c['batch']} S "
          f"{c['seq']}, cross-entropy chunk {arch.loss_chunk}: parent loss "
          f"{float(val)!r} (the step's own evaluation; holding the "
          f"({enc.n_vars}, P) directions took "
          f"{time.perf_counter() - t0:.2f} s)")
    for i in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_bits, new_val, improved = step(params, batch, bits, val, key)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(bool(improved) == bool(new_val < val),
              f"dgo-step {i}: improved {bool(improved)} but new "
              f"{float(new_val)} vs parent {float(val)}")
        own = float(step.evaluate(params, batch, new_bits[None], key)[0])
        rel = abs(float(new_val) - own) / abs(own)
        rows = torch.cat([torch.stack([bits, new_bits]),
                          tables.children(bits, sample, 0)])
        b16, f32 = (step.evaluate(params, batch, rows, key, fn).tolist()
                    for fn in (loss_fn, loss32))
        flips = sum((b16[j] < b16[0]) != (f32[j] < f32[0])
                    for j in range(2, len(rows)))
        noise = max(abs(x - y) for x, y in zip(b16, f32))
        kept = (f32[1] < f32[0]) == bool(improved)
        print(f"[dgo-step] step {i}: {secs:.2f} s "
              f"({enc.population / secs:.1f} children/s), improved "
              f"{bool(improved)}, new_val {float(new_val)!r} (parent "
              f"{float(val)!r}, margin {float(val) - float(new_val):.6g}); "
              f"the step's own evaluation of the winner {own!r} (rel "
              f"{rel:.3g}, bar {DGO_OWN_BAR}); parent and winner in "
              f"float32 {f32[0]!r}, {f32[1]!r}: float32 "
              f"{'keeps' if kept else 'reverses'} the step's decision; of {DGO_SAMPLE} children float32 "
              f"reverses {flips} comparisons with the parent; bf16 vs "
              f"float32 up to {noise:.4g} ({b16})")
        check(rel <= DGO_OWN_BAR, f"dgo-step {i}: new_val "
                                  f"{float(new_val)} vs {own}")
        bits, val = new_bits, new_val
    with torch.no_grad():
        alone = float(loss_fn(materialize_winner(
            params, bits, enc, key, c["alpha"]), batch))
    rel = abs(float(val) - alone) / abs(alone)
    print(f"[dgo-step] the last winner's lm_loss at materialize_winner "
          f"alone {alone!r} vs new_val {float(val)!r} (rel {rel:.3g}, bar "
          f"{DGO_BF16_BAR}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(rel <= DGO_BF16_BAR, f"dgo-step: new_val {float(val)} vs the "
                               f"materialized winner's {alone}")
    del step, params
    torch.cuda.empty_cache()


def start_dry_run() -> subprocess.Popen:
    """12d, started first and read last: the meta-device dry run of
    ``DRY_CELLS`` and the subspace-DGO cell on pod16x16 (256 fake ranks)
    in a process of its own (the fake group is global to a process); CPU
    work only (deepseek-v3's 16 microbatches of 61 layers take minutes),
    at a lower priority than the timed phases."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    code = ("import json, logging\n"
            "logging.getLogger('torch.distributed.tensor._redistribute')"
            ".setLevel(logging.ERROR)\n"
            "from repro_torch.launch import dryrun\n"
            f"for a, s in {DRY_CELLS!r}:\n"
            "    r = dryrun.run_cell(a, s, False)\n"
            "    print(json.dumps(r), flush=True)\n"
            "print(json.dumps(dryrun.run_dgo_cell(False)), flush=True)\n")
    env["OMP_NUM_THREADS"] = "1"         # meta tensors: nothing to compute
    # files, not pipes: nobody reads a pipe until 12d, and a full one
    # would stop the dry run
    DRY_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(DRY_LOG.with_suffix(".out"), "w") as out, \
            open(DRY_LOG.with_suffix(".err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                cwd=ROOT, stdout=out, stderr=err,
                                preexec_fn=lambda: os.nice(10))
    atexit.register(proc.kill)            # a failed phase leaves no process
    return proc


def phase_dry_run(proc: subprocess.Popen) -> None:
    """12d's records: argument bytes a device, the policy and the
    collective counts by kind; the DGO cell's table only the (value, id)
    all-gathers."""
    t0 = time.perf_counter()
    proc.wait(timeout=900)
    out = DRY_LOG.with_suffix(".out").read_text()
    err = DRY_LOG.with_suffix(".err").read_text()
    print(f"[dryrun] waited {time.perf_counter() - t0:.1f} s for it")
    check(proc.returncode == 0, f"dry run: rc {proc.returncode}: "
                                f"{err[-3000:]}")
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check(len(recs) == len(DRY_CELLS) + 1, f"dry run: {len(recs)} records")
    for rec in recs:
        counts = {k: v["count"] for k, v in rec["collectives"].items()}
        wire = {k: v["executed_wire_bytes"]
                for k, v in rec["collectives"].items()}
        mem = rec.get("memory_analysis", {})
        print(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"{rec['step_s']} s; arguments "
              f"{mem.get('argument_size_in_bytes')} bytes a device; "
              f"meta {rec.get('meta')}; collectives {counts}, wire bytes "
              f"{wire}; flops {rec['cost_analysis']['flops']:.4g}")
    dgo = recs[-1]
    check(set(dgo["collectives"]) == {"all-gather"}
          and dgo["collectives"]["all-gather"]["bytes"]
          <= 16 * dgo["shards"],
          f"dry run: the DGO cell's table {dgo['collectives']}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    dry = start_dry_run()
    phase_build()
    rs = phase_kernel_vs_plain(dev)
    bound_ms, bound_by = popstep_bound_ms(rs)
    rs["term_table"] = phase_term_table(dev)
    timing_for("popstep_fold")
    fold = phase_fold(dev, rs["enc"].population)
    fold_bound, fold_by = fold_bound_ms(fold)
    timing_for("popstep")
    by_path = phase_main_path(dev, rs["ms"], rs["rastrigin_ms"])
    by_path.update(phase_schedule(dev))
    timing_for("packed")
    errs, pt, packed = phase_packed(dev)
    timing_for("flash_attention")
    ft = phase_flash(dev)
    served = phase_serve(dev)
    timing_for("popstep")
    restarts, dgo_paths = phase_dgo(dev)
    by_path.update(dgo_paths)
    phase_train(dev)
    phase_subspace(dev)
    phase_meta(dev)
    timing_for("flash_attention")
    zoo = phase_zoo(dev, 10, ZOO, ZOO_TRAIN, ZOO_SUBSPACE)
    zoo2 = phase_zoo(dev, 11, ZOO2, [name for name, *_ in ZOO2],
                     ZOO2_SUBSPACE)
    timing_for("popstep")
    by_path.update(phase_fleet(dev))
    steps_flash = phase_steps(dev)
    phase_dgo_step(dev)
    phase_dry_run(dry)
    n_launch = sum(n for n, _ in by_path.values())
    n_fold = sum(f for _, f in by_path.values())
    zoo_launches = sum(m["launches"] for m in zoo.values())
    zoo2_launches = sum(m["launches"] for m in zoo2.values())
    # by_model: every model that launched the kernel in phases 10 and 11
    zoo = {**zoo, **{n: m for n, m in zoo2.items() if m["launches"]}}
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card_line())
    source = "src/repro_torch/kernels/popstep/csrc/popstep.cu"
    counts, bounds = packed["counts"], packed["bounds"]

    def packed_entry(name, source, replaces, err, ms, plain_ms,
                     library_ms=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": library_ms, "clock": clock_of("packed")}

    kernels_dir = "src/repro_torch/kernels"
    # no single PyTorch call computes popstep, its fold, graycode or
    # fixedpoint (library_ms null); popstep's plain_ms is the plain step,
    # values and selection together, its bound_ms the work the step needs
    # (every unit recomputed: full_work_bound_ms); popstep_fold runs inside
    # the popstep launch on the main path (0 launches of its own), its ms
    # is the check entry's, as is popmin_fold's (merged into popmin's
    # launch); popmin's library call is torch.min(vals, dim=0), at
    # P = 5,439, and its by_p entry holds every timed P
    print(json.dumps({"kernels": [{
        "name": "popstep", "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/popstep/kernel.py:172",
        "launches": n_launch,
        "max_abs_err": max(rs["max_abs_err"], restarts["max_abs_err"]),
        "ms": rs["ms"], "plain_ms": rs["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "clock": clock_of("popstep"),
        "full_work_bound_ms": rs["full_work_bound_ms"],
        "by_path": {path: n for path, (n, _) in by_path.items()},
        "by_shape": rs["by_shape"],
        "by_restarts": restarts["by_restarts"],
        "term_table": rs["term_table"]}, {
        "name": "popstep_fold", "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/popstep/kernel.py:110",
        "launches": n_fold, "max_abs_err": fold["max_abs_err"],
        "ms": fold["ms"], "plain_ms": fold["plain_ms"],
        "bound_ms": fold_bound, "bound_by": fold_by, "library_ms": None,
        "clock": clock_of("popstep_fold"), "merged_into": "popstep"},
        packed_entry("graycode", f"{kernels_dir}/graycode/csrc/graycode.cu",
                     "src/repro/kernels/graycode/kernel.py:74",
                     errs["graycode"], pt["graycode"], pt["graycode_plain"]),
        packed_entry("fixedpoint",
                     f"{kernels_dir}/fixedpoint/csrc/fixedpoint.cu",
                     "src/repro/kernels/fixedpoint/kernel.py:67",
                     errs["fixedpoint"], pt["fixedpoint"],
                     pt["fixedpoint_plain"]),
        {**packed_entry("popmin", f"{kernels_dir}/popmin/csrc/popmin.cu",
                        "src/repro/kernels/popmin/kernel.py:41",
                        errs["popmin"], pt["popmin"], pt["popmin_plain"],
                        pt["popmin_library"]),
         "by_p": {str(p): {
             "ms": pt[f"popmin_{p}"], "plain_ms": pt[f"popmin_plain_{p}"],
             "bound_ms": bounds[f"popmin_{p}"][0],
             "library_ms": pt[f"popmin_library_{p}"]}
             for p in POPMIN_TIME_PS}},
        {**packed_entry("popmin_fold", f"{kernels_dir}/popmin/csrc/popmin.cu",
                        "src/repro/kernels/popmin/kernel.py:30",
                        errs["popmin_fold"], pt["popmin_fold"],
                        pt["popmin_fold_plain"]),
         "merged_into": "popmin"}, {
        "name": "flash_attention", "route": "cuda",
        "source": f"{kernels_dir}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:95",
        "launches": served["launches"] + zoo_launches + zoo2_launches,
        "max_abs_err": max(ft["max_abs_err"], served["max_abs_err"],
                           *(sh["max_abs_err"] for m in zoo.values()
                             for sh in m["shapes"])),
        "ms": ft["serve"], "plain_ms": ft["serve_plain"],
        "bound_ms": ft["serve_bound"], "bound_by": ft["serve_bound_by"],
        "library_ms": ft["serve_sdpa_f32"],
        "clock": clock_of("flash_attention"),
        "by_path": {"serve": served["launches"], "zoo": zoo_launches,
                    "zoo2": zoo2_launches},
        "by_model": {name: {
            "launches": m["launches"], "prefill_share": m["prefill_share"],
            "shapes": [{k: sh[k] for k in (
                "shape", "causal", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
                for sh in m["shapes"]]} for name, m in zoo.items()}}, {
        "name": "flash_attention_bf16", "route": "cuda",
        "source": f"{kernels_dir}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:95",
        "launches": served["bf16_launches"] + steps_flash,
        "by_path": {"serve": served["bf16_launches"], "steps": steps_flash},
        "max_abs_err": ft["max_abs_err_bf16"],
        "ms": ft["serve_bf16"], "plain_ms": ft["serve_plain_bf16"],
        "bound_ms": ft["serve_bf16_bound"],
        "bound_by": ft["serve_bf16_bound_by"],
        "library_ms": ft["serve_sdpa_bf16"],
        "clock": clock_of("flash_attention"),
        "by_model": {name: {"shapes": [{
            "shape": sh["shape"], "causal": sh["causal"],
            "max_abs_err": sh["max_abs_err_bf16"], "ms": sh["ms_bf16"],
            "bound_ms": sh["bound_ms_bf16"], "bound_by": sh["bound_by_bf16"],
            "library_ms": sh["library_ms_bf16"]} for sh in m["shapes"]]}
            for name, m in zoo.items()}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
