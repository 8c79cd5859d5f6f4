"""Take the packed-word kernels' designs apart on one CUDA card: variants
of ``graycode``, ``fixedpoint`` and ``popmin``, each built from the
kernel's own source with one of the ``-D`` switches that source documents,
timed side by side.

    PYTHONPATH=src python3 -m repro_torch.kernels.probe_packed \
        [--parent DIR ...] [--popmin-only]

(from the repository root: it uses ``chip_smoke.py``'s timing helpers).
Each ``--parent`` names an unpacked tree of another commit (e.g. ``git
archive <commit> src/repro_torch/kernels | tar -x -C build/<label>``)
whose three kernels are timed beside these under the directory's name,
through that tree's C interfaces (the first CUDA kernels' graycode took a
``rows_per_block`` argument; fixedpoint took no multiprocessor count
before its redesign; popmin was two launches, ``popmin_partials`` with
tiles of 1,024 values and ``popmin_fold``, before its redesign, and is
built with that tree's own ``dgo_device.cuh``).

Variants:

- fixedpoint: ``kernel`` (as the package builds it); ``staged`` and
  ``unstaged`` (``FIXEDPOINT_STAGE=1``/``0``: the block's words staged in
  shared memory, or read in place, at every shape); ``256 threads``
  (``FIXEDPOINT_THREADS``); ``2048 points`` and ``8192 points``
  (``FIXEDPOINT_POINTS``: a block's points where the population is
  large); ``float4 stores`` (``FIXEDPOINT_FLOAT4``: four points a
  thread, one 16-byte store);
- graycode: ``kernel``; ``ballots`` (``GRAYCODE_BALLOTS``: the parent
  packed by warp ballots on one byte a lane); ``scalar stores``
  (``GRAYCODE_SCALAR_STORES``: each word pair as two 8-byte stores);
  ``no prologue`` (``GRAYCODE_NO_PROLOGUE``: the parent left unpacked,
  wrong output); ``prologue only`` (``GRAYCODE_NO_BODY``: each block packs
  the parent and writes one word); ``neither`` (both: the grid and the
  bounds' loads); and ``empty`` (a kernel with an empty body on one block
  of 32 threads: the floor of a launch).

- popmin: ``kernel``; ``one block of 256`` / ``of 512``
  (``POPMIN_ONE_THREADS``: its most threads); ``grid blocks of 128`` /
  ``256`` / ``1024`` (``POPMIN_THREADS``); ``scalar loads`` and ``float2
  loads`` (``POPMIN_VEC`` 1, 2); ``unroll 1`` / ``2`` / ``8``
  (``POPMIN_UNROLL``); ``fenced ticket`` (``POPMIN_FENCED``); ``no fold`` (``POPMIN_NO_FOLD``:
  no ticket, wrong output); ``empty``; and ``torch.min(vals, dim=0)``
  (the library call, not checked).  Each is
  launched as the wrapper launches it (one block for P <=
  ``ops.ONE_BLOCK_MAX``, else the grid) at P = 287, 5,439 (the packed
  main path's), 2^20 and 2^24.  The switch: the kernel as one block and
  as a grid at P = 2,048 .. 131,072 (``MIN_SWEEP``).

Shapes (children x words, vars x bits): the packed main path's two,
remote-sensing (5,439 x 85, 680 x 4) and rastrigin n=9 at 16 bits (287 x 5,
9 x 16); fixedpoint also at (5,439 x 85, 170 x 16), (287 x 5, 36 x 4),
(100,000 x 5, 9 x 16) and (100,000 x 5, 36 x 4), which part the size of the
population from the length of a row.

Every variant's output is checked bitwise against the package's kernel,
but for the three that skip part of the work.  Times are device times
from ``torch.profiler``, the mean of 50 calls (popmin: all of a call's
launches), each variant measured twice (in the order A B ... B A) and
both printed.  Prints the card's name and power limit first.  Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
from pathlib import Path

import numpy as np

REPS = 50
KERNELS = Path(__file__).resolve().parent
PARTIAL = ("no prologue", "prologue only", "neither")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIX_SIG = {"fixedpoint_decode": (_P, _I, _I, _I, _I, _F, _F, _I, _P, _P)}
FIX_SIG_OLD = {"fixedpoint_decode": (_P, _I, _I, _I, _I, _F, _F, _P, _P)}
GRAY_SIG = {"graycode_children": (_P, _I, _I, _P, _P, _I, _P, _P)}
GRAY_SIG_ROWS = {"graycode_children": (_P, _I, _I, _P, _P, _I, _I, _P, _P)}
MIN_SIG_OLD = {"popmin_partials": (_P, _I, _I, _P, _P, _P),
               "popmin_fold": (_P, _P, _I, _P, _P, _P)}
EMPTY_SRC = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""

FIX_VARIANTS = {"kernel": (), "staged": ("-DFIXEDPOINT_STAGE=1",),
                "unstaged": ("-DFIXEDPOINT_STAGE=0",),
                "256 threads": ("-DFIXEDPOINT_THREADS=256",),
                "2048 points": ("-DFIXEDPOINT_POINTS=2048",),
                "8192 points": ("-DFIXEDPOINT_POINTS=8192",),
                "float4 stores": ("-DFIXEDPOINT_FLOAT4",)}
GRAY_VARIANTS = {"kernel": (), "ballots": ("-DGRAYCODE_BALLOTS",),
                 "scalar stores": ("-DGRAYCODE_SCALAR_STORES",),
                 "no prologue": ("-DGRAYCODE_NO_PROLOGUE",),
                 "prologue only": ("-DGRAYCODE_NO_BODY",),
                 "neither": ("-DGRAYCODE_NO_PROLOGUE", "-DGRAYCODE_NO_BODY")}
MIN_VARIANTS = {"kernel": (), "one block of 256": ("-DPOPMIN_ONE_THREADS=256",),
                "one block of 512": ("-DPOPMIN_ONE_THREADS=512",),
                "grid blocks of 128": ("-DPOPMIN_THREADS=128",),
                "grid blocks of 256": ("-DPOPMIN_THREADS=256",),
                "grid blocks of 1024": ("-DPOPMIN_THREADS=1024",),
                "scalar loads": ("-DPOPMIN_VEC=1",),
                "float2 loads": ("-DPOPMIN_VEC=2",),
                "unroll 1": ("-DPOPMIN_UNROLL=1",),
                "unroll 2": ("-DPOPMIN_UNROLL=2",),
                "unroll 8": ("-DPOPMIN_UNROLL=8",),
                "fenced ticket": ("-DPOPMIN_FENCED",),
                "block 0 polls": ("-DPOPMIN_POLL",),
                "polls, cooperative": ("-DPOPMIN_POLL", "-DPOPMIN_COOP"),
                "no fold": ("-DPOPMIN_NO_FOLD",)}
# fixedpoint-only shapes: (children, vars, bits)
FIX_EXTRA = ((5439, 170, 16), (287, 36, 4), (100_000, 9, 16),
             (100_000, 36, 4))
MIN_PS = (287, 5439, 2**20, 2**24)
MIN_SWEEP = (2048, 4096, 8192, 16384, 32768, 65536, 131072)


def libraries(parents: list[Path]) -> dict:
    from repro_torch.kernels._build import Library
    from repro_torch.kernels.popmin.kernel import SIGNATURES as MIN_SIG

    libs = {}
    for kernel, variants, sig in (("fixedpoint", FIX_VARIANTS, FIX_SIG),
                                  ("graycode", GRAY_VARIANTS, GRAY_SIG),
                                  ("popmin", MIN_VARIANTS, MIN_SIG)):
        for i, (label, flags) in enumerate(variants.items()):
            libs[(kernel, label)] = Library(
                f"probe_{kernel}{i}", KERNELS / kernel / "csrc",
                (f"{kernel}.cu",), sig, flags)
    for parent in parents:
        pk = parent / "src" / "repro_torch" / "kernels"
        pmin = pk / "popmin" / "csrc"
        old = "popmin_partials" in (pmin / "popmin.cu").read_text()
        # the tree's own shared header, found beside its source first
        shutil.copy(pk / "csrc" / "dgo_device.cuh", pmin)
        libs[("popmin", parent.name)] = Library(
            f"probe_popmin_{parent.name}", pmin,
            ("popmin.cu", "dgo_device.cuh"), MIN_SIG_OLD if old else MIN_SIG)
        gray = pk / "graycode" / "csrc"
        fix = pk / "fixedpoint" / "csrc"
        rows = "rows_per_block" in (gray / "graycode.cu").read_text()
        new = "n_sms" in (fix / "fixedpoint.cu").read_text()
        libs[("fixedpoint", parent.name)] = Library(
            f"probe_fixedpoint_{parent.name}", fix, ("fixedpoint.cu",),
            FIX_SIG if new else FIX_SIG_OLD)
        libs[("graycode", parent.name)] = Library(
            f"probe_graycode_{parent.name}", gray, ("graycode.cu",),
            GRAY_SIG_ROWS if rows else GRAY_SIG)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[])
    ap.add_argument("--popmin-only", action="store_true",
                    help="build and time the popmin variants alone")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA card")
    import chip_smoke
    from repro_torch.core import objectives
    from repro_torch.core.encoding import Encoding, pack_bits
    from repro_torch.core.population import table_on
    from repro_torch.kernels._build import BUILD_DIR, Library, build_all
    from repro_torch.kernels.fixedpoint import ops as fops
    from repro_torch.kernels.graycode import ops as gops

    print(chip_smoke.card_line())
    libs = libraries(args.parent)
    if args.popmin_only:
        libs = {key: lib for key, lib in libs.items() if key[0] == "popmin"}
    empty_dir = BUILD_DIR / "probe" / "empty"
    empty_dir.mkdir(parents=True, exist_ok=True)
    (empty_dir / "empty.cu").write_text(EMPTY_SRC)
    empty = Library("probe_empty", empty_dir, ("empty.cu",),
                    {"empty_launch": (_P,)})
    for (kernel, label), (_, log) in zip(
            libs, build_all([*libs.values(), empty])):
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"[build] {kernel} {label}: {'; '.join(regs) or 'cached'}")
    loaded = {key: lib.load() for key, lib in libs.items()}
    empty_lib = empty.load()

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    if args.popmin_only:
        probe_popmin(libs, loaded, empty_lib, dev, stream)
        return
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def fix_call(lib, words, enc, out, new):
        scale = float(torch.tensor(enc.scale, dtype=torch.float32))
        lo = float(torch.tensor(enc.lo, dtype=torch.float32))
        extra = (n_sms,) if new else ()
        return lambda: lib.fixedpoint_decode(
            words.data_ptr(), words.shape[0], words.shape[1], enc.n_vars,
            enc.bits, lo, scale, *extra, out.data_ptr(), stream)

    def gray_call(lib, parent, n, starts, ends, out, rows):
        w = out.shape[1]
        extra = (max(1, 1024 // w),) if rows else ()
        return lambda: lib.graycode_children(
            parent.data_ptr(), n, w, starts.data_ptr(), ends.data_ptr(),
            out.shape[0], *extra, out.data_ptr(), stream)

    def run(label, calls):
        times = {key: [] for key in calls}
        for key in [*calls, *reversed(calls)]:
            fn, out, want = calls[key]
            times[key].append(chip_smoke.device_ms(fn, REPS, dev,
                                                   name="kernel"))
            if out is not None and key[1] not in PARTIAL:
                chip_smoke.check(
                    torch.equal(out.view(torch.int32), want.view(torch.int32)),
                    f"probe {key} at {label}: output differs from the "
                    f"package's kernel")
        for (kernel, name), ts in times.items():
            print(f"[probe] {label}: {kernel:<10} {name:<22} "
                  f"{ts[0]:.4f} / {ts[1]:.4f} ms")

    def fix_calls(enc, pop):
        words = pack_bits(torch.as_tensor(rng.integers(
            0, 2, (pop, enc.n_bits)).astype(np.int8), device=dev))
        want = fops.decode_packed(words, enc)
        calls = {}
        for (kernel, name), lib in loaded.items():
            if kernel == "fixedpoint":
                out = torch.empty_like(want)
                new = libs[(kernel, name)].signatures is FIX_SIG
                calls[(kernel, name)] = (fix_call(lib, words, enc, out, new),
                                         out, want)
        return calls

    rng = np.random.default_rng(0)
    rast = objectives.get("rastrigin", n=9).encoding.with_bits(16)
    for label, enc in (("remote-sensing", objectives.get(
            "remote_sensing").encoding), ("rastrigin n=9 16 bits", rast)):
        n = enc.n_bits
        parent = torch.as_tensor(rng.integers(0, 2, n).astype(np.int8),
                                 device=dev)
        table = table_on("table", n, dev)
        starts = table[:, 0].to(torch.int32).contiguous()
        ends = table[:, 1].to(torch.int32).contiguous()
        want_words = gops.generate_population_packed(parent)
        calls = fix_calls(enc, enc.population)
        for (kernel, name), lib in loaded.items():
            if kernel == "graycode":
                out = torch.empty_like(want_words)
                calls[(kernel, name)] = (gray_call(
                    lib, parent, n, starts, ends, out,
                    libs[(kernel, name)].signatures is GRAY_SIG_ROWS), out,
                    want_words)
        calls[("graycode", "empty")] = (lambda: empty_lib.empty_launch(
            stream), None, None)
        run(label, calls)
    for pop, n_vars, bits in FIX_EXTRA:
        run(f"{pop} x {n_vars} vars x {bits} bits",
            fix_calls(Encoding(n_vars, bits, -3.0, 7.0), pop))
    probe_popmin(libs, loaded, empty_lib, dev, stream)


def probe_popmin(libs, loaded, empty_lib, dev, stream) -> None:
    """The popmin variants at ``MIN_PS`` as the wrapper launches them, the
    parents' kernels, an empty launch and ``torch.min``; then the switch
    from one block to a grid over ``MIN_SWEEP``."""
    import torch

    import chip_smoke
    from repro_torch.kernels.popmin import ops as mops

    mins = {key: lib for key, lib in loaded.items() if key[0] == "popmin"}
    grids, states = {}, {}
    for key, lib in mins.items():
        if libs[key].signatures is not MIN_SIG_OLD:
            blocks = ctypes.c_int(0)
            chip_smoke.check(lib.popmin_grid(ctypes.byref(blocks)) == 0,
                             f"probe {key}: popmin_grid failed")
            grids[key] = blocks.value
            states[key] = torch.zeros(2 + 2 * blocks.value,
                                      dtype=torch.int32, device=dev)
    print(f"[probe] popmin grid blocks: "
          f"{ {k[1]: b for k, b in grids.items()} }")

    def call(key, vals, out, max_blocks):
        lib, ptr = mins[key], out.data_ptr()
        if key not in grids:      # the two-launch kernel, tiles of 1,024
            n_parts = -(-vals.shape[0] // 1024)
            part = torch.empty(2 * n_parts, dtype=torch.int32, device=dev)
            pv, pr = part.data_ptr(), part.data_ptr() + 4 * n_parts

            def two(part=part):       # the closure keeps the partials
                lib.popmin_partials(vals.data_ptr(), vals.shape[0], 1024, pv,
                                    pr, stream)
                lib.popmin_fold(pv, pr, n_parts, ptr, ptr + 4, stream)
            return two
        return lambda: lib.popmin_launch(
            vals.data_ptr(), vals.shape[0], max_blocks,
            states[key].data_ptr(), ptr, ptr + 4, stream)

    def run(label, calls):
        times = {key: [] for key in calls}
        for key in [*calls, *reversed(calls)]:
            fn, out, want = calls[key]
            times[key].append(chip_smoke.device_ms(fn, REPS, dev))
            if out is not None and key != "no fold":
                chip_smoke.check(
                    torch.equal(out.view(torch.int32), want.view(torch.int32)),
                    f"probe popmin {key} at {label}: ({out[0]}, "
                    f"{out[1:].view(torch.int32)}) differs from the "
                    f"package's kernel")
        for key, ts in times.items():
            print(f"[probe] popmin P={label}: {key:<24} "
                  f"{ts[0]:.4f} / {ts[1]:.4f} ms")

    rng = np.random.default_rng(1)

    def values(p):
        vals = torch.as_tensor(rng.standard_normal(p).astype(np.float32),
                               device=dev)
        kv, ki = mops.population_min(vals)
        return vals, torch.stack([kv, ki.view(torch.float32)])

    for p in MIN_PS:
        vals, want = values(p)
        calls = {}
        for key in mins:
            out = torch.empty(2, dtype=torch.float32, device=dev)
            blocks = 1 if p <= mops.ONE_BLOCK_MAX else grids.get(key, 0)
            calls[key[1]] = (call(key, vals, out, blocks), out, want)
        calls["empty"] = (lambda: empty_lib.empty_launch(stream), None, None)
        calls["torch.min"] = (lambda: torch.min(vals, dim=0), None, None)
        run(p, calls)
    for p in MIN_SWEEP:
        vals, want = values(p)
        calls = {}
        for shape, blocks in (("one block", 1),
                              ("grid", grids[("popmin", "kernel")])):
            out = torch.empty(2, dtype=torch.float32, device=dev)
            calls[f"kernel, {shape}"] = (
                call(("popmin", "kernel"), vals, out, blocks), out, want)
        run(p, calls)


if __name__ == "__main__":
    main()
