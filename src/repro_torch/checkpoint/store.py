"""Atomic, manifest-verified, keep-k checkpointing of the port's trees,
the twin of ``repro.checkpoint.store``, file for file.

Layout:  <dir>/step_<k>/manifest.json + leaf_<i>.npy
Atomicity: written into step_<k>.tmp, fsync'd, renamed on completion —
a crash mid-write never leaves a directory that ``latest_step`` will pick.
The manifest records per-leaf key, shape, dtype and CRC-32, verified on
restore (a corrupt leaf raises ``IOError``).  bfloat16 leaves are their
raw 2-byte words, as the reference writes them.

The files cross between the packages both ways.  Leaves are written in
the reference's flatten order under its key strings
(``[0]/['segments']/['seg0']/['attn']/['wq']``, ``[1]/.step``;
:func:`repro_torch.core.tree.entries`), and a layer list is written as
the reference's stacked leaf, e.g. ``(L, d, Hq, hd)``: stacked on save
one leaf at a time (so at most one stacked leaf is held beside the
tree), and split back into per-layer views on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.tree import Layers, entries, rebuild


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the leaf as a host array, its dtype's name).  A bfloat16 tensor is
    written as the reference writes one: its raw 2-byte words (``<V2``),
    ``"bfloat16"`` in the manifest."""
    if isinstance(leaf, Layers):
        leaf = leaf.stacked()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2"), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


def save_checkpoint(ckpt_dir: str | Path, step: int, tree,
                    keep_last: int = 3) -> Path:
    """Write ``tree`` as step ``step`` of ``ckpt_dir`` and keep the newest
    ``keep_last`` steps.  Returns the step's directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(entries(tree)):
        arr, dtype = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": dtype, "crc": _crc(arr),
        })
        del arr
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    # keep-k garbage collection
    steps = sorted(p for p in ckpt_dir.glob("step_????????")
                   if p.is_dir() and not p.suffix)
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The newest complete step of ``ckpt_dir`` (one with a manifest), or
    None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.glob("step_????????"):
        if (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _device_of(like):
    if isinstance(like, Layers):
        like = like[0]
    return like.device if isinstance(like, torch.Tensor) else "cpu"


def restore_checkpoint(ckpt_dir: str | Path, step: int, tree_like,
                       verify: bool = True):
    """Restore step ``step`` into the structure of ``tree_like``: each
    leaf on the device of ``tree_like``'s leaf (a layer list's stacked
    leaf split into per-layer views).  ``verify`` checks every leaf's
    CRC-32 (``IOError`` on a mismatch)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}

    def load(key, like):
        m = by_key[key]
        arr = np.load(d / m["file"])
        if verify:
            crc = _crc(arr)
            if crc != m["crc"]:
                raise IOError(f"checkpoint leaf {key} corrupt "
                              f"(crc {crc} != {m['crc']})")
        if m["dtype"] == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(_device_of(like))
        return torch.from_numpy(arr).to(_device_of(like))

    return rebuild(tree_like, load)
