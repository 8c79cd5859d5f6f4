"""Assigned input shapes (the same set for every LM arch), the twin of
``repro.configs.shapes``.

``train_4k`` is a train step; ``prefill_32k`` the prompt pass;
``decode_32k``/``long_500k`` one new token against a KV cache of
``seq_len``.  ``long_500k`` needs a sub-quadratic backbone and is skipped,
with its reason, for pure full-attention archs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(arch: ArchConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True


def skip_reason(arch: ArchConfig, shape: ShapeSpec) -> str | None:
    if not applicable(arch, shape):
        return (f"{arch.name} is pure full-attention (not sub-quadratic); "
                "long_500k skipped per assignment — see DESIGN.md §3")
    return None
