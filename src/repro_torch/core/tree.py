"""Parameter trees of the port, and the reference's view of them.

The port's trees are nested dicts, tuples and ``NamedTuple``s of tensors,
with each segment's layers as a *list* of per-layer trees of one
structure.  The reference stacks those layers on a leading axis and
flattens a tree with ``jax.tree_util.tree_flatten_with_path``: dict keys
sorted, depth first.  :func:`entries` gives that view of a port tree:
its leaves in the reference's order, each with the reference's key
string (``[0]/['segments']/['seg0']/['attn']/['wq']``, ``[1]/.step``) and
a layer list's leaves as :class:`Layers` (the per-layer tensors of one
stacked leaf, stacked only on demand).  :func:`rebuild` is the way back:
a tree shaped like a given one, each leaf (or each stacked leaf, split
into its layers) taken from a function of its key.
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch


class Layers(list):
    """The per-layer tensors of one leaf of a layer list: the reference's
    leaf is ``torch.stack(self)``."""

    def stacked(self) -> torch.Tensor:
        return torch.stack(list(self))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _gather(layers: list):
    """A list of trees of one structure -> one tree of :class:`Layers`."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _gather([t[k] for t in layers]) for k in first}
    if isinstance(first, (list, tuple)):
        raise TypeError("a layer list's layers are dicts of tensors")
    return Layers(layers)


def _key(kind: str, k) -> str:
    if kind == "dict":
        return f"[{k!r}]"
    if kind == "attr":
        return f".{k}"
    return f"[{k}]"


def entries(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(key string, leaf) in the reference's flatten order; a leaf is a
    tensor (or another non-container value) or a :class:`Layers`."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, Layers):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from entries(tree[k], join(_key("dict", k)))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from entries(getattr(tree, f), join(_key("attr", f)))
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from entries(t, join(_key("seq", i)))
    elif isinstance(tree, list):
        if tree:
            yield from entries(_gather(tree), prefix)
    elif tree is not None:
        yield prefix, tree


def rebuild(like, leaf_of: Callable[[str, object], torch.Tensor],
            prefix: str = ""):
    """A tree shaped like ``like``: each leaf is ``leaf_of(key, like's
    leaf)``; for a layer list ``leaf_of(key, Layers)`` returns the stacked
    tensor, split here into per-layer views."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if isinstance(like, Layers):
        return leaf_of(prefix, like)
    if isinstance(like, dict):
        return {k: rebuild(t, leaf_of, join(_key("dict", k)))
                for k, t in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(rebuild(getattr(like, f), leaf_of,
                                    join(_key("attr", f)))
                            for f in like._fields))
    if isinstance(like, tuple):
        return tuple(rebuild(t, leaf_of, join(_key("seq", i)))
                     for i, t in enumerate(like))
    if isinstance(like, list):
        if not like:
            return []
        stacked = rebuild(_gather(like), leaf_of, prefix)
        return [tree_map(lambda a, i=i: a[i], stacked)
                for i in range(len(like))]
    if like is None:
        return None
    return leaf_of(prefix, like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, t, *(r[k] for r in rest))
                for k, t in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *ts) for ts in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *ts) for ts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the order :func:`tree_map` visits."""
    out: list = []
    tree_map(out.append, tree)
    return out
