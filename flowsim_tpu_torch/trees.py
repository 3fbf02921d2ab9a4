"""Maps over the port's parameter trees.

A tree is one of the frozen dataclasses of the port (``TrapezoidGeometry``,
``BoundaryParams``, ``RatingCurveParams``): tensor leaves, nested trees,
``None`` and static fields (strings).  An ensemble carries the same trees with
a leading member axis on every tensor leaf; these helpers stack members into
such a batched tree and slice a member out of one.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and of the same leaves of
    ``rest``); static fields must agree across all trees."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        others = [getattr(t, f.name) for t in rest]
        if isinstance(v, torch.Tensor):
            out[f.name] = fn(v, *others)
        elif dataclasses.is_dataclass(v):
            if any(not dataclasses.is_dataclass(o) for o in others):
                raise ValueError(f"members differ in the presence of {f.name!r}")
            out[f.name] = tree_map(fn, v, *others)
        else:
            if any(o != v for o in others):
                raise ValueError(
                    f"members must share the static field {f.name!r}; got {sorted({str(v), *map(str, others)})}")
            out[f.name] = v
    return dataclasses.replace(tree, **out)


def stack(trees):
    """Stack per-member trees into one batched tree (leading member axis)."""
    trees = list(trees)
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def member(tree, m):
    """Member ``m`` of a batched tree."""
    return tree_map(lambda x: x[m], tree)


def slice_members(tree, start, stop):
    return tree_map(lambda x: x[start:stop], tree)
