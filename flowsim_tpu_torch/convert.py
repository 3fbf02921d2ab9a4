"""Carry state across from NumPy: plain dicts -> the port's parameter trees.

``from_numpy(kind, tree, device)`` builds a ``TrapezoidGeometry``,
``RatingCurveParams``, ``StorageParams`` (kind ``"storage"``),
``BoundaryParams``, ``PreissmannSettings``, an ``(h0, Q0)`` state or a network
``BranchDef`` (kind ``"branch"``) from a
dict of NumPy arrays / floats / strings whose keys are the field names of the JAX package's dataclasses — what
``dataclasses.fields`` + ``np.asarray`` give for one of its trees.  Array
values may carry a leading member axis (a batched geometry, stacked
boundaries, a ``[B, N]`` state): the result is then the batched tree that
``parallel.ensemble`` takes.  This
module never sees a JAX object: whoever holds one turns it into such a dict
first.  Fields the port does not have (TPU-only settings) are ignored.  A
boundary's ``"rating"`` and ``"storage"`` entries are nested dicts (a storage
may nest a rating of its own).  A branch's ``"geo"`` is a geometry dict, its
``"us"`` / ``"ds"`` either a boundary dict or an ``int`` junction id, and its
``"qlat"`` an array or ``None``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flowsim_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device
from flowsim_tpu_torch.geometry import TrapezoidGeometry
from flowsim_tpu_torch.ops.boundary import BoundaryParams
from flowsim_tpu_torch.ops.network import BranchDef, _is_junction
from flowsim_tpu_torch.ops.preissmann import PreissmannSettings
from flowsim_tpu_torch.ops.rating_curve import RatingCurveParams
from flowsim_tpu_torch.ops.storage import StorageParams

KINDS = ("TrapezoidGeometry", "RatingCurveParams", "storage", "BoundaryParams", "PreissmannSettings", "state",
         "branch")


def _f64(v, device):
    return torch.tensor(np.array(v, dtype=np.float64), dtype=DEFAULT_DTYPE, device=device)


def _geometry(tree, device):
    out = {}
    for f in dataclasses.fields(TrapezoidGeometry):
        v = tree[f.name]
        if f.name == "compound":
            out[f.name] = torch.tensor(np.array(v, dtype=bool), device=device)
        else:
            out[f.name] = _f64(v, device)
    return TrapezoidGeometry(**out)


def _rating(tree, device):
    out = dict(kind=str(tree["kind"]))
    for f in dataclasses.fields(RatingCurveParams):
        if f.name == "kind":
            continue
        v = tree.get(f.name)
        out[f.name] = None if v is None else _f64(v, device)
    return RatingCurveParams(**out)


def _storage(tree, device):
    out = {}
    for f in dataclasses.fields(StorageParams):
        v = tree.get(f.name)
        if f.name == "rating":
            out[f.name] = None if v is None else _rating(v, device)
        elif f.name in ("has_area_curve", "has_rating", "capture_losses"):
            out[f.name] = bool(v)
        else:
            out[f.name] = _f64(v, device)
    return StorageParams(**out)


def _boundary(tree, device):
    rating = tree.get("rating")
    storage = tree.get("storage")
    return BoundaryParams(
        kind=str(tree["kind"]),
        bed_level=_f64(tree["bed_level"], device),
        bed_slope=_f64(tree["bed_slope"], device),
        initial_depth=_f64(tree["initial_depth"], device),
        target_series=_f64(tree["target_series"], device),
        rating=None if rating is None else _rating(rating, device),
        storage=None if storage is None else _storage(storage, device),
    )


def _settings(tree, device):
    names = {f.name for f in dataclasses.fields(PreissmannSettings)}
    return PreissmannSettings(**{k: v for k, v in tree.items() if k in names})


def _state(tree, device):
    return _f64(tree["h0"], device), _f64(tree["Q0"], device)


def _branch(tree, device):
    end = lambda e: int(e) if _is_junction(e) else _boundary(e, device)
    h0, Q0 = _state(tree, device)
    qlat = tree.get("qlat")
    return BranchDef(geo=_geometry(tree["geo"], device), dx=float(tree["dx"]), us=end(tree["us"]),
                     ds=end(tree["ds"]), h0=h0, Q0=Q0, qlat=None if qlat is None else _f64(qlat, device))


_MAKERS = dict(zip(KINDS, (_geometry, _rating, _storage, _boundary, _settings, _state, _branch)))


def from_numpy(kind: str, tree: dict, device=DEFAULT_DEVICE):
    """Build the port's ``kind`` from a dict of NumPy values (see module doc)."""
    if kind not in _MAKERS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    return _MAKERS[kind](tree, resolve_device(device))
