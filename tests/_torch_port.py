"""Shared helpers of the ``test_torch_*`` files: turn a tree of the JAX
package into the plain NumPy dict that ``flowsim_tpu_torch.convert`` takes,
compare arrays at the parity tolerance, and run a file's tests without
autograd (:func:`without_autograd`)."""

import dataclasses

import numpy as np
import pytest
import torch

from flowsim_tpu_torch import convert

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def without_autograd():
    """Autouse in every test file that imports it: the file's tests run in
    ``torch.inference_mode()``.  The plain engines make ~600 small tensor
    calls a Newton iteration and no test differentiates them; inference mode
    drops autograd's bookkeeping from every call (the same results, about a
    sixth less time)."""
    with torch.inference_mode():
        yield


def tree_to_numpy(obj):
    """JAX dataclass -> dict of NumPy arrays / floats / strings (recursive)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (str, bool, int, float)):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out[f.name] = tree_to_numpy(v)
        else:
            out[f.name] = np.asarray(v)
    return out


def to_port(kind, jax_tree, device="cpu"):
    return convert.from_numpy(kind, tree_to_numpy(jax_tree), device=device)


def arr(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, rtol=RTOL, what=""):
    """rtol 1e-12 with an absolute floor of 1e-14 x the reference's scale
    (float64 on both sides; the floor covers cancellation to ~0)."""
    p, r = arr(port).astype(np.float64), arr(ref).astype(np.float64)
    assert p.shape == r.shape, f"{what}: shape {p.shape} vs {r.shape}"
    finite = np.abs(r[np.isfinite(r)])
    scale = max(1.0, float(finite.max())) if finite.size else 1.0
    np.testing.assert_allclose(p, r, rtol=rtol, atol=1e-14 * scale, err_msg=what)


def assert_trees_equal(port_tree, jax_tree, rtol=RTOL):
    """Field-by-field equality of a port dataclass with a JAX dataclass."""
    for f in dataclasses.fields(jax_tree):
        if not hasattr(port_tree, f.name):
            continue
        a, b = getattr(port_tree, f.name), getattr(jax_tree, f.name)
        if b is None or isinstance(b, (str, bool, int, float)):
            assert a == b, f.name
        elif dataclasses.is_dataclass(b):
            assert_trees_equal(a, b, rtol)
        else:
            assert_close(a, b, rtol, what=f.name)


def to_jax(tree):
    """A parameter tree of the port -> the JAX package's dataclass of the same
    name, field by field (tensors become JAX arrays; fields only the JAX
    class has keep their defaults): the way back from :func:`to_port`, for
    cases that are built once with the port's own functions."""
    import jax.numpy as jnp

    from flowsim_tpu import geometry as jgeom
    from flowsim_tpu.ops import boundary as jbnd
    from flowsim_tpu.ops import preissmann as jprs
    from flowsim_tpu.ops import rating_curve as jrc
    from flowsim_tpu.ops import storage as jstg

    classes = {c.__name__: c for c in (jgeom.TrapezoidGeometry, jbnd.BoundaryParams, jstg.StorageParams,
                                       jrc.RatingCurveParams, jprs.PreissmannSettings)}
    cls = classes[type(tree).__name__]
    kw = {}
    for f in dataclasses.fields(cls):
        if not hasattr(tree, f.name):
            continue
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = jnp.asarray(v.detach().cpu().numpy())
        elif dataclasses.is_dataclass(v):
            kw[f.name] = to_jax(v)
        else:
            kw[f.name] = v
    return cls(**kw)
