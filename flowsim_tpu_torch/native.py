"""ctypes binding of the polyline rasterizer in ``native/flowsim_native.c``.

Counterpart of ``flowsim_tpu/native.py`` (its ``polyline_tables``).  The C
source is the repository's; this module compiles it at first use with the
system C compiler into ``build/flowsim_tpu_torch/`` (under the current
working directory, or ``$FLOWSIM_TORCH_BUILD_DIR``, as the CUDA kernels of
``ops/cuda/build.py``) — never beside the source — and falls back to the
NumPy polyline of :mod:`flowsim_tpu_torch.geometry_tables` where no compiler
is present.  The compiler flags are the JAX package's, so both packages
rasterize with the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "flowsim_native.c")
_CFLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_load_error = None


def _lib_path() -> str:
    from flowsim_tpu_torch.ops.cuda.build import build_dir

    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(_CFLAGS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"libflowsim_native-{tag}.so")


def load():
    """The loaded library, built first if needed; ``None`` where it cannot be
    built or loaded.  A failure is remembered, so a machine without a
    compiler does not start one for every geometry build."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        so = _lib_path()
        if not os.path.exists(so):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            cc = os.environ.get("CC", "cc")
            subprocess.run([cc, *_CFLAGS, "-o", tmp, _SRC, "-lm"], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.polyline_tables.argtypes = [dp, dp, ctypes.c_int64, dp, ctypes.c_int64, dp, dp, dp]
        lib.polyline_tables.restype = None
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _load_error = e
    return _lib


def available() -> bool:
    return load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def polyline_tables(x, z, depths):
    """(A, P, T) tables over ``depths`` above the polyline minimum: the C
    rasterizer where it builds, else the NumPy polyline."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    z = np.ascontiguousarray(z, dtype=np.float64)
    depths = np.ascontiguousarray(depths, dtype=np.float64)
    m = depths.size
    if lib is not None:
        A, P, T = np.empty(m), np.empty(m), np.empty(m)
        lib.polyline_tables(_ptr(x), _ptr(z), x.size, _ptr(depths), m, _ptr(A), _ptr(P), _ptr(T))
        return A, P, T
    from flowsim_tpu_torch.geometry_tables import polyline_properties

    zmin = z.min()
    out = np.array([polyline_properties(x, z, zmin + d) for d in depths])
    return out[:, 0], out[:, 1], out[:, 3]
