"""Global numeric configuration of the PyTorch/CUDA port.

The port runs float64 throughout: the H100 has native FP64 units, so the
mixed f32 / double-single policy of the JAX package has no counterpart here.
Entry points take an explicit ``device=`` that defaults to ``"cuda"``; only
an explicit ``device="cpu"`` runs on the host (what the CPU tests pass).
"""

from __future__ import annotations

import numpy as np
import torch

# Standard gravity, identical to scipy.constants.g used throughout the
# reference (ref: hydraulics.py:2, preissmann.py:2).
GRAVITY = 9.80665

DEFAULT_DTYPE = torch.float64
DEFAULT_DEVICE = "cuda"


def default_dtype():
    """Floating dtype of all solver state (always float64 in the port)."""
    return DEFAULT_DTYPE


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for an entry point; raises when CUDA is asked for
    (the default) and no CUDA device is present — there is no silent CPU
    fallback."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' explicitly to run on the host")
    return dev


def farray(x, device="cpu") -> torch.Tensor:
    """float64 tensor on ``device``; NumPy input is copied (it may be
    read-only), a float64 tensor already on ``device`` is returned as is."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=DEFAULT_DTYPE, device=device)
    return torch.tensor(np.array(x, dtype=np.float64), dtype=DEFAULT_DTYPE, device=device)
