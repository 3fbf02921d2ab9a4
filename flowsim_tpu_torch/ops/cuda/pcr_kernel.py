"""``pcr_solve``: the CUDA block-PCR solve kernel and its plain version.

Counterpart of ``flowsim_tpu/ops/pallas/pcr_kernel.py`` (``pcr_pallas``).
The kernel (``csrc/pcr_kernel.cu``) solves one 2x2-block tridiagonal system
per thread block in float64, the system resident in shared memory for
N <= :data:`SMEM_MAX_N` and ping-ponged through a global scratch buffer above
that, up to :data:`MAX_N`.  Up to :data:`CARRIED_MAX_N` nodes the C entry
carries each node's inverse of D from sweep to sweep (one inversion a node and
sweep instead of two); both paths give the same bits.  A leading batch
dimension maps to ``blockIdx.x``.

On a CUDA tensor the wrapper launches the kernel or raises; the plain version
(:func:`pcr_solve_plain`, which is ``ops.tridiag.block_pcr``) runs only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from flowsim_tpu_torch.ops import tridiag
from flowsim_tpu_torch.ops.cuda import build

MAX_N = 8192          # same ceiling as the TPU kernel
SMEM_MAX_N = 1000     # 2 buffers x 14 doubles x N <= 227 KB of shared memory
CARRIED_MAX_N = 512   # the carried path (csrc/pcr_kernel.cu) up to this N
_COMPONENTS = 14

# the C entry's paths (csrc/pcr_kernel.cu): it chooses by N (-1); 0
# (sweep_node) or 1 (the carried inverse) forces one, a test hook
PATH_CHOOSE, PATH_NODE, PATH_CARRIED = -1, 0, 1

# number of kernel launches made by pcr_solve (not by its plain version)
launch_count = 0


def pcr_solve_plain(L, D, U, b):
    """The plain PyTorch version of the kernel: ``ops.tridiag.block_pcr``."""
    return tridiag.block_pcr(L, D, U, b)


def _lib():
    lib = build.load("pcr_kernel")
    fn = lib.flowsim_pcr_solve
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flowsim_pcr_carried_max_n.argtypes = []
        lib.flowsim_pcr_carried_max_n.restype = ctypes.c_int
        if lib.flowsim_pcr_carried_max_n() != CARRIED_MAX_N:
            raise RuntimeError("the carried path's limit differs between pcr_kernel.cu and its wrapper")
        fn._typed = True
    return lib


def _check(L, D, U, b):
    if L.ndim not in (3, 4) or L.shape[-2:] != (2, 2):
        raise ValueError(f"L must be [N, 2, 2] or [B, N, 2, 2]; got {tuple(L.shape)}")
    if D.shape != L.shape or U.shape != L.shape:
        raise ValueError("L, D, U must have the same shape")
    if b.shape != L.shape[:-1]:
        raise ValueError(f"b must be {tuple(L.shape[:-1])}; got {tuple(b.shape)}")
    N = L.shape[-3]
    if N > MAX_N:
        raise ValueError(
            f"N={N} exceeds the single-block kernel limit {MAX_N}; use "
            'linear_solver="cuda_tiled" (ops.cuda.tiled_pcr) for longer reaches')
    if N < 1:
        raise ValueError("empty system")
    return N


def pcr_solve(L, D, U, b, path: int = PATH_CHOOSE):
    """Solve the block-tridiagonal system(s): L, D, U ``[..., N, 2, 2]``,
    b ``[..., N, 2]`` -> x ``[..., N, 2]`` (at most one batch dimension).
    ``path`` forces a path of the C entry, a test hook (:data:`PATH_NODE`,
    :data:`PATH_CARRIED`); every caller leaves it to choose."""
    global launch_count
    N = _check(L, D, U, b)
    if L.device.type == "cpu":
        return pcr_solve_plain(L, D, U, b)
    if L.device.type != "cuda":
        raise ValueError(f"pcr_solve needs CUDA or CPU tensors; got {L.device}")
    for name, t in (("L", L), ("D", D), ("U", U), ("b", b)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64 on the card; got {t.dtype}")
        if t.device != L.device:
            raise ValueError("L, D, U, b must lie on the same device")
    L, D, U, b = (t.contiguous() for t in (L, D, U, b))
    n_sys = L.shape[0] if L.ndim == 4 else 1
    use_smem = N <= SMEM_MAX_N
    x = torch.empty_like(b)
    scratch = x if use_smem else torch.empty(
        (n_sys, 2 * _COMPONENTS * N), dtype=torch.float64, device=L.device)
    args = (L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(),
            n_sys, N, int(use_smem), path)
    if L.device.index == torch.cuda.current_device():
        rc = _lib().flowsim_pcr_solve(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(L.device):
            rc = _lib().flowsim_pcr_solve(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pcr_solve launch failed: CUDA error {rc}")
    launch_count += 1
    return x
