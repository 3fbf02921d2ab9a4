"""``fused_simulate``: the whole-simulation CUDA kernel and its plain version.

Counterpart of ``flowsim_tpu/ops/pallas/fused_newton.py``
(``fused_simulate``).  The kernel (``csrc/fused_newton.cu``) runs every time
level and every Newton iteration of one single-reach simulation inside one
thread block, in float64; this module packs the parameter trees into the flat
buffers the kernel reads, checks that the configuration is inside the
kernel's scope (:func:`_check_supported` raises :class:`FusedUnsupported`
otherwise — callers are NOT silently re-routed to the plain engine), launches,
and unpacks a :class:`~flowsim_tpu_torch.ops.preissmann.SimOutput`.

On CUDA tensors the wrapper launches the kernel or raises.  The plain version
:func:`fused_simulate_plain` — ``ops.preissmann.simulate`` with
``linear_solver="pcr"`` — runs only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from flowsim_tpu_torch.geometry import TrapezoidGeometry
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops.cuda import build

# shared-memory footprint of the kernel: two 14-component PCR buffers plus
# h and Q, float64, per node; 227 KB per block less the static reduction area
SMEM_BYTES_PER_NODE = (2 * 14 + 2) * 8
MAX_N = 964

_GEO_ROWS = ("z_bed", "b_main", "m_main", "n_main", "compound", "h_bank", "b_fp_left",
             "b_fp_right", "m_fp", "n_left", "n_right", "bed_slope", "curvature")
_BC_KINDS = {"flow_hydrograph": 0, "stage_hydrograph": 1, "fixed_depth": 2,
             "normal_depth": 3, "rating_curve": 4}
_RC_KINDS = {"polynomial": 0, "blended_poly": 1, "gated_blend": 2}
_N_PARAMS = 22

# number of kernel launches made by fused_simulate (not by its plain version)
launch_count = 0


class FusedUnsupported(Exception):
    """Raised when the configuration is outside the fused kernel's scope."""


def _check_supported(geo, us_bc, ds_bc, settings, lateral_inflow=None):
    if not isinstance(geo, TrapezoidGeometry):
        raise FusedUnsupported(
            "fused kernel supports TrapezoidGeometry only (table geometry is "
            "an extension still to be ported)")
    if lateral_inflow is not None:
        raise FusedUnsupported("lateral inflow is not in the fused kernel yet")
    for name, bc in (("upstream", us_bc), ("downstream", ds_bc)):
        if bc.kind not in _BC_KINDS:
            raise FusedUnsupported(f"unknown {name} BC kind {bc.kind!r}")
        if bc.storage is not None:
            raise FusedUnsupported("lumped storage is not in the fused kernel yet")
        if bc.kind == "normal_depth":
            s0 = float(bc.bed_slope)
            if not math.isfinite(s0) or s0 <= 0.0:
                raise FusedUnsupported(f"normal_depth {name} BC needs S0 > 0")
    if us_bc.kind == "rating_curve":
        raise FusedUnsupported("an upstream rating curve is not in the fused kernel yet")
    if ds_bc.kind == "rating_curve":
        if ds_bc.rating is None or ds_bc.rating.kind not in _RC_KINDS:
            kind = None if ds_bc.rating is None else ds_bc.rating.kind
            raise FusedUnsupported(f"unsupported rating kind {kind!r}")
        if ds_bc.rating.coeffs.shape[-1] != 3:
            raise FusedUnsupported("the fused kernel packs quadratics (3 coefficients)")
    if settings.newton != "while":
        raise FusedUnsupported("fused kernel implements the while-Newton only")
    if settings.store != "full":
        raise FusedUnsupported("fused kernel stores full fields only")
    if settings.diagnos:
        raise FusedUnsupported("fused kernel has no rcond diagnostics")
    n = geo.n_nodes
    if n > MAX_N:
        raise FusedUnsupported(
            f"N={n} exceeds the shared-memory limit of the fused kernel "
            f"({MAX_N} nodes at {SMEM_BYTES_PER_NODE} B/node)")


def fused_simulate_plain(geo, us_bc, ds_bc, h0, Q0, settings) -> prs.SimOutput:
    """The plain PyTorch version of the kernel: the eager scan-of-Newton with
    the PCR inner solve."""
    sset = dataclasses.replace(settings, linear_solver="pcr")
    return prs.simulate(geo, us_bc, ds_bc, h0, Q0, sset)


def _lib():
    lib = build.load("fused_newton")
    fn = lib.flowsim_fused_simulate
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for aux in (lib.flowsim_fused_param_count, lib.flowsim_fused_smem_bytes_per_node):
            aux.argtypes = []
            aux.restype = ctypes.c_int
        if lib.flowsim_fused_param_count() != _N_PARAMS:
            raise RuntimeError("parameter layout of fused_newton.cu and its wrapper differ")
        if lib.flowsim_fused_smem_bytes_per_node() != SMEM_BYTES_PER_NODE:
            raise RuntimeError("shared-memory layout of fused_newton.cu and its wrapper differ")
        fn._typed = True
    return lib


def pack_geometry(geo: TrapezoidGeometry) -> torch.Tensor:
    """[13, N] float64: the geometry rows in the kernel's order (``compound``
    as 0/1)."""
    dt = geo.z_bed.dtype
    return torch.stack([getattr(geo, r).to(dt) for r in _GEO_ROWS]).contiguous()


def pack_params(us_bc, ds_bc, settings) -> tuple[torch.Tensor, int]:
    """The 22 scalar parameters the kernel reads, and the rating-curve kind."""
    dev, dt = us_bc.bed_level.device, torch.float64
    rc = ds_bc.rating if ds_bc.kind == "rating_curve" else None
    z = torch.zeros((), dtype=dt, device=dev)
    zero3 = torch.zeros((3,), dtype=dt, device=dev)
    host = torch.tensor(
        [settings.theta, settings.time_step, settings.spatial_step, settings.tolerance],
        dtype=dt, device=dev)
    gated = rc is not None and rc.kind == "gated_blend"
    parts = [
        host,
        torch.stack([us_bc.bed_level, us_bc.bed_slope, us_bc.initial_depth,
                     ds_bc.bed_level, ds_bc.bed_slope, ds_bc.initial_depth]),
        rc.coeffs if rc is not None else zero3,
        rc.coeffs_high if rc is not None and rc.coeffs_high.numel() == 3 else zero3,
        torch.stack([rc.stage_shift, rc.pivot_stage, rc.buffer, rc.fd_step]) if rc is not None
        else torch.zeros((4,), dtype=dt, device=dev),
        (rc.max_cooldown if gated else z).reshape(1),
        torch.full((1,), 1.0 if settings.gate_initially_open else 0.0, dtype=dt, device=dev),
    ]
    par = torch.cat([p.to(dt).reshape(-1) for p in parts]).contiguous()
    if par.numel() != _N_PARAMS:
        raise RuntimeError(f"packed {par.numel()} parameters, the kernel reads {_N_PARAMS}")
    return par, (_RC_KINDS[rc.kind] if rc is not None else 0)


def _series(bc, nt, dev):
    if bc.kind in ("flow_hydrograph", "stage_hydrograph"):
        return bc.target_series.contiguous()
    return torch.zeros((nt,), dtype=torch.float64, device=dev)


def fused_simulate(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow=None) -> prs.SimOutput:
    """Run the full simulation in one CUDA kernel launch; returns a SimOutput.

    Raises :class:`FusedUnsupported` for configurations outside the kernel's
    scope.  CPU tensors take the plain version.
    """
    global launch_count
    _check_supported(geo, us_bc, ds_bc, settings, lateral_inflow)
    prs.check_shapes(geo, us_bc, ds_bc, h0, Q0, settings)
    dev = h0.device
    if dev.type == "cpu":
        return fused_simulate_plain(geo, us_bc, ds_bc, h0, Q0, settings)
    if dev.type != "cuda":
        raise ValueError(f"fused_simulate needs CUDA or CPU tensors; got {dev}")
    if h0.dtype != torch.float64 or Q0.dtype != torch.float64:
        raise TypeError("h0 and Q0 must be float64 on the card")
    if geo.device != dev or Q0.device != dev or us_bc.bed_level.device != dev \
            or ds_bc.bed_level.device != dev:
        raise ValueError("geometry, boundaries and state must lie on the same device")

    n, nt = geo.n_nodes, settings.n_time_levels
    geo_rows = pack_geometry(geo)
    par, rc_kind = pack_params(us_bc, ds_bc, settings)
    us_series, ds_series = _series(us_bc, nt, dev), _series(ds_bc, nt, dev)
    h0c, Q0c = h0.contiguous(), Q0.contiguous()

    f64 = dict(dtype=torch.float64, device=dev)
    depth = torch.empty((nt, n), **f64)
    flow = torch.empty((nt, n), **f64)
    error = torch.empty((nt,), **f64)
    gate = torch.empty((nt,), **f64)
    iters = torch.empty((nt,), dtype=torch.int32, device=dev)
    conv = torch.empty((nt,), dtype=torch.int32, device=dev)

    with torch.cuda.device(dev):
        rc = _lib().flowsim_fused_simulate(
            geo_rows.data_ptr(), h0c.data_ptr(), Q0c.data_ptr(), us_series.data_ptr(),
            ds_series.data_ptr(), par.data_ptr(), depth.data_ptr(), flow.data_ptr(),
            iters.data_ptr(), error.data_ptr(), conv.data_ptr(), gate.data_ptr(),
            1, n, nt, int(settings.max_iter), _BC_KINDS[us_bc.kind], _BC_KINDS[ds_bc.kind],
            rc_kind, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_simulate launch failed: CUDA error {rc}")
    launch_count += 1
    return prs.SimOutput(
        depth=depth, flow=flow, iterations=iters, error=error, converged=conv.bool(),
        reservoir_stage=torch.full((nt,), float("nan"), **f64), gate_open=gate,
        rcond=None,
    )
