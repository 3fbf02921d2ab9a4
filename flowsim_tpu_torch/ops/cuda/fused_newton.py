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

The same kernel on a grid of B blocks is the batched (ensemble) kernel; its
wrapper is ``ops/cuda/fused_batched.py``, which shares :func:`launch` and the
packing functions of this module (they accept a leading member axis).
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
_US_RC_KINDS = ("polynomial", "blended_poly")   # the gate controller is downstream-only
_N_PARAMS = 32
# one boundary's storage block: surface area, min stage, bracket, beta,
# reservoir length, K_q and a 10-slot rating block
_N_STORAGE_PARAMS = 17
_ST_ON, _ST_AREA_CURVE, _ST_RATING, _ST_LOSSES, _ST_RC_SHIFT = 1, 2, 4, 8, 4
_STORAGE_RC_KINDS = ("polynomial", "blended_poly")

# the kernel's builds (csrc/fused_newton.cu): every shape has the register
# build; a batch of N <= 128 reaches without storage that is larger than the
# card holds in it takes the residency build (four blocks an SM, not two)
REGISTER_BUILD, RESIDENCY_BUILD = 0, 1

# phases of an iteration in the probe build, as the network kernel's
# (ops/cuda/fused_network.py): kernel 1 has no junction, and its
# back-substitution and update are one phase
PROBE_PHASES = ("level_start", "previous_level", "closures", "assembly", "sweeps", "back_substitution",
                "schur_rows", "junction_solve", "update")

# number of kernel launches made by fused_simulate (not by its plain version)
launch_count = 0


class FusedUnsupported(Exception):
    """Raised when the configuration is outside the fused kernel's scope."""


def _check_rating(name, bc, kinds):
    kind = None if bc.rating is None else bc.rating.kind
    if kind not in kinds:
        raise FusedUnsupported(f"unsupported {name} rating kind {kind!r}; the kernel has {tuple(kinds)}")
    if bc.rating.coeffs.shape[-1] != 3:
        raise FusedUnsupported("the fused kernel packs quadratics (3 coefficients)")


def _check_supported(geo, us_bc, ds_bc, settings):
    """Raise :class:`FusedUnsupported` outside the kernel's scope."""
    if not isinstance(geo, TrapezoidGeometry):
        raise FusedUnsupported(
            "fused kernel supports TrapezoidGeometry only (table geometry is "
            "an extension still to be ported, ROADMAP.md Queue 1 item 8)")
    for name, bc in (("upstream", us_bc), ("downstream", ds_bc)):
        if bc.kind not in _BC_KINDS:
            raise FusedUnsupported(f"unknown {name} BC kind {bc.kind!r}")
        if bc.kind == "fixed_depth" and bc.storage is not None and bc.storage.has_rating:
            kind = bc.storage.rating.kind
            if kind == "gated_blend":
                raise FusedUnsupported(
                    f"a gated_blend rating on the {name} storage itself is unsupported "
                    "(the plain mass balance cannot evaluate it either)")
            if kind not in _STORAGE_RC_KINDS or bc.storage.rating.coeffs.shape[-1] != 3:
                raise FusedUnsupported(
                    f"unsupported rating kind {kind!r} on the {name} storage; the kernel "
                    f"evaluates {_STORAGE_RC_KINDS} quadratics there (ROADMAP.md Queue 1 item 8)")
        if bc.kind == "normal_depth":
            s0 = float(bc.bed_slope.reshape(-1)[0])
            if not math.isfinite(s0) or s0 <= 0.0:
                raise FusedUnsupported(f"normal_depth {name} BC needs S0 > 0")
    if us_bc.kind == "rating_curve":
        _check_rating("upstream", us_bc, _US_RC_KINDS)
    if ds_bc.kind == "rating_curve":
        _check_rating("downstream", ds_bc, _RC_KINDS)
    if settings.newton != "while":
        raise FusedUnsupported("fused kernel implements the while-Newton only")
    if settings.store not in prs.STORES:
        raise FusedUnsupported(f"fused kernel stores {prs.STORES}; got {settings.store!r}")
    if settings.diagnos:
        raise FusedUnsupported("fused kernel has no rcond diagnostics")
    n = geo.n_nodes
    if n > MAX_N:
        raise FusedUnsupported(
            f"N={n} exceeds the shared-memory limit of the fused kernel "
            f"({MAX_N} nodes at {SMEM_BYTES_PER_NODE} B/node)")


def fused_simulate_plain(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow=None) -> prs.SimOutput:
    """The plain PyTorch version of the kernel: the eager scan-of-Newton with
    the PCR inner solve."""
    sset = dataclasses.replace(settings, linear_solver="pcr")
    return prs.simulate(geo, us_bc, ds_bc, h0, Q0, sset, lateral_inflow=lateral_inflow)


def _lib():
    lib = build.load("fused_newton")
    fn = lib.flowsim_fused_simulate
    if not getattr(fn, "_typed", False):
        head = [ctypes.c_void_p] * 16 + [ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)]
        fn.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flowsim_fused_simulate_probe.argtypes = head + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                                            ctypes.c_void_p]
        lib.flowsim_fused_simulate_probe.restype = ctypes.c_int
        lib.flowsim_fused_resident_blocks.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.flowsim_fused_resident_blocks.restype = ctypes.c_int
        for aux in (lib.flowsim_fused_param_count, lib.flowsim_fused_smem_bytes_per_node,
                    lib.flowsim_fused_storage_param_count, lib.flowsim_fused_probe_phases):
            aux.argtypes = []
            aux.restype = ctypes.c_int
        if lib.flowsim_fused_param_count() != _N_PARAMS \
                or lib.flowsim_fused_storage_param_count() != _N_STORAGE_PARAMS \
                or lib.flowsim_fused_probe_phases() != len(PROBE_PHASES):
            raise RuntimeError("parameter layout of fused_newton.cu and its wrapper differ")
        if lib.flowsim_fused_smem_bytes_per_node() != SMEM_BYTES_PER_NODE:
            raise RuntimeError("shared-memory layout of fused_newton.cu and its wrapper differ")
        fn._typed = True
    return lib


def pack_geometry(geo: TrapezoidGeometry) -> torch.Tensor:
    """[13, N] float64 ([B, 13, N] for a batched geometry): the geometry rows
    in the kernel's order (``compound`` as 0/1)."""
    dt = geo.z_bed.dtype
    return torch.stack([getattr(geo, r).to(dt) for r in _GEO_ROWS], dim=-2).contiguous()


def _rating_slots(rc, gated):
    """(tensor, width) pairs of one rating block: low, high, shift, pivot,
    buffer, fd step and (downstream only, by the caller) the gate cooldown."""
    if rc is None:
        return [(None, 3), (None, 3), (None, 1), (None, 1), (None, 1), (None, 1)], None
    high = rc.coeffs_high if rc.coeffs_high.shape[-1] == 3 else None
    slots = [(rc.coeffs, 3), (high, 3), (rc.stage_shift, 1), (rc.pivot_stage, 1),
             (rc.buffer, 1), (rc.fd_step, 1)]
    return slots, (rc.max_cooldown if gated else None)


def _cat_slots(slots, batch_shape, dev):
    """Concatenate (tensor or None, width) slots into ``[*batch_shape, sum of
    widths]``; ``None`` gives zeros, a width-1 slot is a scalar leaf (0-d when
    shared, ``[B]`` per member)."""
    dt = torch.float64
    parts = []
    for t, width in slots:
        if t is None:
            t = torch.zeros((width,), dtype=dt, device=dev)
        elif width == 1:
            t = t.unsqueeze(-1)
        parts.append(t.to(dt).expand(*batch_shape, width))
    return torch.cat(parts, dim=-1).contiguous()


def pack_params(us_bc, ds_bc, settings, batch_shape=()) -> tuple[torch.Tensor, int, int]:
    """The 32 scalar parameters the kernel reads — ``[32]``, or ``[B, 32]``
    with ``batch_shape=(B,)`` where any boundary leaf may carry a leading
    member axis — and the downstream and upstream rating-curve kinds."""
    dev, dt = us_bc.bed_level.device, torch.float64
    rc = ds_bc.rating if ds_bc.kind == "rating_curve" else None
    urc = us_bc.rating if us_bc.kind == "rating_curve" else None
    ds_slots, cooldown = _rating_slots(rc, rc is not None and rc.kind == "gated_blend")
    us_slots, _ = _rating_slots(urc, False)
    host = torch.tensor(
        [settings.theta, settings.time_step, settings.spatial_step, settings.tolerance],
        dtype=dt, device=dev)
    gate_init = torch.tensor(1.0 if settings.gate_initially_open else 0.0, dtype=dt, device=dev)
    slots = [(host, 4), (us_bc.bed_level, 1), (us_bc.bed_slope, 1), (us_bc.initial_depth, 1),
             (ds_bc.bed_level, 1), (ds_bc.bed_slope, 1), (ds_bc.initial_depth, 1),
             *ds_slots, (cooldown, 1), (gate_init, 1), *us_slots]
    par = _cat_slots(slots, batch_shape, dev)
    if par.shape[-1] != _N_PARAMS:
        raise RuntimeError(f"packed {par.shape[-1]} parameters, the kernel reads {_N_PARAMS}")
    return par, (_RC_KINDS[rc.kind] if rc is not None else 0), (_RC_KINDS[urc.kind] if urc is not None else 0)


def _storage_of(bc):
    return bc.storage if bc.kind == "fixed_depth" else None


def pack_storage(us_bc, ds_bc, batch_shape=()):
    """The storage inputs of the kernel: the scalar blocks ``[*batch, 2, 17]``
    (upstream, downstream), the tables ``[*batch, L]`` or shared ``[L]`` — per
    end ``vol_stage | vol_table | area_stage | area_table`` — and the six
    ints {us flags, ds flags, us nv, us na, ds nv, ds na}.  A boundary without
    storage gives a zero block, no tables and flags 0."""
    dev, dt = us_bc.bed_level.device, torch.float64
    blocks, tables, flags, lens = [], [], [], []
    for sp in (_storage_of(us_bc), _storage_of(ds_bc)):
        if sp is None:
            blocks.append(torch.zeros((*batch_shape, _N_STORAGE_PARAMS), dtype=dt, device=dev))
            flags.append(0)
            lens += [0, 0]
            continue
        rc_slots, _ = _rating_slots(sp.rating, False)
        slots = [(t, 1) for t in (sp.surface_area, sp.min_stage, sp.y_min, sp.y_max, sp.beta,
                                  sp.reservoir_length, sp.K_q)] + rc_slots
        blocks.append(_cat_slots(slots, batch_shape, dev))
        flag = _ST_ON | (_ST_AREA_CURVE if sp.has_area_curve else 0) \
            | (_ST_RATING if sp.has_rating else 0) | (_ST_LOSSES if sp.capture_losses else 0)
        if sp.has_rating:
            flag |= _RC_KINDS[sp.rating.kind] << _ST_RC_SHIFT
        flags.append(flag)
        if sp.has_area_curve:
            lens += [sp.vol_stage.shape[-1], sp.area_stage.shape[-1]]
            tables += [sp.vol_stage, sp.vol_table, sp.area_stage, sp.area_table]
        else:
            lens += [0, 0]
    stor = torch.stack(blocks, dim=-2).contiguous()
    if not tables:
        stab = torch.zeros((1,), dtype=dt, device=dev)
    else:
        # tables of a stacked boundary carry the member axis; a shared
        # boundary's are expanded only when the other end's are per member
        lead = batch_shape if any(t.dim() > 1 for t in tables) else ()
        stab = torch.cat([t.to(dt).expand(*lead, t.shape[-1]) for t in tables], dim=-1).contiguous()
    return stor, stab, (flags[0], flags[1], lens[0], lens[1], lens[2], lens[3])


def output_bytes(n_sims: int, n: int, nt: int, store: str) -> int:
    """Bytes of the kernel's outputs: depth and flow (float64, N or 2 nodes
    per level) plus error, gate, the two reservoir stages, iterations and
    converged per level."""
    width = n if store == "full" else 2
    return n_sims * nt * (2 * width * 8 + 4 * 8 + 2 * 4)


def check_output_memory(n_sims: int, n: int, nt: int, store: str, free_bytes: int) -> None:
    """Refuse, before anything is allocated, a launch whose outputs exceed
    the free memory of the card."""
    need = output_bytes(n_sims, n, nt, store)
    if need > free_bytes:
        raise MemoryError(
            f"the outputs of {n_sims} simulations (N={n}, nt={nt}, store={store!r}) take "
            f"{need / 1e9:.2f} GB but the card has {free_bytes / 1e9:.2f} GB free: run the "
            f"ensemble in chunks (batched_simulate(..., chunk_size=...)) or use store='boundaries'")


def resident_blocks(n: int, storage: bool = False, build_id: int = REGISTER_BUILD) -> int:
    """Blocks of a kernel build that one SM holds at N nodes, from the CUDA
    occupancy calculator (:data:`REGISTER_BUILD`, every shape;
    :data:`RESIDENCY_BUILD`, N <= 128 without storage)."""
    out = ctypes.c_int(0)
    rc = _lib().flowsim_fused_resident_blocks(n, int(storage), build_id, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return out.value


def launch(geo_rows, h0, Q0, us_series, ds_series, par, qlat, settings, us_kind, ds_kind,
           rc_kind, us_rc_kind, storage, build_id: int = -1, probe=None) -> prs.SimOutput:
    """Launch the kernel on a grid of ``S = geo_rows.shape[0]`` blocks, one per
    simulation.  Every input carries the leading ``S`` axis and lies on one
    CUDA device; ``qlat`` is ``None``, ``[S, N]`` or ``[S, nt, N]``;
    ``storage`` is what :func:`pack_storage` returns (blocks ``[S, 2, 17]``,
    tables ``[S, L]`` or shared ``[L]``).  ``build_id`` -1 lets the kernel's C
    entry choose its build by the member count (what every wrapper does);
    :data:`REGISTER_BUILD` or :data:`RESIDENCY_BUILD` forces one, for timing
    the two against each other.  ``probe``: ``None``, or ``(cycles, clock)``
    — an int64 tensor ``[len(PROBE_PHASES)]`` on the device and a
    ``ctypes.c_int`` — for one launch of the probe build (N <= 128, no
    storage), which fills them with the cycles of each phase and the SM
    clock in kHz.  Returns a SimOutput whose fields carry the ``S`` axis."""
    dev = geo_rows.device
    n_sims, _, n = geo_rows.shape
    nt = settings.n_time_levels
    expect = dict(geo_rows=(n_sims, len(_GEO_ROWS), n), h0=(n_sims, n), Q0=(n_sims, n),
                  us_series=(n_sims, nt), ds_series=(n_sims, nt), par=(n_sims, _N_PARAMS))
    given = dict(geo_rows=geo_rows, h0=h0, Q0=Q0, us_series=us_series, ds_series=ds_series, par=par)
    stor, stab, st_ints = storage
    expect["storage blocks"] = (n_sims, 2, _N_STORAGE_PARAMS)
    given["storage blocks"] = stor
    tab_len = max(1, 2 * sum(st_ints[2:]))
    expect["storage tables"] = (n_sims, tab_len) if stab.dim() == 2 else (tab_len,)
    given["storage tables"] = stab
    if qlat is not None:
        expect["qlat"] = (n_sims, n) if qlat.dim() == 2 else (n_sims, nt, n)
        given["qlat"] = qlat
    for name, t in given.items():
        if tuple(t.shape) != expect[name] or t.dtype != torch.float64 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float64 {expect[name]} tensor on {dev}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    with torch.cuda.device(dev):
        check_output_memory(n_sims, n, nt, settings.store, torch.cuda.mem_get_info()[0])
        width = n if settings.store == "full" else 2
        f64 = dict(dtype=torch.float64, device=dev)
        depth = torch.empty((n_sims, nt, width), **f64)
        flow = torch.empty((n_sims, nt, width), **f64)
        error = torch.empty((n_sims, nt), **f64)
        gate = torch.empty((n_sims, nt), **f64)
        iters = torch.empty((n_sims, nt), dtype=torch.int32, device=dev)
        conv = torch.empty((n_sims, nt), dtype=torch.int32, device=dev)
        stage = torch.full((n_sims, nt, 2), float("nan"), **f64)
        args = (geo_rows.data_ptr(), h0.data_ptr(), Q0.data_ptr(), us_series.data_ptr(),
                ds_series.data_ptr(), par.data_ptr(), None if qlat is None else qlat.data_ptr(),
                depth.data_ptr(), flow.data_ptr(), iters.data_ptr(), error.data_ptr(),
                conv.data_ptr(), gate.data_ptr(), stage.data_ptr(), stor.data_ptr(), stab.data_ptr(),
                tab_len if stab.dim() == 2 else 0, n_sims, n, nt, int(settings.max_iter),
                _BC_KINDS[us_kind], _BC_KINDS[ds_kind], rc_kind, us_rc_kind,
                int(settings.store == "boundaries"), 0 if qlat is None else qlat.dim() - 1,
                (ctypes.c_int * 6)(*st_ints))
        stream = torch.cuda.current_stream().cuda_stream
        if probe is None:
            rc = _lib().flowsim_fused_simulate(*args, build_id, stream)
        else:
            rc = _lib().flowsim_fused_simulate_probe(*args, probe[0].data_ptr(), ctypes.byref(probe[1]), stream)
    if rc != 0:
        raise RuntimeError(f"fused_simulate launch failed: CUDA error {rc}")
    return prs.SimOutput(
        depth=depth, flow=flow, iterations=iters, error=error, converged=conv.bool(),
        reservoir_stage=stage[..., 0], gate_open=gate, rcond=None,
        reservoir_stage_us=stage[..., 1],
    )


def series(bc, nt, dev, batch_shape=()):
    """The boundary's target series ``[*batch_shape, nt]`` (zeros for a kind
    that reads none)."""
    if bc.kind in ("flow_hydrograph", "stage_hydrograph"):
        return bc.target_series.expand(*batch_shape, nt).contiguous()
    return torch.zeros((*batch_shape, nt), dtype=torch.float64, device=dev)


def check_device(dev, h0, Q0, geo, us_bc, ds_bc, name):
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA or CPU tensors; got {dev}")
    if h0.dtype != torch.float64 or Q0.dtype != torch.float64:
        raise TypeError("h0 and Q0 must be float64 on the card")
    if geo.device != dev or Q0.device != dev or us_bc.bed_level.device != dev \
            or ds_bc.bed_level.device != dev:
        raise ValueError("geometry, boundaries and state must lie on the same device")


def _launch_one(geo, us_bc, ds_bc, h0, Q0, settings, qlat, probe=None) -> prs.SimOutput:
    """One simulation on a grid of one block."""
    nt, dev = settings.n_time_levels, h0.device
    par, rc_kind, us_rc_kind = pack_params(us_bc, ds_bc, settings)
    stor, stab, st_ints = pack_storage(us_bc, ds_bc)
    one = lambda t: t.unsqueeze(0).contiguous()
    out = launch(one(pack_geometry(geo)), one(h0), one(Q0), one(series(us_bc, nt, dev)),
                 one(series(ds_bc, nt, dev)), one(par), None if qlat is None else one(qlat),
                 settings, us_bc.kind, ds_bc.kind, rc_kind, us_rc_kind,
                 (one(stor), stab, st_ints), probe=probe)
    return prs.SimOutput(*(None if f is None else f[0] for f in out))


def fused_simulate_probe(geo, us_bc, ds_bc, h0, Q0, settings):
    """A measurement hook: one launch of the probe build (N <= 128, no
    storage) on CUDA tensors.  Returns ``(SimOutput, cycles, clock_khz)``:
    ``cycles`` maps each of :data:`PROBE_PHASES` to the SM cycles thread 0
    spent in it over the run.  Its outputs are the production build's bits.
    Counts no launch."""
    _check_supported(geo, us_bc, ds_bc, settings)
    prs.check_shapes(geo, us_bc, ds_bc, h0, Q0, settings, None)
    check_device(h0.device, h0, Q0, geo, us_bc, ds_bc, "fused_simulate_probe")
    cycles = torch.zeros(len(PROBE_PHASES), dtype=torch.int64, device=h0.device)
    clock = ctypes.c_int(0)
    out = _launch_one(geo, us_bc, ds_bc, h0, Q0, settings, None, probe=(cycles, clock))
    return out, dict(zip(PROBE_PHASES, cycles.tolist())), clock.value


def fused_simulate(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow=None) -> prs.SimOutput:
    """Run the full simulation in one CUDA kernel launch; returns a SimOutput.

    ``lateral_inflow``: ``None``, per node ``[N]`` or per level and node
    ``[nt, N]``.  Raises :class:`FusedUnsupported` for configurations outside
    the kernel's scope.  CPU tensors take the plain version.
    """
    global launch_count
    _check_supported(geo, us_bc, ds_bc, settings)
    qlat = prs.as_lateral_inflow(lateral_inflow, h0)
    prs.check_shapes(geo, us_bc, ds_bc, h0, Q0, settings, qlat)
    dev = h0.device
    if dev.type == "cpu":
        return fused_simulate_plain(geo, us_bc, ds_bc, h0, Q0, settings, qlat)
    check_device(dev, h0, Q0, geo, us_bc, ds_bc, "fused_simulate")
    out = _launch_one(geo, us_bc, ds_bc, h0, Q0, settings, qlat)
    launch_count += 1
    return out
