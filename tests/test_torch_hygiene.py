"""The port stands alone: it imports neither JAX, the JAX package, pandas nor
triton; its entry points default to the card and say so when there is none;
the fused engine refuses what it does not implement instead of falling back.
"""

import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "flowsim_tpu_torch")

torch.set_num_threads(1)


IMPORTED_ALONE = ["flowsim_tpu_torch", "flowsim_tpu_torch.models.gerd_roseires.model",
                  "flowsim_tpu_torch.ops.cuda.fused_newton",
                  "flowsim_tpu_torch.ops.cuda.pcr_kernel", "flowsim_tpu_torch.convert",
                  "flowsim_tpu_torch.ops.cuda.fused_batched",
                  "flowsim_tpu_torch.parallel.ensemble",
                  "flowsim_tpu_torch.models.calibrate",
                  "flowsim_tpu_torch.ops.cuda.tiled_pcr",
                  "flowsim_tpu_torch.ops.storage",
                  "flowsim_tpu_torch.models.example",
                  "flowsim_tpu_torch.ops.network",
                  "flowsim_tpu_torch.ops.cuda.fused_network",
                  "flowsim_tpu_torch.models.gerd_tributary",
                  "flowsim_tpu_torch.models.basin"]


@pytest.fixture(scope="module")
def fresh_imports():
    """Every module of IMPORTED_ALONE imported in an interpreter of its own;
    the interpreters are started together (each spends seconds importing
    torch) and a test waits for its own."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    for module in IMPORTED_ALONE:
        code = (f"import sys, {module}\n"
                "bad = [m for m in ('jax', 'jaxlib', 'flowsim_tpu', 'pandas', 'triton') if m in sys.modules]\n"
                "assert not bad, bad\n"
                "import torch; assert 'torch' in sys.modules")
        procs[module] = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("module", IMPORTED_ALONE)
def test_import_leaves_other_frameworks_out(fresh_imports, module):
    proc = fresh_imports[module]
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_sources_import_no_jax_no_jax_package_no_pandas():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pandas|triton|flowsim_tpu)(\.|\s|$)", re.M)
    files = _port_sources()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hit = pattern.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_kernel_sources_have_their_notes_and_no_library_calls():
    for name, replaced in (("pcr_kernel.cu", "pcr_kernel.py"), ("fused_newton.cu", "fused_newton.py"),
                           ("pcr_common.cuh", "pcr_common.py"), ("tiled_pcr.cu", "tiled_pcr.py"),
                           ("fused_network.cu", "fused_network.py")):
        with open(os.path.join(PORT, "ops", "cuda", "csrc", name)) as f:
            text = f.read()
        assert "Replaces flowsim_tpu/ops/pallas/" + replaced in text
        for lib in ("cublas", "cusolver", "torch/extension.h", "cutlass"):
            assert lib not in text.lower()


def test_cuda_entry_points_raise_clearly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    from flowsim_tpu_torch import api, build_trapezoid_geometry, resolve_device
    from flowsim_tpu_torch.models import basin, gerd_tributary
    from flowsim_tpu_torch.models.gerd_roseires import model
    from flowsim_tpu_torch.ops import boundary, rating_curve

    for call in (lambda: resolve_device(), lambda: resolve_device("cuda:0"),
                 lambda: model.build(), lambda: gerd_tributary.build(sim_duration=3600),
                 lambda: basin.build(levels=2), lambda: api.NetworkSolver([], 0.6, 60.0, 100.0, 600.0),
                 lambda: build_trapezoid_geometry(5, 100.0, 1.0, 0.0, 10.0, 0.03),
                 lambda: rating_curve.make_polynomial(1.0, 2.0, 3.0),
                 lambda: boundary.make_boundary("fixed_depth", initial_depth=1.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_build_needs_nvcc_and_says_so(monkeypatch, tmp_path):
    from flowsim_tpu_torch.ops.cuda import build

    monkeypatch.setenv("FLOWSIM_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("pcr_kernel")
    log = ("ptxas info    : Compiling entry function '_Z3fooPd' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooPd\n"
           "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 96 registers, 512 bytes smem, 400 bytes cmem[0]\n")
    assert build.parse_ptxas(log) == [dict(kernel="_Z3fooPd", stack_bytes=16, spill_store_bytes=8,
                                           spill_load_bytes=12, registers=96, static_smem_bytes=512)]


@pytest.fixture(scope="module")
def flagship():
    from flowsim_tpu_torch.models.gerd_roseires import model

    solver, channel = model.build(sim_duration=3600 * 2, device="cpu")
    return solver, channel, solver.settings(1e-6, 100)


def test_check_supported_accepts_the_flagship(flagship):
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    solver, channel, sset = flagship
    fn._check_supported(channel.geometry, solver.us_params, solver.ds_params, sset)
    par, rc_kind, us_rc_kind = fn.pack_params(solver.us_params, solver.ds_params, sset)
    assert par.shape == (32,) and (rc_kind, us_rc_kind) == (1, 0)
    assert float(par[22:].abs().max()) == 0.0          # no upstream rating: its block is zero
    assert fn.pack_geometry(channel.geometry).shape == (13, 121)
    assert fn.SMEM_BYTES_PER_NODE * fn.MAX_N + 512 <= 232448  # 227 KB per block


@pytest.mark.parametrize("case", ["table_geometry", "storage", "newton_fixed", "store_boundaries",
                                  "upstream_rating", "lateral_inflow", "too_long", "table_rating",
                                  "normal_depth_without_slope", "diagnos"])
def test_check_supported_raises_fused_unsupported(flagship, case):
    from flowsim_tpu_torch.ops import rating_curve as rc
    from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported, _check_supported, fused_simulate

    solver, channel, sset = flagship
    geo, us, ds = channel.geometry, solver.us_params, solver.ds_params
    if case == "table_geometry":
        # the port's TableGeometry is in the kernel (its table builds); what
        # is refused by name is a geometry class the kernel does not know
        from flowsim_tpu_torch import build_table_geometry, trapezoid_station
        table = build_table_geometry([trapezoid_station(z_bed=1.0, b_main=10.0), trapezoid_station(
            z_bed=0.0, b_main=10.0)], [0.0, 1000.0], [0.0, 500.0, 1000.0], depth_max=5.0, samples=8, device="cpu")
        _check_supported(table, us, ds, sset)

        class TableGeometry:  # not the port's TableGeometry
            n_nodes = 121
        geo = TableGeometry()
        with pytest.raises(FusedUnsupported, match="unknown geometry class 'TableGeometry'"):
            _check_supported(geo, us, ds, sset)
    elif case == "storage":
        # lumped storage is in the kernel; what stays refused, as in the TPU
        # kernel, is a gated rating on the storage itself
        from flowsim_tpu_torch.ops import storage as stg
        gated = rc.make_gated_blend([0.0, 50.0, 0.0], [0.0, 80.0, 0.0], 480.0, device="cpu")
        plain = stg.make_storage(surface_area=1e6, device="cpu")
        _check_supported(geo, us, dataclasses.replace(ds, kind="fixed_depth", storage=plain), sset)
        ds = dataclasses.replace(ds, kind="fixed_depth", storage=stg.make_storage(
            surface_area=1e6, rating=gated, device="cpu"))
    elif case == "newton_fixed":
        sset = dataclasses.replace(sset, newton="fixed")
    elif case == "store_boundaries":
        sset = dataclasses.replace(sset, store="ends")      # "boundaries" itself is in the kernel now
    elif case == "diagnos":
        sset = dataclasses.replace(sset, diagnos=True)
    elif case == "upstream_rating":
        # a polynomial or blended upstream rating is in the kernel; the gate
        # controller is downstream-only
        gated = rc.make_gated_blend([0.0, 50.0, 0.0], [0.0, 80.0, 0.0], 480.0, device="cpu")
        us = dataclasses.replace(ds, rating=gated)
    elif case == "lateral_inflow":
        # lateral inflow is in the kernel; what stays refused is a batched
        # inflow of a shape the batched wrapper cannot place
        from flowsim_tpu_torch.ops.cuda.fused_batched import batched_lateral_inflow
        with pytest.raises(FusedUnsupported, match="lateral_inflow"):
            batched_lateral_inflow(torch.zeros(5, 121), 4, 121, 3, solver.h0)
        _check_supported(geo, us, ds, sset)
        return
    elif case == "too_long":
        # beyond the long build's 8192 nodes (121 x 68 = 8228)
        geo = dataclasses.replace(geo, **{f.name: getattr(geo, f.name).repeat(68)
                                          for f in dataclasses.fields(geo)})
    elif case == "table_rating":
        ds = dataclasses.replace(ds, rating=rc.make_table([480.0, 490.0], [0.0, 1e4], device="cpu"))
    elif case == "normal_depth_without_slope":
        ds = dataclasses.replace(ds, kind="normal_depth")  # the flagship's bed_slope is NaN
    with pytest.raises(FusedUnsupported):
        _check_supported(geo, us, ds, sset)
    # and the entry point lets it reach the caller: no fallback to the plain engine
    with pytest.raises(FusedUnsupported):
        fused_simulate(geo, us, ds, solver.h0, solver.Q0, sset)


@pytest.mark.parametrize("n", [965, 8192, 8193])
def test_check_supported_takes_the_long_build_up_to_8192_nodes(flagship, n):
    """From 965 to 8192 nodes one simulation takes the reach build (its state
    in a thread-block cluster's shared memory; the long build, its state in
    a scratch of device memory counted with the outputs before anything is
    allocated, runs where a test hook forces it); 8193 is refused by name,
    with the solver that goes on."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.ops.cuda import fused_newton as fn

    solver, channel, sset = flagship
    geo = trees.tree_map(lambda v: v[:1].expand(n).contiguous(), channel.geometry)
    assert fn.uses_reach_build(n) == (n > fn.MAX_N) and not fn.uses_long_build(n)
    assert fn.uses_long_build(121, fn.LONG_BUILD)
    if n > fn.LONG_MAX_N:
        with pytest.raises(fn.FusedUnsupported, match=r"N=8193 exceeds .* 8192 nodes.*cuda_tiled"):
            fn._check_supported(geo, solver.us_params, solver.ds_params, sset)
        return
    fn._check_supported(geo, solver.us_params, solver.ds_params, sset)
    # the long build forced on 1024 members: outputs (two stored nodes) and
    # the scratch, 288 B a node
    need = fn.output_bytes(1024, n, 9, "boundaries") + fn.scratch_bytes(1024, n)
    assert fn.scratch_bytes(1024, n) == 1024 * n * 36 * 8
    fn.check_output_memory(1024, n, 9, "boundaries", free_bytes=need, long_build=True)
    fn.check_output_memory(1024, n, 9, "boundaries", free_bytes=need - 1)      # the outputs alone fit
    with pytest.raises(MemoryError, match=r"scratch .* chunk_size"):
        fn.check_output_memory(1024, n, 9, "boundaries", free_bytes=need - 1, long_build=True)


def test_long_reach_solver_is_named_and_runs_plain_on_cpu_tensors():
    """``cuda_pcr`` stops at 8192 nodes and says which solver goes on;
    ``tiled_spike_solve`` takes its plain version for CPU tensors (no nvcc,
    no launch) and is what ``linear_solver="cuda_tiled"`` reaches."""
    from flowsim_tpu_torch.ops import tridiag
    from flowsim_tpu_torch.ops.cuda import build, tiled_pcr

    n = 8193
    eye = torch.eye(2, dtype=torch.float64).expand(n, 2, 2)
    zero = torch.zeros((n, 2, 2), dtype=torch.float64)
    b = torch.ones((n, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="cuda_tiled"):
        tridiag.solve_block_tridiag(zero, eye, zero, b, method="cuda_pcr")
    before = tiled_pcr.launch_count
    x = tridiag.solve_block_tridiag(zero, eye, zero, b, method="cuda_tiled")
    assert torch.equal(x, b) and tiled_pcr.launch_count == before
    assert "tiled_pcr" in build.SOURCES and "cuda_tiled" in tridiag.METHODS
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tiled_pcr.tiled_spike_solve(*(t.to("meta") for t in (zero, eye, zero, b)))


def test_api_fused_engine_does_not_fall_back(flagship):
    from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported

    solver, _, _ = flagship
    solver.newton = "fixed"
    try:
        with pytest.raises(FusedUnsupported):
            solver.run(engine="fused", tolerance=1e-6, verbose=0)
        with pytest.raises(ValueError, match="engine"):
            solver.run(engine="xla")
    finally:
        solver.newton = "while"


def test_ensemble_entry_points_stay_on_the_device_of_their_inputs(flagship):
    """The ensemble and calibration helpers create their tensors where the
    geometry lies (no default device of their own), and the batched wrapper
    takes its plain version for CPU tensors only."""
    from flowsim_tpu_torch import trees
    from flowsim_tpu_torch.models import calibrate
    from flowsim_tpu_torch.ops.cuda.fused_batched import fused_simulate_batched
    from flowsim_tpu_torch.parallel import ensemble

    solver, channel, sset = flagship
    on_meta = lambda tree: trees.tree_map(lambda v: v.to("meta"), tree)
    geo = on_meta(channel.geometry)
    geob = ensemble.roughness_ensemble(geo, [0.03, 0.04])
    assert geob.n_main.shape == (2, 121)
    assert {getattr(geob, f.name).device.type for f in dataclasses.fields(geob)} == {"meta"}
    assert calibrate.set_main_roughness(geo, 0.03).n_main.device.type == "meta"
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_simulate_batched(geob, on_meta(solver.us_params), on_meta(solver.ds_params),
                               solver.h0.to("meta"), solver.Q0.to("meta"), sset)
