"""PyTorch port vs JAX package: river networks on the CPU in float64.

* the junction closures (rated outflow of all five rating kinds, plain and
  reservoir junction rows) against the JAX functions, rtol 1e-12;
* the port's loop engine on the 2-branch serial split of the flagship against
  the port's own single reach (the split solves the same system): identical
  counts, |dh| <= 1e-12 m;
* the GERD tributary network, 6 levels: the port's loop, stacked and fused
  (on CPU tensors: its plain version) engines against the JAX loop engine;
* a 7-branch basin with a junction reservoir with a power-law release, a
  rated withdrawal at a plain junction, a gated outlet and [nt, N] lateral
  inflow: the port's stacked and fused engines against the JAX stacked engine;
* ``batched_simulate_network`` (plain and fused) against member-by-member runs,
  its validation and its output-memory reckoning;
* ``NetworkSolver`` from ``Channel``s with ``Junction`` ends against the JAX
  solver built from the same inputs (geometry and initial state);
* every refusal of the network kernel and every ``NotImplementedError``.

Tolerances: identical per-level iteration counts, max|dh| <= 1e-9 m,
max|dQ| <= 1e-6 m^3/s, max|dY| <= 1e-9 m.  Two JAX network simulations are
compiled (the tributary's loop engine, the basin's stacked engine), each once,
in module-scoped fixtures.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsim_tpu import api as japi
from flowsim_tpu.models import basin as jbasin
from flowsim_tpu.models import gerd_tributary as jgt
from flowsim_tpu.ops import boundary as jbnd
from flowsim_tpu.ops import network as jnet
from flowsim_tpu.ops import rating_curve as jrc
from flowsim_tpu_torch import api, convert, trees
from flowsim_tpu_torch.models.gerd_roseires import model
from flowsim_tpu_torch.ops import network as net
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops import rating_curve as rc
from flowsim_tpu_torch.ops.cuda import fused_network as fnet
from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported
from flowsim_tpu_torch.parallel import ensemble as ens

from tests._torch_port import (  # noqa: F401 (without_autograd is an autouse fixture)
    arr, assert_close, to_port, tree_to_numpy, without_autograd)

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s
Y_TOL = 1e-9   # m


def _port_branches(jbranches):
    return [convert.from_numpy("branch", tree_to_numpy(b), device="cpu") for b in jbranches]


def _port_settings(js):
    return convert.from_numpy("PreissmannSettings", {f.name: getattr(js, f.name) for f in dataclasses.fields(js)},
                              device="cpu")


def _assert_network_matches(out, jout, what):
    assert out.iterations.tolist() == arr(jout.iterations).tolist(), what
    assert bool(out.converged.all()), what
    for b, (h, jh) in enumerate(zip(out.depth, jout.depth)):
        assert float(np.abs(arr(h) - arr(jh)).max()) <= H_TOL, (what, b)
    for b, (q, jq) in enumerate(zip(out.flow, jout.flow)):
        assert float(np.abs(arr(q) - arr(jq)).max()) <= Q_TOL, (what, b)
    assert float(np.abs(arr(out.junction_stage) - arr(jout.junction_stage)).max()) <= Y_TOL, what
    assert float(np.abs(arr(out.junction_outflow) - arr(jout.junction_outflow)).max()) <= Q_TOL, what
    np.testing.assert_array_equal(arr(out.gate_open), arr(jout.gate_open), err_msg=what)
    np.testing.assert_allclose(arr(out.reservoir_stage), arr(jout.reservoir_stage), rtol=0, atol=1e-9,
                               equal_nan=True, err_msg=what)


# -- (a) junction closures ----------------------------------------------------

def _jax_ratings():
    return [jrc.make_polynomial(2.0, 30.0, -40.0, stage_shift=-3.0),
            jrc.make_blended_poly([0.5, -200.0, 2e4], [0.8, -300.0, 3e4], pivot_stage=6.0, buffer=0.7),
            jrc.make_polynomial_general([-5.0, 12.0, 0.3, 0.02, -1e-4], stage_shift=-2.0),
            jrc.make_power(20.0, 1.5, stage_shift=-4.0),
            jrc.make_table([4.0, 5.0, 6.5, 8.0], [0.0, 40.0, 150.0, 400.0]),
            None]


@pytest.mark.parametrize("stage_offset", [-1.3, 0.0, 0.55, 2.1])
def test_junction_outflow_and_residuals_match_jax(stage_offset):
    jr = _jax_ratings()
    pr = [None if r is None else to_port("RatingCurveParams", r) for r in jr]
    Y = np.array([5.2, 6.1, 4.4, 5.9, 6.0, 5.0]) + stage_offset
    jq, jdq = jnet._junction_outflow(jr, jnp.asarray(Y), jnp.float64)
    q, dq = net._junction_outflow(pr, torch.tensor(Y, dtype=torch.float64))
    assert_close(q, jq, what="Q_out")
    assert_close(dq, jdq, what="dQ_out/dY")
    rng = np.random.default_rng(11)
    S, Sp, Yp, qp = (rng.uniform(-50.0, 50.0, 6), rng.uniform(-50.0, 50.0, 6), Y - rng.uniform(0.0, 0.1, 6),
                     rng.uniform(0.0, 30.0, 6))
    area = np.array([0.0, 4e4, 0.0, 2.5e5, 0.0, 1e3])           # plain and reservoir junctions
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    G = net._junction_residuals(t(S), t(Y), t(area), 900.0, q, (t(Yp), t(Sp), t(qp)))
    jG = jnet._junction_residuals(jnp.asarray(S), jnp.asarray(Y), jnp.asarray(area), 900.0, jq,
                                  (jnp.asarray(Yp), jnp.asarray(Sp), jnp.asarray(qp)))
    assert_close(G, jG, what="junction rows")
    assert net.junction_outflow_series(pr, t(Y)[None].expand(3, 6)).shape == (3, 6)


# -- (b) the serial split against the port's own single reach ------------------

def test_serial_split_is_the_single_reach():
    solver, channel = model.build(sim_duration=3600 * 3, device="cpu")
    sset = solver.settings(1e-6, 100)
    ref = prs.simulate(channel.geometry, solver.us_params, solver.ds_params, solver.h0, solver.Q0, sset)
    cut = 60
    geo = channel.geometry
    branches = [net.BranchDef(geo=trees.tree_map(lambda v: v[: cut + 1], geo), dx=solver.spatial_step,
                              us=solver.us_params, ds=0, h0=solver.h0[: cut + 1], Q0=solver.Q0[: cut + 1]),
                net.BranchDef(geo=trees.tree_map(lambda v: v[cut:], geo), dx=solver.spatial_step, us=0,
                              ds=solver.ds_params, h0=solver.h0[cut:], Q0=solver.Q0[cut:])]
    out = net.simulate_network(branches, 1, sset, engine="loop")
    assert out.iterations.tolist() == ref.iterations.tolist()
    h = torch.cat([out.depth[0], out.depth[1][:, 1:]], dim=1)
    q = torch.cat([out.flow[0], out.flow[1][:, 1:]], dim=1)
    assert float((h - ref.depth).abs().max()) <= 1e-12
    assert float((q - ref.flow).abs().max()) <= 1e-12 * float(ref.flow.abs().max())
    assert float((out.junction_stage[:, 0] - (ref.depth[:, cut] + geo.z_bed[cut])).abs().max()) <= 1e-12


# -- (c) the tributary against the JAX loop engine ------------------------------

@pytest.fixture(scope="module")
def tributary():
    jb, nj, js, _ = jgt.build(sim_duration=3600 * 5)
    jout = jnet.simulate_network(jb, nj, js, engine="loop")
    return jb, nj, js, jout


@pytest.mark.parametrize("engine", ["loop", "stacked", "fused"])
def test_tributary_matches_jax(tributary, engine):
    jb, nj, js, jout = tributary
    before = fnet.launch_count
    out = net.simulate_network(_port_branches(jb), nj, _port_settings(js), engine=engine)
    _assert_network_matches(out, jout, engine)
    assert fnet.launch_count == before          # CPU tensors: the plain version, no launch


def test_tributary_model_builds_the_same_network(tributary):
    jb, nj, js, _ = tributary
    from flowsim_tpu_torch.models import gerd_tributary

    pb, pnj, ps, _ = gerd_tributary.build(sim_duration=3600 * 5, device="cpu")
    assert pnj == nj and ps.n_time_levels == js.n_time_levels
    for p, j in zip(pb, jb):
        assert p.dx == j.dx and type(p.us) is not int or p.us == j.us
        for f in ("z_bed", "b_main", "n_main", "curvature", "h_bank"):
            assert_close(getattr(p.geo, f), getattr(j.geo, f), what=f)
        assert_close(p.h0, j.h0, what="h0")
        assert_close(p.Q0, j.Q0, what="Q0")
    assert_close(pb[1].us.target_series, jb[1].us.target_series, what="tributary inflow")


def test_network_solver_assembles_the_tributary_from_channels():
    """``gerd_tributary.network_solver``: the same branches from api.Channel
    and api.Junction objects (node chainages rounded apart by 1e-13 m)."""
    from flowsim_tpu_torch.models import gerd_tributary

    ns, branches = gerd_tributary.network_solver(sim_duration=3600 * 2, device="cpu")
    assert ns.n_junctions == 1 and len(ns.branches) == 3
    for a, b in zip(ns.branches, branches):
        assert a.dx == b.dx and a.geo.n_nodes == b.geo.n_nodes
        for f in ("z_bed", "b_main", "m_main", "n_main", "h_bank", "curvature"):
            assert float((getattr(a.geo, f) - getattr(b.geo, f)).abs().max()) <= 1e-10, f
        assert torch.equal(a.h0, b.h0) and torch.equal(a.Q0, b.Q0)
        for end in ("us", "ds"):
            ea, eb = getattr(a, end), getattr(b, end)
            assert ea == eb if isinstance(eb, int) else (ea.kind == eb.kind and bool(
                (ea.target_series - eb.target_series).abs().max() == 0.0))


# -- (d) a basin with every junction option against the JAX stacked engine ------

def _jax_basin():
    jb, nj, js = jbasin.build(levels=3, sim_hours=1.0)
    nt = js.n_time_levels
    outlet = jb[0]
    y0 = float(outlet.geo.z_bed[-1] + outlet.h0[-1])
    q0 = float(outlet.Q0[-1])
    gated = jrc.make_gated_blend([0.0, 150.0, q0 - 150.0 * y0], [0.0, 200.0, q0 - 200.0 * y0],
                                 pivot_stage=y0 - 0.2, max_cooldown=1800.0)
    jb[0] = dataclasses.replace(outlet, ds=jbnd.make_boundary("rating_curve", bed_level=float(outlet.geo.z_bed[-1]),
                                                              rating=gated))
    rng = np.random.default_rng(5)
    jb[3] = dataclasses.replace(jb[3], qlat=jnp.asarray(rng.uniform(0.0, 1e-3, (nt, 13))))
    z1 = float(jb[1].geo.z_bed[0])
    area = jnp.asarray([0.0, 4e4, 0.0])
    rating = [jrc.make_polynomial(0.0, 10.0, -30.0), jrc.make_power(20.0, 1.5, stage_shift=-z1), None]
    return jb, nj, js, area, rating


@pytest.fixture(scope="module")
def basin():
    jb, nj, js, area, rating = _jax_basin()
    jout = jnet.simulate_network(jb, nj, js, junction_area=area, junction_rating=rating, engine="stacked")
    return jb, nj, js, area, rating, jout


def test_basin_model_builds_the_same_network(basin):
    """``models.basin.build`` (initial depths of all branches in one
    node-wise bisection) against the JAX model's per-branch build."""
    jb, nj, js, _, _, _ = basin
    from flowsim_tpu_torch.models import basin as pbasin

    pb, pnj, ps = pbasin.build(levels=3, sim_hours=1.0, device="cpu")
    assert pnj == nj and ps.n_time_levels == js.n_time_levels and len(pb) == len(jb)
    for p, j in zip(pb, jb):
        assert p.dx == j.dx and (p.us == j.us if isinstance(j.us, int) else p.us.kind == j.us.kind)
        for f in ("z_bed", "b_main", "m_main", "n_main", "bed_slope"):
            assert_close(getattr(p.geo, f), getattr(j.geo, f), what=f)
        assert_close(p.h0, j.h0, what="h0")
        assert_close(p.Q0, j.Q0, what="Q0")
        if not isinstance(j.us, int):
            assert_close(p.us.target_series, j.us.target_series, what="headwater inflow")


@pytest.mark.parametrize("engine", ["stacked", "fused"])
def test_basin_with_junction_options_matches_jax(basin, engine):
    jb, nj, js, area, rating, jout = basin
    out = net.simulate_network(_port_branches(jb), nj, _port_settings(js), junction_area=arr(area),
                               junction_rating=[None if r is None else to_port("RatingCurveParams", r)
                                                for r in rating], engine=engine)
    _assert_network_matches(out, jout, engine)
    assert float(out.junction_outflow[1:, :2].min()) > 0.0


# -- (e) the batched entry point -------------------------------------------------

def _scaled(bc, scales):
    b = trees.tree_map(lambda v: v.expand(len(scales), *v.shape), bc)
    return dataclasses.replace(b, target_series=bc.target_series[None] * torch.tensor(scales)[:, None])


@pytest.fixture(scope="module")
def small_tributary():
    from flowsim_tpu_torch.models import gerd_tributary

    return gerd_tributary.build(sim_duration=3600 * 2, device="cpu")


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_batched_network_is_member_by_member(small_tributary, engine):
    br, nj, sset, _ = small_tributary
    scales = [0.9, 1.15]
    batch = [dict(us=_scaled(br[0].us, scales)), dict(h0=torch.stack([br[1].h0, br[1].h0 + 0.01])), dict()]
    out = ens.batched_simulate_network(br, nj, sset, batch, engine=engine, chunk_size=1)
    assert out.depth[0].shape == (2, sset.n_time_levels, 61) and out.junction_stage.shape[:2] == (2, 3)
    for m in range(2):
        one = net.simulate_network(net.member_branches(br, batch, m), nj, sset, engine="stacked")
        for a, b in zip((*out.depth, *out.flow, out.junction_stage, out.error),
                        (*one.depth, *one.flow, one.junction_stage, one.error)):
            assert torch.equal(a[m], b)
        assert out.iterations[m].tolist() == one.iterations.tolist()
    assert not torch.equal(out.flow[2][0], out.flow[2][1])


def test_stacked_network_switches_pcr_f32_below_the_floor(small_tributary):
    """simulate_network with "pcr_f32" at tol 1e-8 warns and runs the "pcr"
    solve, as the JAX package's guard does."""
    br, nj, sset, _ = small_tributary
    tight = dataclasses.replace(sset, tolerance=1e-8)
    with pytest.warns(UserWarning, match="pcr_f32"):
        out = net.simulate_network(br, nj, dataclasses.replace(tight, linear_solver="pcr_f32"), engine="stacked")
    ref = net.simulate_network(br, nj, dataclasses.replace(tight, linear_solver="pcr"), engine="stacked")
    assert out.iterations.tolist() == ref.iterations.tolist()
    for a, b in zip((*out.depth, *out.flow, out.junction_stage, out.error),
                    (*ref.depth, *ref.flow, ref.junction_stage, ref.error)):
        assert torch.equal(a, b)


def test_batched_network_validates_its_inputs(small_tributary):
    br, nj, sset, _ = small_tributary
    us2 = _scaled(br[0].us, [1.0, 1.1])
    for batch, match in (([dict(us=us2)], "one dict per branch"),
                         ([dict(us=us2), dict(dx=torch.ones(2)), dict()], "dx is static"),
                         ([dict(us=us2), dict(), dict(us=us2)], "junction ends"),
                         ([dict(us=us2), dict(h0=torch.zeros(3, 10)), dict()], "members"),
                         ([dict(us=us2), dict(qlat=torch.zeros(2, 9)), dict()], "qlat"),
                         ([dict(), dict(), dict()], "overrides nothing")):
        with pytest.raises(ValueError, match=match):
            ens.batched_simulate_network(br, nj, sset, batch)
    with pytest.raises(ValueError, match="chunk_size"):
        ens.batched_simulate_network(br, nj, sset, [dict(us=_scaled(br[0].us, [1.0, 1.1, 1.2])), dict(), dict()],
                                     chunk_size=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        ens.batched_simulate_network(br, nj, sset, [dict(us=us2), dict(), dict()], shard=True)
    # the outputs are reckoned before anything is allocated
    need = fnet.output_bytes(1024, 3, 61, 1, 385)
    assert need == 1024 * 385 * (2 * 3 * 61 * 8 + 8 + 12 * 8 + 8 + 8)
    fnet.check_output_memory(1024, 3, 61, 1, 385, need)
    with pytest.raises(MemoryError, match="chunk_size"):
        fnet.check_output_memory(1024, 3, 61, 1, 385, need - 1)


# -- (f) NetworkSolver against the JAX solver ------------------------------------

def _channels(api_mod):
    def hyd(mod):
        return mod.Hydrograph(function=lambda t: 300.0 + 100.0 * np.sin(t / 7200.0))

    rc_ = api_mod.RatingCurve()
    rc_.set("polynomial", a=2.0, b=80.0, c=-400.0, stage_shift=0.0)
    main = api_mod.Channel(api_mod.Boundary("flow_hydrograph", 0.0, bed_level=12.0, initial_depth=2.5, hydrograph=hyd(api_mod)),
                           api_mod.Junction(0, 8000.0, bed_level=8.0, initial_depth=2.5), initial_flow=300.0,
                           roughness=0.03, width=60.0, interpolation_method="linear")
    side = api_mod.Channel(api_mod.Boundary("flow_hydrograph", 0.0, bed_level=11.0, initial_depth=2.5, hydrograph=hyd(api_mod)),
                           api_mod.Junction(0, 5000.0, bed_level=8.0, initial_depth=2.5), initial_flow=300.0,
                           roughness=0.035, width=40.0, interpolation_method="linear")
    out = api_mod.Channel(api_mod.Junction(0, 0.0, bed_level=8.0, initial_depth=2.5),
                          api_mod.Boundary("rating_curve", 6000.0, bed_level=5.0, initial_depth=2.5, rating_curve=rc_),
                          initial_flow=600.0, roughness=0.03, width=90.0, interpolation_method="linear")
    return [main, side, out]


def test_network_solver_builds_the_jax_branches():
    kw = dict(theta=0.7, time_step=600.0, spatial_step=1000.0, simulation_time=3600.0)
    js = japi.NetworkSolver(_channels(japi), **kw)
    ps = api.NetworkSolver(_channels(api), device="cpu", **kw)
    assert ps.n_junctions == js.n_junctions == 1 and ps.branch_dx == js.branch_dx
    for p, j in zip(ps.branches, js.branches):
        assert p.us == j.us if isinstance(j.us, int) else p.us.kind == j.us.kind
        assert p.ds == j.ds if isinstance(j.ds, int) else p.ds.kind == j.ds.kind
        for f in dataclasses.fields(j.geo):
            assert_close(getattr(p.geo, f.name), getattr(j.geo, f.name), what=f.name)
        assert_close(p.h0, j.h0, what="h0")
        assert_close(p.Q0, j.Q0, what="Q0")
    assert_close(ps.branches[0].us.target_series, js.branches[0].us.target_series, what="series")
    assert ps.settings(1e-6, 50).n_time_levels == js.settings(1e-6, 50).n_time_levels
    for name in ("branch", "summary", "save_results"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
            getattr(ps, name)(*([0] if name != "summary" else []))


# -- (g) refusals ----------------------------------------------------------------

def test_fused_network_refuses_by_name(small_tributary):
    br, nj, sset, _ = small_tributary
    lv = lambda **kw: [dataclasses.replace(br[0], **kw), *br[1:]]

    # table branches, their tables at the branches' nodes built by the port,
    # of two depth-grid resolutions
    from flowsim_tpu_torch import build_table_geometry, trapezoid_station

    def table(b, samples):
        return build_table_geometry([trapezoid_station(z_bed=1.0, b_main=10.0), trapezoid_station(
            z_bed=0.0, b_main=10.0)], [0.0, 1.0], np.linspace(0.0, 1.0, br[b].geo.n_nodes), depth_max=5.0,
            samples=samples, device="cpu")

    two_m = [dataclasses.replace(br[0], geo=table(0, 8)), br[1], dataclasses.replace(br[2], geo=table(2, 16))]

    cases = [
        (lambda: fnet.fused_simulate_network([dataclasses.replace(br[0], ds=br[2].ds)], 0, sset), "not a network"),
        (lambda: fnet.check_supported(two_m, nj, sset), "share one depth-grid resolution"),
        (lambda: fnet.fused_simulate_network(br, nj, dataclasses.replace(sset, diagnos=True)), "diagnostics"),
        (lambda: fnet.fused_simulate_network(
            lv(us=dataclasses.replace(br[2].ds, rating=rc.make_gated_blend([0.0, 5.0, 0.0], [0.0, 6.0, 0.0], 480.0,
                                                                        device="cpu"))), nj, sset),
         "upstream rating kind 'gated_blend'"),
        (lambda: fnet.fused_simulate_network(br, nj, sset, junction_rating=[
            dataclasses.replace(rc.make_polynomial(1.0, 2.0, 3.0, device="cpu"), kind="cubic")]), "rating kind 'cubic'"),
        (lambda: fnet.fused_simulate_network(br, nj, sset, junction_rating=[dataclasses.replace(
            rc.make_polynomial(1.0, 2.0, 3.0, device="cpu"), coeffs=torch.ones(4, dtype=torch.float64))]),
         "quadratic"),
        (lambda: fnet.fused_simulate_network(br, nj, dataclasses.replace(sset, newton="fixed")), "while-Newton"),
    ]
    for call, match in cases:
        with pytest.raises(FusedUnsupported, match=match):
            call()
    # the stacked engine stacks one geometry tree: a mixed network raises by
    # name, for the loop and fused engines that run it
    with pytest.raises(ValueError, match='engine="loop" or engine="fused"'):
        net.simulate_network(lv(geo=table(0, 8)), nj, sset, engine="stacked")
    # the basin at levels=5 fits one block's shared memory; at levels=6 it
    # does not and takes the scratch build, so it is in scope; 127 junctions
    # (levels=8) are refused in the JAX kernel's words
    from flowsim_tpu_torch.models import basin

    b5, n5, s5 = basin.build(levels=5, sim_hours=0.5, device="cpu")
    assert fnet.check_supported(b5, n5, s5).m_rhs == 3          # 31 x 13 slots fit
    b6, n6, s6 = basin.build(levels=6, sim_hours=0.5, device="cpu")
    t6 = fnet.check_supported(b6, n6, s6)                       # 63 x 13 do not
    assert t6.m_rhs == 3 and fnet.smem_bytes(len(b6) * t6.n_max, len(b6), n6, t6.m_rhs) > fnet.SMEM_LIMIT
    b8, n8, s8 = basin.build(levels=8, link_nodes=2, sim_hours=0.5, device="cpu")
    with pytest.raises(FusedUnsupported, match="J > 120"):
        fnet.check_supported(b8, n8, s8)
    # nothing falls back: the api lets it reach the caller
    cubic = dataclasses.replace(rc.make_polynomial(1.0, 2.0, 3.0, device="cpu"), kind="cubic")
    ns = api.NetworkSolver(_channels(api), theta=0.7, time_step=600.0, spatial_step=1000.0,
                           simulation_time=1200.0, junction_rating=[cubic], device="cpu")
    with pytest.raises(FusedUnsupported, match="cubic"):
        ns.run(engine="fused")
    with pytest.raises(ValueError, match="engine"):
        ns.run(engine="xla")


def test_network_inputs_are_checked_before_any_run(small_tributary):
    br, nj, sset, _ = small_tributary
    nt = sset.n_time_levels
    bad_q = [dataclasses.replace(br[1], qlat=torch.zeros(nt + 1, 10)), br[0], br[2]]
    bad_sq = [dataclasses.replace(br[1], qlat=torch.zeros(10, nt)), br[0], br[2]]
    bad_series = [dataclasses.replace(br[0], us=dataclasses.replace(br[0].us, target_series=torch.zeros(nt - 1))),
                  *br[1:]]
    for engine in ("loop", "stacked", "fused"):
        for branches, match in ((bad_q, "qlat"), (bad_sq, "qlat"), (bad_series, "target_series")):
            with pytest.raises(ValueError, match=match):
                net.simulate_network(branches, nj, sset, engine=engine)
        for kw, match in ((dict(junction_area=[0.0, 1.0]), "junction_area has 2"),
                          (dict(junction_rating=[None, None]), "junction_rating has 2"),
                          (dict(junction_rating=[rc.make_gated_blend([0.0, 1.0, 0.0], [0.0, 2.0, 0.0], 480.0,
                                                                     device="cpu")]), "gated_blend")):
            with pytest.raises(ValueError, match=match):
                net.simulate_network(br, nj, sset, engine=engine, **kw)
        with pytest.raises(ValueError, match="junction 1 connects 0"):
            net.simulate_network(br, 2, sset, engine=engine)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            net.simulate_network(br, nj, dataclasses.replace(sset, newton="fixed"), engine=engine)
    with pytest.raises(ValueError, match="unknown engine"):
        net.simulate_network(br, nj, sset, engine="xla")
