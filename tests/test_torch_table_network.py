"""PyTorch port vs JAX package: river networks with surveyed (lookup-table)
branches on the CPU in float64.

The network is the JAX package's own test case (tests/test_fused_network.py
``_table_reach``): an 8 km surveyed reach of two polylines, 9 nodes, M = 48
depth samples, 17 levels of 1800 s, split at node 4 into two table branches;
its mixed variant adds a 4 km trapezoid tributary at the junction.

* the weight bridge: a JAX table branch crosses into the port bit for bit;
* the port's loop engine against the JAX loop engine, all-table and mixed;
* the port's stacked engine against the JAX stacked engine, all-table;
* ``engine="fused"`` on CPU tensors (the network kernel's plain version, the
  stacked engine with each geometry class stacked on its own) against the
  JAX loop engine, mixed — the JAX fused kernel's own tests hold that kernel
  to this loop engine;
* a two-member batch through ``batched_simulate_network(engine="fused")``
  against the port's loop engine member by member;
* ``api.NetworkSolver`` with two surveyed channels and a trapezoid one
  against the JAX ``NetworkSolver`` (both apis' tables at M = 48);
* the refusals: mismatched depth-grid resolutions, a per-member table
  override in a fused batch, a mixed network and differing ``n_ref`` in the
  stacked engine.

Tolerances: identical per-level iteration counts, max|dh| <= 1e-9 m,
max|dQ| <= 1e-6 m^3/s, junction stages <= 1e-9 m.  Four JAX network
simulations are compiled, each once, in module-scoped fixtures.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from flowsim_tpu import api as japi
from flowsim_tpu import geometry as jgeom
from flowsim_tpu import geometry_tables as jgt
from flowsim_tpu.ops import boundary as jbnd
from flowsim_tpu.ops import initial_conditions as jic
from flowsim_tpu.ops import network as jnet
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu_torch import api, convert
from flowsim_tpu_torch import geometry_tables as gt
from flowsim_tpu_torch.geometry import TableGeometry
from flowsim_tpu_torch.ops import network as net
from flowsim_tpu_torch.ops.cuda import fused_network as fnet
from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported
from flowsim_tpu_torch.parallel import ensemble as ens

from tests._torch_port import (  # noqa: F401 (without_autograd is an autouse fixture)
    arr, tree_to_numpy, without_autograd)

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s
Y_TOL = 1e-9   # m
SLOPE, LENGTH, SPLIT = 2e-4, 8000.0, 4
SCALES = (0.9, 1.1)


def _polyline(seed, z0):
    """A surveyed section of 21 points over 220 m, a parabola 8 m deep plus
    up to 0.5 m of noise from ``seed`` (the JAX case's sections)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 220.0, 21)
    return x, z0 + 8.0 * ((x - 110.0) / 110.0) ** 2 + rng.uniform(0.0, 0.5, x.size)


def _ramp(q0, q1, times):
    return [q0 + (q1 - q0) * min(t / (4 * 3600.0), 1.0) for t in times]


def _jax_networks(samples=48, n_nodes=9, nt=17):
    """The JAX package's branches: the split table reach and its mixed
    variant (the tests/test_fused_network.py cases), and the settings."""
    (x1, z1), (x2, z2) = _polyline(1, SLOPE * LENGTH), _polyline(2, 0.0)
    sts = [jgt.IrregularStation(x=x1, z=z1, n_main=0.03, bed_slope=SLOPE),
           jgt.IrregularStation(x=x2, z=z2, n_main=0.03, bed_slope=SLOPE)]
    geo = jgt.build_table_geometry(sts, [0.0, LENGTH], np.linspace(0.0, LENGTH, n_nodes), samples=samples)
    h0, Q0 = jic.initial_conditions(geo, "steady-state", 400.0, 1000.0)
    times = np.arange(nt) * 1800.0
    us = jbnd.make_boundary("flow_hydrograph", bed_level=float(geo.z_bed[0]), target_series=_ramp(400.0, 1000.0, times))
    ds = jbnd.make_boundary("normal_depth", bed_level=float(geo.z_bed[-1]), bed_slope=float(geo.bed_slope[-1]))
    sset = jprs.PreissmannSettings(theta=0.7, time_step=1800.0, spatial_step=1000.0, n_time_levels=nt,
                                   tolerance=1e-8, max_iter=100)
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    upper = jnet.BranchDef(geo=sl(slice(0, SPLIT + 1)), dx=1000.0, us=us, ds=0, h0=h0[:SPLIT + 1],
                           Q0=Q0[:SPLIT + 1])
    lower = jnet.BranchDef(geo=sl(slice(SPLIT, None)), dx=1000.0, us=0, ds=ds, h0=h0[SPLIT:], Q0=Q0[SPLIT:])
    z_conf = float(np.asarray(geo.z_bed)[SPLIT])
    stations = [jgeom.trapezoid_station(z_bed=z_conf + 4000.0 * SLOPE, b_main=40.0, m_main=2.0, n_main=0.03,
                                        bed_slope=SLOPE),
                jgeom.trapezoid_station(z_bed=z_conf, b_main=40.0, m_main=2.0, n_main=0.03, bed_slope=SLOPE)]
    gT = jgeom.interpolate_stations(stations, [0.0, 4000.0], np.linspace(0.0, 4000.0, 5))
    hT, QT = jic.initial_conditions(gT, "steady-state", 150.0, 1000.0)
    us_t = jbnd.make_boundary("flow_hydrograph", bed_level=float(gT.z_bed[0]), target_series=_ramp(150.0, 300.0, times))
    tributary = jnet.BranchDef(geo=gT, dx=1000.0, us=us_t, ds=0, h0=hT, Q0=QT)
    mixed = [upper, tributary, dataclasses.replace(lower, Q0=lower.Q0 + 150.0)]
    return [upper, lower], mixed, sset


def _port(jbranches):
    return [convert.from_numpy("branch", tree_to_numpy(b), device="cpu") for b in jbranches]


def _port_settings(js):
    return convert.from_numpy("PreissmannSettings", {f.name: getattr(js, f.name) for f in dataclasses.fields(js)},
                              device="cpu")


@pytest.fixture(scope="module")
def cases():
    """Both networks in both packages, and the JAX runs the tests compare
    with: the loop engine on each network, the stacked engine on the
    all-table one."""
    jtab, jmix, jsset = _jax_networks()
    ref = dict(table_loop=jnet.simulate_network(jtab, 1, jsset, engine="loop"),
               mixed_loop=jnet.simulate_network(jmix, 1, jsset, engine="loop"),
               table_stacked=jnet.simulate_network(jtab, 1, jsset, engine="stacked"))
    return dict(jax=dict(table=jtab, mixed=jmix), port=dict(table=_port(jtab), mixed=_port(jmix)),
                sset=_port_settings(jsset), ref=ref)


def _assert_network_matches(out, ref, what):
    assert out.iterations.tolist() == arr(ref.iterations).tolist(), what
    assert bool(out.converged.all()), what
    for b, (h, jh) in enumerate(zip(out.depth, ref.depth)):
        assert float(np.abs(arr(h) - arr(jh)).max()) <= H_TOL, (what, b)
    for b, (q, jq) in enumerate(zip(out.flow, ref.flow)):
        assert float(np.abs(arr(q) - arr(jq)).max()) <= Q_TOL, (what, b)
    assert float(np.abs(arr(out.junction_stage) - arr(ref.junction_stage)).max()) <= Y_TOL, what


def test_convert_carries_a_table_branch_bit_for_bit(cases):
    jb, pb = cases["jax"]["mixed"][0], cases["port"]["mixed"][0]
    assert isinstance(pb.geo, TableGeometry) and pb.geo.n_ref == jb.geo.n_ref
    for f in dataclasses.fields(jb.geo):
        if f.name != "n_ref":
            ref = np.asarray(getattr(jb.geo, f.name))
            got = arr(getattr(pb.geo, f.name))
            assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref), f.name
    assert np.array_equal(arr(pb.h0), np.asarray(jb.h0)) and np.array_equal(arr(pb.Q0), np.asarray(jb.Q0))
    assert pb.ds == 0 and pb.dx == jb.dx


@pytest.mark.parametrize("network", ["table", "mixed"])
def test_loop_engine_matches_jax(cases, network):
    out = net.simulate_network(cases["port"][network], 1, cases["sset"], engine="loop")
    _assert_network_matches(out, cases["ref"][network + "_loop"], f"loop engine, {network}")


def test_stacked_engine_matches_jax(cases):
    out = net.simulate_network(cases["port"]["table"], 1, cases["sset"], engine="stacked")
    _assert_network_matches(out, cases["ref"]["table_stacked"], "stacked engine, all-table")


def test_fused_plain_version_runs_mixed_networks(cases):
    before = fnet.launch_count
    out = net.simulate_network(cases["port"]["mixed"], 1, cases["sset"], engine="fused")
    assert fnet.launch_count == before                      # CPU tensors: the plain version
    _assert_network_matches(out, cases["ref"]["mixed_loop"], "fused (plain version), mixed")


def _scaled_upper(branches, scales):
    """The per-member override of the upper stem's inflow series."""
    us = branches[0].us
    s = torch.tensor(scales, dtype=torch.float64)
    batched = dataclasses.replace(us, **{f.name: getattr(us, f.name).expand(len(scales), *getattr(us, f.name).shape)
                                         for f in dataclasses.fields(us)
                                         if isinstance(getattr(us, f.name), torch.Tensor)})
    return dataclasses.replace(batched, target_series=us.target_series[None, :] * s[:, None])


def test_batched_mixed_network_matches_member_runs(cases):
    br, sset = cases["port"]["mixed"], cases["sset"]
    batch = [dict(us=_scaled_upper(br, SCALES))] + [dict() for _ in br[1:]]
    before = fnet.batched_launch_count
    out = ens.batched_simulate_network(br, 1, sset, batch, engine="fused")
    assert fnet.batched_launch_count == before
    for m in range(len(SCALES)):
        ref = net.simulate_network(net.member_branches(br, batch, m), 1, sset, engine="loop")
        _assert_network_matches(net.NetworkOutput(*(tuple(x[m] for x in f) if isinstance(f, tuple) else f[m]
                                                    for f in out)), ref, f"member {m}")


def _api_channels(mod, irregular, trapezoid_station):
    """A surveyed main stem in two channels (upper: inflow rising 400 -> 1000
    m^3/s, lower: normal depth) with a trapezoid tributary (150 -> 300 m^3/s)
    at junction 0, 4 km each at 1 km spacing."""
    (x1, z1), (x2, z2), (x3, z3) = _polyline(1, 1.6), _polyline(2, 0.8), _polyline(3, 0.0)
    st = lambda x, z: irregular(x=x, z=z, n_main=0.03, bed_slope=SLOPE)
    hyd = lambda q0, q1: mod.Hydrograph(function=lambda t: q0 + (q1 - q0) * min(t / (4 * 3600.0), 1.0))
    upper = mod.Channel(mod.Boundary(condition="flow_hydrograph", chainage=0.0, hydrograph=hyd(400.0, 1000.0)),
                        mod.Junction(0, 4000.0), initial_flow=400.0, interpolation_method="steady-state")
    upper.set_cross_sections([0.0, 4000.0], [st(x1, z1), st(x2, z2)])
    lower = mod.Channel(mod.Junction(0, 0.0), mod.Boundary(condition="normal_depth", chainage=4000.0),
                        initial_flow=550.0, interpolation_method="steady-state")
    lower.set_cross_sections([0.0, 4000.0], [st(x2, z2), st(x3, z3)])
    z_conf = float(z2.min())
    trib = mod.Channel(mod.Boundary(condition="flow_hydrograph", chainage=0.0, hydrograph=hyd(150.0, 300.0)),
                       mod.Junction(0, 4000.0), initial_flow=150.0, interpolation_method="steady-state")
    trib.set_cross_sections([0.0, 4000.0], [
        trapezoid_station(z_bed=z_conf + 4000.0 * SLOPE, b_main=40.0, m_main=2.0, n_main=0.03, bed_slope=SLOPE),
        trapezoid_station(z_bed=z_conf, b_main=40.0, m_main=2.0, n_main=0.03, bed_slope=SLOPE)])
    return [upper, trib, lower]


def test_network_solver_with_surveyed_channels_matches_jax(monkeypatch):
    # both apis rasterize 1024 depth samples a node; 48 keep the host build short
    monkeypatch.setattr(jgt, "build_table_geometry", functools.partial(jgt.build_table_geometry, samples=48))
    monkeypatch.setattr(api, "build_table_geometry", functools.partial(gt.build_table_geometry, samples=48))
    from flowsim_tpu_torch.geometry import TrapezoidStation

    kw = dict(theta=0.7, time_step=1800.0, spatial_step=1000.0, simulation_time=1800.0 * 12)
    js = japi.NetworkSolver(_api_channels(japi, jgt.IrregularStation, jgeom.TrapezoidStation), **kw)
    ps = api.NetworkSolver(_api_channels(api, gt.IrregularStation, TrapezoidStation), device="cpu", **kw)
    assert [type(b.geo).__name__ for b in ps.branches] == ["TableGeometry", "TrapezoidGeometry", "TableGeometry"]
    assert ps.branches[0].geo.area.shape == (5, 48)
    ref = js.run(tolerance=1e-8, verbose=0, engine="loop")
    for engine in ("loop", "fused"):
        _assert_network_matches(ps.run(tolerance=1e-8, verbose=0, engine=engine), ref, f"NetworkSolver {engine}")


def test_table_network_refusals(cases):
    table, mixed, sset = cases["port"]["table"], cases["port"]["mixed"], cases["sset"]
    # table branches of two resolutions: the fused kernel refuses them by name
    stations = [gt.IrregularStation(x=x, z=z, n_main=0.03, bed_slope=SLOPE)
                for x, z in (_polyline(1, 0.8), _polyline(2, 0.0))]
    coarse = dataclasses.replace(table[1], geo=gt.build_table_geometry(
        stations, [0.0, 4000.0], np.linspace(0.0, 4000.0, 5), samples=32, device="cpu"))
    with pytest.raises(FusedUnsupported, match="resolution"):
        net.simulate_network([table[0], coarse], 1, sset, engine="fused")
    # a per-member table override in a fused batch: the members share the tables
    geo_b = ens.table_roughness_ensemble(table[1].geo, [0.03, 0.035])
    with pytest.raises(FusedUnsupported, match="per-member TableGeometry"):
        ens.batched_simulate_network(table, 1, sset, [dict(), dict(geo=geo_b)], engine="fused")
    # the stacked engine stacks one geometry tree: a mixed network raises by
    # name (never an AttributeError), in the ensemble's plain engine too
    with pytest.raises(ValueError, match='engine="loop" or engine="fused"'):
        net.simulate_network(mixed, 1, sset, engine="stacked")
    with pytest.raises(ValueError, match="mixes TableGeometry and TrapezoidGeometry"):
        ens.batched_simulate_network(mixed, 1, sset, [dict(us=_scaled_upper(mixed, SCALES)), dict(), dict()])
    # n_ref is a static field: table branches whose n_ref differs do not stack
    other = [table[0], dataclasses.replace(table[1], geo=dataclasses.replace(table[1].geo, n_ref=0.035))]
    with pytest.raises(ValueError, match="n_ref"):
        net.simulate_network(other, 1, sset, engine="stacked")
    # a batch keeps each branch's geometry class
    with pytest.raises(ValueError, match="geometry class"):
        net.check_batch(mixed, [dict(), dict(geo=geo_b), dict()], sset)
