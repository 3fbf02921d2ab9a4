"""PyTorch port vs JAX package: irregular (lookup-table) sections on the CPU
in float64.

* ``build_table_geometry`` from surveyed polylines alone, from a mixed
  trapezoid / polyline list, and through ``api.Channel`` with planform
  coordinates (curvature stamped onto copies of the stations): rtol 1e-12;
* table ``section_state`` / ``energy_slope`` at depths below the bed, inside
  the table, on its grid points and beyond its span: rtol 1e-12;
* ``table_roughness_ensemble`` and its two refusals: rtol 1e-12;
* a short simulation through ``api.Channel`` (N = 11, M = 1024 — the api's
  own sampling —, 13 levels): JAX ``ops.preissmann.simulate`` against the
  port's plain engine, identical iteration counts at every level,
  max|dh| <= 1e-9 m and max|dQ| <= 1e-6 m^3/s;
* the fused wrappers, which run their plain versions on CPU tensors, against
  the plain engine for one run and a 4-member ensemble: identical counts;
* the batched wrapper's refusal of members whose A, P, T or dR/dA differ.

The simulation's reach is kept at 11 nodes because the api rasterizes 1024
depth samples a node on the host (about 0.5 ms a sample in each package).
One JAX simulation is compiled, in a module-scoped fixture.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsim_tpu import api as japi
from flowsim_tpu import geometry as jgeom
from flowsim_tpu import geometry_tables as jgt
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu.ops import sections as jsec
from flowsim_tpu.parallel import ensemble as jens
from flowsim_tpu_torch import api, geometry_tables as gt, trees
from flowsim_tpu_torch.geometry import TableGeometry, TrapezoidStation
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops import sections as sec
from flowsim_tpu_torch.ops.cuda import fused_batched, fused_newton
from flowsim_tpu_torch.parallel import ensemble as ens

from tests._torch_port import (  # noqa: F401 (without_autograd is an autouse fixture)
    assert_close, to_port, without_autograd)

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s
SLOPE = 2e-4
TABLE_FIELDS = ("z_bed", "depth_max", "area", "perimeter", "top_width", "conveyance", "n_eq", "dK_dA", "dR_dA",
                "bed_slope", "curvature")


def _polyline(seed, z0):
    """A surveyed section of 21 points, 220 m wide, ~8 m deep, made with
    NumPy from a seed (the reach of scripts/validate_fused_hw.py)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 220.0, 21)
    return x, z0 + 8.0 * ((x - 110.0) / 110.0) ** 2 + rng.uniform(0.0, 0.5, x.size)


def _irregular(mod, length):
    (x1, z1), (x2, z2) = _polyline(1, SLOPE * length), _polyline(2, 0.0)
    return [mod.IrregularStation(x=x1, z=z1, n_main=0.03, bed_slope=SLOPE),
            mod.IrregularStation(x=x2, z=z2, n_main=0.03, bed_slope=SLOPE)]


def _mixed(irr_mod, trap_cls, length):
    """Trapezoid, polyline, trapezoid (tests/test_mixed_interpolation.py's
    mixed reach)."""
    x, z = _polyline(3, 0.0)
    z_us = 481.0 + length * SLOPE
    return [trap_cls(z_bed=z_us, b_main=80.0, m_main=2.5, n_main=0.03, bed_slope=SLOPE),
            irr_mod.IrregularStation(x=x, z=z - z.min() + 481.0 + 0.5 * length * SLOPE, n_main=0.035,
                                     bed_slope=SLOPE),
            trap_cls(z_bed=481.0, b_main=90.0, m_main=2.0, n_main=0.03, bed_slope=SLOPE, h_bank=3.0,
                     b_fp_left=40.0, b_fp_right=30.0, m_fp=4.0, n_left=0.05, n_right=0.045)]


def _assert_geometry(port, ref):
    assert port.n_ref == ref.n_ref
    for f in TABLE_FIELDS:
        assert_close(getattr(port, f), getattr(ref, f), what=f)


@pytest.fixture(scope="module")
def tables():
    """The polyline-only reach at 21 nodes and 64 samples, in both packages."""
    length, nodes = 40000.0, np.linspace(0.0, 40000.0, 21)
    jg = jgt.build_table_geometry(_irregular(jgt, length), [0.0, length], nodes, samples=64)
    pg = gt.build_table_geometry(_irregular(gt, length), [0.0, length], nodes, samples=64, device="cpu")
    return jg, pg


def _channel(mod, stations, chainages, length, coords=None):
    us = mod.Boundary(condition="flow_hydrograph", chainage=0.0,
                      hydrograph=mod.Hydrograph(function=lambda t: 400.0 + 600.0 * min(t / (4 * 3600.0), 1.0)))
    ds = mod.Boundary(condition="normal_depth", chainage=length)
    ch = mod.Channel(us, ds, initial_flow=400.0, interpolation_method="steady-state")
    ch.set_cross_sections(chainages, stations)
    if coords is not None:
        ch.set_coords(coords, np.linspace(0.0, length, coords.shape[0]))
    return ch


@pytest.mark.parametrize("case", ["irregular", "mixed", "planform"])
def test_build_table_geometry_matches_jax(tables, case):
    if case == "irregular":
        jg, pg = tables
    elif case == "mixed":
        length, nodes = 6000.0, np.linspace(0.0, 6000.0, 21)
        ch = [0.0, 0.5 * length, length]
        jg = jgt.build_table_geometry(_mixed(jgt, jgeom.TrapezoidStation, length), ch, nodes, samples=64)
        pg = gt.build_table_geometry(_mixed(gt, TrapezoidStation, length), ch, nodes, samples=64, device="cpu")
    else:
        # four stations, two of them interior (they take the planform
        # curvature): nodes 0-2 between trapezoids, 3-5 beside the polyline
        length = 6000.0
        t = np.linspace(0.0, 1.0, 25)
        coords = np.column_stack([6000.0 * t, 800.0 * np.sin(2.0 * np.pi * t)])
        ch = [0.0, 2000.0, 4000.0, length]

        def stations(irr_mod, trap_cls):
            first, irr, last = _mixed(irr_mod, trap_cls, length)
            mid = dataclasses.replace(first, z_bed=first.z_bed - 2000.0 * SLOPE)
            return [first, mid, irr, last]

        jst, pst = stations(jgt, jgeom.TrapezoidStation), stations(gt, TrapezoidStation)
        jc = _channel(japi, jst, ch, length, coords)
        pc = _channel(api, pst, ch, length, coords)
        jg, pg = jc.build_geometry(7), pc.build_geometry(7, device="cpu")
        assert float(np.abs(np.asarray(jg.curvature)).max()) > 0.0
        # the caller's stations keep their curvature: the channel stamped copies
        assert all(s.curvature == 0.0 for s in pst)
        assert isinstance(pg, TableGeometry)
    _assert_geometry(pg, jg)
    assert_close(to_port("TableGeometry", jg).area, jg.area, what="convert")


def test_section_state_and_energy_slope_match_jax(tables):
    jg, pg = tables
    dgrid = np.asarray(jg.depth_max) / 63.0
    rng = np.random.default_rng(11)
    # a planform curvature at every other node, so that Sc and its derivatives count
    curv = np.where(np.arange(dgrid.size) % 2 == 1, rng.uniform(-2e-3, 2e-3, dgrid.size), 0.0)
    jg = dataclasses.replace(jg, curvature=jnp.asarray(curv))
    pg = dataclasses.replace(pg, curvature=torch.tensor(curv))
    depths = np.stack([
        -rng.uniform(0.01, 1.0, dgrid.size),                   # below the bed: first interval, dry
        rng.uniform(0.0, 1.0, dgrid.size) * 63.0 * dgrid,      # inside the table
        rng.integers(0, 64, dgrid.size) * dgrid,               # exactly on grid points
        (1.0 + rng.uniform(0.0, 0.5, dgrid.size)) * 63.0 * dgrid,  # beyond the span: extrapolated
    ])
    Q = rng.uniform(-50.0, 900.0, depths.shape)
    for d, q in zip(depths, Q):
        js, ps = jsec.section_state(jg, jnp.asarray(d)), sec.section_state(pg, torch.tensor(d))
        for f in js._fields:
            assert_close(getattr(ps, f), getattr(js, f), what=f)
        je = jsec.energy_slope(jg, jnp.asarray(d), jnp.asarray(q))
        pe = sec.energy_slope(pg, torch.tensor(d), torch.tensor(q))
        for f in je._fields:
            assert_close(getattr(pe, f), getattr(je, f), what=f)
        assert_close(sec.normal_flow(pg, torch.tensor(d)), jsec.normal_flow(jg, jnp.asarray(d)), what="normal_flow")
    # one node at a time, as the api's accessors and the GVF march evaluate it
    node = pg.node(4)
    s4 = sec.section_state(node, torch.tensor(depths[1, 4], dtype=torch.float64))
    assert_close(s4.A, sec.section_state(pg, torch.tensor(depths[1])).A[4], what="node")
    # a NaN depth reads bracket 0 and stays NaN; no index leaves the table
    nan = sec.section_state(pg, torch.full((21,), float("nan"), dtype=torch.float64))
    assert bool(torch.isnan(nan.n_eq).all()) and float(nan.A.abs().max()) == 0.0


@pytest.mark.parametrize("case", ["parity", "n_base_mismatch", "no_n_ref"])
def test_table_roughness_ensemble(tables, case):
    jg, pg = tables
    n_values = np.linspace(0.025, 0.04, 4)
    if case == "parity":
        jb, pb = jens.table_roughness_ensemble(jg, n_values), ens.table_roughness_ensemble(pg, n_values)
        assert pb.n_ref is None and jb.n_ref is None
        for f in TABLE_FIELDS:
            assert_close(getattr(pb, f), getattr(jb, f), what=f)
        assert pb.area.stride(0) == 0   # geometry-only tables are shared views
        with pytest.raises(ValueError, match="n_base"):
            ens.table_roughness_ensemble(pb, n_values)          # the batch has no anchor left
    elif case == "n_base_mismatch":
        with pytest.raises(ValueError, match="does not match"):
            ens.table_roughness_ensemble(pg, n_values, n_base=0.035)
        with pytest.raises(ValueError, match="does not match"):
            jens.table_roughness_ensemble(jg, n_values, n_base=0.035)
    else:
        bare = dataclasses.replace(pg, n_ref=None)
        with pytest.raises(ValueError, match="pass n_base"):
            ens.table_roughness_ensemble(bare, n_values)
        assert_close(ens.table_roughness_ensemble(bare, n_values, n_base=0.03).conveyance,
                     jens.table_roughness_ensemble(jg, n_values).conveyance, what="explicit n_base")


LEVELS = 13


@pytest.fixture(scope="module")
def reach():
    """The validation reach cut to 10 km and 11 nodes, 13 levels of 1800 s,
    through each package's api; the JAX run compiled once."""
    length = 10000.0

    def solver(mod, **kw):
        ch = _channel(mod, _irregular(gt if mod is api else jgt, length), [0.0, length], length)
        return mod.PreissmannSolver(channel=ch, theta=0.7, time_step=1800.0, spatial_step=1000.0,
                                    simulation_time=1800.0 * (LEVELS - 1), **kw)

    js, ps = solver(japi), solver(api, device="cpu")
    jout = jprs.simulate(js.channel.geometry, js.us_params, js.ds_params, js.h0, js.Q0, js.settings(1e-8, 100))
    return js, ps, jout


def _assert_run(out, ref, what):
    assert out.iterations.tolist() == np.asarray(ref.iterations).tolist(), what
    assert float(np.abs(np.asarray(out.depth) - np.asarray(ref.depth)).max()) <= H_TOL, what
    assert float(np.abs(np.asarray(out.flow) - np.asarray(ref.flow)).max()) <= Q_TOL, what


def test_simulation_through_channel_matches_jax(reach):
    js, ps, jout = reach
    assert isinstance(ps.channel.geometry, TableGeometry) and ps.channel.geometry.area.shape == (11, 1024)
    assert_close(ps.h0, js.h0, what="steady-state h0")
    out = ps.run(engine="plain", tolerance=1e-8, verbose=0)
    _assert_run(out, jout, "plain engine")
    assert bool(np.asarray(jout.converged).all()) and int(np.asarray(jout.iterations).sum()) > 2 * LEVELS


def test_fused_wrappers_run_their_plain_versions_on_cpu(reach):
    js, ps, jout = reach
    args = (ps.channel.geometry, ps.us_params, ps.ds_params, ps.h0, ps.Q0, ps.settings(1e-8, 100))
    before, before_b = fused_newton.launch_count, fused_batched.launch_count
    _assert_run(fused_newton.fused_simulate(*args), jout, "fused_simulate")
    # a 4-member roughness ensemble, one member of it the single run's n
    geob = ens.table_roughness_ensemble(ps.channel.geometry, [0.027, 0.03, 0.033, 0.036])
    out_b = ens.batched_simulate(geob, *args[1:], engine="fused")
    for m in range(4):
        ref = prs.simulate(trees.member(geob, m), *args[1:])
        assert out_b.iterations[m].tolist() == ref.iterations.tolist(), m
        assert torch.equal(out_b.depth[m], ref.depth) and torch.equal(out_b.flow[m], ref.flow), m
    assert out_b.iterations[1].tolist() == np.asarray(jout.iterations).tolist()
    assert fused_newton.launch_count == before and fused_batched.launch_count == before_b


@pytest.mark.parametrize("table", ["area", "perimeter", "top_width", "dR_dA"])
def test_batched_members_must_share_the_geometry_tables(tables, table):
    _, pg = tables
    geob = ens.table_roughness_ensemble(pg, [0.03, 0.035])
    fused_newton.check_shared_tables(geob)
    t = getattr(geob, table).clone()
    t[1, 3, 5] *= 1.0 + 1e-9
    bad = dataclasses.replace(geob, **{table: t})
    with pytest.raises(fused_newton.FusedUnsupported, match=table):
        fused_newton.check_shared_tables(bad)
    h0 = torch.ones(pg.n_nodes, dtype=torch.float64)
    bc = api.Boundary(condition="fixed_depth", chainage=0.0, bed_level=0.0, initial_depth=1.0).build(
        np.arange(3) * 60.0, 0.0, SLOPE, device="cpu")
    sset = prs.PreissmannSettings(theta=0.7, time_step=60.0, spatial_step=2000.0, n_time_levels=3,
                                  tolerance=1e-8, max_iter=10)
    with pytest.raises(fused_newton.FusedUnsupported, match=table):
        fused_batched.fused_simulate_batched(bad, bc, bc, h0, h0, sset)   # refused before the plain run
