"""PyTorch port vs JAX package: the ensemble path on the CPU in float64.

Four members of a cut flagship (N=121, 7 levels: the plain engine takes ~8 ms
per Newton iteration here and the first levels take 10-20 iterations each) with per-member roughness,
per-member inflow (``batch_boundaries``), per-member rating pivot and
per-member lateral inflow go through ``flowsim_tpu.parallel.ensemble.
batched_simulate(engine="xla", shard=False)`` (the f64 vmapped scan — not the
Pallas kernel in interpret mode, whose double-single arithmetic is only ~1e-6
close) and through the port's ``batched_simulate`` with both engines; on CPU
tensors ``engine="fused"`` runs the plain version of the batched kernel.

Tolerances: identical iteration count per member and level,
max|dh| <= 1e-9 m, max|dQ| <= 1e-6 m^3/s.

Two JAX configurations are compiled here: the blended flagship with batched
boundaries and a ``[B, nt, N]`` lateral inflow (an inflow of zeros is the case
without one), and the gated flagship.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsim_tpu.models.gerd_roseires import model as jmodel
from flowsim_tpu.ops import boundary as jbnd
from flowsim_tpu.ops import rating_curve as jrc
from flowsim_tpu.parallel import ensemble as jens
from flowsim_tpu_torch import convert, trees
from flowsim_tpu_torch.models.gerd_roseires import model
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops.cuda import fused_batched, fused_newton
from flowsim_tpu_torch.parallel import ensemble as ens

from tests._torch_port import assert_close, to_port, tree_to_numpy

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s
LEVELS = 6     # 7 time levels
B = 4


def _members(seed=3):
    """The ensemble's per-member numbers, made with NumPy for both packages."""
    rng = np.random.default_rng(seed)
    return dict(n=rng.uniform(0.025, 0.045, B), scale=rng.uniform(0.8, 1.2, B),
                pivot=rng.uniform(-0.1, 0.1, B),
                qlat=rng.uniform(0.0, 2e-3, (B, LEVELS + 1, 121)))


def _jax_ensemble(js, jc, mem, ds_members):
    geob = jens.roughness_ensemble(jc.geometry, mem["n"])
    us_b, us_ax = jens.batch_boundaries([
        dataclasses.replace(js.us_params, target_series=js.us_params.target_series * f)
        for f in mem["scale"]])
    ds_b, ds_ax = jens.batch_boundaries(ds_members)
    return geob, us_b, us_ax, ds_b, ds_ax


def _port_ensemble(geob, us_b, ds_b, js):
    """The JAX-made batched trees, carried over through NumPy."""
    return (to_port("TrapezoidGeometry", geob), to_port("BoundaryParams", us_b),
            to_port("BoundaryParams", ds_b),
            *convert.from_numpy("state", dict(h0=np.asarray(js.h0), Q0=np.asarray(js.Q0)), device="cpu"))


def _same(a, b):
    """Bitwise equality that takes NaN (an unused slope or depth) as equal."""
    return a.shape == b.shape and torch.equal(torch.nan_to_num(a.double(), nan=-1.0),
                                              torch.nan_to_num(b.double(), nan=-1.0))


def _assert_matches(out, jout, what):
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist(), what
    assert bool(out.converged.all()), what
    assert out.depth.shape == np.asarray(jout.depth).shape, what
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= H_TOL, what
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)).max() <= Q_TOL, what
    assert out.gate_open.tolist() == np.asarray(jout.gate_open).tolist(), what


@pytest.fixture(scope="module")
def blended():
    """JAX and port ensembles of the smooth (blended_poly) flagship, and the
    JAX runs with zero and with random per-member lateral inflow."""
    mem = _members()
    js, jc = jmodel.build(sim_duration=3600 * LEVELS)
    jset = js.settings(1e-6, 100)
    ds_members = [dataclasses.replace(js.ds_params, rating=dataclasses.replace(
        js.ds_params.rating, pivot_stage=js.ds_params.rating.pivot_stage + dp)) for dp in mem["pivot"]]
    geob, us_b, us_ax, ds_b, ds_ax = _jax_ensemble(js, jc, mem, ds_members)

    def jrun(q):
        return jens.batched_simulate(geob, us_b, ds_b, js.h0, js.Q0, jset, shard=False,
                                     us_axes=us_ax, ds_axes=ds_ax, engine="xla",
                                     lateral_inflow=jnp.asarray(q))

    jout0, joutq = jrun(np.zeros_like(mem["qlat"])), jrun(mem["qlat"])
    s, _ = model.build(sim_duration=3600 * LEVELS, device="cpu")
    port = _port_ensemble(geob, us_b, ds_b, js)
    return mem, port, s.settings(1e-6, 100), jout0, joutq


@pytest.fixture(scope="module")
def port_runs(blended):
    """The port's runs without lateral inflow, one per engine."""
    mem, (geob, us_b, ds_b, h0, Q0), sset, *_ = blended
    return {engine: ens.batched_simulate(geob, us_b, ds_b, h0, Q0, sset, us_axes=0, ds_axes=0, engine=engine)
            for engine in ens.ENGINES}


@pytest.mark.parametrize("engine", ens.ENGINES)
def test_batched_simulate_matches_jax_vmap(blended, port_runs, engine):
    """Per-member roughness, inflow and rating pivot."""
    jout0, out = blended[3], port_runs[engine]
    _assert_matches(out, jout0, engine)
    assert out.iterations.shape == (B, LEVELS + 1) and out.error.shape == (B, LEVELS + 1)
    assert bool(torch.isnan(out.reservoir_stage).all())
    assert len({tuple(r) for r in out.iterations.tolist()}) > 1      # the members really differ


@pytest.mark.parametrize("engine", ens.ENGINES)
def test_per_member_lateral_inflow_matches_jax_vmap(blended, engine):
    mem, (geob, us_b, ds_b, h0, Q0), sset, jout0, joutq = blended
    out = ens.batched_simulate(geob, us_b, ds_b, h0, Q0, sset, us_axes=0, ds_axes=0, engine=engine,
                               lateral_inflow=mem["qlat"])
    _assert_matches(out, joutq, engine)
    assert np.abs(np.asarray(joutq.depth) - np.asarray(jout0.depth)).max() > 1e-3   # the inflow moved the state


def test_chunks_and_boundaries_store(blended, port_runs):
    """``chunk_size`` gives the result of one batch, and ``store="boundaries"``
    is columns 0 and N-1 of the full fields."""
    mem, (geob, us_b, ds_b, h0, Q0), sset, jout0, _ = blended
    kw = dict(us_axes=0, ds_axes=0, engine="fused")
    whole = port_runs["fused"]
    chunked = ens.batched_simulate(geob, us_b, ds_b, h0, Q0, dataclasses.replace(sset, store="boundaries"),
                                   chunk_size=2, **kw)
    assert chunked.depth.shape == (B, LEVELS + 1, 2)
    assert torch.equal(chunked.depth, whole.depth[:, :, [0, -1]])
    assert torch.equal(chunked.flow, whole.flow[:, :, [0, -1]])
    for name in ("iterations", "error", "converged", "gate_open"):
        assert torch.equal(getattr(chunked, name), getattr(whole, name)), name
    assert_close(chunked.depth, np.asarray(jout0.depth)[:, :, [0, -1]], rtol=1e-10)
    with pytest.raises(ValueError, match="divisible"):
        ens.batched_simulate(geob, us_b, ds_b, h0, Q0, sset, chunk_size=3, **kw)


def test_shared_and_per_member_constant_inflow_forms(small):
    """A shared ``[N]`` inflow and per-member constants ``[B, N]`` equal their
    ``[B, nt, N]`` broadcast (3 members, 4 levels)."""
    s, c, geob, sset = small
    rng = np.random.default_rng(5)
    q_const = torch.tensor(rng.uniform(0.0, 2e-3, (3, 121)))
    args = (geob, s.us_params, s.ds_params, s.h0, s.Q0, sset)
    by_member = ens.batched_simulate(*args, engine="fused", lateral_inflow=q_const)
    by_level = ens.batched_simulate(*args, engine="plain", chunk_size=1,
                                    lateral_inflow=q_const[:, None, :].expand(3, 4, 121))
    shared = ens.batched_simulate(*args, engine="fused", lateral_inflow=q_const[0])
    assert torch.equal(by_member.depth, by_level.depth)
    assert torch.equal(shared.depth[0], by_member.depth[0]) and not torch.equal(shared.depth[1], by_member.depth[1])


def test_gated_blend_members_carry_their_own_gate_state():
    """Per-member gate-controller state: pivots below and above the initial
    stage, so some members open their gates at the first level and some never
    do."""
    mem = _members()
    pivots = (-0.6, 0.3, -0.6, 0.0)
    js, jc = jmodel.build(sim_duration=3600 * LEVELS, smooth=False)
    rcj = jc.downstream_boundary.rating_curve
    low, high = rcj._quad_of_state(rcj.closed_state), rcj._quad_of_state(rcj.open_state)
    ds_members = [jbnd.make_boundary(
        "rating_curve", bed_level=js.ds_params.bed_level, initial_depth=js.ds_params.initial_depth,
        rating=jrc.make_gated_blend(low, high, rcj.initial_stage + dp)) for dp in pivots]
    geob, us_b, us_ax, ds_b, ds_ax = _jax_ensemble(js, jc, mem, ds_members)
    jout = jens.batched_simulate(geob, us_b, ds_b, js.h0, js.Q0, js.settings(1e-6, 100), shard=False,
                                 us_axes=us_ax, ds_axes=ds_ax, engine="xla")
    gates = np.asarray(jout.gate_open)
    assert gates[0, 1] == 1.0 and gates[1].max() == 0.0          # member 0 opens, member 1 never does
    s, _ = model.build(sim_duration=3600 * LEVELS, smooth=False, device="cpu")
    pgeob, pus, pds, h0, Q0 = _port_ensemble(geob, us_b, ds_b, js)
    assert pds.rating.kind == "gated_blend" and pds.rating.max_cooldown.shape == (B,)
    for engine in ens.ENGINES:
        out = ens.batched_simulate(pgeob, pus, pds, h0, Q0, s.settings(1e-6, 100), us_axes=0, ds_axes=0,
                                   engine=engine)
        _assert_matches(out, jout, engine)


@pytest.fixture(scope="module")
def small():
    """A 4-level, 3-member port ensemble for the argument checks."""
    s, c = model.build(sim_duration=3600 * 3, device="cpu")
    geob = ens.roughness_ensemble(c.geometry, [0.03, 0.035, 0.04])
    return s, c, geob, s.settings(1e-6, 100)


def test_lateral_inflow_ambiguity_and_shapes(small):
    s, c, geob, sset = small
    sset3 = dataclasses.replace(sset, n_time_levels=3)
    cut = lambda bc: dataclasses.replace(bc, target_series=bc.target_series[:3])
    args = (geob, cut(s.us_params), cut(s.ds_params), s.h0, s.Q0, sset3)      # B == nt == 3
    for engine in ens.ENGINES:
        with pytest.raises(ValueError, match="ambiguous"):
            ens.batched_simulate(*args, engine=engine, lateral_inflow=torch.zeros(3, 121))
    out = ens.batched_simulate(*args, engine="fused", lateral_inflow=torch.zeros(3, 3, 121))
    assert out.depth.shape == (3, 3, 121)
    with pytest.raises(fused_newton.FusedUnsupported, match="lateral_inflow"):
        ens.batched_simulate(*args, engine="fused", lateral_inflow=torch.zeros(2, 121))
    with pytest.raises(ValueError, match="ambiguous"):
        fused_batched.fused_simulate_batched_plain(*args, lateral_inflow=torch.zeros(3, 121))
    # a chunk of exactly nt members is not ambiguous: the whole batch is judged
    two = trees.slice_members(geob, 0, 2)
    ens.batched_simulate(two, *args[1:], engine="fused", chunk_size=1, lateral_inflow=torch.zeros(2, 121))


def test_mixed_kinds_sharding_and_engine_errors(small):
    s, c, geob, sset = small
    args = (geob, s.us_params, s.ds_params, s.h0, s.Q0, sset)
    with pytest.raises(ValueError, match="share the boundary kind"):
        ens.batch_boundaries([s.us_params, s.ds_params])
    poly = dataclasses.replace(s.ds_params, rating=dataclasses.replace(s.ds_params.rating, kind="polynomial"))
    with pytest.raises(ValueError, match="static field 'kind'"):
        ens.batch_boundaries([s.ds_params, poly])
    for kw in (dict(shard=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            ens.batched_simulate(*args, **kw)
    with pytest.raises(ValueError, match="engine"):
        ens.batched_simulate(*args, engine="xla")
    # outside the kernel's scope: FusedUnsupported reaches the caller
    with pytest.raises(fused_newton.FusedUnsupported, match="while-Newton"):
        ens.batched_simulate(geob, s.us_params, s.ds_params, s.h0, s.Q0,
                             dataclasses.replace(sset, newton="fixed"), engine="fused")
    with pytest.raises(fused_newton.FusedUnsupported, match="leading member axis"):
        fused_batched.fused_simulate_batched(c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, sset)
    with pytest.raises(ValueError, match="us_batched"):
        fused_batched.fused_simulate_batched(*args, us_batched=True)
    with pytest.raises(ValueError, match="h0 must be"):
        fused_batched.fused_simulate_batched(geob, s.us_params, s.ds_params, s.h0[:-1], s.Q0, sset)


def test_packing_carries_every_member_parameter(small):
    """The batched parameter block and geometry rows, row by row, are the
    single-run packing of each member; per-member initial states are used."""
    s, c, geob, sset = small
    scales = (0.9, 1.0, 1.1)
    us_b, _ = ens.batch_boundaries([dataclasses.replace(
        s.us_params, target_series=s.us_params.target_series * f) for f in scales])
    ds_b, _ = ens.batch_boundaries([dataclasses.replace(s.ds_params, rating=dataclasses.replace(
        s.ds_params.rating, pivot_stage=s.ds_params.rating.pivot_stage + dp, buffer=s.ds_params.rating.buffer + dp))
        for dp in (0.0, 0.1, 0.2)])
    par, rc_kind, us_rc_kind = fused_newton.pack_params(us_b, ds_b, sset, batch_shape=(3,))
    rows = fused_newton.pack_geometry(geob)
    assert par.shape == (3, 32) and rows.shape == (3, 13, 121) and (rc_kind, us_rc_kind) == (1, 0)
    for m in range(3):
        par_m, *_ = fused_newton.pack_params(trees.member(us_b, m), trees.member(ds_b, m), sset)
        assert _same(par[m], par_m)
        assert _same(rows[m], fused_newton.pack_geometry(trees.member(geob, m)))
    assert torch.equal(fused_newton.series(us_b, 4, "cpu", (3,)), us_b.target_series)
    assert fused_newton.series(s.ds_params, 4, "cpu", (3,)).shape == (3, 4)
    # a shared boundary packs to equal rows
    par_s, *_ = fused_newton.pack_params(s.us_params, ds_b, sset, batch_shape=(3,))
    assert torch.equal(par_s[:, 4:7].isnan(), par[:, 4:7].isnan()) and par_s.shape == (3, 32)
    h0b = torch.stack([s.h0, s.h0 * 1.01, s.h0 * 0.99])
    out = ens.batched_simulate(geob, s.us_params, s.ds_params, h0b, s.Q0, sset, engine="fused")
    one = prs.simulate(trees.member(geob, 1), s.us_params, s.ds_params, h0b[1], s.Q0, sset)
    assert torch.equal(out.depth[1], one.depth) and not torch.equal(out.depth[0], out.depth[1])


def test_output_memory_is_reckoned_before_anything_is_allocated():
    full = fused_newton.output_bytes(10240, 121, 385, "full")
    assert full == 10240 * 385 * (2 * 121 * 8 + 40) and 7.6e9 < full < 7.8e9
    assert fused_newton.output_bytes(10240, 121, 385, "boundaries") == 10240 * 385 * 72
    fused_newton.check_output_memory(10240, 121, 385, "full", free_bytes=80e9)
    with pytest.raises(MemoryError, match="chunk_size"):
        fused_newton.check_output_memory(10240, 121, 385, "full", free_bytes=4e9)


def test_convert_from_numpy_on_batched_trees(small):
    """A batched JAX-side tree, as NumPy, becomes the port's batched tree."""
    s, c, geob, sset = small
    js, jc = jmodel.build(sim_duration=3600 * 3)
    jgeo = jens.roughness_ensemble(jc.geometry, [0.03, 0.035, 0.04])
    pgeo = to_port("TrapezoidGeometry", jgeo)
    assert pgeo.z_bed.shape == (3, 121) and pgeo.compound.dtype == torch.bool and pgeo.n_nodes == 121
    for f in dataclasses.fields(geob):
        assert_close(getattr(pgeo, f.name), getattr(geob, f.name), what=f.name)
    tree = tree_to_numpy(jens.batch_boundaries([js.ds_params] * 2)[0])
    pds = convert.from_numpy("BoundaryParams", tree, device="cpu")
    assert pds.bed_level.shape == (2,) and pds.rating.coeffs.shape == (2, 3) and pds.rating.kind == "blended_poly"
    assert_close(trees.member(pds, 1).rating.coeffs, s.ds_params.rating.coeffs)
    h0, Q0 = convert.from_numpy("state", dict(h0=np.ones((3, 121)), Q0=np.ones((3, 121))), device="cpu")
    assert h0.shape == (3, 121) and h0.dtype == torch.float64
    stacked = ens.stack_geometries([trees.member(geob, m) for m in range(3)])
    assert all(_same(getattr(stacked, f.name), getattr(geob, f.name)) for f in dataclasses.fields(geob))
