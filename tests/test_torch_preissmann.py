"""PyTorch port vs JAX package: the Preissmann assembly, one level, and a
24-level run of the flagship with both inner solvers; float64 on the CPU."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flowsim_tpu import api as japi
from flowsim_tpu.models.gerd_roseires import model as jmodel
from flowsim_tpu.ops import boundary as jbnd
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu_torch import api
from flowsim_tpu_torch.models.gerd_roseires import model
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import preissmann as prs

from tests._torch_port import assert_close, without_autograd  # noqa: F401 (without_autograd is an autouse fixture)

torch.set_num_threads(1)

LEVELS = 24


@pytest.fixture(scope="module")
def pair():
    js, jc = jmodel.build(sim_duration=3600 * LEVELS)
    s, c = model.build(sim_duration=3600 * LEVELS, device="cpu")
    return js, jc, s, c


def _perturbed(js, seed):
    """A perturbed flagship state (NumPy, shared by both sides)."""
    rng = np.random.default_rng(seed)
    h0, Q0 = np.asarray(js.h0), np.asarray(js.Q0)
    return (h0 * (1.0 + 0.05 * rng.uniform(-1, 1, h0.shape)), Q0 * (1.0 + 0.2 * rng.uniform(-1, 1, Q0.shape)),
            h0 * (1.0 + 0.02 * rng.uniform(-1, 1, h0.shape)), Q0 * (1.0 + 0.1 * rng.uniform(-1, 1, Q0.shape)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prev_level_state_and_assemble(pair, seed):
    js, jc, s, c = pair
    h, Q, hp, Qp = _perturbed(js, seed)
    k = 3 + seed
    jset, pset = js.settings(1e-6, 100), s.settings(1e-6, 100)
    jprev = jprs.prev_level_state(jc.geometry, jnp.asarray(hp), jnp.asarray(Qp))
    prev = prs.prev_level_state(c.geometry, torch.tensor(hp), torch.tensor(Qp))
    for name in jprev._fields:
        assert_close(getattr(prev, name), getattr(jprev, name), what=name)
    jL, jD, jU, jb, jerr, _, _ = jprs.assemble(
        jc.geometry, js.us_params, js.ds_params, jset, jprev, jnp.asarray(h), jnp.asarray(Q), k,
        jnp.asarray(np.nan), jbnd.initial_bc_state(jnp.float64))
    L, D, U, b, err, *_ = prs.assemble(
        c.geometry, s.us_params, s.ds_params, pset, prev, torch.tensor(h), torch.tensor(Q), k,
        bnd.initial_bc_state(torch.float64, "cpu"))
    for got, want, what in ((L, jL, "L"), (D, jD, "D"), (U, jU, "U"), (b, jb, "b")):
        assert_close(got, want, what=what)
    assert_close(err, jerr, what="err")
    # structural zeros of the packing
    assert float(L[:, 1].abs().max()) == 0.0 and float(U[:, 0].abs().max()) == 0.0
    assert float(L[0].abs().max()) == 0.0 and float(U[-1].abs().max()) == 0.0


@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_single_step(pair, solver):
    js, jc, s, c = pair
    jset = dataclasses.replace(js.settings(1e-6, 100), linear_solver=solver)
    pset = dataclasses.replace(s.settings(1e-6, 100), linear_solver=solver)
    jh, jQ, jerr, jit, jstate = jprs.single_step(
        jc.geometry, js.us_params, js.ds_params, js.h0, js.Q0, 1, jnp.nan, jset)
    h, Q, err, it, state = prs.single_step(c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, 1, pset)
    assert it == int(jit)
    assert_close(h, jh, rtol=1e-10)
    assert_close(Q, jQ, rtol=1e-10)
    assert_close(state.gate_stage, jstate.gate_stage, rtol=1e-10)
    assert float(err) < 1e-6


@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_simulate_24_levels(pair, solver):
    js, jc, s, c = pair
    jset = dataclasses.replace(js.settings(1e-6, 100), linear_solver=solver)
    pset = dataclasses.replace(s.settings(1e-6, 100), linear_solver=solver)
    jout = jprs.simulate(jc.geometry, js.us_params, js.ds_params, js.h0, js.Q0, jset)
    out = prs.simulate(c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, pset)
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist()
    assert bool(out.converged.all()) and out.depth.shape == (LEVELS + 1, 121)
    dh = np.abs(out.depth.numpy() - np.asarray(jout.depth)).max()
    dq = np.abs((out.flow.numpy() - np.asarray(jout.flow)) / np.asarray(jout.flow)).max()
    assert dh <= 1e-9 and dq <= 1e-9, (dh, dq)
    assert_close(out.error, jout.error, rtol=1e-4)  # a norm of ~1e-7 residues of cancelling terms
    assert np.isnan(out.reservoir_stage.numpy()).all()
    assert out.gate_open.tolist() == np.asarray(jout.gate_open).tolist()


@pytest.mark.parametrize("name", chip_smoke.BOUNDARY_CASES)
def test_boundary_kinds_through_the_fused_entry_point(name):
    """The boundary kinds the flagship does not use, on a prismatic
    rectangular reach (simple sections, steady-state initial conditions):
    the port's fused entry point on CPU tensors vs the JAX scan.  The same
    cases run against the CUDA kernel in chip_smoke.py."""
    js = chip_smoke.build_boundary_case(japi, name)
    s = chip_smoke.build_boundary_case(api, name, device="cpu")
    jout = jprs.simulate(js.channel.geometry, js.us_params, js.ds_params, js.h0, js.Q0,
                         js.settings(1e-8, 100))
    out = s.run(engine="fused", tolerance=1e-8, verbose=0)
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist()
    assert int(out.iterations.sum()) > 12 and bool(out.converged.all())
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= 1e-9
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)).max() <= 1e-9 * 1e3
    assert float(out.depth.max() - out.depth.min()) > 0.1   # the forcing moved the state


def test_settings_and_shape_checks(pair):
    js, jc, s, c = pair
    pset = s.settings(1e-6, 100)
    args = (c.geometry, s.us_params, s.ds_params, s.h0, s.Q0)
    for bad in (dict(newton="fixed"), dict(newton="implicit")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prs.simulate(*args, dataclasses.replace(pset, **bad))
    with pytest.raises(ValueError, match="store"):
        prs.simulate(*args, dataclasses.replace(pset, store="ends"))
    with pytest.raises(ValueError, match="linear_solver"):
        prs.simulate(*args, dataclasses.replace(pset, linear_solver="pallas_pcr"))
    with pytest.raises(ValueError, match="n_time_levels"):
        prs.simulate(*args, dataclasses.replace(pset, n_time_levels=LEVELS + 5))
    with pytest.raises(ValueError, match="h0/Q0"):
        prs.simulate(c.geometry, s.us_params, s.ds_params, s.h0[:-1], s.Q0[:-1], pset)
    assert not hasattr(pset, "out_memory") and not hasattr(pset, "fused_unroll")


def test_f32_floor_guard_matches_jax():
    """The port's guard_f32_floor against the JAX one: the same warning and
    the same switched settings below tol 1e-6, pass-through at 1e-6."""
    for tol in (1e-8, 1e-7):
        jset = jprs.PreissmannSettings(0.6, 3600.0, 1000.0, 4, tol, 30, linear_solver="pcr_f32")
        pset = prs.PreissmannSettings(0.6, 3600.0, 1000.0, 4, tol, 30, linear_solver="pcr_f32")
        with pytest.warns(UserWarning) as jw:
            jout = jprs.guard_f32_floor(jset)
        with pytest.warns(UserWarning) as pw:
            out = prs.guard_f32_floor(pset)
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
        assert dataclasses.asdict(out) == {k: v for k, v in dataclasses.asdict(jout).items()
                                           if k in dataclasses.asdict(out)}
        assert out.linear_solver == jout.linear_solver == "pcr"
    for solver, tol in (("pcr_f32", 1e-6), ("pcr", 1e-8)):
        pset = prs.PreissmannSettings(0.6, 3600.0, 1000.0, 4, tol, 30, linear_solver=solver)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert prs.guard_f32_floor(pset) is pset


def test_simulate_switches_pcr_f32_below_the_floor(pair):
    """A 3-level flagship run with "pcr_f32" at tol 1e-8 warns and is the
    "pcr" run, bit for bit."""
    js, jc, s, c = pair
    us = dataclasses.replace(s.us_params, target_series=s.us_params.target_series[:4])
    pset = dataclasses.replace(s.settings(1e-8, 100), n_time_levels=4)
    args = (c.geometry, us, s.ds_params, s.h0, s.Q0)
    with pytest.warns(UserWarning, match="pcr_f32"):
        out = prs.simulate(*args, dataclasses.replace(pset, linear_solver="pcr_f32"))
    ref = prs.simulate(*args, dataclasses.replace(pset, linear_solver="pcr"))
    assert out.iterations.tolist() == ref.iterations.tolist() and int(out.iterations.sum()) > 3
    for field in ("depth", "flow", "error"):
        assert torch.equal(getattr(out, field), getattr(ref, field)), field


def test_not_ported_messages_name_their_queue_items(pair):
    js, jc, s, c = pair
    args = (c.geometry, s.us_params, s.ds_params, s.h0, s.Q0)
    for newton in ("fixed", "implicit"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            prs.simulate(*args, dataclasses.replace(s.settings(1e-6, 100), newton=newton))

    # irregular sections are ported (TableGeometry); what is not a geometry
    # or a station of the port is refused by name
    class TableGeometry:  # not the port's TableGeometry
        n_nodes = 3

    from flowsim_tpu_torch.ops import sections as sec
    with pytest.raises(TypeError, match="unknown geometry class 'TableGeometry'"):
        sec.section_state(TableGeometry(), torch.ones(3, dtype=torch.float64))

    class IrregularStation:  # not the port's IrregularStation
        pass

    flow = api.Hydrograph(function=lambda t: 100.0)
    channel = api.Channel(api.Boundary(condition="flow_hydrograph", hydrograph=flow, chainage=0.0, bed_level=1.0),
                          api.Boundary(condition="normal_depth", chainage=2000.0, bed_level=0.0),
                          initial_flow=100.0)
    channel.set_cross_sections([0.0, 2000.0], [IrregularStation(), IrregularStation()])
    with pytest.raises(TypeError, match="unknown station class 'IrregularStation'"):
        channel.build_geometry(3, device="cpu")
