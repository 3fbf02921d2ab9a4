"""PyTorch port vs JAX package: lateral inflow and ``store="boundaries"``.

The cut flagship (N=121, 13 levels) with a lateral inflow per node ``[N]`` and
per level and node ``[nt, N]`` (NumPy, seeded) goes through
``flowsim_tpu.ops.preissmann.simulate`` and through the port's plain engine,
its fused entry point (on CPU tensors: the kernel's plain version) and
``PreissmannSolver.run``; float64 on the CPU.

Tolerances: identical iteration count per level, max|dh| <= 1e-9 m,
max|dQ| <= 1e-6 m^3/s.

One JAX configuration is compiled: the full-field run with an ``[nt, N]``
inflow.  A per-node inflow is given to it broadcast to ``[nt, N]`` (what it
does itself with an ``[N]`` argument), and ``store="boundaries"`` is held
against columns 0 and N-1 of its fields.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsim_tpu.models.gerd_roseires import model as jmodel
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu_torch.models.gerd_roseires import model
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops.cuda import fused_newton

from tests._torch_port import assert_close, without_autograd  # noqa: F401 (without_autograd is an autouse fixture)

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s
LEVELS = 12
NT, N = LEVELS + 1, 121


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    q_node = rng.uniform(0.0, 2e-3, N)
    q_level = rng.uniform(0.0, 2e-3, (NT, N))
    js, jc = jmodel.build(sim_duration=3600 * LEVELS)
    jargs = (jc.geometry, js.us_params, js.ds_params, js.h0, js.Q0, js.settings(1e-6, 100))
    jouts = {name: jprs.simulate(*jargs, lateral_inflow=jnp.asarray(q))
             for name, q in (("node", np.broadcast_to(q_node, (NT, N))), ("level", q_level),
                             ("none", np.zeros((NT, N))))}
    s, c = model.build(sim_duration=3600 * LEVELS, device="cpu")
    args = (c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, s.settings(1e-6, 100))
    return dict(node=q_node, level=q_level), jouts, s, args


def _assert_matches(out, jout, cols=slice(None)):
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist()
    assert bool(out.converged.all())
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)[:, cols]).max() <= H_TOL
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)[:, cols]).max() <= Q_TOL


@pytest.mark.parametrize("form", ["node", "level"])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_plain_engine_with_lateral_inflow(case, form, solver):
    q, jouts, s, args = case
    sset = dataclasses.replace(args[5], linear_solver=solver)
    out = prs.simulate(*args[:5], sset, lateral_inflow=q[form])
    _assert_matches(out, jouts[form])
    moved = np.abs(np.asarray(jouts[form].depth) - np.asarray(jouts["none"].depth)).max()
    assert moved > 1e-3, moved                      # the inflow raised the water


@pytest.mark.parametrize("form", ["node", "level"])
def test_fused_entry_point_with_lateral_inflow(case, form):
    q, jouts, s, args = case
    _assert_matches(fused_newton.fused_simulate(*args, lateral_inflow=torch.tensor(q[form])), jouts[form])


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_store_boundaries(case, engine):
    """depth/flow of shape [nt, 2]: nodes 0 and N-1 of the full run."""
    q, jouts, s, args = case
    sset = dataclasses.replace(args[5], store="boundaries")
    run = prs.simulate if engine == "plain" else fused_newton.fused_simulate
    out = run(*args[:5], sset, lateral_inflow=q["level"])
    assert out.depth.shape == (NT, 2) and out.flow.shape == (NT, 2)
    _assert_matches(out, jouts["level"], cols=[0, -1])
    out0 = run(*args[:5], sset)
    _assert_matches(out0, jouts["none"], cols=[0, -1])
    assert_close(out0.error, jouts["none"].error, rtol=1e-4)


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_solver_run_takes_scalar_node_and_level_forms(engine):
    """``PreissmannSolver.run(lateral_inflow=...)``: a scalar is a uniform
    per-node inflow; 3 levels."""
    s, c = model.build(sim_duration=3600 * 2, device="cpu")
    kw = dict(engine=engine, tolerance=1e-6, verbose=0)
    scalar = s.run(lateral_inflow=1e-3, **kw)
    node = s.run(lateral_inflow=np.full(N, 1e-3), **kw)
    level = s.run(lateral_inflow=np.full((3, N), 1e-3), **kw)
    none = s.run(**kw)
    assert torch.equal(scalar.depth, node.depth) and torch.equal(node.depth, level.depth)
    assert float((scalar.depth - none.depth).abs().max()) > 1e-4
    assert s.depth.shape == (3, N)


def test_single_step_and_cell_stencil_take_the_inflow(case):
    q, jouts, s, args = case
    geo, us, ds, h0, Q0, sset = args
    qc, qp = torch.tensor(q["level"][1]), torch.tensor(q["level"][0])
    h, Q, err, it, _ = prs.single_step(geo, us, ds, h0, Q0, 1, sset, qlat_cur=qc, qlat_prev=qp)
    assert it == int(np.asarray(jouts["level"].iterations)[1])
    assert_close(h, np.asarray(jouts["level"].depth)[1], rtol=1e-10)
    # the source enters continuity as the theta-weighted cell average, only
    prev = prs.prev_level_state(geo, h0, Q0)
    _, _, _, b0, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0, 1, None)
    _, _, _, b1, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0, 1, None, qlat_cur=qc, qlat_prev=qp)
    th = sset.theta
    cavg = 0.5 * th * (qc[1:] + qc[:-1]) + 0.5 * (1.0 - th) * (qp[1:] + qp[:-1])
    assert_close(b1[:-1, 1] - b0[:-1, 1], cavg, rtol=1e-9)
    assert torch.equal(b1[:, 0], b0[:, 0]) and torch.equal(b1[-1], b0[-1])


def test_lateral_inflow_shape_checks(case):
    q, jouts, s, args = case
    for engine in (prs.simulate, fused_newton.fused_simulate):
        with pytest.raises(ValueError, match="n_nodes"):
            engine(*args, lateral_inflow=torch.zeros(N - 1))
        with pytest.raises(ValueError, match=r"\[N\] or \[nt=13, N\]"):
            engine(*args, lateral_inflow=torch.zeros(NT + 1, N))
        with pytest.raises(ValueError, match=r"\[N\] or \[nt=13, N\]"):
            engine(*args, lateral_inflow=torch.zeros(2, NT, N))
