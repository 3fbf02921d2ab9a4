"""PyTorch port vs JAX package: the sweep half of ``models/calibrate``.

``rmse_sweep`` over 4 roughness candidates of a cut flagship (N=121, 7 levels)
with both engines of the port (on CPU tensors ``engine="fused"`` runs the
plain version of the batched kernel), with and without per-candidate GVF
initial states, against ``flowsim_tpu.models.calibrate.rmse_sweep(
engine="xla")``; float64 on the CPU.

Tolerances: RMSE rtol 1e-9; interpolation rtol 1e-12.

Two JAX configurations are compiled: the vmapped objective without and with
``gvf_ic_fn``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsim_tpu.models import calibrate as jcal
from flowsim_tpu.models.gerd_roseires import model as jmodel
from flowsim_tpu_torch.models import calibrate as cal
from flowsim_tpu_torch.models.gerd_roseires import model
from flowsim_tpu_torch.ops import preissmann as prs
from flowsim_tpu_torch.ops.cuda.fused_newton import FusedUnsupported

from tests._torch_port import assert_close

torch.set_num_threads(1)

RMSE_RTOL = 1e-9
LEVELS = 6
N_VALUES = np.array([0.026, 0.030, 0.034, 0.041])


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(23)
    js, jc = jmodel.build(sim_duration=3600 * LEVELS)
    s, c = model.build(sim_duration=3600 * LEVELS, device="cpu")
    ts = np.asarray(js.us_params.target_series)
    # targets inside the simulated upstream flows, and one beyond each end
    Q_targets = np.concatenate([[ts.min() - 50.0], np.sort(rng.uniform(ts.min(), ts.max(), 5)), [ts.max() + 50.0]])
    H_targets = float(jc.geometry.z_bed[0]) + float(js.h0[0]) + rng.uniform(-0.2, 0.6, Q_targets.shape)
    jargs = (jc.geometry, js.us_params, js.ds_params, js.h0, js.Q0, js.settings(1e-6, 100))
    args = (c.geometry, s.us_params, s.ds_params, s.h0, s.Q0, s.settings(1e-6, 100))
    gvf = dict(dx=s.spatial_step, Q_init=c.initial_flow_rate, h_downstream=c.downstream_boundary.initial_depth)
    return jargs, args, Q_targets, H_targets, gvf


@pytest.fixture(scope="module")
def jax_sweeps(case):
    jargs, _, Q_targets, H_targets, gvf = case
    return {with_ic: np.asarray(jcal.rmse_sweep(
        *jargs, Q_targets, H_targets, N_VALUES, engine="xla",
        ic_fn=jcal.gvf_ic_fn(**gvf) if with_ic else None)) for with_ic in (False, True)}


@pytest.mark.parametrize("with_ic", [False, True], ids=["shared_ic", "gvf_ic"])
@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_rmse_sweep_matches_jax(case, jax_sweeps, engine, with_ic):
    _, args, Q_targets, H_targets, gvf = case
    rmse = cal.rmse_sweep(*args, Q_targets, H_targets, N_VALUES, engine=engine,
                          ic_fn=cal.gvf_ic_fn(**gvf) if with_ic else None)
    assert rmse.shape == (4,) and rmse.dtype == torch.float64
    np.testing.assert_allclose(rmse.numpy(), jax_sweeps[with_ic], rtol=RMSE_RTOL)
    assert len(set(rmse.tolist())) == 4                       # the candidates differ
    assert np.abs(jax_sweeps[True] - jax_sweeps[False]).max() > 1e-6   # and so do the initial states


def test_upstream_stage_at_matches_jnp_interp(case):
    """Inside the table, at its knots, beyond both ends, on a repeated
    abscissa, and over a leading member axis."""
    rng = np.random.default_rng(5)
    flow0 = np.array([100.0, 150.0, 150.0, 240.0, 300.0, 420.0])
    depth0 = rng.uniform(3.0, 6.0, 6)
    targets = np.array([50.0, 100.0, 120.0, 150.0, 200.0, 419.9, 420.0, 500.0])
    want = np.asarray(jnp.interp(jnp.asarray(targets), jnp.asarray(flow0), jnp.asarray(depth0 + 480.0)))
    out = prs.SimOutput(depth=torch.tensor(np.stack([depth0, depth0[::-1]], axis=1)),
                        flow=torch.tensor(np.stack([flow0, flow0], axis=1)), iterations=None, error=None,
                        converged=None, reservoir_stage=None, gate_open=None)
    assert_close(cal.upstream_stage_at(out, 480.0, targets), want)
    assert_close(cal.upstream_stage_at(out, torch.tensor(480.0), torch.tensor(targets)), want)
    batched = prs.SimOutput(*(None if f is None else torch.stack([f, f * 1.5]) for f in out))
    got = cal.upstream_stage_at(batched, 480.0, targets)
    want1 = np.asarray(jnp.interp(jnp.asarray(targets), jnp.asarray(flow0 * 1.5), jnp.asarray(depth0 * 1.5 + 480.0)))
    assert got.shape == (2, 8)
    assert_close(got[0], want)
    assert_close(got[1], want1)


def test_roughness_setters_objective_and_gvf_states(case):
    jargs, args, Q_targets, H_targets, gvf = case
    geo = args[0]
    g = cal.set_main_roughness(geo, 0.041)
    assert g.n_main.shape == (121,) and float(g.n_main.min()) == float(g.n_main.max()) == 0.041
    assert torch.equal(g.n_left, geo.n_left) and torch.equal(g.z_bed, geo.z_bed)
    per_node = cal.set_main_roughness(geo, np.linspace(0.02, 0.04, 121))
    assert_close(per_node.n_main, np.linspace(0.02, 0.04, 121))
    # the GVF state of a candidate is the JAX in-graph march of the same geometry
    h_j, Q_j = jcal.gvf_ic_fn(**gvf)(jcal.set_main_roughness(jargs[0], 0.041))
    h, Q = cal.gvf_ic_fn(**gvf)(g)
    assert_close(h, h_j, rtol=1e-10)
    assert_close(Q, Q_j)
    assert float((h - args[3]).abs().max()) > 1e-3            # rougher bed, another backwater profile
    # one candidate through the objective and through simulate_with_roughness
    short = dataclasses.replace(args[5], n_time_levels=3)
    cut = lambda bc: dataclasses.replace(bc, target_series=bc.target_series[:3])
    a3 = (geo, cut(args[1]), args[2], args[3], args[4], short)
    obj = cal.rmse_objective(*a3, Q_targets, H_targets)
    out = cal.simulate_with_roughness(*a3, 0.034)
    H = cal.upstream_stage_at(out, geo.z_bed[0], Q_targets)
    want = torch.sqrt(torch.mean((H - torch.tensor(H_targets)) ** 2))
    assert float(obj(0.034)) == float(want)
    sweep = cal.rmse_sweep(*a3, Q_targets, H_targets, [0.034, 0.030], engine="fused")
    assert float(sweep[0]) == float(want)


def test_sweep_refuses_what_is_not_ported(case):
    _, args, Q_targets, H_targets, _ = case
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        cal.rmse_sweep(*args, Q_targets, H_targets, N_VALUES, sharded=True)
    with pytest.raises(ValueError, match="engine"):
        cal.rmse_sweep(*args, Q_targets, H_targets, N_VALUES, engine="xla")
    fixed = dataclasses.replace(args[5], newton="fixed")
    with pytest.raises(FusedUnsupported):          # no fallback to the plain engine
        cal.rmse_sweep(*args[:5], fixed, Q_targets, H_targets, N_VALUES, engine="fused")
    assert not hasattr(cal, "bfgs_calibrate") and not hasattr(cal, "gradient_calibrate")
