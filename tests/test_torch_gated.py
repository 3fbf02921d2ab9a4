"""The port's fused engine with a gated (non-smooth) Roseires release curve.

12 levels with a ``gated_blend`` curve whose pivot sits below the initial
stage, so the gate controller switches at the first level.  The port's
``fused_simulate`` on CPU tensors (the kernel's plain version) is held
against the JAX scan-of-Newton in float64 (identical iteration counts and
gate series, depths to 1e-9 m) and against the TPU kernel itself in Pallas
interpret mode at that kernel's own double-single tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flowsim_tpu.models.gerd_roseires import model as jmodel
from flowsim_tpu.ops import boundary as jbnd
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu.ops import rating_curve as jrc
from flowsim_tpu.ops.pallas.fused_newton import fused_simulate as jax_fused_simulate
from flowsim_tpu_torch.models.gerd_roseires import model
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import rating_curve as rc
from flowsim_tpu_torch.ops.cuda import fused_newton

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s


@pytest.fixture(scope="module")
def gated_pair():
    """12 levels with a gated_blend curve whose pivot sits 0.6 m below the
    initial stage, so the gate opens at the first level."""
    levels = 12
    js, jc = jmodel.build(sim_duration=3600 * levels, smooth=False)
    s, c = model.build(sim_duration=3600 * levels, smooth=False, device="cpu")
    rcj = jc.downstream_boundary.rating_curve
    low, high = rcj._quad_of_state(rcj.closed_state), rcj._quad_of_state(rcj.open_state)
    pivot = rcj.initial_stage - 0.6
    jds = jbnd.make_boundary("rating_curve", bed_level=js.ds_params.bed_level,
                             initial_depth=js.ds_params.initial_depth,
                             rating=jrc.make_gated_blend(low, high, pivot))
    ds = bnd.make_boundary("rating_curve", bed_level=s.ds_params.bed_level,
                           initial_depth=s.ds_params.initial_depth,
                           rating=rc.make_gated_blend(low, high, pivot, device="cpu"), device="cpu")
    jset = dataclasses.replace(js.settings(1e-6, 100), linear_solver="pcr")
    jargs = (jc.geometry, js.us_params, jds, js.h0, js.Q0, jset)
    args = (c.geometry, s.us_params, ds, s.h0, s.Q0, s.settings(1e-6, 100))
    return jargs, args, fused_newton.fused_simulate(*args)


def test_gated_run_with_forced_switch_matches_jax_scan(gated_pair):
    jargs, args, out = gated_pair
    jout = jprs.simulate(*jargs)
    gates = np.asarray(jout.gate_open)
    assert gates[0] == 0.0 and gates[1] == 1.0          # the switch was forced
    assert out.gate_open.tolist() == gates.tolist()
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist()
    assert bool(out.converged.all())
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= H_TOL
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)).max() <= Q_TOL


def test_gated_run_matches_tpu_kernel_in_interpret_mode(gated_pair):
    """Against the Pallas kernel itself, at that kernel's own double-single
    tolerance (tests/test_fused_newton.py): identical counts and gate series,
    depths to 1e-4 m, flows to 1 m^3/s."""
    jargs, args, out = gated_pair
    jfused = jax_fused_simulate(*jargs, interpret=True)
    assert out.iterations.tolist() == np.asarray(jfused.iterations).tolist()
    assert out.gate_open.tolist() == np.asarray(jfused.gate_open).tolist()
    assert np.abs(out.depth.numpy() - np.asarray(jfused.depth)).max() < 1e-4
    assert np.abs(out.flow.numpy() - np.asarray(jfused.flow)).max() < 1.0
    assert np.abs(out.error.numpy()[1:] - np.asarray(jfused.error)[1:]).max() < 1e-4
