"""The first slice of the port as a whole: the GERD->Roseires flagship.

``model.build()`` in both packages gives equal geometry, initial state and
boundary series; ``convert.from_numpy`` carries the JAX solver's trees across;
one full 385-level run of the port's ``engine="fused"`` on the CPU (where the
wrapper takes the kernel's plain version) reproduces the JAX float64 run:
4803 Newton iterations, the same count at every level, depths to 1e-9 m.
The gated (non-smooth) Roseires curve is in ``test_torch_gated.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flowsim_tpu.models.gerd_roseires import model as jmodel
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu_torch import convert
from flowsim_tpu_torch.models.gerd_roseires import model
from flowsim_tpu_torch.ops import rating_curve as rc
from flowsim_tpu_torch.ops.cuda import fused_newton

from tests._torch_port import assert_close, assert_trees_equal, to_port, tree_to_numpy

torch.set_num_threads(1)

H_TOL = 1e-9   # m
Q_TOL = 1e-6   # m^3/s


@pytest.fixture(scope="module")
def pair():
    js, jc = jmodel.build()
    s, c = model.build(device="cpu")
    return js, jc, s, c


def test_build_gives_equal_geometry_state_and_series(pair):
    js, jc, s, c = pair
    assert (s.number_of_nodes, s.number_of_time_levels) == (121, 385)
    assert (s.number_of_nodes, s.number_of_time_levels) == (js.number_of_nodes, js.number_of_time_levels)
    assert s.spatial_step == js.spatial_step and s.theta == js.theta == 0.6
    assert_trees_equal(c.geometry, jc.geometry)
    assert_close(s.h0, js.h0)
    assert_close(s.Q0, js.Q0)
    assert_trees_equal(s.us_params, js.us_params)
    assert_trees_equal(s.ds_params, js.ds_params)
    assert s.us_params.kind == "flow_hydrograph" and s.ds_params.rating.kind == "blended_poly"
    assert_close(c.ch_at_node, jc.ch_at_node)
    assert_close(c.initial_conditions, jc.initial_conditions)


def test_convert_carries_the_jax_trees_across(pair):
    js, jc, s, c = pair
    geo = to_port("TrapezoidGeometry", jc.geometry)
    us, ds = to_port("BoundaryParams", js.us_params), to_port("BoundaryParams", js.ds_params)
    sset = to_port("PreissmannSettings", js.settings(1e-6, 100))
    h0, Q0 = convert.from_numpy("state", dict(h0=np.asarray(js.h0), Q0=np.asarray(js.Q0)), device="cpu")
    for built, carried in ((c.geometry, geo), (s.us_params, us), (s.ds_params, ds)):
        for f in dataclasses.fields(built):
            a, b = getattr(built, f.name), getattr(carried, f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                assert_close(b, a, what=f.name)
            elif dataclasses.is_dataclass(a):
                assert_trees_equal(b, js.ds_params.rating)
            else:
                assert a == b, f.name
    assert sset == s.settings(1e-6, 100)   # TPU-only fields dropped, the rest equal
    assert_close(h0, s.h0)
    assert_close(Q0, s.Q0)
    assert isinstance(to_port("RatingCurveParams", js.ds_params.rating), rc.RatingCurveParams)
    with pytest.raises(ValueError):
        convert.from_numpy("LumpedStorage", {}, device="cpu")
    # a boundary's lumped storage is carried as a nested tree
    from flowsim_tpu.ops import storage as jstg
    from flowsim_tpu_torch.ops import storage as stg
    jsp = jstg.make_storage(surface_area=1.25e6, min_stage=5.0)
    with_storage = convert.from_numpy(
        "BoundaryParams", dict(tree_to_numpy(js.ds_params), kind="fixed_depth", storage=tree_to_numpy(jsp)),
        device="cpu")
    assert isinstance(with_storage.storage, stg.StorageParams)
    assert_trees_equal(with_storage.storage, jsp)


def test_full_flagship_run_matches_jax_f64(pair):
    """All 385 levels, port engine="fused" on device="cpu" (= the kernel's
    plain version) vs the JAX scan-of-Newton with the PCR solve."""
    js, jc, s, c = pair
    jset = dataclasses.replace(js.settings(1e-6, 100), linear_solver="pcr")
    jout = jprs.simulate(jc.geometry, js.us_params, js.ds_params, js.h0, js.Q0, jset)
    before = fused_newton.launch_count
    out = s.run(engine="fused", tolerance=1e-6, verbose=0)
    assert fused_newton.launch_count == before          # CPU tensors: plain version, no launch
    jit = np.asarray(jout.iterations)
    assert int(jit.sum()) == 4803 and int(jit.max()) == 24
    assert int(out.iterations.sum()) == 4803
    assert out.iterations.tolist() == jit.tolist()      # the same count at every level
    assert bool(out.converged.all()) and bool(np.asarray(jout.converged).all())
    assert out.depth.shape == (385, 121) and s.depth.shape == (385, 121)
    dh = np.abs(out.depth.numpy() - np.asarray(jout.depth)).max()
    dq = np.abs(out.flow.numpy() - np.asarray(jout.flow)).max()
    assert dh <= H_TOL and dq <= Q_TOL, (dh, dq)
    # accessors of the solver surface
    assert s.depth_at(k=None, i=0) == float(out.depth[-1, 0])
    assert s.water_level_at(k=10, i=5) == pytest.approx(float(jc.geometry.z_bed[5]) + float(jout.depth[10, 5]), abs=1e-8)


def test_model_run_hook_and_unported_options():
    stages = model.run(Q=[1600.0, 1700.0], verbose=0, sim_duration=3600 * 3, device="cpu")
    jstages = jmodel.run(Q=[1600.0, 1700.0], verbose=0, sim_duration=3600 * 3, folder=None)
    assert_close(stages, jstages, rtol=1e-9)
    with pytest.raises(NotImplementedError):
        model.run(banks_file="banks.shp", device="cpu")
