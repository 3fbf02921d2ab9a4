"""PyTorch port vs JAX package: geometry construction, CSV loaders (the port's
``csv``/NumPy readers against the pandas ones on the same files) and
initial-condition generators; float64 on the CPU, rtol 1e-12."""

import os

import numpy as np
import pytest
import torch

from flowsim_tpu import geometry as jgeom
from flowsim_tpu.models.gerd_roseires import settings as jsettings
from flowsim_tpu.ops import initial_conditions as jic
from flowsim_tpu.utils import io as jio
from flowsim_tpu_torch import geometry as geom
from flowsim_tpu_torch.models.gerd_roseires import settings
from flowsim_tpu_torch.ops import initial_conditions as ic
from flowsim_tpu_torch.utils import io

from tests._torch_port import (  # noqa: F401 (without_autograd is an autouse fixture)
    assert_close, assert_trees_equal, without_autograd)

torch.set_num_threads(1)


def test_data_files_are_the_same_bytes():
    for name in sorted(os.listdir(settings.DATA_DIR)):
        with open(os.path.join(settings.DATA_DIR, name), "rb") as a, \
                open(os.path.join(jsettings.DATA_DIR, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("name,sort_by,header", [
    ("centerline_coords.csv", "chainage", True), ("centerline_coords.csv", None, True),
    ("gerd_vol_curve.csv", None, False)])
def test_import_table(name, sort_by, header):
    got = io.import_table(os.path.join(settings.DATA_DIR, name), header=header, sort_by=sort_by)
    want = jio.import_table(os.path.join(jsettings.DATA_DIR, name), header=header, sort_by=sort_by)
    assert got.dtype == np.float64
    assert_close(got, want)


@pytest.mark.parametrize("name", ["inflow_hydrograph.csv", "inflow_hydrograph_small.csv"])
@pytest.mark.parametrize("convert", [True, False])
def test_import_hydrograph(name, convert):
    assert_close(io.import_hydrograph(os.path.join(settings.DATA_DIR, name), convert),
                 jio.import_hydrograph(os.path.join(jsettings.DATA_DIR, name), convert))


def test_import_area_curve_and_messy_table(tmp_path):
    p = tmp_path / "area.csv"
    p.write_text("stage,area,note\nm,km2,\n480,12.5,\n470,3.25,\n490,40,\n")
    assert_close(io.import_area_curve(str(p)), jio.import_area_curve(str(p)))
    q = tmp_path / "messy.csv"
    q.write_text("a,b,empty\n3,1.5,\n1,,\n2,0.5,\n\n")
    assert_close(io.import_table(str(q), sort_by="a"), jio.import_table(str(q), sort_by="a"))


def _stations():
    ch, st = io.load_trapezoid_stations(settings.cross_sections_path)
    jch, jst = jio.load_trapezoid_stations(jsettings.cross_sections_path)
    return ch, st, jch, jst


@pytest.mark.parametrize("kw", [{}, dict(n_main=0.03, n_fp=0.06), dict(skip_files=())])
def test_load_trapezoid_stations(kw):
    ch, st = io.load_trapezoid_stations(settings.cross_sections_path, **kw)
    jch, jst = jio.load_trapezoid_stations(jsettings.cross_sections_path, **kw)
    assert ch == jch and len(st) == len(jst)
    assert len(st) == (21 if "skip_files" not in kw else 22)
    for a, b in zip(st, jst):
        assert vars(a) == vars(b)


def test_planform_curvature_and_interpolate_stations():
    ch, st, jch, jst = _stations()
    coords = io.import_table(settings.coords_path, sort_by="chainage")
    curv = geom.planform_curvature(np.asarray(ch), coords[:, 0], coords[:, 1:])
    jcurv = jgeom.planform_curvature(np.asarray(jch), coords[:, 0], coords[:, 1:])
    assert_close(curv, jcurv)
    assert np.abs(curv).max() > 0 and curv[0] == 0 and curv[-1] == 0
    for n_nodes in (21, 121, 500):
        nodes = np.linspace(ch[0] - 50.0, ch[-1] + 50.0, n_nodes)  # clamps at both ends
        g = geom.interpolate_stations(st, ch, nodes, coords=coords[:, 1:], coords_chainages=coords[:, 0], device="cpu")
        jg = jgeom.interpolate_stations(jst, jch, nodes, coords=coords[:, 1:], coords_chainages=coords[:, 0])
        assert_trees_equal(g, jg)
        assert g.compound.dtype == torch.bool and g.n_nodes == n_nodes
    with pytest.raises(ValueError):
        geom.interpolate_stations(st, ch[::-1], nodes, device="cpu")


def test_mixed_simple_compound_blend_and_prismatic():
    mk = lambda m: [m.TrapezoidStation(z_bed=10.0, b_main=20.0, m_main=1.0, bed_slope=1e-4),
                    m.TrapezoidStation(z_bed=9.0, b_main=30.0, m_main=2.0, h_bank=4.0, b_fp_left=15.0,
                                       b_fp_right=5.0, m_fp=3.0, bed_slope=2e-4),
                    m.TrapezoidStation(z_bed=8.5, b_main=25.0, h_bank=1e-7, bed_slope=None)]
    ch, nodes = np.array([0.0, 1000.0, 2500.0]), np.linspace(0.0, 2500.0, 26)
    assert_trees_equal(geom.interpolate_stations(mk(geom), ch, nodes, device="cpu"),
                       jgeom.interpolate_stations(mk(jgeom), ch, nodes))
    assert_trees_equal(geom.build_trapezoid_geometry(41, 8000.0, 12.0, 10.0, 35.0, 0.03, device="cpu"),
                       jgeom.build_trapezoid_geometry(41, 8000.0, 12.0, 10.0, 35.0, 0.03))


def _reach(n_nodes=121):
    ch, st, jch, jst = _stations()
    nodes = np.linspace(ch[0], ch[-1], n_nodes)
    dx = float(nodes[1] - nodes[0])
    return (geom.interpolate_stations(st, ch, nodes, device="cpu"),
            jgeom.interpolate_stations(jst, jch, nodes), dx)


@pytest.mark.parametrize("Q,stage_ds", [(1562.5, 487.0), (3000.0, 489.5)])
def test_gvf_profile(Q, stage_ds):
    g, jg, dx = _reach()
    h_ds = stage_ds - float(g.z_bed[-1])
    res, jres = ic.gvf_profile(g, Q, h_ds, dx), jic.gvf_profile(jg, Q, h_ds, dx)
    assert_close(res.depth, jres.depth)
    assert res.supercritical is False and not bool(jres.supercritical)
    h, Qv = ic.initial_conditions(g, "GVF_equation", Q, dx, h_ds=h_ds)
    jh, jQ = jic.initial_conditions(jg, "GVF_equation", Q, dx, h_ds=h_ds)
    assert_close(h, jh)
    assert_close(Qv, jQ)


def test_gvf_supercritical_raises_in_both():
    g = geom.build_trapezoid_geometry(11, 1000.0, 60.0, 10.0, 5.0, 0.01, device="cpu")
    jg = jgeom.build_trapezoid_geometry(11, 1000.0, 60.0, 10.0, 5.0, 0.01)
    with pytest.raises(RuntimeError, match="supercritical"):
        ic.initial_conditions(g, "GVF_equation", 200.0, 100.0, h_ds=0.5)
    with pytest.raises(RuntimeError, match="supercritical"):
        jic.initial_conditions(jg, "GVF_equation", 200.0, 100.0, h_ds=0.5)


def test_steady_normal_depth_and_linear():
    g = geom.build_trapezoid_geometry(31, 9000.0, 14.0, 11.0, 40.0, 0.032, device="cpu")
    jg = jgeom.build_trapezoid_geometry(31, 9000.0, 14.0, 11.0, 40.0, 0.032)
    for Q in (150.0, 0.0, -5.0, 1e9):
        assert_close(ic.steady_normal_depth(g, Q), jic.steady_normal_depth(jg, Q), what=f"Q={Q}")
    h, Qv = ic.initial_conditions(g, "linear", 80.0, 300.0, h_us=2.0, h_ds=3.5)
    jh, jQ = jic.initial_conditions(jg, "linear", 80.0, 300.0, h_us=2.0, h_ds=3.5)
    assert_close(h, jh)
    assert_close(Qv, jQ)
    h, _ = ic.initial_conditions(g, "steady-state", 150.0, 300.0)
    assert_close(h, jic.initial_conditions(jg, "steady-state", 150.0, 300.0)[0])
    with pytest.raises(ValueError):
        ic.initial_conditions(g, "cubic", 1.0, 1.0)
