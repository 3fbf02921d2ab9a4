"""PyTorch port vs JAX package: hydraulic closures, section state, energy
slope, rating curves and boundary rows.  Same NumPy inputs through both;
float64 on the CPU; rtol 1e-12 (absolute floor 1e-14 x scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsim_tpu import geometry as jgeom
from flowsim_tpu.ops import boundary as jbnd
from flowsim_tpu.ops import hydraulics as jhyd
from flowsim_tpu.ops import rating_curve as jrc
from flowsim_tpu.ops import sections as jsec
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import hydraulics as hyd
from flowsim_tpu_torch.ops import rating_curve as rc
from flowsim_tpu_torch.ops import sections as sec

from tests._torch_port import assert_close, to_port, without_autograd  # noqa: F401 (without_autograd is an autouse fixture)

torch.set_num_threads(1)

T = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
J = lambda x: jnp.asarray(np.asarray(x, dtype=np.float64))

_rng = np.random.default_rng(7)
_M = 64
_IN = dict(
    A=_rng.uniform(5.0, 5e3, _M), n=_rng.uniform(0.02, 0.08, _M), R=_rng.uniform(0.2, 12.0, _M),
    dR_dA=_rng.uniform(-1e-3, 1e-3, _M), Q=_rng.uniform(-2e4, 2e4, _M), K=_rng.uniform(1e2, 1e6, _M),
    dK=_rng.uniform(1.0, 1e3, _M), S0=_rng.uniform(-1e-3, 1e-3, _M), T=_rng.uniform(5.0, 900.0, _M),
    h=_rng.uniform(0.1, 25.0, _M), rc=_rng.uniform(-5e3, 5e3, _M),
)

HYD_CASES = {
    "pow_2_3": ("R",), "pow_m1_3": ("R",), "pow_1_6": ("R",), "pow_3_2": ("K",),
    "conveyance": ("A", "n", "R"), "dK_dA": ("A", "n", "R", "dR_dA"),
    "friction_slope": ("Q", "K"), "dSf_dA": ("Q", "K", "dK"), "dSf_dQ": ("Q", "K"),
    "normal_flow": ("S0", "K"), "dQn_dA": ("S0", "dK"), "froude": ("T", "A", "Q"),
    "dFr_dA": ("T", "A", "Q"), "dFr_dQ": ("T", "A"), "darcy_weisbach_f": ("n", "R"),
    "curvature_slope": ("h", "T", "A", "Q", "n", "R", "rc"),
    "dSc_dA": ("h", "A", "Q", "n", "R", "rc", "dR_dA", "T"),
    "dSc_dQ": ("h", "T", "A", "Q", "n", "R", "rc"),
}


@pytest.mark.parametrize("name", sorted(HYD_CASES))
def test_hydraulics(name):
    args = [_IN[a] for a in HYD_CASES[name]]
    assert_close(getattr(hyd, name)(*map(T, args)), getattr(jhyd, name)(*map(J, args)), what=name)


def test_fractional_powers_at_zero_and_tiny():
    x = np.array([0.0, 1e-300, 1e-12, 1.0, 8.0, 1e12])
    for name in ("pow_2_3", "pow_3_2"):
        assert_close(getattr(hyd, name)(T(x)), getattr(jhyd, name)(J(x)), what=name)


# -- sections ---------------------------------------------------------------

def _geometry(kind, curvature, n=48, seed=3):
    rng = np.random.default_rng(seed)
    compound = np.ones(n, bool) if kind == "compound" else (
        np.zeros(n, bool) if kind == "simple" else rng.uniform(size=n) < 0.5)
    curv = rng.uniform(-2e-3, 2e-3, n) if curvature else np.zeros(n)
    if curvature:
        curv[::7] = 0.0
        curv[3] = 1e-13  # between the Sc (!= 0) and dSc (> 1e-12) thresholds
    f = dict(
        z_bed=rng.uniform(450.0, 500.0, n), b_main=rng.uniform(10.0, 80.0, n),
        m_main=rng.uniform(0.0, 14.0, n), n_main=rng.uniform(0.025, 0.05, n),
        h_bank=np.where(compound, rng.uniform(3.0, 20.0, n), 1e30),
        b_fp_left=rng.uniform(0.0, 60.0, n), b_fp_right=rng.uniform(0.0, 60.0, n),
        m_fp=rng.uniform(0.0, 20.0, n), n_left=rng.uniform(0.04, 0.07, n),
        n_right=rng.uniform(0.04, 0.07, n),
        bed_slope=np.where(rng.uniform(size=n) < 0.3, np.nan, rng.uniform(-1e-4, 5e-4, n)),
        curvature=curv,
    )
    jg = jgeom.TrapezoidGeometry(compound=jnp.asarray(compound), **{k: J(v) for k, v in f.items()})
    return jg, to_port("TrapezoidGeometry", jg), rng


def _depths(jg, regime, rng):
    n = jg.n_nodes
    hb = np.where(np.asarray(jg.compound), np.asarray(jg.h_bank), 10.0)
    if regime == "below":
        return hb * rng.uniform(0.05, 0.95, n)
    if regime == "above":
        return hb * rng.uniform(1.05, 2.0, n)
    if regime == "at_bank":
        return hb.copy()
    # h -> 0 guards: dry, negative, and vanishing depths
    return np.resize(np.array([0.0, -0.5, 1e-12, 1e-6, 1e-3]), n)


@pytest.mark.parametrize("curvature", [False, True], ids=["straight", "curved"])
@pytest.mark.parametrize("regime", ["below", "above", "at_bank", "dry"])
@pytest.mark.parametrize("kind", ["simple", "compound", "mixed"])
def test_section_state_energy_slope_normal_flow(kind, regime, curvature):
    jg, pg, rng = _geometry(kind, curvature)
    h = _depths(jg, regime, rng)
    Q = rng.uniform(-3e3, 2.5e4, jg.n_nodes)
    jst, pst = jsec.section_state(jg, J(h)), sec.section_state(pg, T(h))
    for name in jst._fields:
        assert_close(getattr(pst, name), getattr(jst, name), what=f"section_state.{name}")
    A, P, R, Tw = sec.trapezoid_properties(pg, T(h))
    for got, want in zip((A, P, R, Tw), jsec.trapezoid_properties(jg, J(h))):
        assert_close(got, want, what="trapezoid_properties")
    # NaN (0/0 on a dry section) must appear at the same places on both sides
    jes, pes = jsec.energy_slope(jg, J(h), J(Q)), sec.energy_slope(pg, T(h), T(Q))
    for name in jes._fields:
        assert_close(getattr(pes, name), getattr(jes, name), what=f"energy_slope.{name}")
    assert_close(sec.normal_flow(pg, T(h)), jsec.normal_flow(jg, J(h)), what="normal_flow")


def test_compound_quirk_area_omits_main_column_above_bankfull():
    """Above bankfull the area omits the main-channel column while dA_dh is
    the full top width: the port keeps the reference's quirk."""
    jg, pg, rng = _geometry("compound", False)
    h = _depths(jg, "above", rng)
    st = sec.section_state(pg, T(h))
    eps = 1e-6
    dA_fd = (sec.section_state(pg, T(h + eps)).A - sec.section_state(pg, T(h - eps)).A) / (2 * eps)
    T_bank = pg.b_main + 2.0 * pg.m_main * pg.h_bank
    assert torch.allclose(st.dA_dh - dA_fd, T_bank, rtol=1e-5)


# -- rating curves ----------------------------------------------------------

_LOW, _HIGH = [3.1, -2890.0, 674000.0], [9.4, -8650.0, 1991000.0]


def _curves(kind):
    if kind == "polynomial":
        return jrc.make_polynomial(2.5, -30.0, 400.0, stage_shift=-470.0), \
            rc.make_polynomial(2.5, -30.0, 400.0, stage_shift=-470.0, device="cpu")
    if kind == "poly_n":
        c = [12.0, -3.0, 0.7, 0.01]
        return jrc.make_polynomial_general(c, stage_shift=-480.0), \
            rc.make_polynomial_general(c, stage_shift=-480.0, device="cpu")
    if kind == "power":
        return jrc.make_power(35.0, 1.6, stage_shift=-470.0), rc.make_power(35.0, 1.6, stage_shift=-470.0, device="cpu")
    if kind == "blended_poly":
        return jrc.make_blended_poly(_LOW, _HIGH, 487.0, buffer=0.5), \
            rc.make_blended_poly(_LOW, _HIGH, 487.0, buffer=0.5, device="cpu")
    if kind == "blended_step":
        return jrc.make_blended_poly(_LOW, _HIGH, 487.0, buffer=0.0), \
            rc.make_blended_poly(_LOW, _HIGH, 487.0, buffer=0.0, device="cpu")
    if kind == "table":
        s, q = np.linspace(480.0, 492.0, 13), np.linspace(480.0, 492.0, 13) ** 2 - 2.2e5
        return jrc.make_table(s, q), rc.make_table(s, q, device="cpu")
    return jrc.make_gated_blend(_LOW, _HIGH, 487.0), rc.make_gated_blend(_LOW, _HIGH, 487.0, device="cpu")


# across the buffer (487 .. 487.5), at its ends, and outside the table span
_STAGES = np.array([479.0, 485.2, 486.999, 487.0, 487.0005, 487.1, 487.25, 487.4, 487.4995,
                    487.5, 487.5005, 488.3, 491.0, 493.0])


@pytest.mark.parametrize("kind", ["polynomial", "poly_n", "power", "blended_poly", "blended_step", "table"])
def test_rating_discharge_and_slope(kind):
    j, p = _curves(kind)
    for f in ("coeffs", "coeffs_high", "pivot_stage", "buffer", "fd_step", "stage_shift"):
        assert_close(getattr(p, f), getattr(j, f), what=f)
    assert_close(rc.discharge(p, T(_STAGES)), jrc.discharge(j, J(_STAGES)), what="discharge")
    # the finite-difference slope divides a ~1e-3 difference of ~1e4 values:
    # an ulp of Q (2e-12) over 2e-3 — compare at the scale of Q / fd_step
    want = np.asarray(jrc.dQ_dz(j, J(_STAGES)))
    got = rc.dQ_dz(p, T(_STAGES)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14 * 1e4 / 1e-3)


def test_rating_gated_discharge_slope_and_gate_update():
    j, p = _curves("gated_blend")
    for gate in (0.0, 1.0):
        assert_close(rc.gated_discharge(p, T(_STAGES), T(gate)),
                     jrc.gated_discharge(j, J(_STAGES), J(gate)), what="gated_discharge")
        np.testing.assert_allclose(rc.gated_dQ_dz(p, T(_STAGES), T(gate)).numpy(),
                                   np.asarray(jrc.gated_dQ_dz(j, J(_STAGES), J(gate))),
                                   rtol=1e-12, atol=1e-7)
    # controller: every combination of gate state, cooldown, stage side, first call
    for gate in (0.0, 1.0):
        for cooldown in (0.0, 1800.0, 7200.0):
            for stage in (485.9, 486.0, 487.2, 487.5, 488.0):
                for prev_time in (-1.0, 3600.0):
                    a = rc.gate_update(p, T(gate), T(cooldown), T(prev_time), T(stage), 7200.0)
                    b = jrc.gate_update(j, J(gate), J(cooldown), J(prev_time), J(stage), J(7200.0))
                    for x, y in zip(a, b):
                        assert float(x) == float(y)


def test_inverse_stage_and_fit():
    j, p = _curves("polynomial")
    assert_close(rc.inverse_stage(p, 900.0, trial_stage=490.0),
                 jrc.inverse_stage(j, 900.0, trial_stage=490.0), rtol=1e-10)
    stages = np.linspace(480.0, 490.0, 9)
    q = 3.0 * (stages - 470.0) ** 2 + 11.0
    jf, pf = jrc.fit(q, stages, stage_shift=-470.0), rc.fit(q, stages, stage_shift=-470.0, device="cpu")
    assert_close(pf.coeffs, jf.coeffs)
    X = np.column_stack([np.repeat(stages, 3), np.tile([1.0, 2.0, 3.0], 9)])
    y = X[:, 0] * 2.0 + X[:, 1] ** 2
    assert_close(rc.fit_quadratic_bivariate(X, y), jrc.fit_quadratic_bivariate(X, y))


# -- boundaries -------------------------------------------------------------

_KINDS = ["flow_hydrograph", "stage_hydrograph", "fixed_depth", "normal_depth",
          "rating_polynomial", "rating_blended", "rating_gated"]


@pytest.mark.parametrize("end", ["upstream", "downstream"])
@pytest.mark.parametrize("kind", _KINDS)
def test_boundary_evaluate(kind, end):
    jg, pg, rng = _geometry("compound", True)
    h = _depths(jg, "above", rng)
    Q = rng.uniform(2e3, 2e4, jg.n_nodes)
    i = 0 if end == "upstream" else -1
    series = rng.uniform(1e3, 2e4, 12) if kind != "stage_hydrograph" else rng.uniform(480.0, 500.0, 12)
    jrat = prat = None
    bc_kind = kind
    if kind.startswith("rating_"):
        bc_kind = "rating_curve"
        jrat, prat = _curves({"rating_polynomial": "polynomial", "rating_blended": "blended_poly",
                              "rating_gated": "gated_blend"}[kind])
    kw = dict(bed_level=float(jg.z_bed[i]), bed_slope=-2e-4 if end == "upstream" else 3e-4,
              initial_depth=7.5, target_series=series)
    jbc = jbnd.make_boundary(bc_kind, rating=jrat, **kw)
    pbc = bnd.make_boundary(bc_kind, rating=prat, device="cpu", **kw)
    jst, pst = jsec.section_state(jg, J(h)), sec.section_state(pg, T(h))
    jnode = jbnd.NodeSection(**{f: getattr(jst, f)[i] for f in jbnd.NodeSection._fields})
    pnode = bnd.NodeSection(**{f: getattr(pst, f)[i] for f in bnd.NodeSection._fields})
    for gate in (0.0, 1.0):
        jstate = jbnd.initial_bc_state(jnp.float64, gate_open=gate, gate_stage=487.0)
        pstate = bnd.initial_bc_state(torch.float64, "cpu", gate_open=gate, gate_stage=487.0)
        je = jbnd.evaluate(jbc, jnode, J(h)[i], J(Q)[i], 5, 3600.0, Q_prev=J(Q)[i],
                           reservoir_stage_prev=J(np.nan), bc_state=jstate, upstream=end == "upstream")
        pe = bnd.evaluate(pbc, pnode, T(h)[i], T(Q)[i], 5, 3600.0, bc_state=pstate)
        assert_close(pe.residual, je.residual, what="residual")
        assert_close(pe.df_dQ, je.df_dQ, what="df_dQ")
        np.testing.assert_allclose(float(pe.df_dh), float(je.df_dh), rtol=1e-12, atol=1e-7)
        assert np.isnan(float(pe.reservoir_stage)) and np.isnan(float(je.reservoir_stage))


def test_gate_update_level_start_and_storage_refused():
    j, p = _curves("gated_blend")
    jbc = jbnd.make_boundary("rating_curve", bed_level=470.0, rating=j)
    pbc = bnd.make_boundary("rating_curve", bed_level=470.0, rating=p, device="cpu")
    js = jbnd.initial_bc_state(jnp.float64, gate_stage=487.6)
    ps = bnd.initial_bc_state(torch.float64, "cpu", gate_stage=487.6)
    js, ps = jbnd.update_gate_level_start(jbc, js, J(3600.0)), bnd.update_gate_level_start(pbc, ps, 3600.0)
    for f in ("gate_open", "gate_cooldown", "gate_prev_time", "gate_stage"):
        assert float(getattr(ps, f)) == float(getattr(js, f))
    assert float(ps.gate_open) == 1.0
    # lumped storage rides on a fixed_depth boundary, and on no other kind
    from flowsim_tpu_torch.ops import storage as stg
    sp = stg.make_storage(surface_area=1e6, min_stage=3.0, device="cpu")
    with_storage = bnd.make_boundary("fixed_depth", initial_depth=3.0, storage=sp, device="cpu")
    assert float(with_storage.storage.surface_area) == 1e6 and float(with_storage.storage.min_stage) == 3.0
    with pytest.raises(ValueError, match="fixed_depth"):
        bnd.make_boundary("normal_depth", bed_slope=1e-4, storage=sp, device="cpu")
    with pytest.raises(ValueError):
        bnd.make_boundary("rating_curve", device="cpu")
