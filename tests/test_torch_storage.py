"""PyTorch port vs JAX package: lumped reservoir storage on the CPU in float64.

* ``ops.storage`` function by function against ``flowsim_tpu.ops.storage``
  from NumPy-seeded inputs at rtol 1e-12 (``interp`` also outside the table);
* the storage branch of ``boundary.evaluate`` in both orientations;
* ``convert.from_numpy`` on storage trees, ``api.LumpedStorage``;
* the shipped example (``models.example``: 21 nodes, all 24 levels) with
  ``engine="plain"`` and ``engine="fused"`` (on CPU tensors: the kernel's plain
  version) against ``flowsim_tpu.models.example``;
* a reservoir with a stage-area curve, a rating and entrance losses, one at
  each end, and a four-member ensemble of reservoirs, at 6 levels, against
  the JAX scan (``engine="xla"``: float64, not the double-single Pallas
  kernel).

Run tolerances: the same iteration count at every level, max|dh| <= 1e-9 m,
max|dQ| <= 1e-6 m^3/s, reservoir stage <= 1e-9 m.  Four JAX configurations are
compiled, each once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flowsim_tpu import api as japi
from flowsim_tpu.models import example as jexample
from flowsim_tpu.ops import boundary as jbnd
from flowsim_tpu.ops import preissmann as jprs
from flowsim_tpu.ops import rating_curve as jrc
from flowsim_tpu.ops import storage as jstg
from flowsim_tpu.parallel import ensemble as jens
from flowsim_tpu_torch import api, convert, trees
from flowsim_tpu_torch.models import example
from flowsim_tpu_torch.ops import boundary as bnd
from flowsim_tpu_torch.ops import rating_curve as rc
from flowsim_tpu_torch.ops import storage as stg
from flowsim_tpu_torch.ops.cuda import fused_batched, fused_newton
from flowsim_tpu_torch.parallel import ensemble as ens

from tests._torch_port import (  # noqa: F401 (without_autograd is an autouse fixture)
    assert_close, assert_trees_equal, to_jax, to_port, tree_to_numpy, without_autograd)

torch.set_num_threads(1)

H_TOL, Q_TOL, STAGE_TOL = 1e-9, 1e-6, 1e-9

T = lambda v: torch.tensor(v, dtype=torch.float64)
J = jnp.asarray


def _curve(seed=0, m=12):
    rng = np.random.default_rng(seed)
    stages = np.sort(rng.uniform(-2.0, 20.0, m))
    areas = 4.0e5 * (1.0 + np.cumsum(rng.uniform(0.0, 0.2, m)))
    return np.stack([stages, areas], axis=1)


def _storages(kind):
    """The same storage in both packages: (JAX params, port params)."""
    if kind == "const":
        kw = dict(surface_area=1.25e6, min_stage=5.0, solution_boundaries=(0.0, 200.0))
        return jstg.make_storage(**kw), stg.make_storage(device="cpu", **kw)
    if kind == "const_losses":
        kw = dict(surface_area=5.0e5, min_stage=-1.0, solution_boundaries=(-2.0, 30.0),
                  capture_losses=True, reservoir_length=1500.0, K_q=0.2)
        return jstg.make_storage(**kw), stg.make_storage(device="cpu", **kw)
    kw = dict(area_curve=_curve(), min_stage=-1.0, alpha=1.1, beta=0.25, capture_losses=True,
              reservoir_length=1500.0, K_q=0.2)
    return (jstg.make_storage(rating=jrc.make_polynomial(0.0, 30.0, 30.0), **kw),
            stg.make_storage(rating=rc.make_polynomial(0.0, 30.0, 30.0, device="cpu"), device="cpu", **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interp_matches_jnp_interp_inside_and_outside(seed):
    rng = np.random.default_rng(seed)
    xp = np.sort(rng.uniform(0.0, 10.0, 17))
    fp = rng.uniform(-5.0, 5.0, 17)
    x = np.concatenate([rng.uniform(-3.0, 13.0, 40), xp[[0, 5, -1]], [-1e9, 1e9]])
    got = stg.interp(T(x), T(xp), T(fp))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.interp(J(x), J(xp), J(fp))), rtol=1e-12, atol=1e-14)
    assert float(got[-2]) == fp[0] and float(got[-1]) == fp[-1]           # the end values are held
    assert float(stg.interp(T(xp[3]), T(xp), T(fp))) == pytest.approx(fp[3], abs=1e-14)   # a scalar x


@pytest.mark.parametrize("kind", ["const", "const_losses", "curve_rating_losses"])
def test_make_storage_and_its_lookups(kind):
    jsp, sp = _storages(kind)
    assert_trees_equal(sp, jsp)
    assert (sp.has_area_curve, sp.has_rating, sp.capture_losses) == (jsp.has_area_curve, jsp.has_rating, jsp.capture_losses)
    if kind == "curve_rating_losses":
        assert sp.vol_stage.shape == (4096,) and sp.rating.kind == "polynomial"
    y = np.random.default_rng(3).uniform(-4.0, 25.0, 9)
    assert_close(stg.area_at(sp, T(y)) + torch.zeros(9, dtype=torch.float64), jstg.area_at(jsp, J(y)) + jnp.zeros(9))
    assert_close(stg.dA_dY(sp, T(y)), jstg.dA_dY(jsp, J(y)))
    assert_close(stg.net_vol_change(sp, T(y), T(y[::-1].copy())), jstg.net_vol_change(jsp, J(y), J(y[::-1])))
    assert_close(stg.dY_new_dvol_in(sp, T(y)), jstg.dY_new_dvol_in(jsp, J(y)))
    with pytest.raises(ValueError, match="surface_area or area_curve"):
        stg.make_storage(device="cpu")


@pytest.mark.parametrize("kind", ["const", "const_losses", "curve_rating_losses"])
def test_mass_balance_bisection(kind):
    jsp, sp = _storages(kind)
    rng = np.random.default_rng(4)
    y_old = rng.uniform(1.0, 15.0, 7)
    vol_in = rng.uniform(-2e6, 8e6, 7)
    got = stg.mass_balance(sp, 3600.0, T(vol_in), T(y_old))
    want = jstg.mass_balance(jsp, 3600.0, J(vol_in), J(y_old))
    assert_close(got, want)
    res = stg._mass_balance_residual(sp, 3600.0, T(vol_in), T(y_old), got)
    free = got > sp.min_stage       # where the clamp is not active the balance closes
    assert float(res[free].abs().max()) < 1e-6
    off = y_old + 0.5               # away from the root the residual itself is comparable
    assert_close(stg._mass_balance_residual(sp, 3600.0, T(vol_in), T(y_old), T(off)),
                 jstg._mass_balance_residual(jsp, 3600.0, J(vol_in), J(y_old), J(off)))
    assert stg.BISECT_ITERS == jstg._BISECT_ITERS == 80


@pytest.mark.parametrize("fn", ["energy_loss", "dhl_dA", "dhl_dQ"])
def test_entrance_loss_and_its_derivatives(fn):
    rng = np.random.default_rng(5)
    A, Q = rng.uniform(200.0, 900.0, 6), rng.uniform(-300.0, 900.0, 6)
    n, R, dR_dA = rng.uniform(0.02, 0.04, 6), rng.uniform(1.0, 5.0, 6), rng.uniform(1e-3, 5e-3, 6)
    for kind in ("const", "curve_rating_losses"):
        jsp, sp = _storages(kind)
        args = (A, Q, n, R) + ((dR_dA,) if fn == "dhl_dA" else ())
        got = getattr(stg, fn)(sp, *[T(a) for a in args])
        assert_close(got, getattr(jstg, fn)(jsp, *[J(a) for a in args]))
        assert (float(got.abs().max()) > 0.0) == sp.capture_losses


@pytest.mark.parametrize("end,k", [("downstream", 1), ("downstream", 5), ("upstream", 1), ("upstream", 5)])
def test_boundary_evaluate_storage_branch(end, k):
    rng = np.random.default_rng(6)
    upstream = end == "upstream"
    for kind in ("const", "const_losses", "curve_rating_losses"):
        jsp, sp = _storages(kind)
        jbc = jbnd.make_boundary("fixed_depth", bed_level=1.5, storage=jsp)
        bc = bnd.make_boundary("fixed_depth", bed_level=1.5, storage=sp, device="cpu")
        vals = dict(A=rng.uniform(300, 900), R=rng.uniform(2, 4), K=rng.uniform(1e4, 5e4), n_eq=0.03,
                    dA_dh=rng.uniform(100, 150), dR_dA=rng.uniform(1e-3, 4e-3), dK_dA=rng.uniform(50, 90))
        h, Q, Qp, hp, prev = rng.uniform(3, 6), rng.uniform(200, 900), rng.uniform(200, 900), rng.uniform(3, 6), 7.3
        je = jbnd.evaluate(jbc, jbnd.NodeSection(**{f: J(v) for f, v in vals.items()}), J(h), J(Q), k, 3600.0,
                           Q_prev=J(Qp), reservoir_stage_prev=J(prev), upstream=upstream, h_prev=J(hp))
        pe = bnd.evaluate(bc, bnd.NodeSection(**{f: T(v) for f, v in vals.items()}), T(h), T(Q), k, 3600.0,
                          Q_prev=T(Qp), reservoir_stage_prev=T(prev), upstream=upstream, h_prev=T(hp))
        for f in pe._fields:
            assert_close(getattr(pe, f), getattr(je, f), what=f"{kind} {f}")
        assert np.isfinite(float(pe.reservoir_stage))
    with pytest.raises(ValueError, match="only supported on a fixed_depth"):
        bnd.make_boundary("normal_depth", bed_slope=1e-4, storage=sp, device="cpu")


def test_convert_from_numpy_storage_trees():
    jsp, sp = _storages("curve_rating_losses")
    carried = convert.from_numpy("storage", tree_to_numpy(jsp), device="cpu")
    assert isinstance(carried, stg.StorageParams) and isinstance(carried.rating, rc.RatingCurveParams)
    assert_trees_equal(carried, jsp)
    assert carried.has_area_curve is True and carried.capture_losses is True
    jbc = jbnd.make_boundary("fixed_depth", bed_level=2.0, storage=jsp)
    bc = to_port("BoundaryParams", jbc)
    assert_trees_equal(bc, jbc)
    assert bc.storage.vol_table.dtype == torch.float64
    # stacked members: every tensor leaf of the storage gains the member axis
    stacked, _ = jens.batch_boundaries([jbc, dataclasses.replace(jbc, storage=dataclasses.replace(
        jsp, K_q=jnp.asarray(0.4)))])
    b2 = to_port("BoundaryParams", stacked)
    assert b2.storage.K_q.tolist() == [0.2, 0.4] and b2.storage.vol_table.shape == (2, 4096)
    assert_trees_equal(trees.member(b2, 0), jbc)


def test_api_lumped_storage_builds_what_the_jax_api_builds():
    table = _curve(seed=2)
    for cls, kw in ((japi.LumpedStorage, {}), (api.LumpedStorage, dict(device="cpu"))):
        store = cls(solution_boundaries=(0.0, 150.0), surface_area=2e6, min_stage=3.0)
        assert store.min_stage == 3.0 and cls().min_stage == -np.inf
        store.set_area_curve(table, alpha=1.2, beta=0.1)
        store.capture_losses, store.reservoir_length, store.K_q = True, 800.0, 0.3
        if cls is japi.LumpedStorage:
            jsp = store.build(**kw)
        else:
            sp = store.build(**kw)
    assert_trees_equal(sp, jsp)
    b = api.Boundary("fixed_depth", chainage=0.0, bed_level=0.0, initial_depth=4.0)
    b.set_lumped_storage(store)
    params = b.build(np.arange(3) * 60.0, 0.0, 1e-4, device="cpu")
    assert params.storage is not None and params.storage.has_area_curve


@pytest.fixture(scope="module")
def example_pair():
    js, _ = jexample.build("preissmann")
    js.run(verbose=0, max_iter=100)
    s, _ = example.build("preissmann", device="cpu")
    return js, s


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_example_matches_jax_all_24_levels(example_pair, engine):
    js, s = example_pair
    jout = js.output
    before = fused_newton.launch_count
    out = s.run(verbose=0, max_iter=100, engine=engine)
    assert fused_newton.launch_count == before     # CPU tensors: the plain version
    assert (s.number_of_nodes, s.number_of_time_levels) == (21, 25)
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist()
    assert bool(out.converged.all())
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= H_TOL
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)).max() <= Q_TOL
    stage, jstage = out.reservoir_stage.numpy(), np.asarray(jout.reservoir_stage)
    assert np.isnan(stage[0]) and np.isnan(jstage[0])
    assert np.abs(stage[1:] - jstage[1:]).max() <= STAGE_TOL
    assert np.isnan(out.reservoir_stage_us.numpy()).all()
    assert 69.0 < stage[-1] < 71.0 and stage[-1] == stage[1:].max()    # the reservoir fills
    assert_trees_equal(s.ds_params, js.ds_params)


def test_example_module_surface(example_pair, capsys):
    assert example.trapezoid_hydrograph(0.0) == 1000.0 and example.trapezoid_hydrograph(5 * 3600.0) == 10000.0
    for t in (1800.0, 3 * 3600.0, 10 * 3600.0, 12.5 * 3600.0, 20 * 3600.0):
        assert example.trapezoid_hydrograph(t) == jexample.trapezoid_hydrograph(t)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        example.build("lax", device="cpu")
    solver = example.main(device="cpu")
    assert "Peak reservoir stage 69.96" in capsys.readouterr().out and solver.depth.shape == (25, 21)
    # the bracket check: a reservoir that outgrows its solution_boundaries is reported
    s, _ = example.build(device="cpu")
    s.ds_params = dataclasses.replace(s.ds_params, storage=dataclasses.replace(
        s.ds_params.storage, y_max=torch.tensor(20.0, dtype=torch.float64)))
    with pytest.raises(ValueError, match="solution_boundaries"):
        s.run(verbose=0, max_iter=100)


def _compare(out, jout, levels):
    assert out.iterations.tolist() == np.asarray(jout.iterations).tolist()
    assert bool(out.converged.all()) and out.depth.shape[0] == levels + 1
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= H_TOL
    assert np.abs(out.flow.numpy() - np.asarray(jout.flow)).max() <= Q_TOL
    for name in ("reservoir_stage", "reservoir_stage_us"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(jout, name))
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        assert np.nanmax(np.abs(a - b), initial=0.0) <= STAGE_TOL, name


@pytest.mark.parametrize("name,levels", [("ds_curve_rating_losses", 6), ("both_ends", 6)])
def test_storage_variants_match_jax(name, levels):
    geo, us, ds, h0, Q0, sset = chip_smoke.build_storage_case(name, "cpu", levels=levels)
    jout = jprs.simulate(to_jax(geo), to_jax(us), to_jax(ds), J(h0.numpy()), J(Q0.numpy()), to_jax(sset))
    _compare(fused_newton.fused_simulate(geo, us, ds, h0, Q0, sset), jout, levels)
    stage = np.asarray(jout.reservoir_stage)
    assert np.isfinite(stage[1:]).all() and np.ptp(stage[1:]) > 1e-4
    if name == "both_ends":
        assert np.isfinite(np.asarray(jout.reservoir_stage_us)[1:]).all()


def test_storage_ensemble_four_members_matches_jax():
    levels, B = 6, 4
    geo, us, ds, h0, Q0, sset = chip_smoke.build_storage_case("ds_const", "cpu", levels=levels)
    n_values, areas = [0.021, 0.023, 0.026, 0.030], [1.0e6, 1.25e6, 1.5e6, 2.0e6]
    members = [dataclasses.replace(ds, storage=dataclasses.replace(ds.storage, surface_area=T(a))) for a in areas]
    ds_b, ax = ens.batch_boundaries(members)
    geob = ens.roughness_ensemble(geo, n_values)
    jds_b, jax_ = jens.batch_boundaries([to_jax(m) for m in members])
    jout = jens.batched_simulate(jens.roughness_ensemble(to_jax(geo), n_values), to_jax(us), jds_b,
                                 J(h0.numpy()), J(Q0.numpy()), to_jax(sset), ds_axes=jax_, engine="xla", shard=False)
    before = fused_batched.launch_count
    out = ens.batched_simulate(geob, us, ds_b, h0, Q0, sset, ds_axes=ax, engine="fused")
    assert fused_batched.launch_count == before     # CPU tensors: the plain version, a member loop
    assert out.reservoir_stage.shape == (B, levels + 1)
    for m in range(B):
        _compare(chip_smoke.prs_out_member(out, m),
                 type(jout)(*(None if f is None else f[m] for f in jout)), levels)
    assert len(set(out.reservoir_stage[:, -1].tolist())) == B      # the members' reservoirs differ
    # packing per member: scalars [B, 2, 17], no tables for constant areas
    stor, stab, ints = fused_newton.pack_storage(us, ds_b, batch_shape=(B,))
    assert stor.shape == (B, 2, 17) and stor[:, 1, 0].tolist() == areas and float(stor[:, 0].abs().max()) == 0.0
    assert ints == (0, 1, 0, 0, 0, 0) and stab.shape == (1,)


def test_pack_storage_tables_and_what_the_kernel_refuses():
    geo, us, ds, h0, Q0, sset = chip_smoke.build_storage_case("ds_curve_rating_losses", "cpu", levels=2)
    stor, stab, ints = fused_newton.pack_storage(us, ds)
    assert stor.shape == (2, 17) and ints == (0, 1 | 2 | 4 | 8, 0, 0, 4096, 12)
    assert stab.shape == (2 * 4096 + 2 * 12,) and torch.equal(stab[:4096], ds.storage.vol_stage)
    assert torch.equal(stab[-12:], ds.storage.area_table)
    both = chip_smoke.build_storage_case("both_ends", "cpu", levels=2)
    assert fused_newton.pack_storage(both[1], both[2])[2] == (1, 1, 0, 0, 0, 0)
    fused_newton._check_supported(geo, us, ds, sset)
    gated = rc.make_gated_blend([0.0, 20.0, 0.0], [0.0, 30.0, 0.0], pivot_stage=2.0, device="cpu")
    for rating, word in ((gated, "gated_blend"), (rc.make_power(3.0, 1.5, device="cpu"), "power"),
                         (rc.make_table([0.0, 9.0], [0.0, 90.0], device="cpu"), "table")):
        bad = dataclasses.replace(ds, storage=dataclasses.replace(ds.storage, rating=rating))
        with pytest.raises(fused_newton.FusedUnsupported, match=word):
            fused_newton.fused_simulate(geo, us, bad, h0, Q0, sset)
