"""Sharding invariance: the N-shard step must match the single-device step.

The analog of the reference's implicit guarantee that results are
independent of worker count (SURVEY.md 7.2 item 5) — here it holds exactly
because the radial projection decomposes over cells.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scythe_tpu import BC, ZBC, GridParameters, ModelParameters, create_grid
from scythe_tpu.model import build_step, initialize, make_scan
from scythe_tpu.parallel import sharding as sh


def _advection_setup(tmp_path, num_cells=96):
    gp = GridParameters(
        geometry="R",
        xmin=-48.0,
        xmax=48.0,
        num_cells=num_cells,
        BCL={"u": BC.PERIODIC},
        BCR={"u": BC.PERIODIC},
        vars={"u": 1},
    )
    model = ModelParameters(
        ts=0.05,
        integration_time=5.0,
        output_interval=5.0,
        equation_set="LinearAdvection1D",
        initial_conditions=str(tmp_path / "ics.csv"),
        output_dir=str(tmp_path / "out"),
        grid_params=gp,
        physical_params={"c_0": 1.0, "K": 0.1},
    )
    grid = create_grid(gp)
    r = grid.r_mish
    u0 = np.exp(-((r / 15.0) ** 2))
    with open(model.initial_conditions, "w") as f:
        f.write("r,u\n")
        for a, b in zip(r, u0):
            f.write(f"{a},{b}\n")
    return model


def _slab_setup(tmp_path):
    gp = GridParameters(
        geometry="RL",
        xmin=0.0,
        xmax=3.0e5,
        num_cells=32,
        lDim=32,
        BCL={
            "h": BC.R1T1,
            "u": BC.R1T0,
            "v": BC.R1T0,
            "ub": BC.R1T0,
            "vb": BC.R1T0,
            "wb": BC.R1T1,
        },
        BCR={
            "h": BC.R0,
            "u": BC.R1T1,
            "v": BC.R0,
            "ub": BC.R1T1,
            "vb": BC.R0,
            "wb": BC.R0,
        },
        vars={"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6},
    )
    model = ModelParameters(
        ts=3.0,
        integration_time=60.0,
        output_interval=60.0,
        equation_set="Twoway_ShallowWater_Slab",
        initial_conditions=str(tmp_path / "ics.csv"),
        output_dir=str(tmp_path / "out"),
        grid_params=gp,
        physical_params={
            "g": 9.81,
            "K": 5000.0,
            "Cd": 2.4e-3,
            "Hfree": 2000.0,
            "Hb": 1000.0,
            "f": 5.0e-5,
            "S1": 1.0e-5,
        },
    )
    grid = create_grid(gp)
    pts = grid.gridpoints()
    r, lam = pts[:, 0], pts[:, 1]
    # a weak Rankine-like vortex + wavenumber-2 perturbation
    rm, vm = 5.0e4, 20.0
    v = np.where(r < rm, vm * r / rm, vm * rm / r)
    v = v * (1.0 + 0.05 * np.cos(2 * lam))
    with open(model.initial_conditions, "w") as f:
        f.write("r,l,h,u,v,ub,vb,wb\n")
        for i in range(len(r)):
            f.write(f"{r[i]},{lam[i]},0.0,0.0,{v[i]},0.0,{0.8*v[i]},0.0\n")
    return model


def _write_sounding(path, zmax=10000.0):
    zs = np.linspace(0.0, zmax * 1.2, 50)
    theta = 300.0 + 0.004 * zs
    qv = 12.0 * np.exp(-zs / 2500.0)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    return path


def _rz_setup(eqset, vars_, ts):
    """RZ semi-implicit configs: the 'hard path' (Helmholtz column solve +
    condensation adjustment) that round-1 sharding tests skipped."""

    def setup(tmp_path):
        gp = GridParameters(
            geometry="RZ",
            xmin=0.0,
            xmax=10000.0,
            num_cells=32,
            zmin=0.0,
            zmax=10000.0,
            zDim=30,
            BCL={"u": BC.R1T0, "w": BC.R1T1},
            BCR={"u": BC.R1T0},
            vars=vars_,
        )
        model = ModelParameters(
            ts=ts,
            integration_time=10 * ts,
            output_interval=10 * ts,
            equation_set=eqset,
            initial_conditions=str(tmp_path / "ics.csv"),
            output_dir=str(tmp_path / "out"),
            ref_state_file=_write_sounding(str(tmp_path / "sounding.txt")),
            grid_params=gp,
            physical_params={"K": 5.0},
            options={"semiimplicit": True},
        )
        grid = create_grid(gp, jnp.float64)
        pts = grid.gridpoints()
        r, z = pts[:, 0], pts[:, 1]
        rad = np.sqrt((r / 2000.0) ** 2 + ((z - 2000.0) / 2000.0) ** 2)
        s_pert = 3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
        names = list(vars_)
        with open(model.initial_conditions, "w") as f:
            f.write("r,z," + ",".join(names) + "\n")
            for i in range(len(r)):
                vals = {"s": s_pert[i]}
                f.write(
                    f"{r[i]},{z[i]},"
                    + ",".join(str(vals.get(n, 0.0)) for n in names)
                    + "\n"
                )
        return model

    return setup


_euler_rz_setup = _rz_setup(
    "Euler_test", {"s": 1, "xi": 2, "mu": 3, "u": 4, "w": 5}, ts=0.15
)
_moist_rz_setup = _rz_setup(
    "rainfall_test",
    {"s": 1, "xi": 2, "mu": 3, "u": 4, "w": 5, "mu_c": 6, "mu_r": 7, "qss": 8},
    ts=0.1,
)


@pytest.mark.parametrize("method", ["psum", "halo", "halo-pcr"])
@pytest.mark.parametrize(
    "setup", [_advection_setup, _slab_setup, _euler_rz_setup, _moist_rz_setup]
)
def test_sharded_matches_single(tmp_path, setup, method):
    model = setup(tmp_path)
    n_steps = 10
    method, interface = (
        ("halo", "pcr") if method == "halo-pcr" else (method, "gather")
    )

    grid, ctx, state = initialize(model)
    step = build_step(model, grid, ctx, jnp.float64)
    ref = make_scan(step, n_steps)(state)

    mesh = sh.make_mesh(8)
    grid2, ctx2, state2 = sh.initialize_sharded(model, mesh, method=method)
    sstep = sh.build_sharded_step(
        model, grid2, ctx2, jnp.float64, mesh, method, interface
    )
    out = make_scan(sstep, n_steps)(state2)

    spec = np.asarray(out.spec)
    if method == "halo":
        spec = np.asarray(sh.blocks_to_spec(out.spec, 8, grid.params.num_cells // 8))
    np.testing.assert_allclose(
        spec, np.asarray(ref.spec), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.expdot_nm1), np.asarray(ref.expdot_nm1), rtol=1e-12, atol=1e-12
    )


def test_mesh_size_must_divide_cells(tmp_path):
    model = _advection_setup(tmp_path, num_cells=97)
    mesh = sh.make_mesh(8)
    with pytest.raises(ValueError):
        sh.initialize_sharded(model, mesh)


@pytest.mark.parametrize("method", ["psum", "halo", "halo-pcr"])
def test_sharded_matches_single_fastderiv(tmp_path, method):
    """Compensated + single-pass-bf16-derivative mode (the compensated
    production bundle) through the sharded paths: the fast radial operators must be
    sliced per shard exactly like the compensated stacks.  f32 sum-order
    noise bounds the agreement (~1e-4 relative here, measured identical
    with deriv_single on and off); a slicing bug would be O(1) or a shape
    error."""
    from scythe_tpu import io as sio
    from scythe_tpu import timeintegration as ti
    from scythe_tpu.model import build_context

    model = _slab_setup(tmp_path)
    n_steps = 5
    method, interface = (
        ("halo", "pcr") if method == "halo-pcr" else (method, "gather")
    )

    grid_f = create_grid(model.grid_params, jnp.float32, matmul="compensated")
    assert grid_f.fast
    ctx_f = build_context(model, grid_f, jnp.float32)
    step = build_step(model, grid_f, ctx_f, jnp.float32)
    phys0 = sio.read_physical_grid(model.initial_conditions, grid_f)
    spec0 = grid_f.analysis(jnp.asarray(phys0, jnp.float32))
    state = ti.initial_state(
        spec0, (grid_f.nvars,) + grid_f.spatial_shape, jnp.float32
    )
    ref = make_scan(step, n_steps)(state)

    mesh = sh.make_mesh(8)
    grid2, ctx2, state2 = sh.initialize_sharded(
        model, mesh, jnp.float32, method=method, matmul="compensated"
    )
    assert grid2.fast
    sstep = sh.build_sharded_step(
        model, grid2, ctx2, jnp.float32, mesh, method, interface
    )
    out = make_scan(sstep, n_steps)(state2)

    spec = np.asarray(out.spec)
    if method == "halo":
        spec = np.asarray(
            sh.blocks_to_spec(out.spec, 8, grid2.params.num_cells // 8)
        )
    scale = np.abs(np.asarray(ref.spec)).max()
    assert np.abs(spec - np.asarray(ref.spec)).max() < 1e-3 * scale


@pytest.mark.parametrize("method", ["psum", "halo", "halo-pcr"])
@pytest.mark.parametrize("setup", [_advection_setup, _slab_setup, _moist_rz_setup])
def test_modal_filter_sharded_matches_single(tmp_path, setup, method):
    """The per-step modal filter (the convection-permitting stabilizer)
    must compose with every sharded analysis path: psum applies the
    canonical filter to the replicated spectral state; halo gathers the
    small windowed state once at filter time (parallel/sharding.py).
    The advection setup exercises the PERIODIC circulant radial factor."""
    import dataclasses

    model = setup(tmp_path)
    model = dataclasses.replace(
        model, options={**model.opts(), "modal_filter_tau": 30.0}
    )
    n_steps = 5
    method, interface = (
        ("halo", "pcr") if method == "halo-pcr" else (method, "gather")
    )

    grid, ctx, state = initialize(model)
    step = build_step(model, grid, ctx, jnp.float64)
    ref = make_scan(step, n_steps)(state)

    mesh = sh.make_mesh(8)
    grid2, ctx2, state2 = sh.initialize_sharded(model, mesh, method=method)
    sstep = sh.build_sharded_step(
        model, grid2, ctx2, jnp.float64, mesh, method, interface
    )
    out = make_scan(sstep, n_steps)(state2)

    spec = np.asarray(out.spec)
    if method == "halo":
        spec = np.asarray(
            sh.blocks_to_spec(out.spec, 8, grid.params.num_cells // 8)
        )
    np.testing.assert_allclose(
        spec, np.asarray(ref.spec), rtol=1e-12, atol=1e-12
    )


def _moist_rlz_ivd_setup(tmp_path):
    """MoistEulerRLZ with implicit vertical diffusion + Smagorinsky: the
    TC-production option set (tc_sweep4).  The vdiff solve is per-column
    (z is never sharded) so every method must stay 1e-12-invariant."""
    gp = GridParameters(
        geometry="RLZ",
        xmin=0.0,
        xmax=100.0e3,
        num_cells=32,
        lDim=4,
        zmin=0.0,
        zmax=10000.0,
        zDim=16,
        BCL={"u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0},
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "mu_r": ZBC.R1T1, "w": ZBC.R1T0},
        vars={"s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
              "mu_c": 7, "mu_r": 8, "qss": 9},
    )
    model = ModelParameters(
        ts=0.5,
        integration_time=5.0,
        output_interval=5.0,
        equation_set="MoistEulerRLZ",
        initial_conditions=str(tmp_path / "ics_rlz.csv"),
        output_dir=str(tmp_path / "out"),
        ref_state_file=_write_sounding(str(tmp_path / "snd_rlz.txt")),
        grid_params=gp,
        physical_params={"K": 5.0, "f": 5.0e-5},
        options={"semiimplicit": True, "stiff_relaxation": "exp",
                 "implicit_vdiff": True, "smagorinsky": 0.2},
    )
    grid = create_grid(gp, jnp.float64)
    pts = grid.gridpoints()
    r, z = pts[:, 0], pts[:, 2]
    rad = np.sqrt(((r - 40.0e3) / 20.0e3) ** 2 + ((z - 2000.0) / 2000.0) ** 2)
    s_pert = 3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    names = list(gp.vars)
    with open(model.initial_conditions, "w") as f:
        f.write("r,l,z," + ",".join(names) + "\n")
        for i in range(len(r)):
            vals = {"s": s_pert[i], "u": 1.0}
            f.write(
                f"{r[i]},{pts[i, 1]},{z[i]},"
                + ",".join(str(vals.get(n, 0.0)) for n in names) + "\n"
            )
    return model


@pytest.mark.parametrize("method", ["psum", "halo", "halo-pcr"])
def test_implicit_vdiff_sharded_matches_single(tmp_path, method):
    model = _moist_rlz_ivd_setup(tmp_path)
    n_steps = 6
    method, interface = (
        ("halo", "pcr") if method == "halo-pcr" else (method, "gather")
    )
    grid, ctx, state = initialize(model)
    step = build_step(model, grid, ctx, jnp.float64)
    ref = make_scan(step, n_steps)(state)

    mesh = sh.make_mesh(8)
    grid2, ctx2, state2 = sh.initialize_sharded(model, mesh, method=method)
    sstep = sh.build_sharded_step(
        model, grid2, ctx2, jnp.float64, mesh, method, interface
    )
    out = make_scan(sstep, n_steps)(state2)
    spec = np.asarray(out.spec)
    if method == "halo":
        spec = np.asarray(
            sh.blocks_to_spec(out.spec, 8, grid.params.num_cells // 8)
        )
    np.testing.assert_allclose(
        spec, np.asarray(ref.spec), rtol=1e-12, atol=1e-12
    )


def test_modal_filter_periodic_seam_uniform():
    """The periodic radial filter factor must be translation-invariant
    across the cell seam (circulant within range(T)): damping a
    one-cell-shifted field equals shifting the damped field.  Pins the
    circulant D2 form (a raw interior stencil double-counts the
    seam-centered difference and breaks this)."""
    from scythe_tpu.model import build_modal_filter

    gp = GridParameters(
        geometry="R",
        xmin=0.0,
        xmax=96.0,
        num_cells=32,
        BCL={"u": BC.PERIODIC},
        BCR={"u": BC.PERIODIC},
        vars={"u": 1},
    )
    grid = create_grid(gp, jnp.float64)
    filt = build_modal_filter(grid, tau=10.0, order=4, ts=1.0, dtype=jnp.float64)
    r = grid.r_mish
    dx = 96.0 / 32
    f = np.exp(-(((r - 20.0) % 96.0 - 48.0) / 6.0) ** 2) + 0.3 * np.sin(
        2 * np.pi * 5 * r / 96.0
    )
    f_shift = np.exp(
        -(((r - 20.0 - dx) % 96.0 - 48.0) / 6.0) ** 2
    ) + 0.3 * np.sin(2 * np.pi * 5 * (r - dx) / 96.0)
    spec = grid.analysis(jnp.asarray(f[None], jnp.float64))
    spec_s = grid.analysis(jnp.asarray(f_shift[None], jnp.float64))
    out = np.asarray(grid.synthesis(filt(spec))["val"])[0]
    out_s = np.asarray(grid.synthesis(filt(spec_s))["val"])[0]
    # shifting by one cell = rolling the mish points by mubar (3)
    np.testing.assert_allclose(np.roll(out, 3), out_s, rtol=1e-10, atol=1e-12)


def _williamson5_setup(tmp_path):
    """Williamson case 5 (flow over a mountain) via the file-driven
    topography path — the config whose mountain a sharded run used to
    silently drop (initialize_sharded never called _set_topography)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "williamson_example",
        os.path.join(
            os.path.dirname(__file__), "..", "examples", "williamson_sphere.py"
        ),
    )
    wm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wm)

    model = wm.build_model(ts=200.0, t_end=2000.0).with_(
        initial_conditions=str(tmp_path / "ics.csv"),
        output_dir=str(tmp_path / "out"),
        options={"topography_file": str(tmp_path / "topo.csv")},
    )
    grid = create_grid(model.grid_params, jnp.float64)
    pts = grid.gridpoints()
    phi = pts[:, 0].reshape(grid.spatial_shape)
    lam = pts[:, 1].reshape(grid.spatial_shape)
    h5, u5, v5, hs = wm.w5_fields(phi, lam)
    with open(model.initial_conditions, "w") as f:
        f.write("lat,lon,h,u,v\n")
        for a, b, c, d, e in zip(
            pts[:, 0], pts[:, 1], h5.ravel(), u5.ravel(), v5.ravel()
        ):
            f.write(f"{a},{b},{c},{d},{e}\n")
    with open(tmp_path / "topo.csv", "w") as f:
        f.write("lat,lon,hs\n")
        for a, b, c in zip(pts[:, 0], pts[:, 1], hs.ravel()):
            f.write(f"{a},{b},{c}\n")
    return model


@pytest.mark.parametrize("method", ["psum", "halo", "halo-pcr"])
def test_sharded_topography_matches_single(tmp_path, method):
    """Sharded Williamson-5: the mountain must survive initialize_sharded
    (hs_grad present and correctly sliced per shard) and the sharded run
    must match the single-device run to 1e-12."""
    model = _williamson5_setup(tmp_path)
    n_steps = 10
    method, interface = (
        ("halo", "pcr") if method == "halo-pcr" else (method, "gather")
    )

    grid, ctx, state = initialize(model)
    assert "hs_grad" in ctx.extras
    step = build_step(model, grid, ctx, jnp.float64)
    ref = make_scan(step, n_steps)(state)

    mesh = sh.make_mesh(8)
    grid2, ctx2, state2 = sh.initialize_sharded(model, mesh, method=method)
    assert "hs_grad" in ctx2.extras  # the round-3 silent-drop regression
    sstep = sh.build_sharded_step(
        model, grid2, ctx2, jnp.float64, mesh, method, interface
    )
    out = make_scan(sstep, n_steps)(state2)

    spec = np.asarray(out.spec)
    if method == "halo":
        spec = np.asarray(
            sh.blocks_to_spec(out.spec, 8, grid.params.num_cells // 8)
        )
    # h is O(5e3) m here, so the 1e-12 absolute floor used by the
    # perturbation-scale setups sits below f64 reduction-order noise;
    # scale it by the field magnitude (~5e-9 abs == 1e-12 relative).
    scale = np.abs(np.asarray(ref.spec)).max()
    np.testing.assert_allclose(
        spec, np.asarray(ref.spec), rtol=1e-10, atol=1e-12 * scale
    )
