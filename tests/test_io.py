"""IO tests: CSV round trips (native extension built from native/ + numpy
fallback), checkpointing."""

import subprocess
import sys

import numpy as np
import pytest

import scythe_tpu.io as sio


@pytest.fixture(scope="session")
def native(tmp_path_factory):
    """The native CSV extension, compiled from native/scythe_io.cpp into a
    temporary directory (the built .so is never committed)."""
    out = tmp_path_factory.mktemp("native")
    subprocess.run(
        [sys.executable, "setup.py", "-q", "build_ext",
         "--build-lib", str(out), "--build-temp", str(out / "tmp")],
        cwd=sio.NATIVE_DIR, check=True, capture_output=True, timeout=300,
    )
    mod = sio.load_native(str(out))
    assert mod is not None, "native extension built but did not load"
    return mod


def test_csv_roundtrip_fallback(tmp_path):
    path = str(tmp_path / "t.csv")
    cols = np.array([[1.0, 2.5], [3.0, -4.25], [1e-17, 1.23456789012345678]])
    names = ["r", "u"]
    # force the numpy fallback regardless of native availability
    nio = sio._nio
    sio._nio = None
    try:
        sio._write_csv(path, names, cols)
        names2, data = sio._read_csv(path)
    finally:
        sio._nio = nio
    assert names2 == names
    np.testing.assert_allclose(data, cols, rtol=0, atol=0)


def test_csv_roundtrip_native(tmp_path, native, monkeypatch):
    monkeypatch.setattr(sio, "_nio", native)
    path = str(tmp_path / "t.csv")
    rng = np.random.default_rng(0)
    cols = rng.normal(size=(257, 5)) * 10.0 ** rng.integers(-10, 10, size=(257, 5))
    names = ["r", "l", "h", "u", "v"]
    sio._write_csv(path, names, cols)
    names2, data = sio._read_csv(path)
    assert names2 == names
    np.testing.assert_allclose(data, cols, rtol=0, atol=0)  # %.17g is exact


def test_native_matches_fallback(tmp_path, native, monkeypatch):
    monkeypatch.setattr(sio, "_nio", native)
    path = str(tmp_path / "t.csv")
    cols = np.array([[0.1, 2.0], [3.0, 4.0]])
    sio._write_csv(path, ["a", "b"], cols)
    native = sio._read_csv(path)
    nio = sio._nio
    sio._nio = None
    try:
        fallback = sio._read_csv(path)
    finally:
        sio._nio = nio
    assert native[0] == fallback[0]
    np.testing.assert_array_equal(native[1], fallback[1])


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from scythe_tpu import timeintegration as ti

    spec = jnp.asarray(np.random.default_rng(1).normal(size=(2, 13)))
    state = ti.initial_state(spec, (2, 30), jnp.float64)
    state = state._replace(t=jnp.asarray(7))
    path = str(tmp_path / "ckpt.npz")
    sio.save_checkpoint(path, state, t_sim=21.0)
    state2, t_sim = sio.load_checkpoint(path)
    assert t_sim == 21.0
    assert int(state2.t) == 7
    np.testing.assert_array_equal(np.asarray(state2.spec), np.asarray(state.spec))


def test_netcdf_output_roundtrip(tmp_path):
    """--format nc: CF NetCDF output carries coordinates + all variables
    and reads back as initial conditions exactly (VERDICT missing #5)."""
    import jax.numpy as jnp

    from scythe_tpu import BC, GridParameters, ModelParameters, create_grid

    gp = GridParameters(
        geometry="RL",
        xmin=0.0,
        xmax=1.0e5,
        num_cells=8,
        lDim=16,
        BCL={"h": BC.R1T1, "u": BC.R1T0},
        BCR={"h": BC.R0, "u": BC.R0},
        vars={"h": 1, "u": 2},
    )
    model = ModelParameters(
        ts=1.0,
        integration_time=1.0,
        output_interval=1.0,
        equation_set="LinearAdvectionRL",
        initial_conditions="unused.csv",
        output_dir=str(tmp_path),
        grid_params=gp,
        options={"output_format": "nc"},
    )
    grid = create_grid(gp, jnp.float64)
    rng = np.random.default_rng(0)
    phys = rng.normal(size=(2,) + grid.spatial_shape)
    path = sio.write_output(grid, model, 42.0, phys)
    assert path.endswith("physical_out_42.0.nc")

    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        assert f.geometry.decode() == "RL"
        assert float(f.time_seconds) == 42.0
        np.testing.assert_allclose(f.variables["r"][:], grid.r_mish)
        assert f.variables["r"].units == b"m"
        assert f.variables["h"].shape == grid.spatial_shape

    back = sio.read_physical_grid(path, grid)
    np.testing.assert_array_equal(back, phys)


def test_netcdf_missing_variable_errors(tmp_path):
    import jax.numpy as jnp

    from scythe_tpu import BC, GridParameters, create_grid
    from scipy.io import netcdf_file

    gp = GridParameters(
        geometry="R", xmin=0.0, xmax=1.0, num_cells=4,
        BCL={"u": BC.R0}, BCR={"u": BC.R0}, vars={"u": 1},
    )
    grid = create_grid(gp, jnp.float64)
    path = str(tmp_path / "bad.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("r", 12)
    with pytest.raises(ValueError, match="missing variable"):
        sio.read_physical_grid(path, grid)


def test_write_spectral(tmp_path):
    """options['write_spectral'] emits spectral_out_<t>.csv whose columns
    reproduce the coefficient state bitwise (the reference's write_grid
    also exports spectral state, src/io.jl:11)."""
    import jax.numpy as jnp

    from scythe_tpu import BC, GridParameters, ModelParameters, create_grid

    gp = GridParameters(
        geometry="R", xmin=0.0, xmax=10.0, num_cells=8,
        BCL={"u": BC.PERIODIC}, BCR={"u": BC.PERIODIC}, vars={"u": 1},
    )
    model = ModelParameters(
        ts=0.1, integration_time=1.0, output_interval=1.0,
        equation_set="LinearAdvection1D",
        initial_conditions="unused", output_dir=str(tmp_path),
        grid_params=gp, physical_params={"c_0": 1.0, "K": 0.0},
        options={"write_spectral": True},
    )
    grid = create_grid(gp, jnp.float64)
    r = np.asarray(grid.r_mish)
    spec = grid.analysis(jnp.asarray(np.sin(2 * np.pi * r / 10.0)[None]))
    path = sio.write_spectral(grid, model, 0.0, spec)
    names, data = sio._read_csv(path)
    assert names == ["coeff", "u"]
    np.testing.assert_array_equal(data[:, 1], np.asarray(spec[0]))
