"""Grid I/O: CSV interchange (reference-compatible schema) + binary
checkpointing.

The reference reads initial conditions from CSV (columns = coordinates then
variables by name, e.g. ``r,l,h,u,...``; ref read_physical_grid call,
semiimplicit.jl:134 and the notebook IC cells) and writes
``physical_out_<t>.csv`` in the same schema, which doubles as its
checkpoint/restart mechanism (SURVEY.md 5).  We keep that interchange format
(row order = this grid's flattened gridpoint order) and add a fast binary
npz checkpoint holding the full multistep state.

When the native C extension (native/scythe_io.cpp) is built it accelerates
CSV parse/format; otherwise numpy fallbacks are used.
"""

from __future__ import annotations

import os

import numpy as np

# `make native` builds the extension here (native/setup.py build_ext --inplace)
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)


def load_native(directory: str = NATIVE_DIR):
    """The native CSV extension built in ``directory``, or None when it has
    not been built there (hosts without a compiler keep the numpy path)."""
    import glob
    import importlib.util

    for path in sorted(glob.glob(os.path.join(directory, "scythe_native_io*.so"))):
        spec = importlib.util.spec_from_file_location("scythe_native_io", path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except ImportError:  # built for another interpreter
            continue
        return mod
    return None


_nio = load_native()


def _read_csv(path: str) -> tuple[list[str], np.ndarray]:
    if _nio is not None:
        names, nrows, ncols, raw = _nio.read_csv(path)
        data = np.frombuffer(raw, dtype=np.float64).reshape(nrows, ncols)
        return list(names), data
    with open(path) as f:
        header = f.readline().strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return header, data


def _write_csv(path: str, names: list[str], cols: np.ndarray) -> None:
    if _nio is not None:
        arr = np.ascontiguousarray(cols, np.float64)
        _nio.write_csv(path, list(names), arr.data, arr.shape[0], arr.shape[1])
        return
    header = ",".join(names)
    np.savetxt(path, cols, delimiter=",", header=header, comments="", fmt="%.17g")


_COORD_NAMES = {
    "R": ["r"],
    "RL": ["r", "l"],
    "RZ": ["r", "z"],
    "RLZ": ["r", "l", "z"],
    "XYZ": ["x", "y", "z"],
    "SL": ["lat", "lon"],
    "SLZ": ["lat", "lon", "z"],
}


def read_physical_grid(path: str, grid) -> np.ndarray:
    """IC CSV (or .nc) -> [nvars, *spatial] float64 (ref
    read_physical_grid)."""
    if path.endswith(".nc"):
        return read_physical_grid_nc(path, grid)
    names, data = _read_csv(path)
    p = grid.params
    npts = grid.num_points
    if data.shape[0] != npts:
        raise ValueError(
            f"IC file {path} has {data.shape[0]} rows; grid has {npts} points"
        )
    out = np.zeros((p.nvars,) + grid.spatial_shape)
    for v, name in enumerate(p.vars):
        if name not in names:
            raise ValueError(f"IC file missing variable column {name!r}")
        out[v] = data[:, names.index(name)].reshape(grid.spatial_shape)
    return out


def write_output(grid, model, t: float, phys: np.ndarray) -> str:
    """Write ``physical_out_<t>.csv`` (ref write_output, src/io.jl:3-13),
    or CF NetCDF when ``options['output_format'] == 'nc'`` (the reference
    README names NetCDF as its own planned output path)."""
    if model.opts().get("output_format") == "nc":
        return write_output_nc(grid, model, t, phys)
    os.makedirs(model.output_dir, exist_ok=True)
    time = str(round(float(t), 2))
    path = os.path.join(model.output_dir, f"physical_out_{time}.csv")
    coords = grid.gridpoints()
    names = list(_COORD_NAMES[grid.geometry]) + list(grid.params.vars)
    cols = np.concatenate(
        [coords] + [np.asarray(phys[v]).reshape(-1, 1) for v in range(grid.nvars)],
        axis=1,
    )
    _write_csv(path, names, cols)
    return path


def write_spectral(grid, model, t: float, spec) -> str:
    """Write ``spectral_out_<t>.csv``: flattened coefficient index +
    one column per variable (the reference's write_grid also exports the
    spectral state, src/io.jl:11 -> Springsteel write_grid; notebooks
    only consume the physical CSV, so a flat-index schema suffices for
    interchange/restart tooling).  Opt-in via
    ``options['write_spectral']``."""
    os.makedirs(model.output_dir, exist_ok=True)
    time = str(round(float(t), 2))
    path = os.path.join(model.output_dir, f"spectral_out_{time}.csv")
    arr = np.asarray(spec, np.float64).reshape(grid.nvars, -1)
    idx = np.arange(arr.shape[1], dtype=np.float64).reshape(-1, 1)
    cols = np.concatenate([idx] + [arr[v].reshape(-1, 1)
                                   for v in range(grid.nvars)], axis=1)
    _write_csv(path, ["coeff"] + list(grid.params.vars), cols)
    return path


_CF_COORDS = {
    "r": ("radius", "m"),
    "l": ("azimuth", "radian"),
    "z": ("height", "m"),
    "x": ("x", "m"),
    "y": ("y", "m"),
    "lat": ("latitude", "radian"),
    "lon": ("longitude", "radian"),
}


def _grid_coords(grid) -> dict[str, np.ndarray]:
    from .basis import fourier

    names = _COORD_NAMES[grid.geometry]
    out = {names[0]: np.asarray(grid.r_mish, np.float64)}
    for key in ("l", "lon"):
        if key in names:
            out[key] = fourier.angles(grid.nl)
    if "y" in names:
        out["y"] = grid._y_points()
    if "z" in names:
        out["z"] = np.asarray(grid.z_mish, np.float64)
    return out


def write_output_nc(grid, model, t: float, phys: np.ndarray) -> str:
    """CF-style NetCDF (classic format via scipy, no extra deps):
    coordinate variables with units + one [r(,l)(,z)] variable per model
    field + global metadata.  One file per output time, mirroring the CSV
    naming so restart tooling treats both formats alike."""
    from scipy.io import netcdf_file

    os.makedirs(model.output_dir, exist_ok=True)
    time = str(round(float(t), 2))
    path = os.path.join(model.output_dir, f"physical_out_{time}.nc")
    dims = _COORD_NAMES[grid.geometry]
    coords = _grid_coords(grid)
    with netcdf_file(path, "w") as f:
        f.title = f"scythe-tpu {model.equation_set} output"
        f.equation_set = model.equation_set
        f.geometry = grid.geometry
        f.time_seconds = float(t)
        for d in dims:
            f.createDimension(d, len(coords[d]))
            cv = f.createVariable(d, "d", (d,))
            cv[:] = coords[d]
            cv.long_name, cv.units = _CF_COORDS[d]
        for v, name in enumerate(grid.params.vars):
            var = f.createVariable(name, "d", tuple(dims))
            var[:] = np.asarray(phys[v], np.float64)
    return path


def read_physical_grid_nc(path: str, grid) -> np.ndarray:
    """NetCDF counterpart of ``read_physical_grid`` (ICs or restart)."""
    from scipy.io import netcdf_file

    p = grid.params
    out = np.zeros((p.nvars,) + grid.spatial_shape)
    with netcdf_file(path, "r", mmap=False) as f:
        for v, name in enumerate(p.vars):
            if name not in f.variables:
                raise ValueError(f"NetCDF file missing variable {name!r}")
            data = np.asarray(f.variables[name][:], np.float64)
            if data.shape != grid.spatial_shape:
                raise ValueError(
                    f"{path}:{name} has shape {data.shape}; grid needs "
                    f"{grid.spatial_shape}"
                )
            out[v] = data
    return out


def save_checkpoint(path: str, state, t_sim: float) -> None:
    """Full-state binary checkpoint (spectral coefficients + multistep
    tendency history), enabling bitwise restart mid-ramp."""
    np.savez_compressed(
        path,
        spec=np.asarray(state.spec),
        expdot_nm1=np.asarray(state.expdot_nm1),
        expdot_nm2=np.asarray(state.expdot_nm2),
        impdot_nm1=np.asarray(state.impdot_nm1),
        impdot_nm2=np.asarray(state.impdot_nm2),
        t=np.asarray(state.t),
        t_sim=np.asarray(t_sim),
    )


def load_checkpoint(path: str, dtype=None):
    from .timeintegration import ModelState
    import jax.numpy as jnp

    with np.load(path) as d:
        cast = (lambda x: jnp.asarray(x, dtype)) if dtype else jnp.asarray
        state = ModelState(
            spec=cast(d["spec"]),
            expdot_nm1=cast(d["expdot_nm1"]),
            expdot_nm2=cast(d["expdot_nm2"]),
            impdot_nm1=cast(d["impdot_nm1"]),
            impdot_nm2=cast(d["impdot_nm2"]),
            t=jnp.asarray(d["t"]),
        )
        return state, float(d["t_sim"])


def check_cfl(grid, phys: np.ndarray) -> None:
    """Runtime health watchdog (ref checkCFL, semiimplicit.jl:737-751).

    The reference scans for NaN only; we also flag +/-inf (overflow reaches
    inf a few steps before NaN under IEEE arithmetic)."""
    for v, name in enumerate(grid.params.vars):
        bad = ~np.isfinite(np.asarray(phys[v]))
        if bad.any():
            idx = int(np.argwhere(bad.reshape(-1))[0][0])
            raise FloatingPointError(
                f"Non-finite value found in variable {name} at index {idx}! "
                "CFL condition likely violated"
            )
