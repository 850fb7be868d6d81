"""Matmul precision: every f32 contraction of the main path carries an
explicit precision, the backend -> mode rule, the numerics canary's bound,
and the benchmark's peak table."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.extend.core import ClosedJaxpr, Jaxpr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402
from scythe_tpu.grids.base import create_grid, matmul_mode  # noqa: E402


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _dot_generals(sub)


def _flagship_step():
    from __graft_entry__ import _flagship_model, _vortex_state
    from scythe_tpu.model import build_context, build_step

    model = _flagship_model(num_cells=8, nl=16).with_(
        options={"radiation_width": 5.0e4, "sponge_width": 5.0e4}
    )
    grid = create_grid(model.grid_params, jnp.float32)
    ctx = build_context(model, grid, jnp.float32)
    state = _vortex_state(grid, jnp.float32)
    from scythe_tpu.model import _set_boundary_refs

    _set_boundary_refs(ctx, grid, state.spec)
    return build_step(model, grid, ctx, jnp.float32), state


def _moist_step():
    from scythe_tpu.model import build_context, build_step

    model = bench.moist3d_model(n_steps=2)
    model = model.with_(grid_params=dataclasses.replace(
        model.grid_params, num_cells=4, lDim=4, zDim=8))
    grid = create_grid(model.grid_params, jnp.float32)
    ctx = build_context(model, grid, jnp.float32)
    return (build_step(model, grid, ctx, jnp.float32),
            bench.moist3d_state(model, grid, jnp.float32))


@pytest.mark.parametrize("case", ["flagship_rl", "moist_rlz"])
def test_every_f32_contraction_has_explicit_precision(case):
    """No f32 dot_general of the step runs at DEFAULT precision (which a
    GPU may execute as TF32), and no float64 contraction leaks into an
    f32 step."""
    step, state = {"flagship_rl": _flagship_step, "moist_rlz": _moist_step}[case]()
    jaxpr = jax.make_jaxpr(step)(state).jaxpr
    dots = list(_dot_generals(jaxpr))
    assert len(dots) >= 5  # synthesis (3) + analysis (2) at least
    default = (lax.Precision.DEFAULT, lax.Precision.DEFAULT)
    for eqn in dots:
        dtypes = {v.aval.dtype for v in eqn.invars}
        assert jnp.float64 not in dtypes, eqn
        if dtypes == {jnp.dtype(jnp.float32)}:
            prec = eqn.params["precision"]
            assert prec is not None and prec != default, eqn


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_matmul_mode_rule(backend):
    """f32 and f64 states get full-precision plain contractions on every
    backend (chosen on the GPU by measurement, PERF.md)."""
    for dtype in (jnp.float32, jnp.float64):
        mode = matmul_mode(backend, dtype)
        assert mode == "plain"
        grid = create_grid(bench.canary_grid_params(), dtype, matmul=mode)
        assert not grid.comp and grid.precision == lax.Precision.HIGHEST


def _round_tf32(a):
    """Round float32 values to TF32's 10-bit mantissa (round half up on
    the magnitude), as a GPU's DEFAULT-precision f32 GEMM may."""
    u = np.asarray(a, np.float32).view(np.uint32).copy()
    u = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def test_canary_passes_f32_and_fails_tf32_operators():
    grid = create_grid(bench.canary_grid_params(), jnp.float32, matmul="plain")
    err_f32 = bench.canary_error(grid)
    assert err_f32 < bench.CANARY_TOL / 10
    rounded = {
        f.name: jnp.asarray(_round_tf32(getattr(grid, f.name)))
        for f in dataclasses.fields(grid)
        if isinstance(getattr(grid, f.name), jax.Array)
        and getattr(grid, f.name).dtype == jnp.float32
    }
    assert "l_all" in rounded and "synth_r" in rounded
    err_tf32 = bench.canary_error(dataclasses.replace(grid, **rounded))
    assert err_tf32 > bench.CANARY_TOL * 10


def test_peak_rates_known_and_unknown_devices():
    peaks = bench.peak_rates("NVIDIA H100 80GB HBM3")
    assert peaks["f32"] == 67e12 and peaks["hbm"] == 3.35e12
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peak_rates("cpu")
