"""Discretely-balanced initialization (beyond-reference).

Analytic balanced states (e.g. the Jablonowski & Williamson 2006
eta-coordinate jet, or a gradient-wind TC vortex) satisfy the
CONTINUOUS balance equations, not the model's discrete ones: after
spectral fitting, the discrete pressure-gradient / Coriolis / buoyancy
operators leave O(1e-3 m/s^2) residual tendencies, and the state slides
toward its own discrete balance — measured on the SLZ JW06 shell as
~1-3 m/s/day jet loss and ~10 hPa of polar surface-pressure filling,
resolution-insensitive (docs/RESULTS.md, round 3/4).  Round 4 worked
around it with a 4-day "adjustment spinup"; this module removes the
drift at the source.

The approach exploits that the whole model is differentiable: find the
zonal-mean thermodynamic corrections (s, xi) that ZERO the model's own
instantaneous (v, w) tendencies — the discrete gradient-wind +
hydrostatic balance, by construction, including every term the step
actually applies (exact vertical PGF, reference-state cross terms,
curvature, metric factors).  Newton iteration with the exact Jacobian
via jax.jacfwd; the residual is nearly linear in (s, xi), so 2-3
iterations reach the float64 floor.

The solve runs on a SMALL-nl replica grid (default nl_solve=4): a
zonally-uniform state has only k=0 zonal content, and the latitudinal
B-spline fit of a ring-constant field is independent of the number of
points per ring, so the zonal-mean discrete operators — and therefore
the computed correction — are IDENTICAL to the production grid's while
the Jacobian build is ~nl/nl_solve times cheaper
(tests/test_jw06.py::test_balanced_init_transfers_across_nl pins the
transfer).

The reference has a 1-D analog only: reference_state.jl:96-108
re-integrates the hydrostatic column with the model's own Chebyshev
integral so the DISCRETE column is balanced.  This generalizes that
idea to the full 2-D (latitude-height) gradient-wind balance on the
model's actual operators.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .grids.base import create_grid
from .equations.common import get_equation_set


def _total_tendency(eqset, grid, ctx, phys):
    """The model's true instantaneous tendency of the fitted state,
    RE-FITTED through the spectral basis.

    Two deliberate choices:

    * ``expdot`` ALONE: the equation sets' expdot rows carry the FULL
      tendency (e.g. MoistEuler*'s xi row contains -w_z inside -div3,
      and the w row the full PGF), while ``impdot`` duplicates the
      linearized acoustic piece that the AI2* corrector subtracts from
      the explicit integration and re-adds implicitly
      (timeintegration.semiimplicit_adjustment; ref
      semiimplicit.jl:543-566).  Adding impdot would double-count the
      (si_scale-inflated) acoustic term — measured as a spurious
      9 m/s^2 "imbalance".
    * analysis->synthesis of the tendency: the model only ever
      integrates the FITTED tendency (calcTendency re-analyzes the
      stepped state), and the pointwise tendency carries fit-nullspace
      roughness no zonal-mean correction can touch.  Fitting first
      makes the residual ~fully controllable: measured 5000x residual
      reduction vs ~6x on the raw pointwise residual."""
    spec = grid.analysis(phys)
    fields = grid.synthesis(spec)
    res = eqset(fields, ctx)
    return grid.synthesis(grid.analysis(res.expdot))["val"]


def balance_zonal_state(
    model,
    zonal_mean,
    dtype=jnp.float64,
    correct=("s", "xi"),
    residual=("v", "w"),
    nl_solve=4,
    iters=3,
    jac_chunk=128,
    verbose=False,
    on_cpu=True,
):
    """Solve the model's discrete balance for a zonally-symmetric state.

    ``zonal_mean``: [nvars, rDim, zDim] zonal-mean physical fields (the
    analytic state to be balanced; rows for ``correct`` variables are
    adjusted, everything else — in particular the target wind — is held
    fixed).  Returns ``(balanced [nvars, rDim, zDim], info)`` where
    info records the residual max-norms per Newton iterate
    (info['history'][0] is the analytic state's own imbalance).

    The corrections live on the zonal mean only; add
    ``balanced - zonal_mean`` to the full 3-D field (broadcast over
    longitude) to balance a perturbed state.
    """
    import contextlib

    # The solve needs real float64 (the Newton floor is ~1e-14 on the
    # l_q=0 operators) and tiny matrices — run it on the CPU backend
    # even inside an accelerator session (both backends coexist in one
    # process, as in chip_smoke.py; callers must have jax.config
    # enable_x64 on).
    devctx = contextlib.nullcontext()
    if on_cpu:
        try:
            devctx = jax.default_device(jax.devices("cpu")[0])
        except RuntimeError:
            pass
    with devctx:
        return _balance_impl(
            model, zonal_mean, dtype, correct, residual, nl_solve, iters,
            jac_chunk, verbose,
        )


def _balance_impl(
    model, zonal_mean, dtype, correct, residual, nl_solve, iters,
    jac_chunk, verbose,
):
    gp = model.grid_params
    gp_s = dataclasses.replace(gp, lDim=int(nl_solve))
    grid = create_grid(gp_s, dtype)
    from .model import build_context

    ctx = build_context(model, grid, dtype)
    eqset = get_equation_set(model.equation_set)

    vi = grid.params.var_index
    ic = [vi(n) for n in correct]
    ir = [vi(n) for n in residual]
    nvars = grid.nvars
    rDim, nl, zDim = (
        grid.params.rDim,
        grid.nl,
        grid.params.zDim,
    )
    base = jnp.asarray(zonal_mean, dtype)[:, :, None, :] * jnp.ones(
        (1, 1, nl, 1), dtype
    )

    # unknown scaling: Newton is scale-invariant in exact arithmetic but
    # the lstsq fallback (rank-deficient Jacobian at masked pole rings)
    # is not; normalize s (J/kg/K) and xi (log density) to O(1)
    scales = jnp.asarray(
        [10.0 if n == "s" else 0.03 for n in correct], dtype
    )[:, None, None]

    def raw_residual(x):
        # x: [len(correct), rDim, zDim] scaled corrections
        phys = base
        for j, i in enumerate(ic):
            phys = phys.at[i].add((x[j] * scales[j])[:, None, :])
        tot = _total_tendency(eqset, grid, ctx, phys)
        # zonal mean of the residual rows (k=0 content; the state is
        # zonally uniform so this is exact, not a projection)
        return jnp.stack([tot[i].mean(axis=1) for i in ir])

    raw_residual = jax.jit(raw_residual)

    # per-row residual weights: the meridional (v) imbalance — the
    # actual jet-drift driver — is orders smaller than the hydrostatic
    # (w) one; unweighted least squares would ignore it entirely.
    # BOUNDED to a 100:1 ratio: when a row starts essentially balanced
    # (measured: v-row 1.5e-7 vs w-row 1.4e-2 at 48 cells) an unbounded
    # weight inflates its singular values ~5 orders and the relative
    # rcond truncation then discards every OTHER row's physics — the
    # round-5 production-resolution stall.
    r0 = raw_residual(jnp.zeros((len(ic), rDim, zDim), dtype))
    r0max = float(jnp.abs(r0).max())
    row_w = jnp.asarray(
        [
            1.0 / max(float(jnp.abs(r0[j]).max()), 1e-2 * r0max, 1e-30)
            for j in range(len(ir))
        ],
        dtype,
    )[:, None, None]

    def residual_fn(x):
        return raw_residual(x) * row_w

    n = len(ic) * rDim * zDim

    def jac(x):
        """Dense (weighted) Jacobian via chunked jacfwd (memory-bounded)."""

        def jvp_one(tangent):
            return jax.jvp(residual_fn, (x,), (tangent.reshape(x.shape),))[
                1
            ].reshape(-1)

        eye = jnp.eye(n, dtype=dtype)
        cols = []
        for s0 in range(0, n, jac_chunk):
            cols.append(jax.vmap(jvp_one)(eye[s0 : s0 + jac_chunk]))
        return jnp.concatenate(cols, axis=0).T  # [n_res, n]

    def maxnorm(x):
        return float(jnp.abs(raw_residual(x)).max())

    x = jnp.zeros((len(ic), rDim, zDim), dtype)
    history = [maxnorm(x)]
    for it in range(int(iters)):
        r = residual_fn(x)
        J = jac(x)
        # truncated-SVD solve: the gridpoint parametrization is ~3x
        # redundant against the B-spline x Chebyshev fit space, so J has
        # a large exact nullspace (sigma ~ 1e-10 relative) far below the
        # physical spectrum; rcond 1e-6 keeps the physical part —
        # measured 1100x one-step reduction at 48 cells — and discards
        # the nullspace (whose exploitation produced |ds| ~ 1e3 J/kg/K
        # nonphysical corrections on the unfitted residual; the fitted
        # residual + bounded row weights keep the gap wide)
        dx, *_ = jnp.linalg.lstsq(J, -r.reshape(-1), rcond=1e-6)
        dx = dx.reshape(x.shape)
        # backtracking line search on the weighted norm (the residual is
        # nearly linear but q_sat/thermo curvature can overshoot)
        best, best_x = None, None
        for step in (1.0, 0.5, 0.25, 0.1):
            cand = x + step * dx
            nrm = float(jnp.linalg.norm(residual_fn(cand)))
            if best is None or nrm < best:
                best, best_x = nrm, cand
        prev = float(jnp.linalg.norm(residual_fn(x)))
        if best >= prev:
            break  # no descent direction left
        x = best_x
        history.append(maxnorm(x))
        if verbose:
            print(f"balance iter {it + 1}: max|r| {history[-1]:.3e}")
        if history[-1] < 1e-14:
            break

    out = np.asarray(zonal_mean, np.float64).copy()
    for j, i in enumerate(ic):
        out[i] = out[i] + np.asarray(x[j] * scales[j], np.float64)
    return out, {"history": history, "n_unknowns": n}
