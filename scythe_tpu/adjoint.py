"""Differentiable integration: reverse-mode AD through the full core.

The reference core (mmbell/Scythe.jl) mutates per-column state in place
and has no adjoint or sensitivity path of any kind.  Because this
re-architecture expresses the entire step as a pure function of state
(model.build_step: synthesis -> pointwise tendencies -> AB3/AI2* ->
semi-implicit solve -> analysis), `jax.grad` composes through the whole
integration for free — exact discrete adjoints of the real production
step, not a hand-derived approximation.  That enables parameter
estimation, 4D-Var-style calibration, and sensitivity analysis on the
accelerator
(examples/calibrate_drag.py recovers the slab-TCBL drag coefficient from
synthetic observations by gradient descent).

`make_simulator` returns a pure `sim(params, phys0) -> final fields`
suitable for `jax.jit`, `jax.grad`, and `jax.vmap` (ensemble
sensitivities batch through the same GEMMs as `integrate_ensemble`).
Per-step `jax.checkpoint` rematerialization keeps reverse-mode memory at
O(state) per step instead of O(n_steps) intermediates.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import timeintegration as ti
from .config import ModelParameters
from .grids.base import create_grid
from .model import (
    _pick_chunk,
    _set_boundary_refs,
    build_context,
    build_step,
    default_dtype,
    infer_radiation_speed,
)


def make_simulator(
    model: ModelParameters,
    dtype=None,
    n_steps: int | None = None,
    remat: bool = True,
):
    """Build a differentiable end-to-end simulator for ``model``.

    Returns ``(sim, grid, ctx)`` where ``sim(params, phys0)`` integrates
    ``n_steps`` (default: the model's full ``integration_time/ts``) from
    the physical initial fields ``phys0`` ([nvars, *spatial]) and returns
    the final physical fields.

    ``params`` is a dict of physical-parameter overrides (a subset of
    ``model.physical_params`` keys, e.g. ``{"Cd": cd}``); its values are
    traced, so ``jax.grad(loss_fn)(params)`` differentiates the whole
    nonlinear integration with respect to them.  Gradients with respect
    to ``phys0`` (initial-condition sensitivity / 4D-Var) come from the
    second argument.

    Caveats: parameters that feed *setup-time* scalars — the
    semi-implicit Helmholtz operator (built from the reference state),
    an inferred ``radiation_speed`` — are baked in at their static values;
    override ``options['radiation_speed']`` explicitly when calibrating
    ``g``/``H``.  Equation sets that branch in Python on a parameter
    (e.g. LinearAdvectionRL's ``if K > 0``) need that parameter left
    static.

    ``remat=True`` (default) wraps each step in ``jax.checkpoint`` so the
    backward pass rematerializes per-step intermediates instead of
    storing them — required for long integrations.
    """
    dtype = dtype or default_dtype()
    opts = model.opts()
    if opts.get("radiation_width") and not opts.get("radiation_speed"):
        # resolve the setup-time wave speed from the STATIC base params
        # now, so traced params inside sim never reach the float() in
        # build_step's radiation branch (the "baked in" promise above)
        model = model.with_(
            options={
                **opts,
                "radiation_speed": infer_radiation_speed(model.phys(), opts),
            }
        )
    grid = create_grid(model.grid_params, dtype)
    base_ctx = build_context(model, grid, dtype)
    n = model.num_ts if n_steps is None else int(n_steps)
    # bounded scan lengths (CLAUDE.md): trace one <=384-step chunk once
    # and scan over chunks — compile time stays flat in n even for the
    # 28,800-step flagship, and per-step remat still bounds memory
    chunk = max(1, _pick_chunk(n))

    def sim(params: dict, phys0):
        phys0 = jnp.asarray(phys0, dtype)
        ctx = dataclasses.replace(
            base_ctx,
            params={**base_ctx.params, **params},
            extras=dict(base_ctx.extras),
        )
        spec0 = grid.analysis(phys0)
        _set_boundary_refs(ctx, grid, spec0)
        step = build_step(model, grid, ctx, dtype)
        step_fn = jax.checkpoint(step) if remat else step
        state = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype)

        def body(s, _):
            return step_fn(s), None

        def chunk_body(s, _):
            out, _ = jax.lax.scan(body, s, None, length=chunk)
            return out, None

        out, _ = jax.lax.scan(chunk_body, state, None, length=n // chunk)
        return grid.synthesis(out.spec)["val"]

    return sim, grid, base_ctx


def fit_parameters(
    sim,
    init_params: dict,
    phys0,
    observations,
    *,
    steps: int = 100,
    learning_rate: float = 0.1,
    log_space: bool = True,
    obs_slice=None,
):
    """Recover physical parameters from observed final fields by Adam.

    Minimizes the mean-squared misfit between ``sim(params, phys0)`` and
    ``observations`` (optionally restricted to ``obs_slice``, e.g. a
    single observed variable).  ``log_space=True`` (default) optimizes
    ``log(param)`` — the natural parameterization for positive physical
    coefficients spanning decades (drag coefficients, diffusivities).

    Returns ``(params, history)`` with ``history`` the per-iteration loss.
    Uses optax's Adam; one jitted value-and-grad per iteration.
    """
    import optax

    names = sorted(init_params)

    def pack(p):
        return jnp.stack([jnp.log(p[k]) if log_space else jnp.asarray(p[k]) for k in names])

    def unpack(vec):
        return {
            k: (jnp.exp(vec[i]) if log_space else vec[i])
            for i, k in enumerate(names)
        }

    obs = jnp.asarray(observations)

    def loss_fn(vec):
        out = sim(unpack(vec), phys0)
        if obs_slice is not None:
            out = out[obs_slice]
        denom = jnp.mean(obs * obs) + 1e-30
        return jnp.mean((out - obs) ** 2) / denom

    opt = optax.adam(learning_rate)
    vec = pack({k: jnp.asarray(v) for k, v in init_params.items()})
    opt_state = opt.init(vec)
    vg = jax.jit(jax.value_and_grad(loss_fn))

    history = []
    for _ in range(steps):
        loss, g = vg(vec)
        history.append(float(loss))
        updates, opt_state = opt.update(g, opt_state)
        vec = optax.apply_updates(vec, updates)
    return {k: float(v) for k, v in unpack(vec).items()}, history
