"""Galewsky et al. (2004) barotropic-instability test on the SL sphere.

The modern standard nonlinear global shallow-water benchmark: a balanced
mid-latitude jet (u_max = 80 m/s between 25.7N and 64.3N) seeded with a
small height bump rolls up into a vortex train by day ~5 through
barotropic instability.

Measured here (f64, 128 lat cells ~ 0.47 deg x 512 lon, dt = 30 s,
K = 2e4 m^2/s; ~14 min CPU for 6 days):

    day:        1     2     3     4      5       6
    dev energy: 6.0   7.3   9.7   90   875    3899   [m^2, zonal-dev h]
    u_max:      78.0  76.3  75.1  75.1  74.7   74.1

i.e. exponential growth at ~e^2/day from day 3 (the published growth
rate) with the jet amplitude preserved to a few percent — the roll-up,
not diffusion.  At 64 cells (~0.94 deg) the spline l_q filter erodes the
sharp jet faster than the instability grows (u_max 80 -> 51 over 6 days,
no roll-up): this test genuinely needs the ~0.5 deg resolution its
authors prescribe.

Precision note: this example forces float64 (slow on the GPU, but it
works).  At f32-compensated the run is stable and reaches the same
saturated roll-up, but the bf16 noise floor seeds the unstable modes
~5 orders above f64 roundoff, so the growth phase completes by day ~5
(measured, docs/RESULTS.md) — use f64 when the growth rate itself is
the quantity of interest.

Usage:
    python examples/galewsky_instability.py [--cpu] [--cells 128]
        [--days 6]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

A_EARTH = 6.37122e6
OMEGA = 7.292e-5
G = 9.80616
PHI0, PHI1 = np.pi / 7, np.pi / 2 - np.pi / 7
UMAX = 80.0
_EN = np.exp(-4.0 / (PHI1 - PHI0) ** 2)


def u_jet(phi):
    inside = (phi > PHI0) & (phi < PHI1)
    with np.errstate(divide="ignore", over="ignore"):
        val = UMAX / _EN * np.exp(
            1.0 / np.where(inside, (phi - PHI0) * (phi - PHI1), -1.0)
        )
    return np.where(inside, val, 0.0)


def balanced_height(phi, h_mean=10000.0, n_quad=20001):
    """gh from gradient-wind balance of the jet (fine-grid quadrature)."""
    pf = np.linspace(-np.pi / 2, np.pi / 2, n_quad)
    uj = u_jet(pf)
    integ = A_EARTH * uj * (2 * OMEGA * np.sin(pf) + np.tan(pf) * uj / A_EARTH)
    gh = -np.concatenate(
        [[0.0], np.cumsum(0.5 * (integ[1:] + integ[:-1]) * np.diff(pf))]
    )
    gh = gh - gh.mean() + G * h_mean
    return np.interp(phi, pf, gh) / G


def bump(phi, lam, amp=120.0):
    lamc = lam - np.pi
    return (
        amp
        * np.cos(phi)
        * np.exp(-((lamc / (1.0 / 3.0)) ** 2))
        * np.exp(-((((np.pi / 4) - phi) / (1.0 / 15.0)) ** 2))
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cells", type=int, default=128)
    ap.add_argument("--days", type=int, default=6)
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from scythe_tpu import GridParameters, ModelParameters, create_grid
    from scythe_tpu import timeintegration as ti
    from scythe_tpu.model import _pick_chunk, build_context, build_step, make_scan

    gp = GridParameters(
        geometry="SL",
        xmin=-np.pi / 2,
        xmax=np.pi / 2,
        num_cells=args.cells,
        lDim=4 * args.cells,
        sphere_radius=A_EARTH,
        vars={"h": 1, "u": 2, "v": 3},
    )
    # pole-ring gravity CFL (williamson_sphere docstring)
    cos_inner = np.sin(0.1127 * np.pi / args.cells)
    ts = round(0.6 * A_EARTH * cos_inner / np.sqrt(G * 10000.0))
    model = ModelParameters(
        ts=float(ts),
        integration_time=args.days * 86400.0,
        output_interval=86400.0,
        equation_set="ShallowWaterSphere",
        initial_conditions="unused",
        output_dir="/tmp/galewsky",
        grid_params=gp,
        physical_params={"g": G, "Omega": OMEGA, "K": 2.0e4},
    )
    dtype = jnp.float64
    grid = create_grid(gp, dtype)
    ctx = build_context(model, grid, dtype)
    pts = grid.gridpoints()
    phi = pts[:, 0].reshape(grid.spatial_shape)
    lam = pts[:, 1].reshape(grid.spatial_shape)
    phys0 = np.stack(
        [balanced_height(phi) + bump(phi, lam), u_jet(phi), np.zeros_like(phi)]
    )
    spec0 = grid.analysis(jnp.asarray(phys0, dtype))
    state = ti.initial_state(spec0, (3,) + grid.spatial_shape, dtype)
    step = build_step(model, grid, ctx, dtype)
    steps_per_day = int(round(86400.0 / model.ts))
    chunk = _pick_chunk(steps_per_day)
    scan = make_scan(step, chunk)
    for day in range(args.days):
        for _ in range(steps_per_day // chunk):
            state = scan(state)
        rem = steps_per_day % chunk
        if rem:
            state = make_scan(step, rem)(state)
        out = np.asarray(grid.synthesis(state.spec)["val"])
        dev = out[0] - out[0].mean(axis=1, keepdims=True)
        print(
            f"day {day+1}: zonal-dev energy {float((dev**2).mean()):9.2f} m^2, "
            f"u_max {out[1].max():5.1f} m/s, finite={np.isfinite(out).all()}"
        )


if __name__ == "__main__":
    main()
