"""Flagship 24 h Twoway run: f32 stability sweep on the current device.

Round-1 left the production (f32 compensated) path NaN-ing at t~9 h of
the 24 h Cha & Bell Twoway experiment (docs/RESULTS.md).  This sweeps
stabilization candidates back-to-back in one process: horizontal diffusion K and the spline filter cutoff l_q, recording
Vmax / h_min every 30 model-minutes and the first non-finite time.

Usage:
  python tools/flagship_stability.py            # full sweep on the GPU
  python tools/flagship_stability.py --f64-cpu  # float64 CPU reference run
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "models", "cha_bell2024"))
sys.path.insert(0, os.path.join(REPO, "examples"))

RMAX = 50000.0
VMAX = 50.0


def build_ics(workdir, dtype):
    """Rankine ICs -> 3 h symmetric spinup -> wave-2 perturbation CSV."""
    import cha_bell_initialization as cbi
    from oneway_spinup import model as spinup_model
    from scythe_tpu import create_grid, integrate_model

    cached = os.path.join(workdir, "SWslab_wave2.csv")
    if os.path.exists(cached):
        print("reusing cached wave-2 ICs", flush=True)
        return cached
    spinup_model = spinup_model.with_(
        initial_conditions=os.path.join(workdir, "rankine.csv"),
        output_dir=os.path.join(workdir, "spinup"),
    )
    grid = create_grid(spinup_model.grid_params, dtype)
    cbi.write_rankine_ics(grid, spinup_model.initial_conditions)
    t0 = time.time()
    integrate_model(spinup_model, dtype=dtype)
    print(f"spinup done in {time.time()-t0:.1f}s", flush=True)
    balanced = os.path.join(
        spinup_model.output_dir,
        f"physical_out_{round(spinup_model.integration_time, 2)}.csv",
    )
    wave2 = os.path.join(workdir, "SWslab_wave2.csv")
    cbi.add_wave2(grid, balanced, wave2)
    return wave2


def run_flagship(model, dtype, label="", extra_series=None):
    """Shared chunked flagship-integration harness (used by this sweep,
    validate_fastderiv.py, and flagship_radiation.py): integrate ``model``
    in 30-model-minute scan chunks with a non-finite watchdog, recording
    the Vmax/hmin intensity timeseries plus any ``extra_series``
    ({name: fn(phys)->float}).  Returns a dict with ``times_h``, ``vmax``,
    ``hmin``, ``failed_at_h`` (None if it completes), ``wall_s`` and the
    extra series."""
    from scythe_tpu.model import build_step, initialize, make_scan

    grid, ctx, state = initialize(model, dtype)
    step = build_step(model, grid, ctx, dtype)
    chunk = 600  # 30 model-minutes at ts=3 s
    scan = make_scan(step, chunk)
    n_chunks = int(round(model.integration_time / model.ts / chunk))
    extra_series = extra_series or {}
    times, vmaxs, hmins = [], [], []
    extras = {k: [] for k in extra_series}
    failed_at = None
    t0 = time.time()
    for i in range(n_chunks):
        state = scan(state)
        phys = np.asarray(grid.synthesis(state.spec)["val"])
        t_h = (i + 1) * chunk * model.ts / 3600.0
        if not np.isfinite(phys).all():
            failed_at = t_h
            break
        times.append(t_h)
        vmaxs.append(float(phys[2].max()))
        hmins.append(float(phys[0].min()))
        for k, fn in extra_series.items():
            extras[k].append(float(fn(phys)))
    wall = time.time() - t0
    hours = model.integration_time / 3600.0
    status = f"NaN at t={failed_at}h" if failed_at else f"COMPLETED {hours:g}h"
    vm = f"{vmaxs[-1]:.1f}" if vmaxs else "-"
    print(f"[{label}] {status}; last Vmax={vm} ({wall:.0f}s)", flush=True)
    return dict(
        label=label,
        failed_at_h=failed_at,
        wall_s=round(wall, 1),
        times_h=times,
        vmax=vmaxs,
        hmin=hmins,
        **extras,
    ), grid


def run_twoway(ics_csv, dtype, K=5000.0, l_q=2.0, hours=24.0, label=""):
    """One 24 h Twoway run; returns dict with the intensity timeseries and
    the first non-finite time (None if it completes)."""
    import dataclasses

    from common import GRID, PHYSICS
    from scythe_tpu import ModelParameters

    gp = dataclasses.replace(GRID, l_q=l_q)
    model = ModelParameters(
        ts=3.0,
        integration_time=hours * 3600.0,
        output_interval=hours * 3600.0,
        equation_set="Twoway_ShallowWater_Slab",
        initial_conditions=ics_csv,
        output_dir="/tmp/twoway_sweep",
        grid_params=gp,
        physical_params={**PHYSICS, "K": K, "S1": 1.0e-5},
    )
    out, _ = run_flagship(
        model,
        dtype,
        label=f"{label} K={K} l_q={l_q}",
        extra_series={"vbmax": lambda phys: phys[4].max()},
    )
    out.update(K=K, l_q=l_q, label=label)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64-cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.f64_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.f64_cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dtype = jnp.float64 if args.f64_cpu else jnp.float32
    tag = "f64cpu" if args.f64_cpu else "f32"
    workdir = f"/tmp/flagship_{tag}"
    os.makedirs(workdir, exist_ok=True)

    ics = build_ics(workdir, dtype)

    results = []
    if args.f64_cpu:
        results.append(run_twoway(ics, dtype, K=5000.0, label="f64-ref"))
    else:
        for K, lq in [
            (5000.0, 2.0),  # baseline: expect NaN ~9h
            (5000.0, 2.5),
            (5000.0, 3.0),
            (6500.0, 2.0),
            (8000.0, 2.0),
            (10000.0, 2.0),
        ]:
            results.append(run_twoway(ics, dtype, K=K, l_q=lq, label=tag))

    out = args.out or f"/tmp/flagship_sweep_{tag}.json"
    json.dump(results, open(out, "w"), indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
