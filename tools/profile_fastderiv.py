"""Back-to-back device measurement: compensated vs selective-bf16 derivative
synthesis (`GridParameters.deriv_single`), on the bench RLZ roundtrip (all
7 slots kept alive) and the flagship RL step.

Two runs may land on cards with other power limits, so every comparison
here runs in ONE process, interleaved.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def time_fn(compiled, arg, reps=30):
    import jax

    out = jax.block_until_ready(compiled(arg))
    best = np.inf
    for _ in range(5):
        t0 = time.time()
        for _ in range(reps):
            out = compiled(out)
        jax.block_until_ready(out)
        best = min(best, (time.time() - t0) / reps)
    return best


def rlz_roundtrip(deriv_single, dtype):
    import jax
    import jax.numpy as jnp

    from scythe_tpu import GridParameters, create_grid

    gp = GridParameters(
        geometry="RLZ",
        xmin=0.0,
        xmax=3.0e5,
        num_cells=64,
        lDim=128,
        zmin=0.0,
        zmax=1.0e4,
        zDim=60,
        vars={n: i + 1 for i, n in enumerate("abcdefgh")},
        deriv_single=deriv_single,
    )
    grid = create_grid(gp, dtype)
    spec = jnp.ones(grid.spectral_shape, dtype) * 1e-3

    def roundtrip(s):
        out = grid.synthesis(s)
        keep = sum(jnp.sum(out[k]) for k in grid.field_keys if k != "val")
        return grid.analysis(out["val"]) + keep * 1e-30

    compiled = jax.jit(roundtrip).lower(spec).compile()
    flops = float((compiled.cost_analysis() or {}).get("flops", 0.0))
    dt = time_fn(compiled, spec)
    gpv = grid.num_points * gp.nvars / dt
    return dict(us=dt * 1e6, gpv=gpv, gflop=flops / 1e9, tfs=flops / dt / 1e12)


def flagship_step(deriv_single, dtype, n_steps=100):
    import jax
    from dataclasses import replace

    from __graft_entry__ import _flagship_model, _vortex_state
    from scythe_tpu.grids.base import create_grid
    from scythe_tpu.model import build_context, build_step, make_scan

    model = _flagship_model(num_cells=100, nl=256)
    model = model.with_(
        grid_params=replace(model.grid_params, deriv_single=deriv_single)
    )
    grid = create_grid(model.grid_params, dtype)
    ctx = build_context(model, grid, dtype)
    step = build_step(model, grid, ctx, dtype)
    state = _vortex_state(grid, dtype)
    scan = make_scan(step, n_steps)
    state = jax.block_until_ready(scan(state))
    best = np.inf
    for _ in range(4):
        t0 = time.time()
        state = jax.block_until_ready(scan(state))
        best = min(best, time.time() - t0)
    assert np.isfinite(np.asarray(state.spec)).all()
    return dict(
        us_per_step=best / n_steps * 1e6,
        gps=grid.num_points * n_steps / best,
    )


def main():
    import jax
    import jax.numpy as jnp

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dtype = jnp.float32
    print(f"backend: {jax.default_backend()}, {jax.devices()[0].device_kind}")

    # interleave to beat clock and power drift
    for trial in range(2):
        for mode in (False, True):
            r = rlz_roundtrip(mode, dtype)
            print(
                f"[{trial}] RLZ roundtrip deriv_single={mode}: "
                f"{r['us']:.0f} us, {r['gpv']:.3e} gpv/s, "
                f"{r['gflop']:.1f} GF, {r['tfs']:.1f} TF/s"
            )
    for trial in range(2):
        for mode in (False, True):
            r = flagship_step(mode, dtype)
            print(
                f"[{trial}] flagship step deriv_single={mode}: "
                f"{r['us_per_step']:.0f} us/step, {r['gps']:.3e} gps/s"
            )


if __name__ == "__main__":
    main()
