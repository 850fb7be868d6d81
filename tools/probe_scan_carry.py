"""Scan history-carry forensics: how much of a moist3d step the four
physical-space multistep histories cost to carry through lax.scan
(scan-of-step against a spec-only carry).  Experiments:

  E0 baseline  scan of step (the run_loop composition)
  E1 unroll2   scan of step∘step: every carry output is freshly
               computed inside the body (the e_nm2 <- e_nm1 pass-
               through that forces buffer copies disappears)
  E2 slim-imp  impdot histories carried as [2, ...] (only the w and xi
               rows are ever read — semiimplicit_adjustment)
  E3 stacked   histories carried as one [4, nvars, ...] array

Each is timed with the two-length slope.  E1 needs no model change
(make_scan-level); E2/E3 are step-refactor candidates — here they are
approximated at the harness level to bound the win before refactoring.
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def slope(make, ns=(20, 120), reps=4):
    ts = []
    for n in ns:
        f = make(n)
        f()  # warm
        best = np.inf
        for _ in range(reps):
            t0 = time.time()
            f()
            best = min(best, time.time() - t0)
        ts.append(best)
    return (ts[1] - ts[0]) / (ns[1] - ns[0])


def main():
    import jax
    import jax.numpy as jnp

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    from bench import moist3d_model

    from scythe_tpu import timeintegration as ti
    from scythe_tpu.grids.base import create_grid
    from scythe_tpu.model import build_context, build_step

    dev = jax.devices()[0]
    dtype = jnp.float32 if dev.platform != "cpu" else jnp.float64
    print("device:", dev.platform, dev.device_kind)

    model = moist3d_model()
    gp = model.grid_params
    grid = create_grid(gp, dtype)
    ctx = build_context(model, grid, dtype)
    step = build_step(model, grid, ctx, dtype)

    rng = np.random.default_rng(0)
    phys0 = jnp.asarray(
        rng.normal(size=(grid.nvars,) + grid.spatial_shape) * 1e-3, dtype
    )
    spec0 = grid.analysis(phys0)
    state0 = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype)

    def run_scan(body_step, mult):
        def make(n):
            def run(st):
                def body(s, _):
                    return body_step(s), None

                out, _ = jax.lax.scan(body, st, None, length=n // mult)
                return out

            f = jax.jit(run)
            jax.block_until_ready(f(state0))
            return lambda: float(f(state0).spec[0, 0, 0, 0])

        return make

    # NOTE the slope over ns=(20,120) is already per-STEP for every
    # mult (make(n) runs n//mult iterations of a mult-step body = n
    # steps total) — the first version divided by mult AGAIN and
    # reported a spurious 5.2x for composition.
    e0 = slope(run_scan(step, 1))
    print(f"E0 scan-of-step          {e0 * 1e6:8.1f} us/step")

    step2 = lambda s: step(step(s))
    e1 = slope(run_scan(step2, 2))
    print(f"E1 scan-of-step^2        {e1 * 1e6:8.1f} us/step")

    step4 = lambda s: step(step(step(step(s))))
    e14 = slope(run_scan(step4, 4))
    print(f"E1b scan-of-step^4       {e14 * 1e6:8.1f} us/step")

    # E3: stacked histories — one [4, nvars, ...] carry instead of four
    def pack(st):
        return (st.spec,
                jnp.stack([st.expdot_nm1, st.expdot_nm2,
                           st.impdot_nm1, st.impdot_nm2]), st.t)

    def unpack(spec, h, t):
        return ti.ModelState(spec, h[0], h[1], h[2], h[3], t)

    def step_packed(args):
        spec, h, t = args
        out = step(unpack(spec, h, t))
        return pack(out)

    packed0 = pack(state0)

    def make_packed(n):
        def run(p):
            def body(c, _):
                return step_packed(c), None

            out, _ = jax.lax.scan(body, p, None, length=n)
            return out

        f = jax.jit(run)
        jax.block_until_ready(f(packed0))
        return lambda: float(f(packed0)[0][0, 0, 0, 0])

    e3 = slope(make_packed)
    print(f"E3 stacked-history carry {e3 * 1e6:8.1f} us/step")


if __name__ == "__main__":
    main()
