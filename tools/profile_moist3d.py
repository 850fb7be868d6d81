"""Per-stage timing of the moist 3-D core (MoistEulerRLZ, the bench.py
moist3d workload): synthesis / tendencies / semi-implicit / condensation /
analysis / full step, each as an on-device chain (a host fetch closes
every timed region)."""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

L_SHORT, L_LONG = 64, 256


def chain_time(f, x, reps=4):
    """Per-iteration time of f as an on-device scan chain, measured as the
    SLOPE between two chain lengths.  Every host call has a fixed
    dispatch+fetch cost; a single-length measurement folds that constant
    in, the slope cancels it."""
    import jax
    import jax.numpy as jnp

    def make(L):
        def run(x0):
            def body(carry, _):
                (poison,) = carry
                y = f(
                    jax.tree.map(
                        lambda a: a
                        if jnp.issubdtype(a.dtype, jnp.integer)
                        else a * (1.0 + poison),
                        x0,
                    )
                )
                leaves = jax.tree.leaves(y)
                tot = sum(
                    jnp.sum(l) for l in leaves if l.dtype not in (jnp.int32,)
                )
                return ((tot * 1e-300).astype(jnp.float32),), None

            out, _ = jax.lax.scan(
                body, (jnp.zeros((), jnp.float32),), None, length=L
            )
            return out[0]

        g = jax.jit(run)
        float(g(x))
        best = np.inf
        for _ in range(reps):
            t0 = time.time()
            float(g(x))
            best = min(best, time.time() - t0)
        return best

    t_short = make(L_SHORT)
    t_long = make(L_LONG)
    return max(t_long - t_short, 1e-9) / (L_LONG - L_SHORT)


def main():
    import jax
    import jax.numpy as jnp

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    from bench import moist3d_model  # the EXACT benchmark workload

    from scythe_tpu import timeintegration as ti
    from scythe_tpu.equations.common import get_equation_set
    from scythe_tpu.grids.base import create_grid
    from scythe_tpu.model import build_context, build_step
    from scythe_tpu.physics import microphysics as mp

    dev = jax.devices()[0]
    dtype = jnp.float32 if dev.platform != "cpu" else jnp.float64
    print("device:", dev.platform, dev.device_kind)

    model = moist3d_model()
    gp = model.grid_params
    grid = create_grid(gp, dtype)
    ctx = build_context(model, grid, dtype)
    step = build_step(model, grid, ctx, dtype)
    eqset = get_equation_set(model.equation_set)

    rng = np.random.default_rng(0)
    phys0 = jnp.asarray(
        rng.normal(size=(grid.nvars,) + grid.spatial_shape) * 1e-3, dtype
    )
    spec0 = grid.analysis(phys0)
    state = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype,
                             imp_rows=2)

    si_ops = ti.build_semiimplicit_ops(
        gp.zDim, gp.zmin, gp.zmax, gp.b_zDim,
        float(ctx.ref_state.Pxi_bar), model.ts, dtype,
    )
    w_i, xi_i = gp.var_index("w"), gp.var_index("xi")

    fields0 = jax.tree.map(jax.block_until_ready, grid.synthesis(spec0))
    res0 = eqset(fields0, ctx)
    expdot0 = jax.block_until_ready(res0.expdot)

    results = {}
    results["synthesis (7 slots)"] = chain_time(grid.synthesis, spec0)
    results["analysis"] = chain_time(grid.analysis, phys0)
    results["tendencies (eqset)"] = chain_time(
        lambda f: eqset(f, ctx).expdot, fields0
    )

    def si(args):
        v, i = args
        return ti.semiimplicit_adjustment(
            si_ops, v[w_i], v[xi_i], i[w_i], i[w_i], i[w_i],
            i[xi_i], i[xi_i], i[xi_i], jnp.int32(5),
        )

    results["semi-implicit solve"] = chain_time(si, (phys0, expdot0))
    results["condensation adj"] = chain_time(
        lambda v: mp.condensation_adjustment(v, expdot0, ctx), phys0
    )
    results["AB3 step"] = chain_time(
        lambda f: ti.explicit_step(
            f["val"], expdot0, expdot0, expdot0, jnp.int32(5), model.ts
        )[0],
        fields0,
    )
    results["full step"] = chain_time(step, state)

    print(f"{'stage':<28}{'us':>10}")
    for k, v in results.items():
        print(f"{k:<28}{v*1e6:10.1f}")
    tot = sum(v for k, v in results.items() if k != "full step")
    print(f"{'(sum of stages)':<28}{tot*1e6:10.1f}")


if __name__ == "__main__":
    main()
