"""Per-stage timing of the flagship (Twoway SW slab, RL 300x256, 6 vars)
step on the current device: synthesis / tendencies+AB3 / analysis / full
step, each as a two-length on-device chain SLOPE (profile_moist3d.
chain_time) — the fixed per-call host cost cancels in the slope.
Back-to-back in one process."""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "models", "cha_bell2024"))

from profile_moist3d import chain_time  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from scythe_tpu import ModelParameters
    from scythe_tpu import timeintegration as ti
    from scythe_tpu.equations.common import get_equation_set
    from scythe_tpu.grids.base import create_grid
    from scythe_tpu.model import build_context, build_step
    from scythe_tpu.utils.runtime import enable_compile_cache

    from common import GRID, PHYSICS

    enable_compile_cache()
    dev = jax.devices()[0]
    print("device:", dev.platform, dev.device_kind)

    model = ModelParameters(
        ts=3.0,
        integration_time=600.0,
        output_interval=600.0,
        equation_set="Twoway_ShallowWater_Slab",
        initial_conditions="unused",
        output_dir="/tmp/profile_flagship",
        grid_params=GRID,
        physical_params={**PHYSICS, "S1": 1.0e-5},
    )
    dtype = jnp.float32
    grid = create_grid(GRID, dtype)  # auto precision (grids/base.py)
    print("grid.fast (deriv_single):", grid.fast, " matmul comp:", grid.comp)
    ctx = build_context(model, grid, dtype)
    eqset = get_equation_set(model.equation_set)

    rng = np.random.default_rng(0)
    phys0 = jnp.asarray(
        rng.normal(size=(grid.nvars,) + grid.spatial_shape) * 1e-2, dtype
    )
    spec0 = grid.analysis(phys0)
    state = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype)
    step = build_step(model, grid, ctx, dtype)

    results = {}
    results["synthesis (all slots)"] = chain_time(grid.synthesis, spec0)
    results["analysis"] = chain_time(grid.analysis, phys0)

    fields0 = jax.tree.map(jax.block_until_ready, grid.synthesis(spec0))

    def tend(fields):
        res = eqset(fields, ctx)
        phys = fields["val"]
        for v, arr in res.overrides.items():
            phys = phys.at[v].set(arr)
        var_np1, e1, e2 = ti.explicit_step(
            phys, res.expdot, res.expdot, res.expdot, jnp.int32(5), model.ts
        )
        return var_np1, e1, e2

    results["tendencies + AB3"] = chain_time(tend, fields0)
    results["full step"] = chain_time(step, state)

    print(f"{'stage':<28}{'us':>10}")
    for k, v in results.items():
        print(f"{k:<28}{v*1e6:10.1f}")
    tot = sum(v for k, v in results.items() if k != "full step")
    print(f"{'(sum of stages)':<28}{tot*1e6:10.1f}")


if __name__ == "__main__":
    main()
