"""Dense vs factored azimuthal DFT at large nl on the current device.

Measures the full RL transform round trip (synthesis all slots +
analysis) for dense and radix-split azimuthal modes back-to-back in one
process (compare variants only on one card in one run).

Usage: python tools/profile_factored.py [num_cells [nl_list]]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

L = 30


def chain_time(f, x, reps=3):
    import jax
    import jax.numpy as jnp

    def run(x0):
        def body(carry, _):
            (poison,) = carry
            y = f(x0 * (1.0 + poison))
            return ((jnp.ravel(y)[0] * 1e-300).astype(x0.dtype),), None

        out, _ = jax.lax.scan(body, (jnp.zeros((), x0.dtype),), None, length=L)
        return out

    g = jax.jit(run)
    jax.block_until_ready(g(x))
    best = np.inf
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(g(x))
        best = min(best, time.time() - t0)
    return best / L


def main():
    import jax
    import jax.numpy as jnp

    from scythe_tpu import GridParameters, create_grid
    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    nc = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    nls = [int(x) for x in sys.argv[2].split(",")] if len(sys.argv) > 2 else [256, 512, 1024]
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind}; RL grid num_cells={nc}, 6 vars")
    print(f"{'nl':>6} {'dense us':>10} {'factored us':>12} {'speedup':>8}")
    for nl in nls:
        row = {}
        for mode in (False, True):
            gp = GridParameters(
                geometry="RL", xmin=0.0, xmax=3.0e5, num_cells=nc, lDim=nl,
                l_factored=mode,
                vars={f"v{i}": i + 1 for i in range(6)},
            )
            g = create_grid(gp, jnp.float32)
            spec = jnp.full(g.spectral_shape, 1e-3, jnp.float32)

            def rt(s, g=g):
                return g.analysis(g.synthesis(s)["val"])

            row[mode] = chain_time(rt, spec)
        print(
            f"{nl:>6} {row[False]*1e6:>10.1f} {row[True]*1e6:>12.1f} "
            f"{row[False]/row[True]:>8.2f}x"
        )


if __name__ == "__main__":
    main()
