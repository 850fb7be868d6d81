"""Per-stage timing of the RLZ transform round trip on the current device.

Each stage runs inside an on-device lax.scan chain of length L with a tiny
data dependency between iterations, so the per-call dispatch latency
amortizes away and the numbers reflect actual device compute.

Usage: python tools/profile_transforms.py [num_cells [nl [nz [nvars]]]]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

L = 100  # chain length per measurement


def chain_time(f, x, reps=3):
    """Seconds per single application of f, measured over an L-long
    on-device dependency chain (scan carries a scalar poison built from
    each output so XLA cannot CSE or DCE the repeats)."""
    import jax
    import jax.numpy as jnp

    def run(x0):
        def body(carry, _):
            poison, = carry
            y = f(x0 * (1.0 + poison))
            new_poison = jnp.real(jnp.ravel(y)[0]) * 1e-300
            return (new_poison.astype(x0.dtype),), None

        out, _ = jax.lax.scan(body, (jnp.zeros((), x0.dtype),), None, length=L)
        return out

    g = jax.jit(run)
    jax.block_until_ready(g(x))  # compile
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
    nl = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    nz = int(sys.argv[3]) if len(sys.argv) > 3 else 60
    nv = int(sys.argv[4]) if len(sys.argv) > 4 else 8
    gp = GridParameters(
        geometry="RLZ", xmin=0.0, xmax=3.0e5, num_cells=nc, lDim=nl,
        zmin=0.0, zmax=1.0e4, zDim=nz,
        vars={f"v{i}": i + 1 for i in range(nv)},
    )
    dev = jax.devices()[0]
    dtype = jnp.float32
    print(f"device: {dev.device_kind}; grid rDim={3*nc} b={nc+3} nl={nl} nz={nz} nv={nv}")
    with jax.default_device(dev):
        g = create_grid(gp, dtype)
        spec = jnp.full(g.spectral_shape, 1e-3, dtype)
        zc = jax.block_until_ready(jax.jit(lambda s: g._mm("dzK,vbkK->vdbkz", g.z_all, s))(spec))
        lv = jax.block_until_ready(jax.jit(lambda z: g._mm("dlk,vbkz->vdblz", g.l_all, z[:, 0]))(zc))
        lz = jax.block_until_ready(jax.jit(lambda z: g._mm("lk,vdbkz->vdblz", g.l_synth, z[:, 1:]))(zc))
        r3 = jax.block_until_ready(jax.jit(lambda l: g._mm("drb,vblz->vdrlz", g.synth_r, l[:, 0]))(lv))
        phys = r3[:, 0]
        hat = jax.block_until_ready(jax.jit(g._l_coeffs)(phys))
        rc = jax.block_until_ready(jax.jit(lambda h: g._mm("vbr,vrkz->vbkz", g.analysis_r, h))(hat))

        stages = [
            ("syn zc [dzK,vbkK->vdbkz]", lambda s: g._mm("dzK,vbkK->vdbkz", g.z_all, s), spec),
            ("syn lv [dlk,vbkz->vdblz]", lambda z: g._mm("dlk,vbkz->vdblz", g.l_all, z[:, 0]), zc),
            ("syn lz [lk,vdbkz->vdblz]", lambda z: g._mm("lk,vdbkz->vdblz", g.l_synth, z[:, 1:]), zc),
            ("syn r3 [drb,vblz->vdrlz]", lambda l: g._mm("drb,vblz->vdrlz", g.synth_r, l[:, 0]), lv),
            ("syn rl [rb,vdblz->vdrlz]", lambda l: g._mm("rb,vdblz->vdrlz", g.synth_r_val, l[:, 1:]), lv),
            ("syn rz [rb,vdblz->vdrlz]", lambda l: g._mm("rb,vdblz->vdrlz", g.synth_r_val, l), lz),
            ("ana l  [kl,vrlz->vrkz]+mask", g._l_coeffs, phys),
            ("ana r  [vbr,vrkz->vbkz]", lambda h: g._mm("vbr,vrkz->vbkz", g.analysis_r, h), hat),
            ("ana z  [vKz,vbkz->vbkK]", lambda r: g._mm("vKz,vbkz->vbkK", g.analysis_z, r), rc),
        ]
        results = {}
        for name, f, x in stages:
            results[name] = chain_time(f, x)

        t_syn = chain_time(lambda s: g.synthesis(s)["val"], spec)
        t_rt = chain_time(lambda s: g.analysis(g.synthesis(s)["val"]), spec)

        m, k, n = 576, 67, nv * nl * nz
        a = jnp.ones((m, k), jnp.bfloat16)
        t_g = chain_time(lambda a: jnp.dot(a, jnp.ones((k, n), jnp.bfloat16),
                                           preferred_element_type=jnp.float32), a)

        tot = sum(results.values())
        print(f"\n{'stage':<32} {'us':>9} {'% of sum':>9}")
        for k_, v in results.items():
            print(f"{k_:<32} {v*1e6:9.1f} {100*v/tot:8.1f}%")
        print(f"{'sum of stages':<32} {tot*1e6:9.1f}")
        print(f"{'fused synthesis (7 slots)':<32} {t_syn*1e6:9.1f}")
        print(f"{'fused round trip':<32} {t_rt*1e6:9.1f}")
        print(f"{'bare GEMM 576x67x61440 bf16':<32} {t_g*1e6:9.1f}")


if __name__ == "__main__":
    main()
