"""Probe: does the RLZ axis order (z-minor vs l-minor) change synthesis
throughput on the device?  Times the same GEMM chain in both layouts,
back-to-back in one process.

Chains mirror the production fast-deriv synthesis structure
(grids/base.py): compensated-style value chain (simulated at f32) + plain
bf16 single-pass derivative stacks.  ALL outputs are kept alive via a
sum-poison (an earlier version of this probe kept only the value stack and
mismeasured the layout delta on 3 of 7 slots).

Variants:
  A  z-minor state [v,b,k,K], z-minor outputs [v,r,l,z]  (current layout)
  B  l-minor state [v,b,K,k], l-minor outputs [v,r,z,l]  (layout change)
  C  l-minor internal, z-minor outputs (transpose on the final writes)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

L = 50


def chain_time(f, x, reps=3):
    import jax
    import jax.numpy as jnp

    def run(x0):
        def body(carry, _):
            (poison,) = carry
            ys = f(x0 * (1.0 + poison))
            tot = sum(jnp.sum(y) for y in ys)
            return ((tot * 1e-300).astype(x0.dtype),), None

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
    import jax.numpy as jnp

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    v, b, r, nl, nz = 8, 67, 192, 128, 60
    f32, bf16 = jnp.float32, jnp.bfloat16

    rng = np.random.default_rng(0)

    def mk(shape, dt=f32):
        return jnp.asarray(rng.normal(size=shape), dt)

    zval = mk((nz, nz))
    zd = mk((2, nz, nz), bf16)
    lval = mk((nl, nl))
    ld = mk((2, nl, nl), bf16)
    lsyn = mk((nl, nl), bf16)
    rval = mk((r, b))
    rd = mk((2, r, b), bf16)

    def bf(x):
        return x.astype(bf16)

    results = {}

    # A: current z-minor layout, fast-deriv structure
    spec_a = mk((v, b, nl, nz))

    def syn_a(s):
        zv = jnp.einsum("zK,vbkK->vbkz", zval, s)
        zdd = jnp.einsum("dzK,vbkK->vdbkz", zd, bf(s), preferred_element_type=f32)
        lv = jnp.einsum("lk,vbkz->vblz", lval, zv)
        ldd = jnp.einsum("dlk,vbkz->vdblz", ld, bf(zv), preferred_element_type=f32)
        lz = jnp.einsum("lk,vdbkz->vdblz", lsyn, bf(zdd), preferred_element_type=f32)
        val = jnp.einsum("rb,vblz->vrlz", rval, lv)
        rdv = jnp.einsum("drb,vblz->vdrlz", rd, bf(lv), preferred_element_type=f32)
        rl = jnp.einsum("rb,vdblz->vdrlz", rd[0], bf(ldd), preferred_element_type=f32)
        rz = jnp.einsum("rb,vdblz->vdrlz", rd[0], bf(lz), preferred_element_type=f32)
        return val, rdv, rl, rz

    results["A z-minor (current)"] = chain_time(syn_a, spec_a)

    # B: l-minor layout end to end
    spec_b = mk((v, b, nz, nl))

    def syn_b(s):
        zv = jnp.einsum("zK,vbKk->vbzk", zval, s)
        zdd = jnp.einsum("dzK,vbKk->vdbzk", zd, bf(s), preferred_element_type=f32)
        lv = jnp.einsum("lk,vbzk->vbzl", lval, zv)
        ldd = jnp.einsum("dlk,vbzk->vdbzl", ld, bf(zv), preferred_element_type=f32)
        lz = jnp.einsum("lk,vdbzk->vdbzl", lsyn, bf(zdd), preferred_element_type=f32)
        val = jnp.einsum("rb,vbzl->vrzl", rval, lv)
        rdv = jnp.einsum("drb,vbzl->vdrzl", rd, bf(lv), preferred_element_type=f32)
        rl = jnp.einsum("rb,vdbzl->vdrzl", rd[0], bf(ldd), preferred_element_type=f32)
        rz = jnp.einsum("rb,vdbzl->vdrzl", rd[0], bf(lz), preferred_element_type=f32)
        return val, rdv, rl, rz

    results["B l-minor (layout change)"] = chain_time(syn_b, spec_b)

    # C: l-minor internals, transpose to the public z-minor layout at the end
    def syn_c(s):
        val, rdv, rl, rz = syn_b(s)
        tp = lambda a: jnp.swapaxes(a, -1, -2)
        return tp(val), tp(rdv), tp(rl), tp(rz)

    results["C l-minor int, z-minor out"] = chain_time(syn_c, spec_b)

    print(f"{'variant':<30} {'us':>9}")
    for k, t in results.items():
        print(f"{k:<30} {t*1e6:9.1f}")


if __name__ == "__main__":
    main()
