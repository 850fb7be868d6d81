"""Sub-stage timing INSIDE the moist tendency: the stage profile
(tools/profile_moist3d.py) times 'tendencies (eqset)' as a whole — this
decomposes it into thermodynamic closure / PGF / microphysics /
advection+diffusion blocks so the optimization targets the measured hot
spot, not a guess.

The blocks mirror equations/test_models.py::MoistEulerRLZ verbatim
(kept in sync by eye; this is a profiler, not a correctness surface).
Timing: chain-slope methodology (per-call fixed-cost cancellation), same
as profile_moist3d.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from profile_moist3d import chain_time  # noqa: E402  (same dir)


def main():
    import jax
    import jax.numpy as jnp

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    from bench import moist3d_model

    from scythe_tpu.equations.common import get_equation_set
    from scythe_tpu.grids.base import create_grid
    from scythe_tpu.model import build_context
    from scythe_tpu.physics import microphysics as mp
    from scythe_tpu.physics import thermodynamics as td

    dev = jax.devices()[0]
    dtype = jnp.float32 if dev.platform != "cpu" else jnp.float64
    print("device:", dev.platform, dev.device_kind)

    model = moist3d_model()
    gp = model.grid_params
    grid = create_grid(gp, dtype)
    ctx = build_context(model, grid, dtype)
    eqset = get_equation_set(model.equation_set)
    rs = ctx.ref_state
    r = ctx.coords["r"]

    rng = np.random.default_rng(0)
    phys0 = jnp.asarray(
        rng.normal(size=(grid.nvars,) + grid.spatial_shape) * 1e-3, dtype
    )
    spec0 = grid.analysis(phys0)
    fields0 = jax.tree.map(jax.block_until_ready, grid.synthesis(spec0))

    def totals(val):
        return (
            val[0] + rs.sbar[None, None, :, 0],
            val[1] + rs.xibar[None, None, :, 0],
            val[2] + rs.mubar[None, None, :, 0],
        )

    def thermo(fields):
        s_t, xi_t, mu_t = totals(fields["val"])
        return td.thermodynamic_tuple(s_t, xi_t, mu_t)

    tup0 = jax.tree.map(jax.block_until_ready, thermo(fields0))

    def pgf(args):
        fields, (q_v, rho_d, Tk, p) = args
        dr, dl, dz = fields["dr"], fields["dl"], fields["dz"]
        mu_t = fields["val"][2] + rs.mubar[None, None, :, 0]
        mu_fac = td.dmudq(mu_t, q_v)
        coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
        Ps, Pxi, Pqv = coeffs
        dpdr = Ps * dr[0] + Pxi * dr[1] + Pqv * (dr[2] / mu_fac)
        dpdl = Ps * dl[0] + Pxi * dl[1] + Pqv * (dl[2] / mu_fac)
        dpdz = ctx.vertical_pgf(coeffs, dz[0], dz[1], dz[2] / mu_fac)
        return dpdr + dpdl + dpdz

    def micro(args):
        fields, (q_v, rho_d, Tk, p) = args
        val = fields["val"]
        mu_c, mu_r, qss = val[6], val[7], val[8]
        q_c, q_r = td.ahyp(mu_c), td.ahyp(mu_r)
        q_l = q_c + q_r
        N_c, r_c = 100.0, 10.0
        cloudtau = ctx.stiff_rate(mp.invtau_condensation(Tk, p, N_c, r_c))
        raintau = ctx.stiff_rate(mp.rain_evaporation(q_r, rho_d, Tk, p))
        q_cond = mp.q_condensation(
            qss, Tk, p, q_v, q_l, N_c, r_c, invtau=cloudtau
        )
        q_cond = ctx.cap_condensation(q_cond)
        s_cond = mp.s_condensation(q_cond, Tk, rho_d, q_v, q_l, p)
        q_auto = mp.autoconversion(q_c, rho_d)
        q_coll = mp.collection(q_c, q_r, rho_d, Tk)
        Vt = ctx.sedimentation(q_r, rho_d, Tk)
        Vt_flux = ctx.grid.column_flux_derivative(q_r * Vt) / rho_d
        return (
            s_cond + q_cond + q_auto + q_coll + Vt_flux
            - qss * (cloudtau + raintau)
        )

    def advlap(fields):
        val, dr, drr, dl, dll, dz, dzz = (
            fields["val"], fields["dr"], fields["drr"], fields["dl"],
            fields["dll"], fields["dz"], fields["dzz"],
        )
        K = ctx.p("K")
        sbar_z = rs.sbar[None, None, :, 1]
        zrow = jnp.zeros_like(sbar_z)
        barz = jnp.stack([sbar_z, sbar_z, sbar_z, zrow, zrow, zrow,
                          zrow, zrow, zrow])
        u3, v3, w3 = val[3:4], val[4:5], val[5:6]
        adv_all = -u3 * dr - (v3 / r) * dl - w3 * dz - w3 * barz
        lap_mask = jnp.asarray(
            [1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0], dr.dtype
        )[:, None, None, None]
        horiz = drr + dr / r + dll / (r * r)
        return adv_all + lap_mask * (K * (horiz + dzz))

    results = {}
    results["thermo tuple"] = chain_time(thermo, fields0)
    results["pgf (given tuple)"] = chain_time(pgf, (fields0, tup0))
    results["microphysics (given tuple)"] = chain_time(micro, (fields0, tup0))
    results["adv+lap"] = chain_time(advlap, fields0)
    results["eqset total"] = chain_time(lambda f: eqset(f, ctx).expdot, fields0)

    print(f"{'block':32s} {'us':>8s}")
    for k, v in results.items():
        print(f"{k:32s} {v * 1e6:8.1f}")
    acc = sum(v for k, v in results.items() if k != "eqset total")
    print(f"{'(sum of blocks)':32s} {acc * 1e6:8.1f}")

    # --- scan-vs-chain: the bench (lax.scan of the full step, the real
    # driver composition) against the stage profile's chained step — a
    # gap here is scan/carry overhead.
    import time as _t

    from scythe_tpu import timeintegration as ti
    from scythe_tpu.model import build_step, make_scan

    step = build_step(model, grid, ctx, dtype)
    state0 = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype)

    def scan_per_step(n):
        f = make_scan(step, n)
        out = jax.block_until_ready(f(state0))  # compile+warm
        best = np.inf
        for _ in range(4):
            t0 = _t.time()
            float(f(state0).spec[0, 0, 0, 0])
            best = min(best, _t.time() - t0)
        return best

    t20, t120 = scan_per_step(20), scan_per_step(120)
    print(f"{'scan-of-step (slope 20->120)':32s} {(t120 - t20) / 100 * 1e6:8.1f}")
    print(f"{'chained step (profile method)':32s} "
          f"{chain_time(step, state0) * 1e6:8.1f}")

    # carry-shape experiment: scan whose carry is ONLY spec (histories
    # closed over as constants — wrong numerics, right cost shape).  If
    # this matches the chained step, the gap is history-carry traffic
    # (copies / layout conversions of the 4 x 16 MB physical histories).
    def spec_only(n):
        def body(spec, _):
            st = ti.ModelState(spec, state0.expdot_nm1, state0.expdot_nm2,
                               state0.impdot_nm1, state0.impdot_nm2,
                               state0.t)
            return step(st).spec, None

        def run(s0):
            out, _ = jax.lax.scan(body, s0, None, length=n)
            return out

        f = jax.jit(run)
        jax.block_until_ready(f(state0.spec))
        best = np.inf
        for _ in range(4):
            t0 = _t.time()
            float(f(state0.spec)[0, 0, 0, 0])
            best = min(best, _t.time() - t0)
        return best

    s20, s120 = spec_only(20), spec_only(120)
    print(f"{'scan spec-only carry (slope)':32s} "
          f"{(s120 - s20) / 100 * 1e6:8.1f}")


if __name__ == "__main__":
    main()
