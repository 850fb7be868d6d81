"""Jablonowski & Williamson (2006) baroclinic-wave test on the SLZ
global shell — the standard 3-D dry dynamical-core validation (QJRMS
132, 2943-2975; also the DCMIP-2012 test 4), run on `MoistEulerSLZ`
(equations/sphere.py) with trace moisture.  Round-3 VERDICT #5: the SL
surface has Williamson/Galewsky numbers; this gives the 3-D shell a
published protocol.

Initial state (their eqs. 2-12, exact): zonal jets
u = u0 cos^{3/2}(eta_v) sin^2(2 phi) in thermal-wind balance with the
analytic T(eta, phi) and geopotential Phi(eta, phi), eta = p / p0.  The
state is an exact steady solution of the hydrostatic primitive
equations, so the published test has two parts:

1. STEADY STATE: unperturbed, the flow must stay steady — JW06's
   acceptance is that l2(u - u_init) stays small through day 30 (their
   Fig. 4: grid models hold it to a few m/s at medium resolution; the
   drift is resolution- and core-dependent).
2. BAROCLINIC WAVE: a small zonal-wind bump (up = 1 m/s, R = a/10 at
   40N, 20E) grows slowly to day ~6 and breaks explosively by day ~9:
   published surface-pressure minimum (their Fig. 6/Table 2 region)
   ~997 hPa at day 4, ~980 hPa at day 6, ~940-960 hPa at day 8 (spread
   across the four reference cores), deepening past 930 hPa by day 10.

Height-coordinate translation (this is a nonhydrostatic z-coordinate
core): JW06 give Phi(eta, phi) in closed form, so z(eta, phi) =
Phi / g is inverted pointwise by Newton for eta(z, phi); T and p = eta
p0 follow analytically — no hydrostatic re-integration, no interpolated
soundings.  Below the eta = 1 surface (which undulates +-300 m in z)
the same analytic formulas extend smoothly to eta > 1.  The model
reference column is the phi = 45 deg column written through
``exact_reference_state``; all latitude structure rides in the
perturbation fields.

Usage:
    python examples/jw06_baroclinic_slz.py [--cpu] [--days 9]
        [--cells 24] [--nl 96] [--zdim 24] [--ts 15] [--steady]

Production recipe (round 5 — the configuration that holds both phases
on device; see docs/RESULTS.md "round-5 JW06 forensic chain"):

    python examples/jw06_baroclinic_slz.py --cells 48 --nl 96 \
        --zdim 24 --ts 7.5 --days 12 --l-q 0 --balanced-init \
        --balance-cache --sponge-top-km 12 --k4 6e16 --smag 0.21

This bundle carried the full life cycle through wave breaking to day
10 on device (eddy-ps -22.6 hPa, |v| 28 m/s; docs/RESULTS.md).  Each
piece closes a measured failure mode: l_q=0 (contractive fit),
--balanced-init (eta->z drift), incremental closing analysis (on by
default here; standing-state erosion on device), --sponge-top-km 12
(polar model-top mode; 8 km base sits in the drifting layer and
detonates at h72-78), --k4 (surface shortwave edge waves; obeys the
diagonal AB3 CFL guard — the guard sets the max K4 per ts), --smag
0.21 (horizontal-only breaking-front closure), small ts (the endgame
death day is ts-controlled: 15 -> day 8, 10 -> day 9, 7.5 -> day 11).
The isotropic-smag+ivd variant measured WORSE on the shell (day 6) —
see RESULTS.  Compare curves: tools/jw06_compare_published.py.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# JW06 constants (their Table 1)
A_SPH = 6.371229e6
OMEGA = 7.29212e-5
G = 9.80616
RD = 287.04
P0 = 1.0e5  # Pa
U0 = 35.0
T0 = 288.0
GAMMA = 0.005
ETA_T = 0.2
ETA_0 = 0.252
DELTA_T = 4.8e5
Q_TRACE = 0.01  # g/kg trace vapor (exact zero NaNs the f32 moist path)

VARS = {"s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
        "mu_c": 7, "mu_r": 8, "qss": 9}


def _eta_v(eta):
    return (eta - ETA_0) * np.pi / 2.0


def t_mean(eta):
    t = T0 * eta ** (RD * GAMMA / G)
    return np.where(eta < ETA_T, t + DELTA_T * (ETA_T - eta) ** 5, t)


def phi_mean(eta):
    base = T0 * G / GAMMA * (1.0 - eta ** (RD * GAMMA / G))
    corr = RD * DELTA_T * (
        (np.log(eta / ETA_T) + 137.0 / 60.0) * ETA_T**5
        - 5.0 * ETA_T**4 * eta
        + 5.0 * ETA_T**3 * eta**2
        - (10.0 / 3.0) * ETA_T**2 * eta**3
        + 1.25 * ETA_T * eta**4
        - 0.2 * eta**5
    )
    return np.where(eta < ETA_T, base - corr, base)


def _horiz_factors(phi):
    """The two latitude factors of JW06's T and Phi corrections."""
    sinp, cosp = np.sin(phi), np.cos(phi)
    f1 = -2.0 * sinp**6 * (cosp**2 + 1.0 / 3.0) + 10.0 / 63.0
    f2 = 1.6 * cosp**3 * (sinp**2 + 2.0 / 3.0) - np.pi / 4.0
    return f1, f2


def temperature(eta, phi):
    ev = _eta_v(eta)
    f1, f2 = _horiz_factors(phi)
    corr = (
        0.75 * (eta * np.pi * U0 / RD)
        * np.sin(ev) * np.sqrt(np.abs(np.cos(ev)))
        * (f1 * 2.0 * U0 * np.cos(ev) ** 1.5 + f2 * A_SPH * OMEGA)
    )
    return t_mean(eta) + corr


def geopotential(eta, phi):
    ev = _eta_v(eta)
    f1, f2 = _horiz_factors(phi)
    corr = U0 * np.cos(ev) ** 1.5 * (
        f1 * U0 * np.cos(ev) ** 1.5 + f2 * A_SPH * OMEGA
    )
    return phi_mean(eta) + corr


def u_wind(eta, phi):
    return U0 * np.cos(_eta_v(eta)) ** 1.5 * np.sin(2.0 * phi) ** 2


def eta_of_z(z, phi):
    """Newton inversion of geopotential(eta, phi) = g z (vectorized)."""
    z = np.asarray(z, np.float64)
    eta = np.full(np.broadcast(z, phi).shape, 0.5)
    target = G * z
    for _ in range(60):
        f = geopotential(eta, phi) - target
        df = (geopotential(eta * 1.0001, phi) - f - target) / (eta * 1e-4)
        d = f / df
        d = np.clip(d, -0.2, 0.2)  # keep Newton inside the branch
        eta = np.clip(eta - d, 1e-5, 1.5)
        if np.max(np.abs(d)) < 1e-14:
            break
    return eta


def state_at(z, phi):
    """(T, p, rho_d, u) of the JW06 atmosphere at height z, latitude
    phi (broadcastable arrays)."""
    eta = eta_of_z(z, phi)
    T = temperature(eta, phi)
    p = eta * P0
    qv = Q_TRACE * 1e-3
    e = p * qv / (0.622 + qv)
    rho_d = (p - e) / (RD * T)
    return T, p, rho_d, u_wind(eta, phi)


def write_reference_file(path, gp):
    """phi = 45 deg JW06 column as the model's exact reference state."""
    from scythe_tpu.basis import chebyshev
    from scythe_tpu.physics import thermodynamics as td

    zops = chebyshev.build_ops(gp.zDim, gp.zmin, gp.zmax, gp.b_zDim)
    T, p, rho_d, _ = state_at(zops.points, np.pi / 4.0)
    qv = Q_TRACE * 1e-3
    s = np.asarray(td.entropy(T, rho_d, qv))
    xi = np.asarray(td.log_dry_density(rho_d))
    mu = float(np.asarray(td.bhyp(qv)))
    with open(path, "w") as f:
        for k, z in enumerate(zops.points):
            f.write(f"{z} {s[k]} {xi[k]} {mu} 0.0\n")
    return path


def build_model(out_dir, num_cells=24, nl=96, zdim=24, ts=15.0,
                t_end=9 * 86400.0, K=1.0e5, filter_tau=0.0,
                filter_axes="rl", filter_order=4, smag=0.0, l_q=2.0,
                sponge_top=0.0, sponge_top_tau=600.0, k4=0.0,
                incremental=True, ivd=False, ivd_no_w=False):
    from scythe_tpu import GridParameters, ModelParameters, ZBC

    os.makedirs(out_dir, exist_ok=True)
    gp = GridParameters(
        geometry="SLZ",
        xmin=-np.pi / 2,
        xmax=np.pi / 2,
        num_cells=num_cells,
        lDim=nl,
        sphere_radius=A_SPH,
        zmin=0.0,
        zmax=30.0e3,
        zDim=zdim,
        # FREE (R0) vertical fits for the thermo/wind fields: the JW06
        # perturbations vs the 45-deg column carry O(1) REAL vertical
        # gradients at the surface at every latitude, and an insulated
        # (R1T1) fit clamps them — measured as a non-converging
        # ~0.5 m/s^2 spurious w forcing pinned to the lowest Chebyshev
        # level (the blow-up mechanism of this example's first version).
        # R0 is admissible here because the run carries NO explicit
        # vertical diffusion (K_v = 0 below) — the wall-flux rule
        # (docs/NUMERICS.md) only binds K-diffused variables.
        BCB={"w": ZBC.R1T0},
        BCT={"w": ZBC.R1T0},
        vars=VARS,
        # l_q=0 disables the per-step spline-penalty filter: the
        # penalized analysis is CONTRACTIVE (A S != I), and at 5760
        # steps/day it alone erodes the fitted jet peak ~30%/day at 12
        # cells (measured round 5: 1000 pure fit iterations take u_max
        # 34.88 -> 28.0 with zero dynamics; l_q=0 is bitwise neutral).
        # This - not discrete imbalance - was the round-3/4 "base-state
        # drift".  Stabilization then falls to dealiasing + K +
        # Smagorinsky, the standard dry-core recipe.
        l_q=float(l_q),
    )
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=t_end,
        equation_set="MoistEulerSLZ",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=write_reference_file(
            os.path.join(out_dir, "ref.txt"), gp
        ),
        grid_params=gp,
        # horizontal-only constant diffusion: planetary-scale K with
        # K_v = 0 (the standard dry-core configuration; the isotropic
        # default would impose a ~(pi/10km)^2 * K = 1e-2 1/s vertical
        # mixing rate — three orders too strong)
        physical_params={"K": K, "K_v": 0.0, "Omega": OMEGA},
        options={
            "semiimplicit": True,
            "exact_reference_state": True,
            "stiff_relaxation": "exp",
            # SHB78 robustness: the polar columns' local P_xi/rho run
            # well above the 45-deg reference column's, and the
            # semi-implicit split is only stable when the implicit
            # coefficient exceeds the local acoustics EVERYWHERE
            # (EqContext.pxi_si).  Measured: explosive polar-
            # stratosphere mode (e-fold ~4 min) at 1.0, clean at 1.5.
            "si_scale": 1.5,
            # the baroclinic wave BREAKS around day 8 (fronts collapse
            # to the grid scale); the published cores all carry
            # scale-selective damping there.  --filter-tau enables the
            # modal filter (horizontal axes only: the vertical fields
            # are R0-fit and the wave is balanced, docs/RESULTS.md).
            **({"modal_filter_tau": float(filter_tau),
                "modal_filter_axes": filter_axes,
                "modal_filter_order": int(filter_order)}
               if filter_tau > 0.0 else {}),
            # Smagorinsky closure.  Two modes:
            # - horizontal-only ('rl' axes): the physical-space closure
            #   for the day 7+ breaking front; keeps the R0 vertical
            #   fits admissible (no explicit vertical mixing).
            # - ivd: isotropic closure + implicit (weak-form) vertical
            #   solve with the Lilly Ri factor — vertical mixing turns
            #   ON where the column goes statically unstable, i.e. a
            #   flow-dependent dry convective adjustment.  Round-5
            #   forensics: the wave phase drives the weakly-stable
            #   tropical low levels to neutral by day ~7 and resolved
            #   grid-scale dry convection detonates (this core is
            #   nonhydrostatic convection-permitting with K_v = 0;
            #   the published hydrostatic cores never see this mode).
            #   The weak-form implicit solve is wall-flux safe for the
            #   R0 columns (docs/NUMERICS.md implicit_vdiff).
            **({"smagorinsky": float(smag),
                **({"implicit_vdiff": True,
                    # the w-excluded arm for the day-6 ivd negative
                    # (vdiff after the AI2* corrector perturbs the
                    # discrete (w, xi) closure — model.py forensic lead)
                    **({"vdiff_exclude": ("xi", "qss", "w")}
                       if ivd_no_w else {})} if ivd
                   else {"smagorinsky_axes": "rl"})}
               if smag > 0.0 else {}),
            # top absorbing layer (model.build_step sponge_top_*): the
            # published cores all damp their model tops; ours measured
            # a polar model-top v-mode without one (round 5)
            **({"sponge_top_width": float(sponge_top),
                "sponge_top_tau": float(sponge_top_tau)}
               if sponge_top > 0.0 else {}),
            # horizontal del^4: the scale-selective damping every
            # published core carries (surface shortwave edge waves)
            **({"hyperdiffusion_k4": float(k4)} if k4 > 0.0 else {}),
            # incremental closing analysis: the classical per-step
            # full-state refit drifts the balanced zonal mean on device
            # (compensated-bf16 fit bias ~1e-6/step -> polar surface
            # +0.9 K/1000 steps, tropical stratification collapse by
            # day ~7 — the round-5 equatorial killer; model.build_step)
            **({"incremental_analysis": True} if incremental else {}),
        },
    )


def initial_fields(grid, ref_state, perturb=True):
    """Perturbation (vs the model reference column) initial fields."""
    from scythe_tpu.physics import thermodynamics as td

    pts = grid.gridpoints()
    sh = grid.spatial_shape
    phi = pts[:, 0].reshape(sh)
    lam = pts[:, 1].reshape(sh)
    z = pts[:, 2].reshape(sh)

    T, p, rho_d, u = state_at(z, phi)
    if perturb:
        # JW06 eq. 11-12: Gaussian zonal-wind bump at (20E, 40N)
        lam_c, phi_c = np.pi / 9.0, 2.0 * np.pi / 9.0
        rr = A_SPH * np.arccos(np.clip(
            np.sin(phi_c) * np.sin(phi)
            + np.cos(phi_c) * np.cos(phi) * np.cos(lam - lam_c), -1.0, 1.0))
        u = u + 1.0 * np.exp(-((rr / (A_SPH / 10.0)) ** 2))

    qv = Q_TRACE * 1e-3
    s = np.asarray(td.entropy(T, rho_d, qv))
    xi = np.asarray(td.log_dry_density(rho_d))

    phys = np.zeros((grid.nvars,) + sh)
    phys[0] = s - np.asarray(ref_state.sbar[:, 0])[None, None, :]
    phys[1] = xi - np.asarray(ref_state.xibar[:, 0])[None, None, :]
    phys[3] = u
    return phys


def diagnostics(grid, ref_state, phys):
    """(u_max, v_absmax, NH-band ps_min, ps_max, eddy ps_min) in hPa.

    The ps extrema are taken over the 25-75 deg N storm track: the JW06
    surface-pressure signal (published Fig. 6 curves) lives there, while
    the GLOBAL minimum is the south-pole surface value (~953 hPa at
    z = 0 by construction — the eta = 1 surface sits ~300 m above z = 0
    at the poles) which hides the wave low entirely.

    ``eddy ps_min`` = min over the band of (ps − zonal-mean ps): the
    published curves start from JW06's exactly-uniform 1000 hPa surface
    pressure, so ``1000 + eddy ps_min`` is the directly comparable
    number (our absolute z = 0 ps carries the ±300 m eta = 1 undulation
    in its zonal mean, offsetting the raw band minimum by ~−45 hPa)."""
    from scythe_tpu.physics import thermodynamics as td

    sh = grid.spatial_shape
    s = phys[0].reshape(sh) + np.asarray(ref_state.sbar[:, 0])[None, None, :]
    xi = phys[1].reshape(sh) + np.asarray(ref_state.xibar[:, 0])[None, None, :]
    mu = phys[2].reshape(sh) + np.asarray(ref_state.mubar[:, 0])[None, None, :]
    _, _, Tk, p = (np.asarray(a) for a in td.thermodynamic_tuple(s, xi, mu))
    z0 = float(grid.z_mish[0])
    # thermodynamic_tuple returns hPa; hydrostatically extend to z = 0
    ps = p[..., 0] * np.exp(G * z0 / (RD * Tk[..., 0]))
    lat = np.degrees(np.asarray(grid.r_mish))
    band = (lat > 25.0) & (lat < 75.0)
    ps_eddy = ps - ps.mean(axis=1, keepdims=True)
    return (float(phys[3].max()), float(np.abs(phys[4]).max()),
            float(ps[band].min()), float(ps[band].max()),
            float(ps_eddy[band].min()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--days", type=float, default=9.0)
    ap.add_argument("--cells", type=int, default=24)
    ap.add_argument("--nl", type=int, default=96)
    ap.add_argument("--zdim", type=int, default=24)
    ap.add_argument("--ts", type=float, default=15.0,
                    help="must satisfy the BUOYANCY CFL ts < ~0.7/N "
                    "(N_max ~ 0.026 1/s at the JW06 stratopause, all "
                    "latitudes -> ts <~ 20 s): gravity waves are explicit "
                    "(only vertical acoustics are implicit), and at "
                    "ts = 25 the stratopause mode still grows (measured "
                    "e-fold ~200 s at z = 14-21 km; clean at 12.5)")
    ap.add_argument("--steady", action="store_true",
                    help="unperturbed steady-state test (JW06 part 1)")
    ap.add_argument("--filter-tau", type=float, default=0.0,
                    help="modal filter e-folding (s); survives wave "
                    "breaking past day ~8 (0 = off)")
    ap.add_argument("--filter-axes", default="rl")
    ap.add_argument("--spinup-days", type=int, default=0,
                    help="integrate unperturbed this many days, then add "
                    "the JW06 bump to the ADJUSTED base (wave phase is "
                    "measured against a base the model holds)")
    ap.add_argument("--filter-order", type=int, default=4,
                    help="modal filter falloff order: at order 4 a tau "
                    "strong enough to absorb day-8 front collapse also "
                    "damps the k~8 WAVE with an hours-scale e-fold "
                    "(measured suppression); order 8 separates the "
                    "scales (k=8 e-fold ~90 days at tau 120)")
    ap.add_argument("--l-q", type=float, default=2.0,
                    help="spline-filter half-power wavelength (grid "
                    "units); 0 disables the per-step penalty (neutral "
                    "re-analysis - see build_model note)")
    ap.add_argument("--smag", type=float, default=0.0,
                    help="horizontal-only Smagorinsky Cs (classic "
                    "0.18-0.25; 0 = off) — the flow-dependent "
                    "physical-space closure for the breaking front")
    ap.add_argument("--sponge-top-km", type=float, default=0.0,
                    help="top Rayleigh-sponge depth (km; 0 = off): "
                    "relax the top layer toward the initial state "
                    "(published cores all absorb at the model top)")
    ap.add_argument("--sponge-top-tau", type=float, default=600.0)
    ap.add_argument("--k4", type=float, default=0.0,
                    help="horizontal del^4 hyperdiffusion coefficient "
                    "(m^4/s; ~5e16 at 48 cells: 30-min grid-scale "
                    "e-fold, ~25-day at wave k=8; 0 = off)")
    ap.add_argument("--chunk-cap", type=int, default=384,
                    help="max lax.scan chunk length (one device call "
                    "per chunk; raise when the per-call host cost is large)")
    ap.add_argument("--ivd-no-w", action="store_true",
                    help="with --ivd: exclude w from the implicit "
                    "vertical solve (the (w,xi)-closure forensic arm)")
    ap.add_argument("--ivd", action="store_true",
                    help="isotropic Smagorinsky + implicit vertical "
                    "diffusion (Ri-factor dry convective adjustment) "
                    "instead of the horizontal-only 'rl' closure")
    ap.add_argument("--balance-cache", action="store_true",
                    help="cache/reuse the (cells, zdim)-keyed balance "
                    "solution in /tmp (the correction is ~8 min of CPU "
                    "Newton at 48 cells and identical across option "
                    "arms: the solve sees only the zonal-mean state)")
    ap.add_argument("--balanced-init", action="store_true",
                    help="discretely-balanced initialization: solve the "
                    "model's own gradient-wind/hydrostatic balance on "
                    "the discrete operators (scythe_tpu.balance), "
                    "removing the eta->z drift + spinup protocol")
    ap.add_argument("--out", default="./jw06_out")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    elif args.balanced_init:
        # the balance solve runs f64 on the CPU backend inside the GPU
        # session (scythe_tpu.balance on_cpu; the main run stays f32 —
        # dtype is pinned below, NOT read from the x64 flag)
        jax.config.update("jax_enable_x64", True)
    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from scythe_tpu import create_grid
    from scythe_tpu import timeintegration as ti
    from scythe_tpu.model import (build_context, build_step, default_dtype,
                                  make_scan, _pick_chunk)

    model = build_model(args.out, num_cells=args.cells, nl=args.nl,
                        zdim=args.zdim, ts=args.ts,
                        t_end=args.days * 86400.0,
                        filter_tau=args.filter_tau,
                        filter_axes=args.filter_axes,
                        filter_order=args.filter_order,
                        smag=args.smag, l_q=args.l_q,
                        sponge_top=args.sponge_top_km * 1.0e3,
                        sponge_top_tau=args.sponge_top_tau,
                        k4=args.k4, ivd=args.ivd, ivd_no_w=args.ivd_no_w)
    # --balanced-init enables x64 globally for the CPU-side solve; the
    # device run must stay f32 (f64 is slow on the GPU), so pin the dtype
    # instead of reading it off the x64 flag.
    dtype = default_dtype() if args.cpu else jnp.float32
    grid = create_grid(model.grid_params, dtype)
    ctx = build_context(model, grid, dtype)
    phys0 = initial_fields(grid, ctx.ref_state, perturb=not args.steady)
    spec0 = grid.analysis(jnp.asarray(phys0, dtype))
    state = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype,
                             imp_rows=2)

    if args.balanced_init:
        # Solve the model's own discrete gradient-wind/hydrostatic
        # balance for the zonal-mean (s, xi) and rebuild the initial
        # state on the balanced base: kills the eta->z drift (~1-3
        # m/s/day jet loss, ~10 hPa polar ps filling) at the source.
        # The analytic unperturbed state is zonally symmetric, so the
        # zonal mean IS the base; the wind bump is re-added on top.
        from scythe_tpu.balance import balance_zonal_state

        base0 = initial_fields(grid, ctx.ref_state, perturb=False)
        zm = np.asarray(base0).mean(axis=2)
        cache = (f"/tmp/jw06_bal_c{args.cells}_z{args.zdim}.npz"
                 if args.balance_cache else None)
        if cache and os.path.exists(cache):
            bal = np.load(cache)["bal"]
            print(f"balanced init: loaded {cache}")
        else:
            bal, info = balance_zonal_state(model, zm, verbose=True)
            print("balanced init: max|residual| "
                  + " -> ".join(f"{h:.3e}" for h in info["history"]))
            if cache:
                np.savez(cache, bal=bal)
        delta = (bal - zm)[:, :, None, :]
        phys0 = np.asarray(phys0) + delta
        spec0 = grid.analysis(jnp.asarray(phys0, dtype))
        state = ti.initial_state(
            spec0, (grid.nvars,) + grid.spatial_shape, dtype, imp_rows=2
        )

    # boundary-treatment refs (top sponge): relax toward the state the
    # run actually starts from (balanced if --balanced-init), so the
    # sponge is exactly neutral at t = 0
    from scythe_tpu.model import _set_boundary_refs

    _set_boundary_refs(ctx, grid, spec0)
    step = build_step(model, grid, ctx, dtype)

    per = int(round(86400.0 / model.ts))  # report daily
    # --chunk-cap: when the per-execution fixed host cost is large, fewer
    # and longer scan calls cut wall time; compile time grows with scan
    # length, so this is a session-condition knob, not a default.
    chunk = _pick_chunk(per, cap=args.chunk_cap)
    # one jitted scan per chunk length, reused across every day/spinup
    # loop iteration (a make_scan call inside the loop would retrace)
    scan_chunk = make_scan(step, chunk)
    scan_rem = make_scan(step, per % chunk) if per % chunk else None

    def run_day(state):
        for _ in range(per // chunk):
            state = scan_chunk(state)
        if scan_rem is not None:
            state = scan_rem(state)
        return state
    if args.spinup_days > 0 and not args.steady:
        # adjustment protocol: integrate the UNPERTURBED state first
        # (the discrete state slides toward its own balance — polar
        # surface lows fill ~10 hPa and the jet sheds ~1-3 m/s/day
        # early; measured round 3/4) and add the JW06 u-bump to the
        # ADJUSTED base, so wave growth is measured against a base the
        # model actually holds.
        base0 = initial_fields(grid, ctx.ref_state, perturb=False)
        state = ti.initial_state(
            grid.analysis(jnp.asarray(base0, dtype)),
            (grid.nvars,) + grid.spatial_shape, dtype, imp_rows=2,
        )
        for d in range(int(args.spinup_days)):
            state = run_day(state)
        base = np.asarray(grid.synthesis(state.spec)["val"])
        if not np.isfinite(base).all():
            print("NONFINITE during spinup")
            sys.exit(1)
        bump = np.asarray(phys0) - np.asarray(base0)  # the u perturbation
        spec0 = grid.analysis(jnp.asarray(base + bump, dtype))
        # fresh multistep history on the perturbed state
        state = ti.initial_state(
            spec0, (grid.nvars,) + grid.spatial_shape, dtype, imp_rows=2
        )
        phys0 = base + bump
    u0max = float(phys0[3].max())
    print(" day   u_max   |v|_max  ps_min(hPa)  ps_max(hPa)  ps_eddy_min")
    um, vm, pmn, pmx, pse = diagnostics(grid, ctx.ref_state, phys0)
    print(f"{0:4.0f} {um:7.2f} {vm:8.3f} {pmn:10.2f} {pmx:10.2f} "
          f"{pse:10.2f}", flush=True)
    for day in range(1, int(args.days) + 1):
        state = run_day(state)
        phys = np.asarray(grid.synthesis(state.spec)["val"])
        if not np.isfinite(phys).all():
            print(f"NONFINITE at day {day}")
            sys.exit(1)
        um, vm, pmn, pmx, pse = diagnostics(grid, ctx.ref_state, phys)
        print(f"{day:4.0f} {um:7.2f} {vm:8.3f} {pmn:10.2f} "
              f"{pmx:10.2f} {pse:10.2f}", flush=True)
    if args.steady:
        print(f"steady-state drift: u_max {u0max:.2f} -> {um:.2f} m/s "
              f"(JW06 Fig. 4: reference cores hold a few m/s)")
    else:
        print("published (JW06 Fig. 6, four reference cores): ps_min "
              "~997 hPa day 4, ~980 day 6, ~940-960 day 8, <930 day 10")
        print("compare 1000 + ps_eddy_min against those curves (the "
              "published initial surface pressure is uniform 1000 hPa)")


if __name__ == "__main__":
    main()
