"""Model driver: build the jitted SPMD step and run the time loop.

The reference's worker/RPC/SharedArray runtime (src/semiimplicit.jl:126-332)
collapses into a single jitted function-of-state here: per step --
synthesis -> pointwise tendencies -> AB3/AI2* update -> (semi-implicit
column solve) -> (condensation adjustment) -> analysis.  Steps between
output intervals run inside one `lax.scan`; the host only touches data at
output boundaries (CSV write + NaN watchdog), matching the reference cadence
(semiimplicit.jl:288-293).
"""

from __future__ import annotations

import logging
import os
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from . import io as sio
from . import timeintegration as ti
from .config import ModelParameters
from .equations.common import EqContext, get_equation_set
from .grids.base import Grid, create_grid
from .physics import microphysics as mp
from .physics import reference_state as rsmod

log = logging.getLogger("scythe_tpu")


def default_dtype():
    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def build_context(model: ModelParameters, grid: Grid, dtype) -> EqContext:
    ref = rsmod.build_reference_state(model, grid, dtype)
    return EqContext(
        grid=grid,
        coords=grid.coords(),
        params=model.phys(),
        options=model.opts(),
        ts=model.ts,
        var_index=grid.params.var_index,
        ref_state=ref,
    )


def infer_radiation_speed(params: dict, opts: dict) -> float:
    """Static outgoing-wave speed for the Sommerfeld radiation strip:
    options['radiation_speed'] if set, else sqrt(g·H) from the physical
    params.  A setup-time scalar — callers with traced params (the
    differentiable simulator, adjoint.make_simulator) must resolve it from
    their static base values before tracing."""
    rad_c = opts.get("radiation_speed")
    if rad_c is None:
        g_ = params.get("g")
        H_ = params.get("H", params.get("Hfree"))
        if g_ is None or H_ is None:
            raise ValueError(
                "options['radiation_width'] needs options['radiation_speed'] "
                "or physical params g and H/Hfree to infer the gravity-wave "
                "speed"
            )
        rad_c = float(np.sqrt(float(g_) * float(H_)))
    return float(rad_c)


def build_modal_filter(grid: Grid, tau: float, order: int, ts: float, dtype,
                       axes: str = "rlz"):
    """Per-step scale-selective modal damping in coefficient space — the
    convection-permitting stability lever classic cloud models get from
    hyperdiffusion/limiters (beyond-reference; the reference has only the
    l_q spline penalty + 2/3 dealiasing, and its ∇²K diffusion is not
    scale-selective enough to survive a mature deep-convective cell —
    measured forensic trail in docs/RESULTS.md).

    Exact exponential damping with e-folding time ``tau`` at the grid
    scale, falling as (scale fraction)^order toward resolved scales:
      * B-spline radial axis, PER VARIABLE: F_v = Q V exp(-(ts/tau)
        λ/λmax) Vᵀ Qᵀ where Q is an orthonormal basis of range(T_v)
        (the variable's BC-constraint subspace, bspline.
        constraint_matrix) and (λ, V) eigendecompose the coefficient
        4th-difference energy (D₂ Q)ᵀ(D₂ Q) restricted to it — a true
        ∇⁴-type operator at dense-[b_r,b_r]-matmul cost that CANNOT
        move the state off its boundary conditions.  (The first
        version filtered raw coefficients; on bounded geometries that
        pushed spec out of range(T) and the per-step BC violation at
        the r→0 axis grew into a runaway — measured on the RLZ TC
        experiment, tools/probe_tc_blowup.py.  For periodic bases this
        form is also exactly wrap-preserving.)
      * Fourier axis: exp(-(ts/tau)(|k|/kmax)^order) per wavenumber;
      * Chebyshev axis: exp(-(ts/tau)(n/nmax)^order) per mode.
    All factors are ≤ 1 (unconditionally stable; symmetric with
    spectrum in [0, 1]) and equal 1 at the largest scales.  Returns a
    function spec -> spec.

    ``axes`` (options['modal_filter_axes'], default "rlz") selects which
    spectral directions are filtered.  Vertical ("z") filtering damps
    the near-wall Chebyshev modes that carry REAL boundary-layer
    structure — on the RLZ TC experiment (thin surface entropy layer
    under a balanced vortex) the z factor alone destabilized an
    otherwise-quiet run (tools/probe_tc_blowup.py); "rl" filters the
    horizontal directions only, which is where grid-point-storm
    variance lives.  When "r" is excluded the radial factor is skipped
    entirely (the state already lives in range(T), so the QQᵀ projector
    would be a wasted dense matmul).

    The F_v matmuls run through ``Grid._mm`` so the grid's matmul mode
    and precision cover them like every other operator (CLAUDE.md
    convention — a reduced-precision application of this near-identity
    operator every step would slowly erode the '<0.3% on resolved scales'
    contract).
    """
    from .basis import bspline, fourier
    from .grids.base import _split3

    p = grid.params
    g = grid._struct
    a = ts / tau
    prep = _split3 if grid.comp else (lambda o: jnp.asarray(np.asarray(o), dtype))

    br = p.b_rDim
    F_r = None
    F_rk = None
    if "r" in axes:
        fs = []
        for v in range(p.nvars):
            T = bspline.constraint_matrix(p.num_cells, p.BCL[v], p.BCR[v])
            if p.BCL[v] == bspline.BC.PERIODIC:
                # Build in the n-dim PERIODIC coefficient space, whose
                # Euclidean metric is translation-invariant (the raw
                # metric on range(T) double-weights the three seam
                # coefficients, so even a circulant energy restricted
                # via QR breaks seam uniformity — measured).  Circulant
                # D2 -> circulant filter F̂, lifted to raw coefficients
                # as T F̂ pinv(T): exactly shift-equivariant, spectrum
                # unchanged (similarity), and self-adjoint in the field
                # L2 norm (the periodic Gram matrix is circulant and
                # commutes with F̂).
                n = p.num_cells
                d2 = np.zeros((n, n))
                for i in range(n):
                    d2[i, i] = -2.0
                    d2[i, (i - 1) % n] = 1.0
                    d2[i, (i + 1) % n] = 1.0
                lam, vec = np.linalg.eigh(d2.T @ d2)
                core = (
                    vec * np.exp(-a * np.clip(lam / lam.max(), 0.0, None))
                ) @ vec.T
                fs.append(T @ core @ np.linalg.pinv(T))
                continue
            q, _ = np.linalg.qr(T)
            d2 = np.zeros((br, br))
            for i in range(1, br - 1):
                d2[i, i] = -2.0
                d2[i, i - 1] = 1.0
                d2[i, i + 1] = 1.0
            b = d2 @ q
            lam, vec = np.linalg.eigh(b.T @ b)
            lmax = lam.max()
            if lmax <= 0.0:
                fs.append(q @ q.T)
                continue
            core = (vec * np.exp(-a * np.clip(lam / lmax, 0.0, None))) @ vec.T
            fs.append(q @ core @ q.T)
        F_r = prep(np.stack(fs))
        # Ring-masked form for polar / spherical grids: the plain F_r
        # mixes radial (latitude) coefficients at FIXED zonal wavenumber
        # k, which spreads mid-domain k-content into pole rings whose
        # circumference cannot support it — the analysis ring mask is
        # bypassed because it lives in (r_physical, k) space.  Measured
        # consequence (round 4, tools/jw06_filter_probe.py): on the SLZ
        # JW06 run the filtered STEADY state blows up at the pole rings
        # within 6 h (v 3 -> 24 m/s at lat 89.4) while the 'l'-only
        # filter is quiet.  Fix: per zonal wavenumber, synthesize the
        # filtered radial coefficients to physical latitude, re-apply
        # that ring's mask, and re-analyze — F̃[v,k] = A_v M_k S F_r[v],
        # a precomputed [nvars, kDim, b_r, b_r] batched matmul.  Only
        # needed when the mask is r-DEPENDENT (uniform dealias masks
        # commute with the latitude mixing).  Applied FACTORED — synth
        # (pre-composed with F_r), elementwise mask in (ring, k) space,
        # re-analysis — rather than precomposing per-k [nvars, kDim,
        # b_r, b_r] matrices: the composed tensor is multi-GB at build
        # time on large factored-DFT grids (nl > 2048) while the
        # factored form stores only 2 x [nvars, rDim, b_r] operators
        # and costs one extra synthesis/analysis pair per application
        # (identical linear map: F̃[v,k] = A_v M_k S F_v per k).
        if grid.ring_mask is not None:
            mask = np.asarray(grid.ring_mask, np.float64)
            if not np.allclose(mask, mask[0][None, :]):
                a_ops = []
                sf_ops = []
                for v in range(p.nvars):
                    ops = bspline.build_ops(
                        p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q
                    )
                    a_ops.append(ops.analysis)  # [b_r, rDim]
                    sf_ops.append(ops.synth[0] @ fs[v])  # [rDim, b_r]
                F_rk = (
                    prep(np.stack(a_ops)),
                    prep(np.stack(sf_ops)),
                    jnp.asarray(mask, dtype),
                )
                F_r = None

    f_l = f_z = None
    if g in ("RL", "RLZ") and "l" in axes:
        if grid.l_fact is not None:
            # factored-DFT slot layout: |k| per slot from the -k^2 map
            k = np.sqrt(np.maximum(-np.asarray(grid.l_fact.fd.k_d2), 0.0))
        else:
            k = np.abs(fourier.coeff_wavenumbers(grid.nl)).astype(np.float64)
        kmax = max(k.max(), 1.0)
        f_l = jnp.asarray(np.exp(-a * (k / kmax) ** order), dtype)
    if g in ("RZ", "RLZ") and "z" in axes:
        n = np.arange(p.zDim, dtype=np.float64)
        nmax = max(p.zDim - 1, 1)
        f_z = jnp.asarray(np.exp(-a * (n / nmax) ** order), dtype)

    def apply(spec):
        out = spec
        if F_r is not None:
            out = grid._mm("vab,vb...->va...", F_r, out)
        elif F_rk is not None:
            A_st, SF_st, mk = F_rk
            if g == "RL":
                mid = grid._mm("vrb,vbk->vrk", SF_st, out) * mk[None]
                out = grid._mm("vbr,vrk->vbk", A_st, mid)
            else:  # RLZ-structured (incl. SLZ)
                mid = (
                    grid._mm("vrb,vbkK->vrkK", SF_st, out)
                    * mk[None, :, :, None]
                )
                out = grid._mm("vbr,vrkK->vbkK", A_st, mid)
        if g == "RL" and f_l is not None:
            out = out * f_l[None, None, :]
        elif g == "RZ" and f_z is not None:
            out = out * f_z[None, None, :]
        elif g == "RLZ":
            if f_l is not None:
                out = out * f_l[None, None, :, None]
            if f_z is not None:
                out = out * f_z[None, None, None, :]
        return out

    return apply


def build_surface_fluxes(grid: Grid, ctx: EqContext, cfg: dict, dtype):
    """Bulk-aerodynamic air-sea fluxes (beyond-reference): the WISHE
    engine of tropical-cyclone intensification (Emanuel 1986; Rotunno &
    Emanuel 1987).  options['surface_fluxes'] = {'sst': K, 'Ck': 1.2e-3,
    'Cd': 1.5e-3, 'depth': 600.0, 'wind_floor': 1.0}.

    Standard bulk formulas evaluated at the lowest model level:
    enthalpy/moisture fluxes Ck |U| (x_sea* - x_air) toward the saturated
    sea-surface state at the prescribed SST (x* from the framework's own
    thermodynamics at the reference-state surface pressure), and momentum
    drag -Cd |U| u.  Deposited over an exp(-z/depth) profile normalized
    to unit mass-column integral on the model levels — the spectral-
    vertical analog of a surface-layer flux divergence (a Chebyshev
    column cannot take a delta-function flux BC).  Moisture enters as a
    mu tendency through the same dmudq Jacobian convention the
    microphysics sources use.  Requires the moist perturbation variables
    (s, mu, u[, v]) and a reference state.  Returns expdot -> expdot.
    """
    from .physics import thermodynamics as td

    p = grid.params
    vi = p.var_index
    rs = ctx.ref_state
    if rs is None:
        raise ValueError("options['surface_fluxes'] requires a ref_state_file")
    for need in ("s", "mu", "u"):
        if need not in p.vars:
            raise ValueError(
                f"options['surface_fluxes'] needs variable {need!r} "
                f"(moist Euler family); got {list(p.vars)}"
            )
    sst = float(cfg["sst"])
    ck = float(cfg.get("Ck", 1.2e-3))
    cd = float(cfg.get("Cd", 1.5e-3))
    depth = float(cfg.get("depth", 600.0))
    floor = float(cfg.get("wind_floor", 1.0))

    z = np.asarray(grid.z_mish, np.float64)
    wz = np.exp(-(z - z[0]) / depth)
    trapz = getattr(np, "trapezoid", None) or np.trapz
    wz = wz / trapz(wz, z)  # [1/m], unit column integral on model levels
    wz = jnp.asarray(wz, dtype)

    # setup-time scalars from the (concrete) reference state.  This
    # builder also runs INSIDE the sharded step's shard_map trace, where
    # any jnp op — even on closed-over constants — is staged into a
    # tracer; host-read the arrays and force eager evaluation of the
    # thermodynamic closures so the scalars stay concrete.
    with jax.ensure_compile_time_eval():
        sbar0 = float(np.asarray(rs.sbar)[0, 0])
        xibar0 = float(np.asarray(rs.xibar)[0, 0])
        mubar0 = float(np.asarray(rs.mubar)[0, 0])
        _, rho0, _, p0 = (
            float(x) for x in td.thermodynamic_tuple(sbar0, xibar0, mubar0)
        )
        q_star = float(td.q_sat_liquid(jnp.asarray(sst), p0))
        s_star = float(td.entropy(jnp.asarray(sst), rho0, q_star))

    i_s, i_mu, i_u = vi("s"), vi("mu"), vi("u")
    i_v = vi("v") if "v" in p.vars else None

    def apply(expdot, phys):
        u1 = phys[i_u][..., 0]
        spd2 = u1 * u1 + floor * floor
        if i_v is not None:
            v1 = phys[i_v][..., 0]
            spd2 = spd2 + v1 * v1
        spd = jnp.sqrt(spd2)
        s1 = phys[i_s][..., 0] + sbar0
        mu1 = phys[i_mu][..., 0] + mubar0
        q1 = td.ahyp(mu1)
        f_s = ck * spd * (s_star - s1)
        f_mu = ck * spd * (q_star - q1) * td.dmudq(mu1, q1)
        expdot = expdot.at[i_s].add(f_s[..., None] * wz)
        expdot = expdot.at[i_mu].add(f_mu[..., None] * wz)
        expdot = expdot.at[i_u].add((-cd * spd * u1)[..., None] * wz)
        if i_v is not None:
            expdot = expdot.at[i_v].add((-cd * spd * v1)[..., None] * wz)
        return expdot

    return apply


def build_implicit_vdiff(grid: Grid, dtype, exclude=("xi", "qss")):
    """Backward-Euler implicit vertical diffusion (beyond-reference).

    Production cloud models treat vertical mixing implicitly because the
    near-wall spacing makes the explicit diffusive limit K*ts/dz^2
    prohibitive — on the Chebyshev column dz_min ~ L*(pi/nz)^2/2 (93 m
    for the 20 km / 24-level TC column), which caps any EXPLICIT closure
    at O(100 m^2/s) there and leaves a flux-driven TC boundary layer
    effectively unmixed (measured failure: surface v = 60 m/s and
    grid-storm collapse, docs/RESULTS.md round 3).

    With options['implicit_vdiff'], every K-diffused variable phi
    solves, per column, after the explicit/semi-implicit update:

        (I + ts * W^-1 D^T diag(w_q K_v) D) phi^{n+1} = phi*

    the SYMMETRIC (weak/flux) form of -d/dz(K d/dz): D is the
    unconstrained spectral derivative on the Gauss points and w_q the
    Chebyshev-Gauss quadrature weights, so the operator is similar to a
    symmetric negative-semidefinite matrix FOR ANY rounding of D — the
    collocation form D_r0 diag(K) D_bc this replaced measured an f32
    spectral radius of 1.0001-1.006 for R0-boundary variables (e-fold
    175-10,000 steps: the quiet h58 NaN of the first diagnostic+ivd TC
    run), while the flux form is stable by construction, conserves the
    column integral to roundoff (flux-zero walls emerge from the weak
    form; w's wall values are re-imposed by its own spectral constraint
    at the closing analysis), and needs ONE operator for all variables.
    K_v is the uncapped closure field the equation set returns
    (EqResult.k_v, coefficients lagged one step — standard practice).
    The [nz, nz] systems are assembled with one einsum and LU-solved
    BATCHED over all columns with the diffused variables as shared
    right-hand sides — dense batched column algebra, the analog of the
    reference's per-column LAPACK solves
    (semiimplicit.jl:768-781), but with a per-step spatially varying
    coefficient a precomputed factorization could not carry.  z is
    never sharded, so the solve is shard-local under every parallel
    path.
    """
    from .basis import chebyshev

    p = grid.params
    nz = p.zDim
    z0 = chebyshev.build_ops(nz, p.zmin, p.zmax, p.b_zDim)
    d_r0 = z0.dsynth @ (z0.constrain @ z0.analysis)
    # Chebyshev-Gauss quadrature weights on the (ascending) mish points
    theta = np.pi * (np.arange(nz) + 0.5) / nz
    wq = 0.5 * (p.zmax - p.zmin) * (np.pi / nz) * np.sin(theta)
    dmat = jnp.asarray(d_r0, dtype)
    wq_j = jnp.asarray(wq, dtype)
    winv = jnp.asarray(1.0 / wq, dtype)
    # xi (mass) and qss (supersaturation bookkeeping) are not
    # K-diffused, matching the equation sets' lap_mask.
    # options['vdiff_exclude'] can widen the exclusion — e.g. adding
    # "w": the vdiff solve runs AFTER the AI2* acoustic corrector, so
    # mixing w perturbs the discrete (w, xi) closure each step
    # (negligible at the TC's ts = 2-3 s; the ts = 15 JW06 ivd arm
    # died day 6 with this as the open forensic lead — ROADMAP).
    idxs = tuple(
        v for v, name in enumerate(p.vars) if name not in exclude
    )
    eye = jnp.eye(nz, dtype=dtype)
    prec = grid.precision

    def apply(var_np1, k_v, ts):
        # k_v: [*spatial] (z-last); var_np1: [nvars, *spatial]
        # S_ij = sum_m D_mi (wq_m K_m) D_mj, batched over columns
        s = jnp.einsum(
            "mi,...m,mj->...ij", dmat, wq_j * k_v, dmat, precision=prec
        )
        m = eye + ts * (winv[:, None] * s)
        rhs = jnp.stack([var_np1[i] for i in idxs], axis=-1)
        sol = jnp.linalg.solve(m, rhs)
        for k, i in enumerate(idxs):
            var_np1 = var_np1.at[i].set(sol[..., k])
        return var_np1

    return apply


def build_step(
    model: ModelParameters,
    grid: Grid,
    ctx: EqContext,
    dtype,
    analysis_fn=None,
    synthesis_fn=None,
    modal_filter_fn=None,
):
    """Returns step(state) -> state, jittable and shard_map-able.

    ``analysis_fn``/``synthesis_fn`` default to the grid's transforms; the
    sharded builder (parallel.sharding) overrides them with shard-local
    synthesis and a project+psum+solve analysis.  ``modal_filter_fn``
    overrides the per-step modal filter built from options — the sharded
    builder passes a spectral-layout-aware application (the halo path's
    state is windowed blocks, not the canonical coefficient array).
    """
    analysis_fn = analysis_fn or grid.analysis
    synthesis_fn = synthesis_fn or grid.synthesis
    eqset = get_equation_set(model.equation_set)
    if getattr(eqset, "geometry", None) and eqset.geometry != grid.geometry:
        raise ValueError(
            f"equation_set {model.equation_set!r} requires a "
            f"{eqset.geometry} grid, got {grid.geometry}"
        )
    opts = ctx.options
    if opts.get("topography_file") and "hs_grad" not in ctx.extras:
        raise ValueError(
            "options['topography_file'] is set but ctx.extras['hs_grad'] is "
            "missing — the context was built without _set_topography (every "
            "initializer must call it, or the mountain is silently dropped)"
        )
    p = grid.params
    semiimplicit = bool(opts.get("semiimplicit"))
    needs_condensation = model.equation_set in (
        "BF02_test",
        "rainfall_test",
        "MoistEulerRLZ",
        "MoistEulerXYZ",
        "MoistEulerSLZ",
    )
    si_ops = None
    if semiimplicit:
        if ctx.ref_state is None:
            raise ValueError("semiimplicit integration requires a ref_state_file")
        si_mode = opts.get("si_mode", "constant")
        if si_mode not in ("constant", "variable"):
            raise ValueError(
                f"options['si_mode'] must be 'constant' or 'variable', "
                f"got {si_mode!r}"
            )
        # 'variable': bake the per-level Pxi profile into the implicit
        # operator so the reference column's full acoustics go implicit
        # (deep-column stability, docs/NUMERICS.md); the equation sets pick
        # the matching impdot coefficient via ctx.pxi_si().
        # options['si_scale'] inflates the implicit coefficient (SHB78
        # robustness rule — see EqContext.pxi_si, which applies the SAME
        # scale to the equation sets' impdot term)
        si_scale = float(opts.get("si_scale", 1.0))
        si_ops = ti.build_semiimplicit_ops(
            p.zDim,
            p.zmin,
            p.zmax,
            p.b_zDim,
            si_scale * np.asarray(ctx.ref_state.Pxi_prof, np.float64)
            if si_mode == "variable"
            else si_scale * float(ctx.ref_state.Pxi_bar),
            model.ts,
            dtype,
        )
        w_i = p.var_index("w")
        xi_i = p.var_index("xi")

    ts = model.ts

    # Optional Rayleigh sponge near the open outer boundary: relax the
    # outer ``sponge_width`` meters toward the initial far-field state on
    # timescale ``sponge_tau`` (cos^2 ramp).  Standard limited-area
    # practice for TC domains; counters the outer-boundary wave pile-up /
    # inflow-advection instability that otherwise terminates the marginal
    # f32 flagship regime (docs/RESULTS.md round-2 analysis).  Off by
    # default — the reference has no sponge.
    sponge_sigma = None
    sponge_ref = None
    sp_w = float(opts.get("sponge_width", 0.0) or 0.0)
    if sp_w > 0.0:
        tau = float(opts.get("sponge_tau", 600.0))
        r = ctx.coords["r"]
        ramp = jnp.clip((r - (p.xmax - sp_w)) / sp_w, 0.0, 1.0)
        sponge_sigma = (jnp.sin(0.5 * jnp.pi * ramp) ** 2 / tau).astype(dtype)
        if "sponge_ref" not in ctx.extras:
            raise ValueError(
                "options['sponge_width'] needs ctx.extras['sponge_ref'] (the "
                "initial far-field state) — initialize()/initialize_sharded() "
                "set it; drivers that cannot (e.g. integrate_ensemble) do not "
                "support sponge configurations"
            )
        sponge_ref = ctx.extras["sponge_ref"]

    # Optional TOP (z) Rayleigh sponge: relax the top ``sponge_top_width``
    # meters toward the (filtered) initial state on ``sponge_top_tau``
    # seconds, sin^2 ramp — the standard absorbing layer of the published
    # global-core protocols (JW06 run their tops with absorbers; our SLZ
    # shell measured a polar model-top v-mode without one,
    # tools/jw06_r5_probe.py round 5).  Composes additively with the
    # radial sponge; both relax toward the same sponge_ref.
    sp_tw = float(opts.get("sponge_top_width", 0.0) or 0.0)
    if sp_tw > 0.0:
        if "z" not in ctx.coords:
            raise ValueError(
                "options['sponge_top_width'] needs a vertical axis "
                f"(geometry {p.geometry!r} has none)"
            )
        tau_t = float(opts.get("sponge_top_tau", 600.0))
        zc = ctx.coords["z"]
        ramp_t = jnp.clip((zc - (p.zmax - sp_tw)) / sp_tw, 0.0, 1.0)
        sigma_t = (jnp.sin(0.5 * jnp.pi * ramp_t) ** 2 / tau_t).astype(dtype)
        # options['sponge_top_vars']: restrict the absorber to named
        # variables (classical practice: damp the eddy winds — v, w —
        # and leave the thermodynamic state free to follow the
        # interior's slow discrete adjustment; a full-state relaxation
        # pins the top to t=0 against that drift and builds a forcing
        # ring at the sponge base).  Default: all variables.
        sp_vars = opts.get("sponge_top_vars")
        if sp_vars is not None:
            mask = np.zeros((grid.nvars,) + (1,) * sigma_t.ndim,
                            dtype=np.float32)
            for name in sp_vars:
                mask[p.var_index(name)] = 1.0
            sigma_t = sigma_t * jnp.asarray(mask, dtype)
        else:
            sigma_t = sigma_t[None]
        if sponge_sigma is not None:
            sponge_sigma = sponge_sigma[None] + sigma_t
        else:
            sponge_sigma = sigma_t
        if "sponge_ref" not in ctx.extras:
            raise ValueError(
                "options['sponge_top_width'] needs ctx.extras['sponge_ref'] "
                "(the initial state) — initialize()/initialize_sharded() "
                "set it"
            )
        sponge_ref = ctx.extras["sponge_ref"]

    # Optional Sommerfeld (radiating) outer boundary: over the outer
    # ``radiation_width`` meters, blend the model tendency toward the
    # one-way outgoing wave equation d(phi')/dt = -c d(phi')/dr on the
    # perturbation from the filtered initial state, with c the external
    # gravity-wave speed (options['radiation_speed'], default sqrt(g*H) /
    # sqrt(g*Hfree)).  Where the sponge merely damps what reaches the
    # boundary, this advects it out — removing the reflection itself
    # (flow-relaxation form of Orlanski 1976).  The two compose: radiation
    # carries the wave through, a sponge cleans up the slow remainder.
    # Off by default — the reference has neither.
    rad_blend = None
    rad_ref_dr = None
    rad_c = 0.0
    rad_w = float(opts.get("radiation_width", 0.0) or 0.0)
    if rad_w > 0.0:
        rad_c = infer_radiation_speed(ctx.params, opts)
        r = ctx.coords["r"]
        ramp = jnp.clip((r - (p.xmax - rad_w)) / rad_w, 0.0, 1.0)
        rad_blend = (jnp.sin(0.5 * jnp.pi * ramp) ** 2).astype(dtype)
        if "radiation_ref_dr" not in ctx.extras:
            raise ValueError(
                "options['radiation_width'] needs ctx.extras['radiation_ref_dr'] "
                "(d/dr of the filtered initial state) — initialize()/"
                "initialize_sharded() set it; drivers that cannot (e.g. "
                "integrate_ensemble) do not support radiation configurations"
            )
        rad_ref_dr = ctx.extras["radiation_ref_dr"]

    # Optional per-step modal filter (exact exponential grid-scale damping
    # in coefficient space, build_modal_filter).  Off by default — the
    # convection-permitting stabilizer for configurations whose mature
    # cells outrun the l_q/dealias/∇²K trio (docs/RESULTS.md).
    modal_filter = modal_filter_fn
    mf_tau = float(opts.get("modal_filter_tau", 0.0) or 0.0)
    if modal_filter is None and mf_tau > 0.0:
        modal_filter = build_modal_filter(
            grid, mf_tau, int(opts.get("modal_filter_order", 4)), ts, dtype,
            axes=str(opts.get("modal_filter_axes", "rlz")),
        )

    # Optional bulk air-sea fluxes (build_surface_fluxes): off by default.
    sfx_apply = None
    sfx_cfg = opts.get("surface_fluxes")
    if sfx_cfg:
        sfx_apply = build_surface_fluxes(grid, ctx, dict(sfx_cfg), dtype)

    # Optional implicit vertical diffusion (build_implicit_vdiff): off by
    # default.  Requires an equation set that exports EqResult.k_v.
    vdiff_apply = None
    if opts.get("implicit_vdiff"):
        if model.equation_set not in (
            "MoistEulerRLZ", "MoistEulerXYZ", "MoistEulerSLZ"
        ):
            raise ValueError(
                "options['implicit_vdiff'] is supported by the MoistEuler* "
                f"equation sets, not {model.equation_set!r}"
            )
        vdiff_exclude = tuple(
            opts.get("vdiff_exclude", ("xi", "qss"))
        )
        for name in vdiff_exclude:
            if name not in p.vars:
                raise ValueError(
                    f"options['vdiff_exclude'] names unknown variable "
                    f"{name!r} (vars: {list(p.vars)})"
                )
        vdiff_apply = build_implicit_vdiff(grid, dtype, vdiff_exclude)

    # options['incremental_analysis']: close the step with
    # spec + A(delta) instead of A(var_np1) — see the comment at the
    # closing analysis below.  Off by default (bitwise compatibility);
    # long f32 device integrations on near-balanced states should turn
    # it on (the JW06/SLZ configurations do).
    incremental = bool(opts.get("incremental_analysis", False))

    def step(state: ti.ModelState) -> ti.ModelState:
        fields = synthesis_fn(state.spec)
        res = eqset(fields, ctx)
        phys = fields["val"]
        for v, arr in res.overrides.items():
            phys = phys.at[v].set(arr)
        expdot = res.expdot
        if sfx_apply is not None:
            expdot = sfx_apply(expdot, phys)
        if rad_blend is not None:
            rad_dot = -rad_c * (fields["dr"] - rad_ref_dr)
            expdot = (1.0 - rad_blend)[None] * expdot + rad_blend[None] * rad_dot
        if sponge_sigma is not None:
            # radial-only sigma is [*spatial]; any top-sponge sigma
            # already carries the leading variable axis
            sig = (sponge_sigma if sponge_sigma.ndim == phys.ndim
                   else sponge_sigma[None])
            expdot = expdot - sig * (phys - sponge_ref)
        var_np1, e_nm1, e_nm2 = ti.explicit_step(
            phys, expdot, state.expdot_nm1, state.expdot_nm2, state.t, ts
        )
        impdot = res.impdot
        i_nm1, i_nm2 = state.impdot_nm1, state.impdot_nm2
        # slim implicit history (ti.ModelState doc): [[w, xi], *spatial]
        # instead of [nvars, *spatial] — the AI2* corrector reads only
        # those rows, and the full-width tensors cost real lax.scan
        # carry time (round-4 forensics).  Static-shape branch.
        slim = (
            state.impdot_nm1.shape[0] == 2
            and state.impdot_nm1.shape != state.expdot_nm1.shape
        )
        if slim and not semiimplicit:
            raise ValueError(
                "slim impdot history (imp_rows=2) requires "
                "options['semiimplicit'] — use full-width initial_state"
            )
        if semiimplicit:
            hw, hx = (0, 1) if slim else (w_i, xi_i)
            w_new, xi_new = ti.semiimplicit_adjustment(
                si_ops,
                var_np1[w_i],
                var_np1[xi_i],
                impdot[w_i],
                state.impdot_nm1[hw],
                state.impdot_nm2[hw],
                impdot[xi_i],
                state.impdot_nm1[hx],
                state.impdot_nm2[hx],
                state.t,
            )
            var_np1 = var_np1.at[w_i].set(w_new).at[xi_i].set(xi_new)
        if impdot is not None:
            i_n = jnp.stack([impdot[w_i], impdot[xi_i]]) if slim else impdot
            i_nm1, i_nm2 = i_n, state.impdot_nm1
        if vdiff_apply is not None:
            var_np1 = vdiff_apply(var_np1, res.k_v, ts)
        if needs_condensation:
            var_np1 = mp.condensation_adjustment(var_np1, impdot, ctx)
        if incremental:
            # Incremental closing analysis: spec + A(var_np1 - S spec).
            # Algebraically identical to A(var_np1) when A S = I, but the
            # STANDING state never passes through the roundtrip, so the
            # compensated-bf16 GEMM's ~1e-6 systematic fit bias applies
            # only to the per-step increment (~tendency*ts), not the full
            # field.  Measured (tools/jw06_r5_fititer.py): the classical
            # form drifts the balanced JW06 zonal mean by +0.9 K/1000
            # steps at the polar surface and erodes the jet 0.16 m/s/1000
            # steps on device with ZERO dynamics — at 5760 steps/day this
            # collapses the tropical low-level stratification by day ~7
            # (the round-5 "equatorial surface killer").  The delta must
            # be taken against the ORIGINAL synthesis value (fields
            # ["val"]), not the override-patched phys, for the identity
            # to hold.
            spec_new = state.spec + analysis_fn(var_np1 - fields["val"])
        else:
            spec_new = analysis_fn(var_np1)
        if modal_filter is not None:
            spec_new = modal_filter(spec_new)
        return ti.ModelState(
            spec=spec_new,
            expdot_nm1=e_nm1,
            expdot_nm2=e_nm2,
            impdot_nm1=i_nm1,
            impdot_nm2=i_nm2,
            t=state.t + 1,
        )

    return step


def make_scan(step, n_steps: int, unroll: int = 4):
    """Jitted scan of ``step``, COMPOSED ``unroll`` steps per scan
    iteration.

    Composing steps removes part of the multistep-history carry shuffle
    (e_nm2 <- e_nm1 pass-throughs of the physical history tensors) that
    a one-step scan body pays every step (tools/probe_scan_carry.py
    measures the variants).  Composition preserves operation order —
    trajectories are bitwise identical; the cost is compile time
    (body x unroll)."""
    k = max(1, min(int(unroll), int(n_steps)))

    def chunk(state):
        if n_steps // k:
            def body(s, _):
                for _ in range(k):
                    s = step(s)
                return s, None

            state, _ = jax.lax.scan(body, state, None, length=n_steps // k)
        for _ in range(n_steps % k):
            state = step(state)
        return state

    return jax.jit(chunk)


def _pick_chunk(output_int: int, cap: int = 384) -> int:
    """Largest divisor of the output interval <= cap.

    XLA compile time grows with the number of steps composed into one
    program, so long output intervals are executed as repeats of one
    bounded, compiled-once scan."""
    if output_int <= cap:
        return output_int
    for c in range(cap, 0, -1):
        if output_int % c == 0:
            return c
    return output_int


def imp_history_rows(model: ModelParameters) -> int | None:
    """Implicit-history width for ti.initial_state: the slim 2-row
    [w, xi] layout for semi-implicit configurations (the AI2* corrector
    is the only consumer — ti.ModelState doc), full width otherwise."""
    return 2 if model.opts().get("semiimplicit") else None


def initialize(model: ModelParameters, dtype=None, matmul="auto"):
    """Build grid, context, initial state from the IC file (ref
    initialize_model, semiimplicit.jl:126-193).  ``matmul`` forwards to
    create_grid."""
    dtype = dtype or default_dtype()
    grid = create_grid(model.grid_params, dtype, matmul=matmul)
    ctx = build_context(model, grid, dtype)
    phys0 = sio.read_physical_grid(model.initial_conditions, grid)
    spec0 = grid.analysis(jnp.asarray(phys0, dtype))
    _set_boundary_refs(ctx, grid, spec0)
    _set_topography(ctx, grid)
    state = ti.initial_state(
        spec0,
        (grid.nvars,) + grid.spatial_shape,
        dtype,
        imp_rows=imp_history_rows(model),
    )
    return grid, ctx, state


def _set_topography(ctx, grid):
    """Optional bottom topography for the spherical shallow-water set:
    ``options['topography_file']`` names a CSV (reference IC schema:
    coordinate columns then an ``hs`` column on this grid's points).
    The momentum PGF then acts on the free surface h + h_s via the
    spectrally-filtered gradient (equations/sphere.py) — the same
    derive-extras-inside-initialize pattern as the sponge/radiation
    references below."""
    topo = ctx.options.get("topography_file")
    if not topo:
        return
    names, data = sio._read_csv(topo)
    if "hs" not in names:
        raise ValueError(f"topography file {topo} needs an 'hs' column")
    if data.shape[0] != grid.num_points:
        raise ValueError(
            f"topography file {topo} has {data.shape[0]} rows; grid has "
            f"{grid.num_points} points"
        )
    hs = data[:, names.index("hs")].reshape(grid.spatial_shape)
    pad = np.zeros((grid.nvars,) + grid.spatial_shape)
    pad[0] = hs
    f = grid.synthesis(grid.analysis(jnp.asarray(pad)))
    ctx.extras["hs_grad"] = jnp.stack([f["dr"][0], f["dl"][0]])
    ctx.extras["hs_filtered"] = f["val"][0]


def _set_boundary_refs(ctx, grid, spec0):
    """Reference-state extras for the optional outer-boundary treatments:
    both relax toward / radiate against the *filtered* initial state (what
    the spline space actually represents), not the raw ICs."""
    need_sponge = (
        float(ctx.options.get("sponge_width", 0.0) or 0.0) > 0.0
        or float(ctx.options.get("sponge_top_width", 0.0) or 0.0) > 0.0
    )
    need_rad = float(ctx.options.get("radiation_width", 0.0) or 0.0) > 0.0
    if not (need_sponge or need_rad):
        return
    fields0 = grid.synthesis(spec0)
    if need_sponge:
        ctx.extras["sponge_ref"] = fields0["val"]
    if need_rad:
        ctx.extras["radiation_ref_dr"] = fields0["dr"]


def integrate_model(
    model: ModelParameters,
    dtype=None,
    write_outputs=True,
    resume_from: str | None = None,
    profile_dir: str | None = None,
):
    """Public driver (ref integrate_model, src/Scythe.jl:37-62).

    Runs ``integration_time / ts`` steps, writing CSV output and running the
    NaN watchdog every ``output_interval`` (plus t=0 and the final time).
    Returns (grid, final physical values [nvars, *spatial]).

    Beyond the reference:
    * ``options['checkpoint_interval']`` (seconds) writes binary full-state
      checkpoints (spectral coefficients + multistep history) alongside the
      CSV output; ``resume_from`` restarts bitwise-exactly from one — the
      reference's only restart path is lossy CSV round-tripping (SURVEY.md 5).
    * ``profile_dir`` wraps the loop in a JAX profiler trace.
    """
    dtype = dtype or default_dtype()
    with logged_run(model, profile_dir):
        return _run(model, dtype, write_outputs, resume_from)


class logged_run:
    """Context manager shared by the single-device and sharded drivers:
    scythe_out.log file handler + optional JAX profiler trace."""

    def __init__(self, model: ModelParameters, profile_dir: str | None = None):
        self.model = model
        self.profile_dir = profile_dir
        self._trace = None

    def __enter__(self):
        self.handler = None
        if jax.process_index() == 0:
            os.makedirs(self.model.output_dir, exist_ok=True)
            self.handler = logging.FileHandler(
                os.path.join(self.model.output_dir, "scythe_out.log")
            )
            log.addHandler(self.handler)
        log.setLevel(logging.INFO)
        if self.profile_dir:
            self._trace = jax.profiler.trace(self.profile_dir)
            self._trace.__enter__()
        return self

    def __exit__(self, *exc):
        if self._trace is not None:
            self._trace.__exit__(*exc)
        if self.handler is not None:
            log.removeHandler(self.handler)
        return False


def _run(model: ModelParameters, dtype, write_outputs, resume_from=None):
    t_setup = _time.time()
    grid, ctx, state = initialize(model, dtype)
    step = build_step(model, grid, ctx, dtype)
    return run_loop(
        model,
        grid,
        ctx,
        state,
        step,
        dtype,
        write_outputs=write_outputs,
        resume_from=resume_from,
        t_setup=t_setup,
    )


def run_loop(
    model: ModelParameters,
    grid,
    ctx,
    state,
    step,
    dtype,
    *,
    write_outputs=True,
    resume_from=None,
    t_setup=None,
    to_canonical=None,
    from_canonical=None,
    gather=None,
):
    """The shared output/checkpoint/watchdog time loop (ref run_model +
    model_loop, src/semiimplicit.jl:219-293).  The sharded driver passes
    ``to_canonical``/``from_canonical`` to map between its spectral state
    layout (e.g. halo-windowed blocks) and the canonical spectral array used
    for synthesis, checkpoints, and resume, and ``gather`` (multi-process
    runs) to bring cross-process-sharded arrays to the host; files are
    written by process 0 only."""
    t_setup = t_setup or _time.time()
    t_sim0 = 0.0
    if resume_from:
        state0, t_sim0 = sio.load_checkpoint(resume_from, dtype)
        if from_canonical is not None:
            state0 = from_canonical(state0)
        state = state0
        log.info("Resumed from %s at t=%s (step %d)", resume_from, t_sim0, int(state.t))
    num_ts = model.num_ts
    output_int = max(1, min(model.output_int, num_ts))
    chunk = _pick_chunk(output_int)
    scan = make_scan(step, chunk)
    log.info(
        "Initialized %s on %s grid: %d vars, %s points, %d steps",
        model.equation_set,
        grid.geometry,
        grid.nvars,
        grid.spatial_shape,
        num_ts,
    )

    gather = gather or np.asarray
    primary = jax.process_index() == 0
    write_outputs = write_outputs and primary

    def canonical_spec(st):
        spec = jnp.asarray(gather(st.spec))
        if to_canonical is not None:
            spec = to_canonical(spec)
        return spec

    def canonical(st):
        st = st._replace(
            spec=canonical_spec(st),
            expdot_nm1=jnp.asarray(gather(st.expdot_nm1)),
            expdot_nm2=jnp.asarray(gather(st.expdot_nm2)),
            impdot_nm1=jnp.asarray(gather(st.impdot_nm1)),
            impdot_nm2=jnp.asarray(gather(st.impdot_nm2)),
        )
        return st

    def fetch_phys(st):
        return np.asarray(grid.synthesis(canonical_spec(st))["val"])

    ckpt_interval = ctx.options.get("checkpoint_interval", 0.0)
    ckpt_int = int(round(ckpt_interval / model.ts)) if ckpt_interval else 0

    write_spec = bool(ctx.options.get("write_spectral"))
    phys = fetch_phys(state)
    if write_outputs and not resume_from:
        sio.check_cfl(grid, phys)
        sio.write_output(grid, model, t_sim0, phys)
        if write_spec:
            sio.write_spectral(grid, model, t_sim0, canonical_spec(state))
    log.info("Setup in %.2fs; starting integration", _time.time() - t_setup)

    t_run = _time.time()
    steps_done = 0
    while steps_done < num_ts:
        n = min(output_int, num_ts - steps_done)
        if n % chunk == 0:
            for _ in range(n // chunk):
                state = scan(state)
        else:
            state = make_scan(step, n)(state)
        steps_done += n
        t_sim = t_sim0 + steps_done * model.ts
        phys = fetch_phys(state)
        sio.check_cfl(grid, phys)
        if write_outputs:
            sio.write_output(grid, model, t_sim, phys)
            if write_spec:
                sio.write_spectral(grid, model, t_sim, canonical_spec(state))
        if ckpt_int and steps_done % ckpt_int == 0:
            ckpt_state = canonical(state)
            if primary:
                path = os.path.join(
                    model.output_dir, f"checkpoint_{round(t_sim, 2)}.npz"
                )
                sio.save_checkpoint(path, ckpt_state, t_sim)
                log.info("checkpoint: %s", path)
        log.info("ts: %s", t_sim)
    wall = _time.time() - t_run
    gps = grid.num_points * num_ts / wall if wall > 0 else float("inf")
    log.info(
        "Done: %d steps in %.3fs (%.1f steps/s, %.3e grid-point-steps/s)",
        num_ts,
        wall,
        num_ts / wall,
        gps,
    )
    return grid, phys


def integrate_ensemble(
    model: ModelParameters, ics: np.ndarray, dtype=None, mesh=None
):
    """Run a vmapped ensemble of initial conditions through the model.

    ``ics``: [n_members, nvars, *spatial] physical initial conditions.
    Returns final physical fields [n_members, nvars, *spatial].  Ensemble
    members batch through every transform GEMM (larger GEMMs) — a JAX-native capability with no reference counterpart.

    ``mesh``: optional single-axis `jax.sharding.Mesh`
    (`parallel.sharding.make_ensemble_mesh()`): members are sharded across
    its devices.  Members are independent, so XLA partitions the program
    with zero inter-chip communication — embarrassingly-parallel weak
    scaling over however many chips the mesh spans.  `n_members` must be
    divisible by the mesh size.
    """
    dtype = dtype or default_dtype()
    sharding_in = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axis = mesh.axis_names[0]
        if len(ics) % mesh.shape[axis]:
            raise ValueError(
                f"n_members={len(ics)} must be divisible by the "
                f"{mesh.shape[axis]}-device ensemble mesh"
            )
        sharding_in = NamedSharding(mesh, PartitionSpec(axis))
    grid = create_grid(model.grid_params, dtype)
    ctx = build_context(model, grid, dtype)
    step = build_step(model, grid, ctx, dtype)
    num_ts = model.num_ts

    def member(phys0):
        spec = grid.analysis(phys0)
        state = ti.initial_state(
            spec, phys0.shape, dtype, imp_rows=imp_history_rows(model)
        )

        def body(s, _):
            return step(s), None

        out, _ = jax.lax.scan(body, state, None, length=num_ts)
        return grid.synthesis(out.spec)["val"]

    arr = jnp.asarray(ics, dtype)
    if sharding_in is not None:
        arr = jax.device_put(arr, sharding_in)
        run = jax.jit(jax.vmap(member), out_shardings=sharding_in)
    else:
        run = jax.jit(jax.vmap(member))
    out = np.asarray(run(arr))
    sio.check_cfl(grid, out.reshape((-1,) + grid.spatial_shape))
    return grid, out
