"""Benchmark harness: flagship two-layer shallow-water TC run.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Workload: the Cha & Bell (2024) Twoway_ShallowWater_Slab configuration
(BASELINE.json config 4): RL grid, 100 radial cells (300 mish points) x 256
azimuthal points, 6 variables, ts=3 s.  Metric is grid-point-steps/s on the
accelerator (float32).

``vs_baseline``: the reference (Julia) publishes no numbers and is not
runnable in this container (no Julia toolchain), so the baseline is a
measured proxy: the same numerics in float64 on this container's CPU via
the XLA CPU backend — an optimistic stand-in for the reference's
single-node multi-process envelope (the reference is float64 CPU-only,
shared-memory; README.md:7).  vs_baseline = accel_gps / cpu_f64_gps.
"""

import json
import os
import sys
import time

import numpy as np


def build(num_cells=100, nl=256, dtype=None):
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_model, _vortex_state
    from scythe_tpu.grids.base import create_grid
    from scythe_tpu.model import build_context, build_step

    model = _flagship_model(num_cells=num_cells, nl=nl)
    grid = create_grid(model.grid_params, dtype)
    ctx = build_context(model, grid, dtype)
    step = build_step(model, grid, ctx, dtype)
    state = _vortex_state(grid, dtype)
    return model, grid, step, state


def _best_time(call, reps):
    best = np.inf
    for _ in range(reps):
        t0 = time.time()
        call()
        best = min(best, time.time() - t0)
    return best


def slope_time(make_call, n_short, n_long, reps=3):
    """Per-iteration time of an on-device chain, as the SLOPE between two
    chain lengths: (t(n_long) - t(n_short)) / (n_long - n_short).

    Every host->device execution call carries a fixed host cost (launch,
    argument handling, the closing fetch) independent of program size.  A
    single-length measurement folds that constant into the per-step time,
    while the slope cancels it and reports the device rate of a long
    run.  Returns (seconds_per_iteration, fixed_seconds).
    """
    c_short, c_long = make_call(n_short), make_call(n_long)
    c_short()  # warmup (compile + first-dispatch)
    c_long()
    t_s = _best_time(c_short, reps)
    t_l = _best_time(c_long, reps)
    per = max(t_l - t_s, 1e-12) / (n_long - n_short)
    return per, max(t_s - n_short * per, 0.0)


def measure(device, dtype, ns=(100, 800), reps=3):
    import jax

    from scythe_tpu.model import make_scan

    with jax.default_device(device):
        model, grid, step, state0 = build(dtype=dtype)
        t0 = time.time()
        final = {}

        def make_call(n):
            scan = make_scan(step, n)

            def call():
                out = scan(state0)
                float(out.spec[0, 0, 0])  # fetch closes the timed region
                final["state"] = out

            return call

        per, fixed = slope_time(make_call, *ns, reps=reps)
        setup_s = time.time() - t0  # compiles + warmups + timed reps
        if not np.isfinite(np.asarray(final["state"].spec)).all():
            raise FloatingPointError("benchmark run produced non-finite state")
        gps = grid.num_points / per
        return dict(
            points=grid.num_points,
            steps_per_s=1.0 / per,
            grid_point_steps_per_s=gps,
            dispatch_fixed_ms=round(fixed * 1e3, 2),
            setup_s=round(setup_s, 2),
        )


def _enable_compile_cache():
    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()


# Published peaks per device, keyed by the exact ``device_kind`` JAX
# reports.  NVIDIA H100 SXM data sheet, dense rates at the full 700 W
# power limit: 989 TFLOP/s bf16 and 495 TF32 on the tensor cores, 67
# TFLOP/s float32 outside them, 3.35 TB/s HBM3.  A card set below 700 W
# (nvidia-smi power.limit, printed beside every result) cannot hold these.
# "f32" is the rate of the HIGHEST-precision plain contractions,
# "bf16" the rate the compensated scheme rides.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12, "tf32": 495e12, "f32": 67e12, "hbm": 3.35e12,
    },
}


def peak_rates(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error,
    never a silent None in the roofline fields."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add a row "
            f"with its source to bench.PEAKS"
        ) from None


def card_stamp() -> str:
    """The card's name and power limit as nvidia-smi reports them (read
    with a subprocess, not through JAX)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def rlz_transform_bench(device, dtype, reps=3, ns=(64, 256)):
    """Transform-only throughput on a 3-D RLZ grid (the BASELINE.json
    primary metric 'grid-points/s per chip (RLZ transforms)'): one full
    synthesis (all 7 derivative slots) + analysis round trip, timed as the
    slope between two on-device scan-chain lengths (see slope_time)."""
    import jax
    import jax.numpy as jnp

    from scythe_tpu import GridParameters, create_grid

    with jax.default_device(device):
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
        )
        grid = create_grid(gp, dtype)
        spec = jnp.ones(grid.spectral_shape, dtype) * 1e-3

        def roundtrip(s):
            out = grid.synthesis(s)
            # keep every derivative slot alive (the real step consumes all
            # 7; without this XLA dead-code-eliminates ~37% of the work)
            keep = sum(
                jnp.sum(out[k]) for k in grid.field_keys if k != "val"
            )
            return grid.analysis(out["val"]) + keep * 1e-30

        t0 = time.time()

        def make_call(n):
            def chain_fn(s0):
                out, _ = jax.lax.scan(
                    lambda c, _: (roundtrip(c), None), s0, None, length=n
                )
                return out

            compiled = jax.jit(chain_fn).lower(spec).compile()
            return lambda: float(compiled(spec)[0, 0, 0, 0])

        # flop + HBM-byte counts from the single-roundtrip compile: XLA
        # cost analysis does not scale a scan body by its trip count
        single = jax.jit(roundtrip).lower(spec).compile()
        ca = single.cost_analysis() or {}
        flops = float(ca.get("flops", 0.0))
        hbm_bytes = float(ca.get("bytes accessed", 0.0))
        dt, fixed = slope_time(make_call, *ns, reps=reps)
        setup_s = time.time() - t0  # compiles + warmups + timed reps
        gps = grid.num_points * gp.nvars / dt
        peaks = peak_rates(device.device_kind)
        peak = peaks["bf16" if grid.comp else "f32"]
        mfu = (flops / dt / peak) if flops else None
        # bandwidth roofline: achieved HBM traffic rate as a fraction of
        # the chip's peak (BASELINE.md gate)
        peak_bw = peaks["hbm"]
        hbm_frac = (hbm_bytes / dt / peak_bw) if hbm_bytes else None
        # The cost-analysis byte count is an UPPER envelope: it counts
        # logical operand bytes, including accesses fusion keeps in
        # registers or cache, so it cannot gate a roofline.
        # Floor bound from the tensors the dataflow must materialize at
        # least once: the 7 synthesis slot tensors + the val tensor
        # re-read by analysis + spec in/out.  The TRUE traffic sits
        # between the two; the floor is the gateable number.
        itemsize = jnp.dtype(dtype).itemsize
        phys_bytes = grid.num_points * gp.nvars * itemsize
        min_bytes = (len(grid.field_keys) + 1) * phys_bytes + 2 * int(
            np.prod(grid.spectral_shape)
        ) * itemsize
        hbm_frac_min = min_bytes / dt / peak_bw
        # First-principles DATAFLOW byte audit (round-5, closes the
        # BASELINE roofline gate): enumerate every GEMM edge of the fast
        # (deriv_single) RLZ round trip — each intermediate tensor is
        # written by exactly one GEMM and read by its consumers, and
        # GEMMs cannot fuse into each other, so each edge moves its
        # tensor through HBM at least once.  Edges (S = spec elements,
        # C = [v,b,l,z] coefficient-block elements, P = physical slot
        # elements): reads 2S + 10C + 8P (spec x2; zval x2; zd; lval x2;
        # ld; lz; val by analysis; hat; rc; 6 derivative slots by the
        # consumer), writes S + 9C + 8P (zval, zd, lval, ld, lz, rdv,
        # rl, rz, val, hat, rc, spec') -> 3S + 19C + 16P element-moves.
        # Charged at 2 bytes/element — the bf16 floor no compilation of
        # this dataflow can beat (the compensated value chain actually
        # needs f32 on several edges, so true traffic is strictly
        # higher).  audited/dt is therefore a PROVEN lower bound on the
        # achieved HBM fraction.
        S = int(np.prod(grid.spectral_shape))
        C = gp.nvars * gp.b_rDim * grid.nl * gp.zDim
        P = grid.num_points * gp.nvars
        audited_elems = 3 * S + 19 * C + 16 * P
        audited_bytes = 2 * audited_elems
        hbm_gbps_audited = audited_bytes / dt / 1e9
        hbm_frac_audit = audited_bytes / dt / peak_bw
        return dict(
            points=grid.num_points,
            nvars=gp.nvars,
            transform_roundtrips_per_s=1.0 / dt,
            grid_points_per_s=gps,
            flops_per_roundtrip=flops,
            tflops_per_s=flops / dt / 1e12 if flops else None,
            mfu_est=mfu,
            hbm_bytes_per_roundtrip=hbm_bytes,
            hbm_gb_per_s=hbm_bytes / dt / 1e9 if hbm_bytes else None,
            hbm_fraction=hbm_frac,
            hbm_fraction_min=hbm_frac_min,
            hbm_bytes_audited=audited_bytes,
            hbm_gbps_audited=round(hbm_gbps_audited, 1),
            hbm_fraction_audited=round(hbm_frac_audit, 4),
            dispatch_fixed_ms=round(fixed * 1e3, 2),
            setup_s=round(setup_s, 2),
        )


def moist3d_model(n_steps=120):
    """The moist3d workload config, shared by moist3d_bench and
    tools/profile_moist3d.py (so the per-stage profile always decomposes
    the exact benchmark workload)."""
    import tempfile

    from scythe_tpu import BC, GridParameters, ModelParameters

    gp = GridParameters(
        geometry="RLZ",
        xmin=0.0,
        xmax=20000.0,
        num_cells=48,
        lDim=64,
        zmin=0.0,
        zmax=10000.0,
        zDim=48,
        BCL={"u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0, "v": BC.R0},
        vars={
            "s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
            "mu_c": 7, "mu_r": 8, "qss": 9,
        },
    )
    zs = np.linspace(0.0, 12000.0, 40)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    snd = tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False)
    snd.write(f"1015.0 {theta[0]} {qv[0]}\n")
    for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
        snd.write(f"{z} {th} {q}\n")
    snd.close()
    return ModelParameters(
        ts=0.15,
        integration_time=n_steps * 0.15,
        output_interval=n_steps * 0.15,
        equation_set="MoistEulerRLZ",
        initial_conditions="unused.csv",
        output_dir=os.path.join(tempfile.gettempdir(), "moist3d_bench"),
        ref_state_file=snd.name,
        grid_params=gp,
        physical_params={"K": 10.0, "f": 5.0e-5},
        options={"semiimplicit": True},
    )


def moist3d_state(model, grid, dtype):
    """The moist3d initial state: a 2 K-scale warm entropy bubble 6 km off
    the axis at 2.5 km height, resting otherwise."""
    import jax

    from scythe_tpu import timeintegration as ti
    from scythe_tpu.model import imp_history_rows

    gp = model.grid_params
    pts = grid.gridpoints()
    r, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    x, y = r * np.cos(lam), r * np.sin(lam)
    rad = np.sqrt(
        ((x - 6000.0) / 2000.0) ** 2
        + (y / 2000.0) ** 2
        + ((z - 2500.0) / 2000.0) ** 2
    )
    s_pert = 2.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    phys0 = np.zeros((gp.nvars,) + grid.spatial_shape)
    phys0[0] = s_pert.reshape(grid.spatial_shape)
    spec0 = grid.analysis(jax.numpy.asarray(phys0, dtype))
    return ti.initial_state(
        spec0,
        (gp.nvars,) + grid.spatial_shape,
        dtype,
        imp_rows=imp_history_rows(model),
    )


def moist3d_bench(device, dtype, ns=(20, 120), reps=3):
    """Full 3-D cylindrical moist compressible core (MoistEulerRLZ, 9 vars,
    semi-implicit + warm rain + condensation adjustment) at production-ish
    resolution — the heavy RLZ path the transforms metric proxies, run as
    the real model step."""
    import jax

    from scythe_tpu.grids.base import create_grid
    from scythe_tpu.model import build_context, build_step, make_scan

    with jax.default_device(device):
        model = moist3d_model(n_steps=ns[1])
        gp = model.grid_params
        grid = create_grid(gp, dtype)
        ctx = build_context(model, grid, dtype)
        step = build_step(model, grid, ctx, dtype)
        state0 = moist3d_state(model, grid, dtype)
        t0 = time.time()
        final = {}

        def make_call(n):
            scan = make_scan(step, n)

            def call():
                out = scan(state0)
                float(out.spec[0, 0, 0, 0])
                final["state"] = out

            return call

        per, fixed = slope_time(make_call, *ns, reps=reps)
        setup_s = time.time() - t0  # compiles + warmups + timed reps
        if not np.isfinite(np.asarray(final["state"].spec)).all():
            raise FloatingPointError("moist3d bench produced non-finite state")
        return dict(
            points=grid.num_points,
            nvars=gp.nvars,
            steps_per_s=1.0 / per,
            grid_point_steps_per_s=grid.num_points / per,
            dispatch_fixed_ms=round(fixed * 1e3, 2),
            setup_s=round(setup_s, 2),
        )


def ensemble_bench(device, dtype, members=16, ns=(20, 120), reps=3):
    """Aggregate throughput of a vmapped ensemble of the flagship config
    (`integrate_ensemble`, the production parameter-study / serving mode):
    members batch through every transform GEMM, fattening the GEMMs."""
    import jax
    import jax.numpy as jnp

    with jax.default_device(device):
        model, grid, step, state = build(dtype=dtype)
        amps = jnp.asarray(1.0 + np.arange(members) / 100.0, dtype)
        states = jax.tree.map(
            lambda x: jnp.stack([x] * members), state
        )._replace(
            spec=state.spec[None]
            * amps[:, None, None, None].astype(state.spec.dtype)
        )

        t0 = time.time()
        final = {}

        def make_call(n):
            def member(st):
                def body4(s, _):
                    for _ in range(4):
                        s = step(s)
                    return s, None

                out, _ = jax.lax.scan(body4, st, None, length=n // 4)
                for _ in range(n % 4):
                    out = step(out)
                return out

            run = jax.jit(jax.vmap(member))

            def call():
                out = run(states)
                float(out.spec[0, 0, 0, 0])
                final["state"] = out

            return call

        per, fixed = slope_time(make_call, *ns, reps=reps)
        setup_s = time.time() - t0  # compiles + warmups + timed reps
        if not np.isfinite(np.asarray(final["state"].spec)).all():
            raise FloatingPointError("ensemble bench produced non-finite state")
        return dict(
            members=members,
            grid_point_steps_per_s=members * grid.num_points / per,
            dispatch_fixed_ms=round(fixed * 1e3, 2),
            setup_s=round(setup_s, 2),
        )


def scaling_bench(n_steps=20):
    """Weak scaling over however many devices are visible (a virtual CPU
    mesh here).  Uses the scalable halo/Schur sharded path for n >= 2.

    NB on virtual devices: n virtual CPU devices share the host's cores,
    so the compute ceiling itself is cores/n — the numbers bound
    framework/comm overhead, not interconnect scaling."""
    import jax
    import jax.numpy as jnp

    from scythe_tpu.model import build_context, make_scan
    from scythe_tpu.parallel import sharding as sh
    from scythe_tpu.grids.base import create_grid
    from __graft_entry__ import _flagship_model, _vortex_state

    results = {}
    ndev = len(jax.devices())
    for n in [1, 2, 4, 8]:
        if n > ndev:
            break
        model = _flagship_model(num_cells=24 * n, nl=128)
        mesh = sh.make_mesh(n)
        grid = create_grid(model.grid_params, jnp.float32)
        ctx = build_context(model, grid, jnp.float32)
        method = "halo" if n >= 2 else "psum"
        state = _vortex_state(grid, jnp.float32)
        if method == "halo":
            state = state._replace(
                spec=sh.spec_to_blocks(state.spec, n, model.grid_params.num_cells // n)
            )
        state = sh.shard_state(state, mesh, method)
        step = sh.build_sharded_step(model, grid, ctx, jnp.float32, mesh, method)
        scan = make_scan(step, n_steps)
        state = jax.block_until_ready(scan(state))
        t0 = time.time()
        state = jax.block_until_ready(scan(state))
        dt = time.time() - t0
        results[n] = grid.num_points * n_steps / dt
    base = results[1]
    cores = os.cpu_count() or 4
    return {
        n: dict(
            gps=v,
            # speedup over the 1-device run at n-times the workload; the
            # honest ceiling on this box is the core count (virtual
            # devices share cores AND the 1-device baseline already uses
            # XLA intra-op threading across all of them), so per-n
            # "efficiency" is not claimable here — real scaling needs
            # real chips (ROADMAP.md).
            speedup_vs_1dev=v / base,
            ceiling=float(min(n, cores)),
        )
        for n, v in results.items()
    }


# numerics canary bound: true float32 sits far below it, TF32 operand
# rounding (what an f32 GEMM at DEFAULT precision may run as on a GPU) far
# above.  Measured values are in PERF.md ("Bring-up findings (H100)").
CANARY_TOL = 1e-4


def canary_error(grid) -> float:
    """Max relative error of 10 chained analysis+synthesis round trips on
    ``grid`` (a 96 x 64 RL grid with 2 variables, run on the device its
    arrays live on) against CPU float64 truth."""
    import jax
    import jax.numpy as jnp

    from scythe_tpu import create_grid

    rng = np.random.default_rng(0)
    f0 = rng.normal(size=(2, 96, 64)).astype(np.float32)

    def chain(g, f):
        def body(c, _):
            return g.synthesis(g.analysis(c))["val"], None
        out, _ = jax.lax.scan(body, f, None, length=10)
        return out

    with jax.default_device(jax.devices("cpu")[0]):
        g64 = create_grid(grid.params, jnp.float64, matmul="plain")
        truth = np.asarray(
            jax.jit(lambda f: chain(g64, f))(jnp.asarray(f0, jnp.float64))
        )
    device = list(grid.synth_r.devices())[0]
    x = jax.device_put(jnp.asarray(f0, grid.dtype), device)
    out = np.asarray(jax.jit(lambda f: chain(grid, f))(x), np.float64)
    return float(np.abs(out - truth).max() / (np.abs(truth).max() + 1e-30))


def canary_grid_params():
    from scythe_tpu import GridParameters

    return GridParameters(
        geometry="RL", xmin=0.0, xmax=3.0e5, num_cells=32, lDim=64,
        vars={"a": 1, "b": 2},
    )


def numerics_canary(device, dtype):
    """Guard against matmul-precision regressions (TF32 or bf16 operand
    rounding, or XLA folding the compensated residual away,
    docs/NUMERICS.md): the transform chain on ``device`` must stay within
    ``CANARY_TOL`` of the CPU float64 result.  Returns the error."""
    import jax

    from scythe_tpu import create_grid

    with jax.default_device(device):
        g = create_grid(canary_grid_params(), dtype)
    err = canary_error(g)
    ok = err < CANARY_TOL
    print(f"numerics canary: rel err {err:.3e} (bound {CANARY_TOL:.0e}) -> "
          f"{'PASS' if ok else 'FAIL'}", file=sys.stderr)
    if not ok:
        raise FloatingPointError(
            f"accelerator transform precision regression: rel err {err:.2e}"
        )
    return err


def _scaling_subprocess():
    """Run scaling_bench on an 8-virtual-device CPU mesh in a subprocess
    (JAX_PLATFORMS=cpu: it never opens the GPU) and return
    {n: weak_scaling_eff}."""
    import os
    import subprocess

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    out = subprocess.run(
        [sys.executable, __file__, "--scaling-only"],
        capture_output=True,
        text=True,
        timeout=900,
        env=env,
    )
    if out.returncode != 0:
        print(f"scaling subprocess failed:\n{out.stderr[-2000:]}", file=sys.stderr)
        return None
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    import jax

    if "--scaling-only" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        res = scaling_bench()
        print(
            json.dumps(
                {
                    str(n): round(v["speedup_vs_1dev"], 3)
                    for n, v in res.items()
                }
                | {
                    "note": "speedup vs 1 virtual device at n-x workload; "
                    "devices share 4 cores (+1-dev baseline multithreads), "
                    "so the ceiling is ~4 regardless of n"
                }
            )
        )
        return

    _enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    accel = jax.devices()[0]
    if accel.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {accel.platform!r}")
    cpu = jax.devices("cpu")[0]

    import jax.numpy as jnp

    print(f"device: {accel.device_kind} x{len(jax.devices())}; "
          f"card: {card_stamp()}", file=sys.stderr)
    numerics_canary(accel, jnp.float32)
    accel_stats = measure(accel, jnp.float32, ns=(100, 800))
    print(f"accel[{accel.device_kind}]: {accel_stats}", file=sys.stderr)
    cpu_stats = measure(cpu, jnp.float64, ns=(25, 100), reps=2)
    print(f"cpu-f64 baseline proxy: {cpu_stats}", file=sys.stderr)

    rlz = rlz_transform_bench(accel, jnp.float32)
    print(f"RLZ transforms: {rlz}", file=sys.stderr)
    moist = moist3d_bench(accel, jnp.float32)
    print(f"moist 3-D core (144x64x48, 9 vars): {moist}", file=sys.stderr)
    ens = ensemble_bench(accel, jnp.float32)
    print(f"ensemble (16 members): {ens}", file=sys.stderr)
    try:
        scaling = _scaling_subprocess()
    except Exception as e:  # scaling is secondary: never fail the bench line
        print(f"scaling bench skipped: {e}", file=sys.stderr)
        scaling = None
    print(f"scaling (8 virtual CPU devices): {scaling}", file=sys.stderr)

    value = accel_stats["grid_point_steps_per_s"]
    vs = value / cpu_stats["grid_point_steps_per_s"]
    extra = {
        "rlz_transform_grid_point_values_per_s": round(rlz["grid_points_per_s"], 1),
        "rlz_transform_tflops_per_s": (
            round(rlz["tflops_per_s"], 2) if rlz["tflops_per_s"] else None
        ),
        "rlz_transform_mfu_est": (
            round(rlz["mfu_est"], 4) if rlz["mfu_est"] else None
        ),
        "rlz_hbm_fraction": (
            round(rlz["hbm_fraction"], 4) if rlz.get("hbm_fraction") else None
        ),
        "rlz_hbm_fraction_min": round(rlz["hbm_fraction_min"], 4),
        "rlz_hbm_gbps_audited": rlz.get("hbm_gbps_audited"),
        "rlz_hbm_fraction_audited": rlz.get("hbm_fraction_audited"),
    }
    extra["moist3d_grid_point_steps_per_s"] = round(
        moist["grid_point_steps_per_s"], 1
    )
    extra["ensemble16_grid_point_steps_per_s"] = round(
        ens["grid_point_steps_per_s"], 1
    )
    # Aggregate ensemble throughput relative to the single-run rate
    # measured in the same process on the same card (two calls may land on
    # cards with other power limits).  <1.0 means the vmapped ensemble's
    # value is batched convenience (one compile/dispatch for N members),
    # not aggregate throughput.
    extra["ensemble16_aggregate_vs_single"] = round(
        ens["grid_point_steps_per_s"] / value, 3
    )
    if scaling:
        extra["scaling_speedup_cpu8"] = scaling
    print(
        json.dumps(
            {
                "metric": "grid-point-steps/s, two-layer SW TC (RL 300x256, 6 vars)",
                "value": round(value, 1),
                "unit": "grid-point-steps/s",
                "vs_baseline": round(vs, 3),
                "device": {
                    "platform": accel.platform,
                    "kind": accel.device_kind,
                    "count": len(jax.devices()),
                },
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()
