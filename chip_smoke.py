#!/usr/bin/env python3
"""The main path on the GPU, each phase checked against a CPU reference.

    python chip_smoke.py           # one GPU: phases 1-6
    python chip_smoke.py --four    # four GPUs: the sharded paths only

One process opens the card(s) once; every CPU reference runs in the same
process on ``jax.devices("cpu")[0]``.  Each phase prints PASS or FAIL with
its wall time, and a failing phase exits non-zero:

1. device: JAX's first device must be a GPU.  Prints its kind, the device
   count, and the card's name and power limit (nvidia-smi).
2. numerics canary (``bench.numerics_canary``): 10 transform round trips
   within ``bench.CANARY_TOL`` of CPU float64 (rejects TF32 operands).
3. flagship: the Cha & Bell (2024) two-layer TC exactly as
   models/cha_bell2024/twoway_f32.py configures it (RL, 100 cells = 300
   points x 256 azimuthal points, 6 variables, ts = 3 s, radiation +
   sponge), from a Rankine + wavenumber-2 vortex IC written as CSV,
   through ``integrate_model`` for 1 h (1200 steps, CSV output every
   600 s, NaN watchdog on).  Every output must be finite, and 100 steps
   at f32 on the GPU must track CPU float64 within ``FLAGSHIP_TOL``.
4. golden-50: tests/golden/twoway_slab_50steps_f64.npz re-run at f32 on
   the GPU must land inside ``GOLDEN_BAND``.
5. moist 3-D core: MoistEulerRLZ at bench.py's size (144 x 64 x 48, 9
   variables, semi-implicit, warm rain): 80 steps stay finite, and 10
   steps track CPU float64 within ``MOIST_TOL``.
6. CLI: ``run_scythe.py models/linear_advection_1d.py`` in this process,
   on the GPU, with the compilation cache where
   ``scythe_tpu.utils.runtime.enable_compile_cache`` puts it.

``--four`` runs only the four-GPU phase: the flagship for 200 steps
through ``integrate_sharded`` (psum and halo) and a 4-member
``integrate_ensemble`` on ``make_ensemble_mesh(4)``, each compared with
the same run on one GPU.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Outputs go to ``chip_smoke_out/`` (gitignored).
"""

from __future__ import annotations

import dataclasses
import json
import os
import runpy
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chip_smoke_out")
FLAGSHIP_CFG = os.path.join(HERE, "models", "cha_bell2024", "twoway_f32.py")

# 100 steps of the full-width flagship, GPU f32 against CPU f64, max over
# fields of max|diff| / max|f64|.  10x what the same comparison gives for
# f32 on the CPU (4.8e-4 on an H100 machine's host, set by wb, the small
# slab-BL vertical velocity): f32 on the GPU rounds in another order but
# not more coarsely (4.6e-4 there at HIGHEST), while TF32 or bf16
# operands land far above (DEFAULT 0.72, bf16x3 9.0e-3; PERF.md).
FLAGSHIP_TOL = 4.8e-3
# 10 steps of the moist 3-D core, GPU f32 against CPU f64, same measure:
# 10x the CPU-f32 error of the same comparison (1.0e-5; DEFAULT on the
# H100 gives 4.6e-3).
MOIST_TOL = 1.0e-4
# golden-50 at f32 against the stored f64 fields (tiny 96 x 32 grid).
# True f32 gives 8.1e-5 on the CPU and 5.4e-5 on an H100; operators
# rounded to TF32 in numpy give 1.4e-2 and compensated bf16 6.6e-3.  Below the band the run
# executed at more than f32 precision and no longer tests what
# production runs.
GOLDEN_BAND = (1e-6, 1e-3)


def _phase(name):
    print(f"--- {name}", flush=True)
    return time.time()


def _done(t0, ok, detail=""):
    print(f"    {'PASS' if ok else 'FAIL'} ({time.time() - t0:.1f}s) {detail}",
          flush=True)
    if not ok:
        sys.exit(1)


def field_errors(out, truth, names) -> dict:
    """Per-field max|out - truth| / max|truth|."""
    out = np.asarray(out, np.float64)
    truth = np.asarray(truth, np.float64)
    return {
        n: float(np.abs(out[v] - truth[v]).max() / (np.abs(truth[v]).max() + 1e-30))
        for v, n in enumerate(names)
    }


def _fmt(errs: dict) -> str:
    return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())


def timed_steps(scan, state, calls):
    """Run ``scan`` ``calls`` times from ``state``; returns the final state
    and the wall seconds of each call, each closed by block_until_ready."""
    import jax

    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        state = jax.block_until_ready(scan(state))
        times.append(time.perf_counter() - t0)
    return state, times


# ----------------------------------------------------------------------
# configurations


def flagship_model(out_dir, num_cells=100, nl=256):
    """models/cha_bell2024/twoway_f32.py with its IC written at ``out_dir``
    (the Rankine + wavenumber-2 vortex of __graft_entry__) and outputs
    there.  ``num_cells``/``nl`` cut the width only for CPU tests."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _vortex_phys
    from scythe_tpu import create_grid, io as sio

    model = runpy.run_path(FLAGSHIP_CFG)["model"]
    model = model.with_(grid_params=dataclasses.replace(
        model.grid_params, num_cells=num_cells, lDim=nl), output_dir=out_dir)
    with jax.default_device(jax.devices("cpu")[0]):  # host coordinates only
        grid = create_grid(model.grid_params, jnp.float32, matmul="plain")
    ic = sio.write_output(grid, model, 0.0, _vortex_phys(grid))
    return model.with_(initial_conditions=ic,
                       output_dir=os.path.join(out_dir, "run"))


# ----------------------------------------------------------------------
# comparisons (pure measurements; the phases below decide pass/fail)


def flagship_truth(cpu, model, n_steps=100):
    """Physical fields after ``n_steps`` of ``model`` in f64 on ``cpu``
    (plain HIGHEST matmuls: the reference)."""
    import jax
    import jax.numpy as jnp

    from scythe_tpu.model import build_step, initialize, make_scan

    with jax.default_device(cpu):
        grid, ctx, s0 = initialize(model, jnp.float64, matmul="plain")
        out = make_scan(build_step(model, grid, ctx, jnp.float64), n_steps)(s0)
        return np.asarray(grid.synthesis(out.spec)["val"])


def flagship_run(dev, model, matmul="auto", n_steps=100, calls=3):
    """``n_steps`` of ``model`` at f32 on ``dev``, then ``calls`` timed
    repeats.  Returns (physical fields after the first ``n_steps``,
    steps/s, memory analysis of the compiled scan)."""
    import jax
    import jax.numpy as jnp

    from scythe_tpu.model import build_step, initialize, make_scan

    with jax.default_device(dev):
        grid, ctx, s0 = initialize(model, jnp.float32, matmul=matmul)
        scan = make_scan(build_step(model, grid, ctx, jnp.float32), n_steps)
        compiled = scan.lower(s0).compile()
        out = jax.block_until_ready(compiled(s0))
        phys = np.asarray(grid.synthesis(out.spec)["val"])
        _, times = timed_steps(compiled, out, calls)
    return phys, n_steps / min(times), compiled.memory_analysis()


def _moist_build(model, dtype, matmul, n_steps):
    import bench
    from scythe_tpu import create_grid
    from scythe_tpu.model import build_context, build_step, make_scan

    grid = create_grid(model.grid_params, dtype, matmul=matmul)
    step = build_step(model, grid, build_context(model, grid, dtype), dtype)
    return grid, make_scan(step, n_steps), bench.moist3d_state(model, grid, dtype)


def moist_truth(cpu, model, n_steps=10):
    """Physical fields after ``n_steps`` of the moist core in f64 on
    ``cpu``."""
    import jax
    import jax.numpy as jnp

    with jax.default_device(cpu):
        grid, scan, s0 = _moist_build(model, jnp.float64, "plain", n_steps)
        return np.asarray(grid.synthesis(scan(s0).spec)["val"])


def moist_run(dev, model, matmul="auto", n_steps=10, calls=7):
    """``n_steps`` of the moist core at f32 on ``dev``, then ``calls`` more
    scans of ``n_steps`` from there.  Returns (physical fields after the
    first ``n_steps``, steps/s, the final spectral state)."""
    import jax
    import jax.numpy as jnp

    with jax.default_device(dev):
        grid, scan, s0 = _moist_build(model, jnp.float32, matmul, n_steps)
        compiled = scan.lower(s0).compile()
        out = jax.block_until_ready(compiled(s0))
        phys = np.asarray(grid.synthesis(out.spec)["val"])
        out, times = timed_steps(compiled, out, calls)
    return phys, n_steps / min(times), np.asarray(out.spec)


# ----------------------------------------------------------------------
# phases


def device_phase():
    import jax

    import bench

    t0 = _phase("device")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"    FAIL: JAX's first device is {dev.platform!r}, not a GPU",
              flush=True)
        sys.exit(1)
    print(f"    device_kind: {dev.device_kind}; count: {len(jax.devices())}")
    print(f"    card (name, power limit): {bench.card_stamp()}", flush=True)
    _done(t0, True)
    return dev


def canary_phase(dev):
    import jax.numpy as jnp

    import bench

    t0 = _phase("numerics canary (10 transform round trips vs CPU f64)")
    try:
        err = bench.numerics_canary(dev, jnp.float32)
    except FloatingPointError as e:
        _done(t0, False, str(e))
    _done(t0, True, f"rel err {err:.3e} < {bench.CANARY_TOL:.0e}")


def flagship_phase(dev, cpu, out_dir, num_cells=100, nl=256, hours=1.0,
                   n_compare=100):
    import jax
    import jax.numpy as jnp

    from scythe_tpu import integrate_model, io as sio

    t0 = _phase(f"flagship: Cha & Bell two-layer TC, {3 * num_cells} x {nl} x 6, "
                f"{hours:g} h through integrate_model")
    model = flagship_model(out_dir, num_cells, nl).with_(
        integration_time=3600.0 * hours, output_interval=600.0
    )
    with jax.default_device(dev):
        grid, _ = integrate_model(model, dtype=jnp.float32)
    outs = sorted(f for f in os.listdir(model.output_dir) if f.endswith(".csv"))
    finite = all(
        np.isfinite(sio.read_physical_grid(os.path.join(model.output_dir, f), grid)).all()
        for f in outs
    )
    n_out = int(round(hours * 6)) + 1
    print(f"    {model.num_ts} steps, {len(outs)} CSV outputs, all finite: {finite}",
          flush=True)
    phys, sps, mem = flagship_run(dev, model, n_steps=n_compare)
    errs = field_errors(phys, flagship_truth(cpu, model, n_compare),
                        model.grid_params.vars)
    err = max(errs.values())
    print(f"    {n_compare} steps f32 vs CPU f64: {_fmt(errs)}")
    print(f"    steps/s {sps:.1f} (block_until_ready, compile excluded)")
    print(f"    compiled {n_compare}-step scan memory: {mem}")
    stats = dev.memory_stats() or {}
    print(f"    peak_bytes_in_use: {stats.get('peak_bytes_in_use')}", flush=True)
    _done(t0, finite and len(outs) == n_out and err < FLAGSHIP_TOL,
          f"max field rel err {err:.2e} (bound {FLAGSHIP_TOL:.1e})")


def golden_phase(dev):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_model, _vortex_state
    from scythe_tpu import create_grid
    from scythe_tpu.model import build_context, build_step, make_scan

    t0 = _phase("golden-50 (f32 on the device vs stored f64 fields)")
    golden = np.load(os.path.join(HERE, "tests", "golden",
                                  "twoway_slab_50steps_f64.npz"))["phys"]
    with jax.default_device(dev):
        model = _flagship_model(num_cells=32, nl=32)
        grid = create_grid(model.grid_params, jnp.float32)
        step = build_step(model, grid, build_context(model, grid, jnp.float32),
                          jnp.float32)
        out = make_scan(step, 50)(_vortex_state(grid, jnp.float32))
        phys = np.asarray(grid.synthesis(out.spec)["val"], np.float64)
    errs = field_errors(phys, golden, model.grid_params.vars)
    err = max(errs.values())
    lo, hi = GOLDEN_BAND
    _done(t0, bool(np.isfinite(phys).all()) and lo < err < hi,
          f"max field rel err {err:.2e} (band {lo:.0e}..{hi:.0e})")


def moist_phase(dev, cpu, model=None, n_compare=10, n_steps=80):
    import bench

    model = model or bench.moist3d_model(n_steps=n_steps)
    gp = model.grid_params
    t0 = _phase(f"moist 3-D core: MoistEulerRLZ {gp.rDim} x {gp.lDim} x {gp.zDim} "
                f"x {gp.nvars}, {n_steps} steps")
    phys, sps, spec = moist_run(dev, model, n_steps=n_compare,
                                calls=n_steps // n_compare - 1)
    errs = field_errors(phys, moist_truth(cpu, model, n_compare), gp.vars)
    finite = bool(np.isfinite(spec).all())
    err = max(errs.values())
    print(f"    {n_compare} steps f32 vs CPU f64: {_fmt(errs)}")
    print(f"    steps/s {sps:.1f}; {n_steps} steps finite: {finite}", flush=True)
    _done(t0, finite and err < MOIST_TOL,
          f"max field rel err {err:.2e} (bound {MOIST_TOL:.1e})")


def cli_phase(out_dir):
    import jax

    import run_scythe
    from scythe_tpu import io as sio
    from scythe_tpu.utils.runtime import enable_compile_cache

    t0 = _phase("CLI: run_scythe.py models/linear_advection_1d.py")
    cfg = os.path.join(HERE, "models", "linear_advection_1d.py")
    model = runpy.run_path(cfg)["model"]
    os.makedirs(out_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out_dir)  # the config's IC and output paths are relative
    try:
        from scythe_tpu import create_grid

        with jax.default_device(jax.devices("cpu")[0]):
            grid = create_grid(model.grid_params, np.float32, matmul="plain")
        u0 = np.exp(-((grid.gridpoints()[:, 0] / 20.0) ** 2))
        os.replace(sio.write_output(grid, model.with_(output_dir="."), 0.0,
                                    u0[None]), model.initial_conditions)
        run_scythe.main([cfg])
        u1 = sio.read_physical_grid(
            os.path.join(model.output_dir, "physical_out_100.0.csv"), grid)[0]
    finally:
        os.chdir(cwd)
    cache = enable_compile_cache()
    cached = os.path.isdir(cache) and len(os.listdir(cache)) > 0
    l2 = float(np.sqrt(np.mean((u1 - u0) ** 2)))
    print(f"    on {jax.devices()[0].platform}; compile cache {cache} "
          f"({'populated' if cached else 'EMPTY'})", flush=True)
    _done(t0, cached and l2 < 1e-2,
          f"L2(u(100) - u(0)) {l2:.2e} after one advection period (< 1e-2)")


def four_phase(out_dir, num_cells=100, nl=256, n_steps=200, n_dev=4):
    """Sharded flagship (psum, halo) and a sharded ensemble, each against
    the same run on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from __graft_entry__ import _vortex_phys
    from scythe_tpu import create_grid, integrate_model
    from scythe_tpu.model import integrate_ensemble
    from scythe_tpu.parallel import sharding as sh

    t0 = _phase(f"four devices: flagship {3 * num_cells} x {nl} x 6, {n_steps} steps, "
                f"sharded vs one device")
    devs = jax.devices()
    if len(devs) < n_dev:
        _done(t0, False, f"needs {n_dev} devices, found {len(devs)}")
    base = flagship_model(out_dir, num_cells, nl).with_(
        integration_time=3.0 * n_steps, output_interval=3.0 * n_steps
    )
    names = base.grid_params.vars

    def out(tag):
        return base.with_(output_dir=os.path.join(out_dir, tag))

    _, one = integrate_model(out("one"), dtype=jnp.float32)
    errs = {}
    for method in ("psum", "halo"):
        _, phys = sh.integrate_sharded(out(method), n_dev, jnp.float32,
                                       method=method, interface="gather")
        errs[method] = max(field_errors(phys, one, names).values())
        mesh = sh.make_mesh(n_dev)
        _, _, st = sh.initialize_sharded(out(method), mesh, jnp.float32, method)
        print(f"    {method}: state spec on devices "
              f"{sorted(d.id for d in st.spec.sharding.device_set)}; "
              f"max field rel err vs one device {errs[method]:.2e}", flush=True)

    # integrate_ensemble drives no sponge/radiation, so the ensemble runs
    # the flagship physics with the open outer boundary of twoway.py
    emodel = out("ensemble").with_(options={})
    with jax.default_device(jax.devices("cpu")[0]):  # host coordinates only
        grid = create_grid(emodel.grid_params, jnp.float32, matmul="plain")
    ics = np.stack([_vortex_phys(grid) * (1.0 + 0.01 * k) for k in range(n_dev)])
    _, e1 = integrate_ensemble(emodel, ics, dtype=jnp.float32)
    emesh = sh.make_ensemble_mesh(n_dev)
    _, e4 = integrate_ensemble(emodel, ics, dtype=jnp.float32, mesh=emesh)
    placed = jax.device_put(jnp.asarray(ics, jnp.float32),
                            NamedSharding(emesh, PartitionSpec(emesh.axis_names[0])))
    errs["ensemble"] = max(
        max(field_errors(e4[k], e1[k], names).values()) for k in range(n_dev)
    )
    print(f"    ensemble: members on devices "
          f"{sorted(d.id for d in placed.sharding.device_set)}; "
          f"max field rel err vs one device {errs['ensemble']:.2e}")
    for d in devs[:n_dev]:
        stats = d.memory_stats() or {}
        print(f"    device {d.id} peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    finite = bool(np.isfinite(one).all() and np.isfinite(e4).all())
    worst = max(errs.values())
    _done(t0, finite and worst < FOUR_TOL,
          f"max rel err {worst:.2e} (bound {FOUR_TOL:.1e})")


# sharded or member-sharded f32 against the one-device f32 run of the same
# steps: the two differ only in the order of reductions (the psum of the
# projections, the interface solve), a perturbation at f32 rounding that
# 200 steps amplify.  On 4 virtual CPU devices at 72 x 32 both sharded
# paths land at 1.0e-4 of the one-device run, the size of f32 against f64
# there (1.3e-4), so the bound is the flagship's f32-vs-f64 bound.
FOUR_TOL = FLAGSHIP_TOL


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = device_phase()
    shutil.rmtree(OUT, ignore_errors=True)
    if four:
        four_phase(os.path.join(OUT, "four"))
    else:
        jax.config.update("jax_enable_x64", True)  # the CPU f64 references
        cpu = jax.devices("cpu")[0]
        canary_phase(dev)
        flagship_phase(dev, cpu, os.path.join(OUT, "flagship"))
        golden_phase(dev)
        moist_phase(dev, cpu)
        cli_phase(os.path.join(OUT, "cli"))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
