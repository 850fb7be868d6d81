"""Matmul-precision candidates on the GPU, measured against CPU float64.

    python tools/precision_sweep.py [--trace-dir DIR] [--trace-only]

For each candidate of ``create_grid``'s contraction precision ("plain": f32
HIGHEST; the compensated bf16x3 ``_mm``; XLA's TF32x3 and BF16x3 dot
algorithms; and DEFAULT, which may run as TF32), runs the gates of
chip_smoke.py phases 2, 3 and 5 and prints each error and steps/s:

* numerics canary error (bench.canary_error) against bench.CANARY_TOL;
* flagship (300 x 256 x 6) 100 steps at f32 against CPU f64, steps/s;
* moist 3-D core (144 x 64 x 48 x 9) 10 steps at f32 against CPU f64,
  steps/s.

It also runs the same comparisons at f32 on the CPU (the calibration of
chip_smoke's bounds), and traces a steady moist window with the default
precision into ``--trace-dir``: the share of device time spent in the
semi-implicit column solve (``named_scope("semiimplicit_solve")``) and
the top device operations.  ``--trace-only`` skips the candidates and
traces with XLA's command buffers (CUDA graphs) off, so that every kernel
is its own trace event with its op name; a graph shows as one event.
One process; exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

def _candidates():
    """Name -> ``create_grid(matmul=...)`` value of each candidate."""
    from jax import lax

    return {
        "plain": "plain",
        "compensated": "compensated",
        "tf32x3": lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
        "bf16x3": lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
        "default": lax.Precision.DEFAULT,
    }


def _measure(dev, matmul, flag_model, flag_truth, moist_model, moist_truth,
             calls=3):
    import jax
    import jax.numpy as jnp

    import bench
    import chip_smoke as cs
    from scythe_tpu import create_grid

    out = {}
    with jax.default_device(dev):
        g = create_grid(bench.canary_grid_params(), jnp.float32, matmul=matmul)
    out["canary"] = bench.canary_error(g)
    phys, sps, _ = cs.flagship_run(dev, flag_model, matmul=matmul, calls=calls)
    out["flagship_err"] = max(
        cs.field_errors(phys, flag_truth, flag_model.grid_params.vars).values())
    out["flagship_steps_per_s"] = sps
    phys, sps, spec = cs.moist_run(dev, moist_model, matmul=matmul,
                                   calls=7 if calls > 1 else 1)
    out["moist_err"] = max(
        cs.field_errors(phys, moist_truth, moist_model.grid_params.vars).values())
    out["moist_steps_per_s"] = sps
    out["moist_finite"] = bool(np.isfinite(spec).all())
    return out


def _hlo_scope_ops(hlo_text: str, scope: str) -> set:
    """Instruction names whose metadata op_name contains ``scope``."""
    names = set()
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = ", line)
        if m and scope in line:
            names.add(m.group(1))
    return names


def trace_moist(dev, moist_model, trace_dir, n_steps=10, calls=3):
    """Trace ``calls`` scans of ``n_steps`` moist steps after a warm call;
    print device busy share, semi-implicit solve share and top ops."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs

    with jax.default_device(dev):
        grid, scan, s0 = cs._moist_build(moist_model, jnp.float32, "auto", n_steps)
        compiled = scan.lower(s0).compile()
        scope_ops = _hlo_scope_ops(compiled.as_text(), "semiimplicit_solve")
        st = jax.block_until_ready(compiled(s0))
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            st, _ = cs.timed_steps(compiled, st, calls)
        wall = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    per_op = collections.Counter()
    op_scope = {}
    intervals = []
    solve = 0.0
    stat_keys = collections.Counter()
    for plane in pd.planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                stat_keys.update(stats.keys())
                op = str(stats.get("hlo_op", ev.name))
                tf_op = str(stats.get("tf_op", ""))
                per_op[op] += ev.duration_ns
                op_scope.setdefault(op, tf_op)
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if "semiimplicit_solve" in tf_op or op in scope_ops:
                    solve += ev.duration_ns
        print(f"trace plane {plane.name}: lines {[l.name for l in plane.lines]}")
    total = sum(per_op.values())
    intervals.sort()
    busy, end = 0.0, -1.0
    for a, b in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    steps = n_steps * calls
    span = intervals[-1][1] - intervals[0][0] if intervals else 0
    print(f"trace: {steps} moist steps, host wall {wall * 1e3:.1f} ms, device "
          f"events {total / 1e6:.2f} ms, busy (union) {busy / 1e6:.2f} ms of "
          f"a {span / 1e6:.2f} ms first-to-last-event span "
          f"(idle share {1 - busy / max(span, 1):.3f})")
    print(f"trace: semi-implicit column solve {solve / 1e6:.3f} ms = "
          f"{solve / max(total, 1):.3%} of device event time "
          f"({len(scope_ops)} HLO instructions in the scope)")
    print(f"trace: event stat keys {sorted(stat_keys)}")
    for op, ns in per_op.most_common(15):
        print(f"trace top op: {ns / 1e6 / steps:.4f} ms/step "
              f"{ns / max(total, 1):.2%} {op[:40]} | {op_scope[op][-90:]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace-dir", default="chip_smoke_out/moist_trace")
    ap.add_argument("--trace-only", action="store_true")
    args = ap.parse_args()
    if args.trace_only:  # before JAX starts its backend
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=").strip()

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import jax

    import bench
    import chip_smoke as cs

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform!r}")
    jax.config.update("jax_enable_x64", True)
    cpu = jax.devices("cpu")[0]
    print(f"device {dev.device_kind} x{len(jax.devices())}; "
          f"card {bench.card_stamp()}", flush=True)

    moist_model = bench.moist3d_model(n_steps=80)
    if args.trace_only:
        trace_moist(dev, moist_model, args.trace_dir)
        return
    t0 = time.time()
    flag_model = cs.flagship_model(os.path.join(cs.OUT, "sweep"))
    flag_truth = cs.flagship_truth(cpu, flag_model)
    moist_truth = cs.moist_truth(cpu, moist_model)
    print(f"CPU f64 references: {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    calib = _measure(cpu, "plain", flag_model, flag_truth,
                     moist_model, moist_truth, calls=1)
    print(f"CPU f32 calibration ({time.time() - t0:.1f}s): {calib}", flush=True)

    for cand, matmul in _candidates().items():
        t0 = time.time()
        try:
            res = _measure(dev, matmul, flag_model, flag_truth,
                           moist_model, moist_truth)
        except Exception as e:  # a candidate XLA cannot lower is a result
            print(f"candidate {cand}: FAILED to run: {type(e).__name__}: "
                  f"{str(e)[:400]}", flush=True)
            continue
        print(f"candidate {cand} ({time.time() - t0:.1f}s): {res}", flush=True)

    trace_moist(dev, moist_model, args.trace_dir)


if __name__ == "__main__":
    main()
