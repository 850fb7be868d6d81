"""Mature-cell collapse envelope vs condensation scheme (XYZ shower).

docs/RESULTS.md "Mature-cell collapse forensics" ends with the principled
candidate fix for the grid-point-storm regime: replace the prognostic-qss
condensation with a rate-capped diagnostic saturation adjustment
(options['condensation'] = 'diagnostic').  This probe measures the
collapse time of the 1.25 km convective-shower configuration
(examples/convective_shower_xyz.py) for each scheme variant, back-to-back
in one process.  Collapse time is bracketed by the
150 s output-interval watchdog, the same resolution as the round-2
forensics windows.

Usage:
  python tools/shower_envelope.py [--time 5400] [--cpu]
  python tools/shower_envelope.py --variant diagnostic --variant default
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))

VARIANTS = {
    "default": {},
    "filter30": {"modal_filter_tau": 30.0},
    "diagnostic": {"condensation": "diagnostic"},
    "diag_cap1e-3": {"condensation": "diagnostic",
                     "condensation_rate_cap": 1.0e-3},
    "diag_filter30": {"condensation": "diagnostic",
                      "modal_filter_tau": 30.0},
    # effectively uncapped: substantiates the ringing-adjustment
    # resonance note in microphysics.condensation_adjustment
    "diag_uncapped": {"condensation": "diagnostic",
                      "condensation_rate_cap": 1.0e9},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--time", type=float, default=5400.0)
    ap.add_argument("--interval", type=float, default=150.0)
    ap.add_argument("--variant", action="append", default=None,
                    help="variant name(s); default: default + diagnostic")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    from convective_shower_xyz import build_model, write_ics

    from scythe_tpu import create_grid, integrate_model
    from scythe_tpu.model import build_context, default_dtype

    names = args.variant or ["default", "diagnostic"]
    results = {}
    for name in names:
        extra = VARIANTS[name]
        out_dir = f"./shower_envelope_{name}"
        model = build_model(out_dir, t_end=args.time)
        model = dataclasses.replace(
            model,
            output_interval=args.interval,
            options={**model.opts(), **extra},
        )
        grid = create_grid(model.grid_params, default_dtype())
        ctx = build_context(model, grid, default_dtype())
        write_ics(model, grid, ctx.ref_state)
        t0 = time.time()
        try:
            integrate_model(model, write_outputs=False)
            results[name] = ("completed", args.time)
            print(f"[{name}] COMPLETED t = {args.time:.0f} s "
                  f"({time.time()-t0:.0f} s wall)", flush=True)
        except FloatingPointError as e:
            # last finite output boundary from the log
            log = os.path.join(out_dir, "scythe_out.log")
            t_last = 0.0
            if os.path.exists(log):
                for line in open(log):
                    if line.startswith("ts:"):
                        try:
                            t_last = max(t_last, float(line.split()[1]))
                        except (IndexError, ValueError):
                            pass
            results[name] = ("collapse", t_last)
            print(f"[{name}] collapse in ({t_last:.0f}, "
                  f"{t_last + args.interval:.0f}] s "
                  f"({time.time()-t0:.0f} s wall): {e}", flush=True)

    print("\nsummary:")
    for name, (state, t) in results.items():
        print(f"  {name:16s} {state:9s} t = {t:.0f} s")


if __name__ == "__main__":
    main()
