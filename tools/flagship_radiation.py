"""Flagship 24 h Twoway run: outer-boundary treatment comparison (f32 device).

Round-2 stabilized the marginal f32 flagship with an outer Rayleigh sponge
(docs/RESULTS.md).  This compares, back-to-back in one session:
  A. sponge only (production: 45 km / tau 600 s)
  B. radiation only (45 km Sommerfeld strip)
  C. radiation + sponge
recording completion, the Vmax timeseries, and outer-region wave energy
(RMS of h over the outer 100 km excluding the treated strip — the pile-up
that drove the round-1 NaN).
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.join(REPO, "models", "cha_bell2024"))

from flagship_stability import build_ics, run_flagship  # noqa: E402


def run(ics_csv, dtype, options, label, hours=24.0):
    from common import GRID, PHYSICS

    from scythe_tpu import ModelParameters

    model = ModelParameters(
        ts=3.0,
        integration_time=hours * 3600.0,
        output_interval=hours * 3600.0,
        equation_set="Twoway_ShallowWater_Slab",
        initial_conditions=ics_csv,
        output_dir="/tmp/twoway_radiation",
        grid_params=GRID,
        physical_params={**PHYSICS, "S1": 1.0e-5},
        options=options,
    )
    # outer-region wave energy (RMS of h over the outer 100 km excluding
    # the treated strip — the pile-up that drove the round-1 NaN)
    from scythe_tpu.grids.base import create_grid

    r = np.asarray(create_grid(GRID, dtype).r_mish)
    outer = (r > 2.0e5) & (r < 2.55e5)
    out, _ = run_flagship(
        model,
        dtype,
        label=label,
        extra_series={
            "h_outer_rms": lambda phys: np.sqrt(np.mean(phys[0][outer] ** 2))
        },
    )
    out.update(label=label, options=options)
    if out["h_outer_rms"]:
        print(f"  [{label}] peak outer h_rms={max(out['h_outer_rms']):.3f}")
    return out


def main():
    import jax.numpy as jnp

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dtype = jnp.float32
    workdir = "/tmp/flagship_f32"
    os.makedirs(workdir, exist_ok=True)
    ics = build_ics(workdir, dtype)

    cases = [
        ("sponge", {"sponge_width": 45000.0, "sponge_tau": 600.0}),
        ("radiation", {"radiation_width": 45000.0}),
        (
            "radiation+sponge",
            {
                "radiation_width": 45000.0,
                "sponge_width": 45000.0,
                "sponge_tau": 600.0,
            },
        ),
    ]
    results = [run(ics, dtype, opts, label) for label, opts in cases]
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/flagship_radiation.json"
    json.dump(results, open(out, "w"), indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
