"""24-hour two-way wavenumber-2 run, float32 production configuration.

Identical physics to twoway.py (ref models/cha_bell2024/
Twoway_ShallowWater_Slab.jl) plus an outer boundary treatment over the
last 45 km: a Sommerfeld radiation strip (carries outgoing gravity waves
through the open edge) combined with a Rayleigh sponge (tau = 600 s,
relaxing the slow remainder to the initial far-field state).  Analysis
(docs/RESULTS.md): the marginal extreme-intensification regime harbors an
outer-boundary instability — reflected gravity-wave pile-up at the open
r = 300 km edge feeding an explosive boundary-layer momentum blow-up —
whose onset time depends on the trajectory's noise level (f32 seeds it at
t ~ 8-9 h; even float64 run from f32-spinup ICs dies at 10.5 h).  The
sponge removes the energy source; with it the f32 run completes the full
24 h.  The radiation strip additionally removes the reflection itself
(tools/flagship_radiation.py: each of sponge-only / radiation-only /
radiation+sponge completes 24 h; radiation+sponge shows the lowest outer
wave energy).  The storm core (RMW ~ 30-50 km) is >200 km from the strip.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
from common import GRID, PHYSICS

from scythe_tpu import ModelParameters

model = ModelParameters(
    ts=3.0,
    integration_time=86400.0,
    output_interval=120.0,
    equation_set="Twoway_ShallowWater_Slab",
    initial_conditions="./Twoway_SWslab_wave2/SWslab_wave2.csv",
    output_dir="./Twoway_SWslab_wave2_f32/",
    grid_params=GRID,
    physical_params={**PHYSICS, "S1": 1.0e-5},
    options={
        "radiation_width": 45000.0,
        "sponge_width": 45000.0,
        "sponge_tau": 600.0,
    },
)
