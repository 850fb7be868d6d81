"""chip_smoke.py and bench.py off the GPU: both refuse to run in the
card's place, and chip_smoke's phases work at tiny sizes on the CPU."""

import dataclasses
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, script)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "grid-point-steps" not in out.stdout


def test_phases_at_tiny_size_on_cpu(tmp_path, capsys):
    import bench
    import chip_smoke as cs

    cpu = jax.devices("cpu")[0]
    cs.canary_phase(cpu)
    cs.flagship_phase(cpu, cpu, str(tmp_path / "flagship"), num_cells=8,
                      nl=16, hours=1.0 / 6.0, n_compare=10)
    cs.golden_phase(cpu)
    model = bench.moist3d_model(n_steps=20)
    model = model.with_(grid_params=dataclasses.replace(
        model.grid_params, num_cells=8, lDim=8, zDim=12))
    cs.moist_phase(cpu, cpu, model=model, n_compare=10, n_steps=20)
    out = capsys.readouterr().out
    assert out.count("PASS") == 4 and "FAIL" not in out
    assert "2 CSV outputs, all finite: True" in out
