"""Compensated bf16 matmul mode: accuracy vs the plain-f64 transforms.

The mode targets bf16 matrix units but is numerically testable anywhere
(bf16 arithmetic is available on CPU)."""

import numpy as np
import jax.numpy as jnp

from scythe_tpu import BC, GridParameters, create_grid


def _gp():
    return GridParameters(
        geometry="RL",
        xmin=0.0,
        xmax=100.0,
        num_cells=24,
        lDim=32,
        BCL={"h": BC.R1T1},
        vars={"h": 1, "u": 2},
        # this file tests the compensated scheme itself on every slot;
        # the (default-on) single-pass-bf16 derivative relaxation is
        # covered by tests/test_fastderiv.py
        deriv_single=False,
    )


def test_compensated_matches_plain_to_f32_grade():
    gp = _gp()
    g64 = create_grid(gp, jnp.float64, matmul="plain")
    gcomp = create_grid(gp, jnp.float32, matmul="compensated")
    rng = np.random.default_rng(0)
    r = g64.r_mish[:, None]
    lam = np.linspace(0, 2 * np.pi, 32, endpoint=False)[None, :]
    f = np.stack(
        [
            (r / 100.0) ** 2 * np.cos(2 * lam),
            np.exp(-(((r - 50) / 30) ** 2)) * np.sin(lam),
        ]
    )
    spec64 = g64.analysis(jnp.asarray(f))
    specc = gcomp.analysis(jnp.asarray(f, jnp.float32))
    scale = np.abs(np.asarray(spec64)).max()
    assert np.abs(np.asarray(specc, np.float64) - np.asarray(spec64)).max() < 3e-5 * scale

    out64 = g64.synthesis(spec64)
    outc = gcomp.synthesis(jnp.asarray(np.asarray(spec64), jnp.float32))
    # error scales with the largest value flowing through the GEMM chain,
    # not with each derivative slot's own magnitude
    gscale = max(np.abs(np.asarray(out64[k])).max() for k in g64.field_keys)
    for key in g64.field_keys:
        a = np.asarray(out64[key])
        b = np.asarray(outc[key], np.float64)
        assert np.abs(a - b).max() < 3e-5 * gscale, key


def test_compensated_beats_single_pass_bf16():
    """The 3-term scheme must be far closer to f64 than raw bf16 operators."""
    gp = _gp()
    g64 = create_grid(gp, jnp.float64, matmul="plain")
    gcomp = create_grid(gp, jnp.float32, matmul="compensated")
    rng = np.random.default_rng(1)
    f = jnp.asarray(rng.normal(size=(2,) + g64.spatial_shape))
    s64 = np.asarray(g64.analysis(f))
    scomp = np.asarray(gcomp.analysis(f.astype(jnp.float32)), np.float64)
    # raw bf16 operator pass for comparison
    g16 = create_grid(gp, jnp.float32, matmul="plain")
    g16.analysis_r = g16.analysis_r.astype(jnp.bfloat16).astype(jnp.float32)
    g16.l_analysis = g16.l_analysis.astype(jnp.bfloat16).astype(jnp.float32)
    s16 = np.asarray(g16.analysis(f.astype(jnp.float32)), np.float64)
    scale = np.abs(s64).max()
    err_comp = np.abs(scomp - s64).max() / scale
    err_16 = np.abs(s16 - s64).max() / scale
    assert err_comp < 3e-5
    assert err_comp < err_16 / 20.0
