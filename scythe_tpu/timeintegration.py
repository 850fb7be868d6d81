"""Time integration: IMEX AB3/AI2* explicit stepper + semi-implicit solve.

Reconstruction of the reference scheme (Durran & Blossey 2012 AI2*-AB3):
* explicit stepper weights per step index (ref explicit_timestep,
  src/semiimplicit.jl:672-698): forward Euler at t=1, AB2 at t=2, AB3 after.
* live semi-implicit corrector for vertically propagating acoustic modes
  (ref semiimplicit_adjustment, src/semiimplicit.jl:521-597): solves a
  per-column Helmholtz problem for w in Chebyshev space with a
  prefactorized matrix; here the solve is a precomputed dense inverse
  applied as one batched matmul over all columns.

State is a pytree carried through `lax.scan`; the step index selects the
startup ramp via `lax.switch` (compiler-friendly, no Python branching).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .basis import chebyshev


class ModelState(NamedTuple):
    """Prognostic state + multistep tendency history (pytree).

    ``spec``: spectral coefficients [nvars, ...]; histories are physical-space
    arrays (ref ModelTile fields expdot_*/impdot_*,
    src/semiimplicit.jl:18-42).  ``expdot_*`` are always full
    [nvars, *spatial] (AB3 consumes every row).  ``impdot_*`` are either
    full [nvars, *spatial] or the SLIM 2-row layout [[w, xi], *spatial]
    (``initial_state(..., imp_rows=2)``): the AI2* corrector is the
    only consumer of the implicit history and reads exactly those two
    rows (semiimplicit.jl:543-566), and inside ``lax.scan`` every carried
    history tensor costs copy traffic each step
    (tools/probe_scan_carry.py).  ``model.build_step``
    branches on the (static) leading dim.  ``t`` is the 1-based index
    of the *next* step to be taken.
    """

    spec: jnp.ndarray
    expdot_nm1: jnp.ndarray
    expdot_nm2: jnp.ndarray
    impdot_nm1: jnp.ndarray
    impdot_nm2: jnp.ndarray
    t: jnp.ndarray


def initial_state(
    spec: jnp.ndarray, phys_shape, dtype, imp_rows: int | None = None
) -> ModelState:
    """``imp_rows=2`` selects the slim [w, xi] implicit-history layout
    (semi-implicit configurations only — model.imp_history_rows picks)."""
    z = jnp.zeros(phys_shape, dtype)
    if imp_rows is None or imp_rows == phys_shape[0]:
        zi = z
    else:
        zi = jnp.zeros((imp_rows,) + tuple(phys_shape[1:]), dtype)
    return ModelState(spec, z, z, zi, zi, jnp.asarray(1, jnp.int32))


def _ramp_index(t: jnp.ndarray) -> jnp.ndarray:
    return jnp.minimum(t, 3) - 1  # 0: Euler, 1: AB2, 2: AB3


def explicit_step(phys, expdot_n, expdot_nm1, expdot_nm2, t, ts):
    """AB3 update with startup ramp (ref explicit_timestep)."""

    def euler(_):
        return phys + ts * expdot_n

    def ab2(_):
        return phys + (0.5 * ts) * (3.0 * expdot_n - expdot_nm1)

    def ab3(_):
        return phys + (ts / 12.0) * (
            23.0 * expdot_n - 16.0 * expdot_nm1 + 5.0 * expdot_nm2
        )

    var_np1 = jax.lax.switch(_ramp_index(t), [euler, ab2, ab3], None)
    return var_np1, expdot_n, expdot_nm1


def explicit_increment(var_np1, expdot_incr, t, ts):
    """Post-hoc forcing increment with the current AB weights (ref
    explicit_increment, src/semiimplicit.jl:700-726; unused by the live
    reference equation sets but part of the stepper API)."""

    def euler(_):
        return var_np1 + ts * expdot_incr

    def ab2(_):
        return var_np1 + (0.5 * ts) * (3.0 * expdot_incr)

    def ab3(_):
        return var_np1 + (ts / 12.0) * (23.0 * expdot_incr)

    return jax.lax.switch(_ramp_index(t), [euler, ab2, ab3], None)


# ----------------------------------------------------------------------
# Semi-implicit vertical Helmholtz machinery


def helmholtz_matrix(nz: int, length: float, pxi, ts_term: float) -> np.ndarray:
    """The reference's Helmholtz system matrix (ref
    calc_Helmholtz_semiimplicit_matrix, src/semiimplicit.jl:768-781):
    rows [bc_bottom; bc_top; interior rows 2..nz-1] of
    (ts_term^2 Pxi) d2 - S, with BC rows = (ts_term^2 Pxi) * S[0/nz-1, :].

    ``pxi`` may be a scalar (the reference's column-mean constant) or an
    [nz] per-level profile: rows are then scaled by the LOCAL coefficient,
    so the implicit operator carries the reference column's full acoustics
    (options['si_mode']='variable', docs/NUMERICS.md).  The scalar case is
    the profile case with a constant profile — one code path.
    """
    s = chebyshev.dct_matrix(nz)
    d2 = chebyshev.dct_2nd_derivative(nz, length)
    fac = ts_term * ts_term * np.atleast_1d(np.asarray(pxi, np.float64))
    h = fac[:, None] * d2 - s
    bc1 = fac[0] * s[0, :]
    bc2 = fac[-1] * s[nz - 1, :]
    return np.vstack([bc1, bc2, h[1 : nz - 1, :]])


class SemiImplicitOps(NamedTuple):
    """Precomputed operators for the batched semi-implicit adjustment."""

    hinv_t1: jnp.ndarray  # [nz, nz] inverse for ts_term = ts/2 (step 1)
    hinv: jnp.ndarray  # [nz, nz] inverse for ts_term = 1.25 ts
    col_filter: jnp.ndarray  # [nz, nz] CB+CA+CI truncation refit
    col_deriv: jnp.ndarray  # [nz, nz] d/dz of the truncated refit
    synth: jnp.ndarray  # [nz, nz] coeff -> value
    dsynth: jnp.ndarray  # [nz, nz] coeff -> d/dz
    pxi_bar: jnp.ndarray  # scalar, or [nz] profile in the variable mode
    ts: float


def build_semiimplicit_ops(nz, zmin, zmax, bdim, pxi_bar, ts, dtype) -> SemiImplicitOps:
    length = zmax - zmin
    h1 = helmholtz_matrix(nz, length, pxi_bar, 0.5 * ts)
    h = helmholtz_matrix(nz, length, pxi_bar, 1.25 * ts)
    zops = chebyshev.build_ops(nz, zmin, zmax, bdim)
    r0a = zops.constrain @ zops.analysis
    return SemiImplicitOps(
        hinv_t1=jnp.asarray(np.linalg.inv(h1), dtype),
        hinv=jnp.asarray(np.linalg.inv(h), dtype),
        col_filter=jnp.asarray(zops.synth @ r0a, dtype),
        col_deriv=jnp.asarray(zops.dsynth @ r0a, dtype),
        synth=jnp.asarray(zops.synth, dtype),
        dsynth=jnp.asarray(zops.dsynth, dtype),
        pxi_bar=jnp.asarray(pxi_bar, dtype),
        ts=ts,
    )


def semiimplicit_adjustment(
    ops: SemiImplicitOps,
    w_np1,
    xi_np1,
    xidot_n,
    xidot_nm1,
    xidot_nm2,
    wdot_n,
    wdot_nm1,
    wdot_nm2,
    t,
):
    """Batched AI2* corrector for (w, xi) (ref semiimplicit_adjustment,
    src/semiimplicit.jl:521-597).  All inputs are [..., nz] with z last;
    ``xidot_*`` is the implicit tendency of w (= -Pxi xi_z) and ``wdot_*``
    that of xi (= -w_z), matching the reference's view naming.
    Returns (w_new, xi_new).
    """
    ts = ops.ts

    def stage1(_):
        # trapezoidal (AM2): subtract Euler-explicit, add ts/2-implicit
        w = w_np1 - ts * xidot_n + 0.5 * ts * xidot_n
        xi = xi_np1 - ts * wdot_n + 0.5 * ts * wdot_n
        return w, xi, 0.5 * ts

    def stage2(_):
        w = (
            w_np1
            - (0.5 * ts) * (3.0 * xidot_n - xidot_nm1)
            - ts * xidot_n
            + 0.75 * ts * xidot_nm1
        )
        xi = (
            xi_np1
            - (0.5 * ts) * (3.0 * wdot_n - wdot_nm1)
            - ts * wdot_n
            + 0.75 * ts * wdot_nm1
        )
        return w, xi, 1.25 * ts

    def stage3(_):
        w = (
            w_np1
            - (ts / 12.0) * (23.0 * xidot_n - 16.0 * xidot_nm1 + 5.0 * xidot_nm2)
            - ts * xidot_n
            + 0.75 * ts * xidot_nm1
        )
        xi = (
            xi_np1
            - (ts / 12.0) * (23.0 * wdot_n - 16.0 * wdot_nm1 + 5.0 * wdot_nm2)
            - ts * wdot_n
            + 0.75 * ts * wdot_nm1
        )
        return w, xi, 1.25 * ts

    w_star, xi_star, ts_term = jax.lax.switch(
        _ramp_index(t), [stage1, stage2, stage3], None
    )
    hinv = jax.lax.cond(t == 1, lambda: ops.hinv_t1, lambda: ops.hinv)

    with jax.named_scope("semiimplicit_solve"):
        # Column refit of xi* and its vertical derivative (z on last axis).
        # Explicit HIGHEST precision: at DEFAULT an f32 GEMM may run in TF32 on
        # the GPU (10-bit mantissa), which corrupts the acoustic solve the way
        # bf16 rounding did (docs/NUMERICS.md); these are small [nz, nz] GEMMs
        # on a minor share of the step, so full f32 costs little.
        PREC = jax.lax.Precision.HIGHEST
        xi_star = jnp.einsum("zk,...k->...z", ops.col_filter, xi_star, precision=PREC)
        xi_star_z = ts_term * ops.pxi_bar * jnp.einsum(
            "zk,...k->...z", ops.col_deriv, xi_star, precision=PREC
        )
        g = xi_star_z - w_star
        # BC rows: zero the first two entries, drop interior rows 0 and nz-1
        # (ref: g = [0; 0; g[2:nz-1]])
        zeros = jnp.zeros(g.shape[:-1] + (2,), g.dtype)
        g = jnp.concatenate([zeros, g[..., 1:-1]], axis=-1)

        a = jnp.einsum("zk,...k->...z", hinv, g, precision=PREC)
        w_new = jnp.einsum("zk,...k->...z", ops.synth, a, precision=PREC)
        xi_new = xi_star - ts_term * jnp.einsum(
            "zk,...k->...z", ops.dsynth, a, precision=PREC
        )
        return w_new, xi_new
