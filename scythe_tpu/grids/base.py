"""Grid objects: mixed-basis spectral transforms on the reference's four
geometries (R / RL / RZ / RLZ) plus the beyond-reference XYZ Cartesian
box and SL / SLZ spherical shells.

Reconstruction of the reference grid layer (un-vendored
Springsteel; API contract at src/spectralGrid.jl:63-94 `createGrid` and the
transform call sites in src/semiimplicit.jl:301-332).  Design:

* Physical state is a dense array ``[nvars, rDim(, nl)(, nz)]`` — vertical
  columns / azimuthal rings are batch axes, replacing the reference's
  per-column thread loop (semiimplicit.jl:308-314) with batched matmuls.
* Analysis / synthesis are precomputed dense operators applied as einsums:
  cubic B-splines in r, real-DFT matrices with per-ring wavenumber masking
  in lambda, Chebyshev (dense DCT matrices) in z.  The spectral state keeps
  every non-radial axis in coefficient space.
* ``synthesis`` returns every derivative slot of the reference physical
  layout (SURVEY.md 2.4): value, d/dr, d2/dr2 (+ d/dl, d2/dl2) (+ d/dz,
  d2/dz2), as a dict of ``[nvars, *spatial]`` arrays.
* For radial sharding, analysis factors into a *local* quadrature projection
  (``project``) plus a small replicated solve (``solve_spectral``), so a
  sharded step only needs one psum of the [b_rDim, ...] projection array —
  the analog of the reference halo overlap-add + shared spectral array
  (semiimplicit.jl:272-285).

Matmul numerics.  Spectral dynamics are sensitive to operand rounding in
the transform GEMMs: plain bfloat16 operands (~2^-8) sent the production
two-layer TC to NaN within ~1200 steps (docs/NUMERICS.md), and TF32
(~2^-11, what an f32 GEMM at DEFAULT precision may run as on a GPU) is in
the same class.  So every plain contraction passes an explicit
``Grid.precision`` (``create_grid`` sets it once; see ``matmul_mode``).
The alternative "compensated" mode implements bf16_3x by construction:
every operator O is stored as the stack [O_hi, O_lo, O_hi] (O_hi =
bf16(O), O_lo = bf16(O - O_hi)) and each activation x is stacked
[x_hi, x_hi, x_lo]; a single widened bf16 GEMM with f32 accumulation then
computes O_hi x_hi + O_lo x_hi + O_hi x_lo — float32-grade accuracy (~1e-6
relative, dropping only the O_lo x_lo term) on bf16 matrix units.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..basis import bspline, chebyshev, fourier
from ..config import GridParameters

GEOMETRIES = ("R", "RL", "RZ", "RLZ", "XYZ", "SL", "SLZ")
# "SLZ": the 3-D spherical shell — SL plus a Chebyshev height column
# (shallow-atmosphere: metric radius fixed at sphere_radius).  Rides the
# RLZ structural paths end to end.
# "SL" (beyond the reference's four geometries): a spherical shell
# surface -- B-spline LATITUDE (xmin/xmax in radians; Gauss mish points
# never reach the exact poles, the same way polar mish points never reach
# r = 0) x masked-Fourier LONGITUDE.  The per-ring dealias mask uses the
# ring circumference a*cos(lat) exactly as the polar grids use r, so the
# effective zonal resolution is uniform (~ the meridional resolution)
# all the way to the pole rings and the gravity-wave CFL is NOT
# pole-restricted.  The dl/dll slots are d/dlambda (longitude angle);
# equation sets divide by a*cos(lat) at point of use, mirroring the
# polar-grid convention.  Structural class: RL.
# "XYZ" (beyond the reference's four geometries): a Cartesian box --
# B-spline x, uniformly-masked periodic Fourier y (lDim points over
# [ymin, ymax], 2/3-rule dealiasing, derivative operators scaled by
# 2*pi/Ly so the dl/dll slots are true d/dy, d2/dy2), Chebyshev z.  It
# shares the RLZ structural paths (same array ranks and transform
# composition); only coordinates and the azimuthal mask/scaling differ.


def matmul_mode(backend: str, dtype) -> str:
    """The ``create_grid(matmul="auto")`` rule: "plain" or "compensated"
    for a state of ``dtype`` on ``backend``.

    Every backend and dtype gets full-precision plain contractions.  On
    the GPU this was chosen by measurement on an H100 (PERF.md, "Bring-up
    findings"): of the candidates that pass every accuracy gate (HIGHEST
    and TF32x3), neither was faster on both the flagship and the moist
    core, so the rule keeps HIGHEST; DEFAULT (TF32), BF16x3 and the
    compensated mode each fail at least one gate."""
    del backend, dtype
    return "plain"


def _split3(op: np.ndarray) -> jnp.ndarray:
    """[O_hi, O_lo, O_hi] bf16 stack for the compensated GEMM."""
    o32 = np.asarray(op, np.float32)
    hi = o32.astype(jnp.bfloat16)
    lo = (o32 - np.asarray(hi, np.float32)).astype(jnp.bfloat16)
    return jnp.asarray(np.stack([hi, lo, hi]))


def _bf16(op: np.ndarray) -> jnp.ndarray:
    """Plain bf16 operator for the single-pass derivative GEMMs."""
    return jnp.asarray(np.asarray(op, np.float32), jnp.bfloat16)


@dataclass
class Grid:
    """A built grid: static metadata + device operator arrays.

    Operator arrays are either plain (``comp=False``, dtype matmuls) or
    compensated bf16 stacks with a leading length-3 axis (``comp=True``).
    All operator applications go through ``_mm``.
    """

    params: GridParameters
    dtype: Any
    comp: bool
    # radial operators
    r_mish: np.ndarray  # [rDim] (host, float64)
    analysis_r: jnp.ndarray  # [nvars, nb, rDim]
    project_r: jnp.ndarray  # [nb, rDim] (var-independent local quadrature)
    msolve_r: jnp.ndarray  # [nvars, nb, nb]
    synth_r: jnp.ndarray  # [3, rDim, nb]
    # precision of every plain contraction (see matmul_mode)
    precision: Any = lax.Precision.HIGHEST
    synth_r_val: jnp.ndarray | None = None  # [rDim, nb] value row only
    # azimuthal (real-DFT; spectral state holds lambda coefficients)
    nl: int = 0
    kDim: int = 0  # azimuthal spectral slots (nl dense; fd.K factored)
    ring_mask: jnp.ndarray | None = None  # [rDim, kDim] over coeff slots
    l_analysis: jnp.ndarray | None = None  # [nl, nl] values -> coeffs
    l_synth: jnp.ndarray | None = None  # [nl, nl] coeffs -> values
    l_all: jnp.ndarray | None = None  # [3, nl, nl] coeffs -> (val, dl, dll)
    l_fact: Any = None  # fourier_factored.FactOps (radix-split mode)
    # vertical
    z_mish: np.ndarray | None = None  # [nz]
    analysis_z: jnp.ndarray | None = None  # [nvars, nz, nz] (constrain @ dct)
    z_all: jnp.ndarray | None = None  # [3, nz, nz] coeff -> (val, dz, dzz)
    zcol_int: jnp.ndarray | None = None  # [nz, nz] R0 column antiderivative
    zcol_deriv: jnp.ndarray | None = None  # [nz, nz] R0 column d/dz
    zcol_filter: jnp.ndarray | None = None  # [nz, nz] CB+CA+CI round trip
    zcol_deriv_ftop: jnp.ndarray | None = None  # [nz, nz] d/dz, F(top)=0
    # selective single-pass bf16 derivative synthesis (fast=True): the value
    # chain stays compensated (its errors feed analysis and accumulate), but
    # the 6 derivative slots feed tendencies that enter the state x dt, so
    # single-pass bf16 is accuracy-adequate there (docs/NUMERICS.md "Where
    # plain bf16 would be acceptable") and cuts that traffic/flops 3x.
    fast: bool = False
    z_synth_val: jnp.ndarray | None = None  # comp [nz, nz] value-only
    z_deriv_f: jnp.ndarray | None = None  # bf16 [2, nz, nz] (dz, dzz)
    l_deriv_f: jnp.ndarray | None = None  # bf16 [2, nl, nl] (dl, dll)
    l_synth_f: jnp.ndarray | None = None  # bf16 [nl, nl]
    synth_r_deriv_f: jnp.ndarray | None = None  # bf16 [2, rDim, nb]
    synth_r_val_f: jnp.ndarray | None = None  # bf16 [rDim, nb]

    # ------------------------------------------------------------------
    def _mm(self, subs: str, op: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """Apply a stored operator: plain einsum or compensated bf16 GEMM.

        The optimization barrier around the hi-part is load-bearing: without
        it XLA folds the f32->bf16->f32 round trip to the identity, which
        turns the residual x_lo into zero and silently collapses the scheme
        back to single-pass bf16."""
        if not self.comp:
            return jnp.einsum(subs, op, x, precision=self.precision)
        xh = lax.optimization_barrier(x.astype(jnp.bfloat16))
        xl = (x - xh.astype(x.dtype)).astype(jnp.bfloat16)
        x3 = jnp.stack([xh, xh, xl])
        a, rest = subs.split(",", 1)
        b, out = rest.split("->")
        return jnp.einsum(
            f"p{a},p{b}->{out}", op, x3, preferred_element_type=self.dtype
        )

    def _mmf(self, subs: str, op: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """Single-pass bf16 GEMM with f32 accumulation (derivative slots)."""
        return jnp.einsum(
            subs, op, x.astype(jnp.bfloat16), preferred_element_type=self.dtype
        )

    # ------------------------------------------------------------------
    @property
    def geometry(self) -> str:
        return self.params.geometry

    @property
    def nvars(self) -> int:
        return self.params.nvars

    @property
    def _struct(self) -> str:
        """Structural class: XYZ shares the RLZ array ranks/paths and SL
        shares the RL ones."""
        g = self.params.geometry
        return {"XYZ": "RLZ", "SL": "RL", "SLZ": "RLZ"}.get(g, g)

    @property
    def spatial_shape(self) -> tuple[int, ...]:
        p = self.params
        if self._struct == "R":
            return (p.rDim,)
        if self._struct == "RL":
            return (p.rDim, self.nl)
        if self._struct == "RZ":
            return (p.rDim, p.zDim)
        return (p.rDim, self.nl, p.zDim)

    @property
    def spectral_shape(self) -> tuple[int, ...]:
        p = self.params
        if self._struct == "R":
            return (p.nvars, p.b_rDim)
        if self._struct == "RL":
            return (p.nvars, p.b_rDim, self.kDim)
        if self._struct == "RZ":
            return (p.nvars, p.b_rDim, p.zDim)
        return (p.nvars, p.b_rDim, self.kDim, p.zDim)

    @property
    def num_points(self) -> int:
        return int(np.prod(self.spatial_shape))

    @property
    def field_keys(self) -> tuple[str, ...]:
        # XYZ reuses the RLZ slot names: dr/drr are d/dx, d2/dx2 and
        # dl/dll are true d/dy, d2/dy2 (operators pre-scaled by 2*pi/Ly)
        return {
            "R": ("val", "dr", "drr"),
            "RZ": ("val", "dr", "drr", "dz", "dzz"),
            "RL": ("val", "dr", "drr", "dl", "dll"),
            "RLZ": ("val", "dr", "drr", "dl", "dll", "dz", "dzz"),
        }[self._struct]

    def _y_points(self) -> np.ndarray:
        p = self.params
        return p.ymin + (p.ymax - p.ymin) * np.arange(self.nl) / self.nl

    # ------------------------------------------------------------------
    def coords(self) -> dict[str, jnp.ndarray]:
        """Coordinate arrays broadcastable against ``[*spatial]`` fields.

        XYZ grids expose "x"/"y"/"z" (plus "r" as an alias of "x" so the
        generic outer-boundary treatments in model.build_step work on the
        +x boundary unchanged)."""
        r = jnp.asarray(self.r_mish, self.dtype)
        out: dict[str, jnp.ndarray] = {}
        if self.geometry == "R":
            out["r"] = r
        elif self.geometry == "RL":
            out["r"] = r[:, None]
            out["l"] = jnp.asarray(fourier.angles(self.nl), self.dtype)[None, :]
        elif self.geometry == "RZ":
            out["r"] = r[:, None]
            out["z"] = jnp.asarray(self.z_mish, self.dtype)[None, :]
        elif self.geometry == "SL":
            out["r"] = out["lat"] = r[:, None]
            out["l"] = out["lon"] = jnp.asarray(
                fourier.angles(self.nl), self.dtype
            )[None, :]
        elif self.geometry == "SLZ":
            out["r"] = out["lat"] = r[:, None, None]
            out["l"] = out["lon"] = jnp.asarray(
                fourier.angles(self.nl), self.dtype
            )[None, :, None]
            out["z"] = jnp.asarray(self.z_mish, self.dtype)[None, None, :]
        elif self.geometry == "XYZ":
            out["r"] = out["x"] = r[:, None, None]
            out["y"] = jnp.asarray(self._y_points(), self.dtype)[None, :, None]
            out["z"] = jnp.asarray(self.z_mish, self.dtype)[None, None, :]
        else:
            out["r"] = r[:, None, None]
            out["l"] = jnp.asarray(fourier.angles(self.nl), self.dtype)[None, :, None]
            out["z"] = jnp.asarray(self.z_mish, self.dtype)[None, None, :]
        return out

    def gridpoints(self) -> np.ndarray:
        """Reference-style [npoints, ndims] coordinate matrix (row order =
        flattened field order; ref `getGridpoints`, semiimplicit.jl:59)."""
        if self.geometry == "R":
            return self.r_mish[:, None]
        if self.geometry in ("RL", "SL"):
            lam = fourier.angles(self.nl)
            rr, ll = np.meshgrid(self.r_mish, lam, indexing="ij")
            return np.stack([rr.ravel(), ll.ravel()], axis=1)
        if self.geometry == "RZ":
            rr, zz = np.meshgrid(self.r_mish, self.z_mish, indexing="ij")
            return np.stack([rr.ravel(), zz.ravel()], axis=1)
        lam = self._y_points() if self.geometry == "XYZ" else fourier.angles(self.nl)
        rr, ll, zz = np.meshgrid(self.r_mish, lam, self.z_mish, indexing="ij")
        return np.stack([rr.ravel(), ll.ravel(), zz.ravel()], axis=1)

    # ------------------------------------------------------------------
    def _l_coeffs(self, phys: jnp.ndarray) -> jnp.ndarray:
        """values -> masked real Fourier coefficients along the lambda axis
        (axis 2 of [nvars, rDim, nl, ...])."""
        from ..basis import fourier_factored as ff

        if phys.ndim == 3:
            if self.l_fact is not None:
                hat = ff.analysis_mm(self.l_fact, self._mm, phys, with_z=False)
            else:
                hat = self._mm("kl,vrl->vrk", self.l_analysis, phys)
            return hat * self.ring_mask[None, :, :]
        if self.l_fact is not None:
            hat = ff.analysis_mm(self.l_fact, self._mm, phys, with_z=True)
        else:
            hat = self._mm("kl,vrlz->vrkz", self.l_analysis, phys)
        return hat * self.ring_mask[None, :, :, None]

    def _analysis_with(self, radial_op, radial_subs: str, phys: jnp.ndarray):
        """Shared analysis chain, ordered shrink-early: the lambda transform
        runs first (the per-ring dealias mask is r-dependent, so it must be
        applied while the r axis is physical), then the radial contraction
        (rDim -> b_rDim, a ~3x shrink) so the vertical GEMM sees the
        smallest operand.  All 1-D operators commute across axes, so this
        equals the reference's per-direction transform composition exactly."""
        g = self._struct
        if g == "R":
            return self._mm(radial_subs + ",vr->vb", radial_op, phys)
        if g == "RL":
            return self._mm(radial_subs + ",vrk->vbk", radial_op, self._l_coeffs(phys))
        if g == "RZ":
            rc = self._mm(radial_subs + ",vrz->vbz", radial_op, phys)
            return self._mm("vKz,vbz->vbK", self.analysis_z, rc)
        rc = self._mm(radial_subs + ",vrkz->vbkz", radial_op, self._l_coeffs(phys))
        return self._mm("vKz,vbkz->vbkK", self.analysis_z, rc)

    def analysis(self, phys: jnp.ndarray) -> jnp.ndarray:
        """physical [nvars, *spatial] -> spectral (ref spectralTransform!).

        Spectral layout: [nvars, b_rDim] (R), + nl lambda coefficients (RL),
        + nz Chebyshev coefficients (RZ/RLZ) — non-radial axes in
        coefficient space."""
        return self._analysis_with(self.analysis_r, "vbr", phys)

    def project(self, phys: jnp.ndarray) -> jnp.ndarray:
        """Local (decomposable) radial quadrature projection.  Summing
        projections over radial shards then applying ``solve_spectral``
        equals ``analysis`` exactly — the sharded-transform contract."""
        return self._analysis_with(self.project_r, "br", phys)

    def solve_spectral(self, proj: jnp.ndarray) -> jnp.ndarray:
        """Apply the (small, replicated) Gram/filter/BC solve to a summed
        projection array (ref splineTransform!, semiimplicit.jl:285)."""
        return self._mm("vbc,vc...->vb...", self.msolve_r, proj)

    def synthesis(self, spec: jnp.ndarray) -> dict[str, jnp.ndarray]:
        """spectral -> all physical derivative slots (ref gridTransform! /
        tileTransform!; slot layout SURVEY.md 2.4).

        Ordered expand-late: the vertical and azimuthal operators (1x size)
        run on the compact [nvars, b_rDim, ...] coefficient block first, with
        derivative slots as stacked GEMMs, and the radial synthesis (the
        ~3x b_rDim -> rDim expansion) runs last — so the large physical-size
        tensors are produced exactly once each, not carried through every
        stage (memory traffic, not FLOPs, bounds this path)."""
        g = self._struct
        out: dict[str, jnp.ndarray] = {}
        if g == "R":
            r3 = self._mm("drb,vb->vdr", self.synth_r, spec)
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            return out
        if g == "RL":
            if self.fast:
                lval = self._mm("lk,vbk->vbl", self.l_synth, spec)
                ld = self._mmf("dlk,vbk->vdbl", self.l_deriv_f, spec)
                rdv = self._mmf("drb,vbl->vdrl", self.synth_r_deriv_f, lval)
                rd = self._mmf("rb,vdbl->vdrl", self.synth_r_val_f, ld)
                out["val"] = self._mm("rb,vbl->vrl", self.synth_r_val, lval)
                out["dr"], out["drr"] = rdv[:, 0], rdv[:, 1]
                out["dl"], out["dll"] = rd[:, 0], rd[:, 1]
                return out
            if self.l_fact is not None:
                from ..basis import fourier_factored as ff

                lc = ff.synthesis_mm(self.l_fact, self._mm, spec, (0, 1, 2), False)
            else:
                lc = self._mm("dlk,vbk->vdbl", self.l_all, spec)
            r3 = self._mm("drb,vbl->vdrl", self.synth_r, lc[:, 0])
            rd = self._mm("rb,vdbl->vdrl", self.synth_r_val, lc[:, 1:])
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            out["dl"], out["dll"] = rd[:, 0], rd[:, 1]
            return out
        if g == "RZ":
            if self.fast:
                zval = self._mm("zK,vbK->vbz", self.z_synth_val, spec)
                zd = self._mmf("dzK,vbK->vdbz", self.z_deriv_f, spec)
                rdv = self._mmf("drb,vbz->vdrz", self.synth_r_deriv_f, zval)
                rd = self._mmf("rb,vdbz->vdrz", self.synth_r_val_f, zd)
                out["val"] = self._mm("rb,vbz->vrz", self.synth_r_val, zval)
                out["dr"], out["drr"] = rdv[:, 0], rdv[:, 1]
                out["dz"], out["dzz"] = rd[:, 0], rd[:, 1]
                return out
            zc = self._mm("dzK,vbK->vdbz", self.z_all, spec)
            r3 = self._mm("drb,vbz->vdrz", self.synth_r, zc[:, 0])
            rd = self._mm("rb,vdbz->vdrz", self.synth_r_val, zc[:, 1:])
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            out["dz"], out["dzz"] = rd[:, 0], rd[:, 1]
            return out
        if self.fast:
            zval = self._mm("zK,vbkK->vbkz", self.z_synth_val, spec)
            zd = self._mmf("dzK,vbkK->vdbkz", self.z_deriv_f, spec)
            lval = self._mm("lk,vbkz->vblz", self.l_synth, zval)
            ld = self._mmf("dlk,vbkz->vdblz", self.l_deriv_f, zval)
            lz = self._mmf("lk,vdbkz->vdblz", self.l_synth_f, zd)
            rdv = self._mmf("drb,vblz->vdrlz", self.synth_r_deriv_f, lval)
            rl = self._mmf("rb,vdblz->vdrlz", self.synth_r_val_f, ld)
            rz = self._mmf("rb,vdblz->vdrlz", self.synth_r_val_f, lz)
            out["val"] = self._mm("rb,vblz->vrlz", self.synth_r_val, lval)
            out["dr"], out["drr"] = rdv[:, 0], rdv[:, 1]
            out["dl"], out["dll"] = rl[:, 0], rl[:, 1]
            out["dz"], out["dzz"] = rz[:, 0], rz[:, 1]
            return out
        zc = self._mm("dzK,vbkK->vdbkz", self.z_all, spec)
        if self.l_fact is not None:
            from ..basis import fourier_factored as ff

            lv = ff.synthesis_mm(self.l_fact, self._mm, zc[:, 0], (0, 1, 2), True)
            nv = zc.shape[0]
            zd = zc[:, 1:].reshape((nv * 2,) + zc.shape[2:])
            lz = ff.synthesis_mm(self.l_fact, self._mm, zd, (0,), True)
            lz = lz.reshape((nv, 2) + lz.shape[2:])
        else:
            lv = self._mm("dlk,vbkz->vdblz", self.l_all, zc[:, 0])
            lz = self._mm("lk,vdbkz->vdblz", self.l_synth, zc[:, 1:])
        r3 = self._mm("drb,vblz->vdrlz", self.synth_r, lv[:, 0])
        rl = self._mm("rb,vdblz->vdrlz", self.synth_r_val, lv[:, 1:])
        rz = self._mm("rb,vdblz->vdrlz", self.synth_r_val, lz)
        out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
        out["dl"], out["dll"] = rl[:, 0], rl[:, 1]
        out["dz"], out["dzz"] = rz[:, 0], rz[:, 1]
        return out

    # ------------------------------------------------------------------
    # Chebyshev column helpers used inside equation sets (R0 constraints),
    # batched over all columns: f has z on the LAST axis.
    def column_integrate(self, f: jnp.ndarray) -> jnp.ndarray:
        """CIInt: antiderivative in z anchored to 0 at z=zmin
        (ref CIInttransform, shallowWaterModels.jl:422-429)."""
        return self._mm("zk,...k->...z", self.zcol_int, f)

    def column_derivative(self, f: jnp.ndarray) -> jnp.ndarray:
        """CIx of the R0-filtered column fit (ref CIxtransform usage,
        shallowWaterModels.jl:469-483)."""
        return self._mm("zk,...k->...z", self.zcol_deriv, f)

    def column_flux_derivative(self, f: jnp.ndarray) -> jnp.ndarray:
        """d/dz of a vertical FLUX with F = 0 imposed at the domain top
        (sedimentation: no rain falls in from above).  See the
        zcol_deriv_ftop build note in create_grid."""
        return self._mm("zk,...k->...z", self.zcol_deriv_ftop, f)

    def column_filter(self, f: jnp.ndarray) -> jnp.ndarray:
        """CB+CA+CI round trip (truncation filter) on columns."""
        return self._mm("zk,...k->...z", self.zcol_filter, f)


def _dense_lon_ops(grid: "Grid", nl: int, prep, deriv_scale: float = 1.0) -> tuple:
    """Shared dense real-DFT longitude/azimuth operator setup (RL dense
    fallback, XYZ, SL).  ``deriv_scale`` converts d/dlambda to a true
    coordinate derivative (XYZ: 2*pi/Ly -> d/dy).  Returns (ls, ld, ld2)
    for the fast-deriv path."""
    grid.nl = nl
    grid.kDim = nl
    la, ls, ld, ld2 = fourier.dft_matrices(nl)
    if deriv_scale != 1.0:
        ld = ld * deriv_scale
        ld2 = ld2 * (deriv_scale * deriv_scale)
    grid.l_analysis = prep(la)
    grid.l_synth = prep(ls)
    grid.l_all = prep(np.stack([ls, ld, ld2]))
    return ls, ld, ld2


def create_grid(params: GridParameters, dtype=jnp.float32, matmul="auto") -> Grid:
    """Build a grid and all of its transform operators (ref createGrid,
    spectralGrid.jl:63-94).

    ``matmul``: "compensated" (bf16_3x by construction, see module
    docstring), "plain" (matmuls in ``dtype`` at HIGHEST precision),
    "auto" (``matmul_mode`` for the default backend), or a
    ``lax.Precision``/``lax.DotAlgorithmPreset`` for plain matmuls at that
    precision (how tools/precision_sweep.py measures the alternatives)."""
    import jax as _jax

    p = params
    if p.geometry not in GEOMETRIES:
        raise ValueError(f"Unknown geometry {p.geometry!r}")
    precision = lax.Precision.HIGHEST
    if matmul == "auto":
        matmul = matmul_mode(_jax.default_backend(), dtype)
    if not isinstance(matmul, str):
        precision, matmul = matmul, "plain"
    if matmul not in ("plain", "compensated"):
        raise ValueError(f"Unknown matmul mode {matmul!r}")
    comp = matmul == "compensated"
    prep = _split3 if comp else (lambda op: jnp.asarray(np.asarray(op), dtype))

    # --- radial spline operators, per variable BC pair ------------------
    an, ms = [], []
    proj = None
    synth = None
    for v in range(p.nvars):
        ops = bspline.build_ops(p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q)
        an.append(ops.analysis)
        ms.append(ops.msolve)
        proj = ops.project
        synth = ops.synth
        r_mish = ops.mish
    grid = Grid(
        params=p,
        dtype=dtype,
        comp=comp,
        precision=precision,
        r_mish=r_mish,
        analysis_r=prep(np.stack(an)),
        project_r=prep(proj),
        msolve_r=prep(np.stack(ms)),
        synth_r=prep(synth),
        synth_r_val=prep(synth[0]),
    )

    def _pick_factored(p, nl, what):
        """Factored-DFT mode decision for a periodic axis: explicit
        ``l_factored`` wins; auto enables beyond nl = 2048 when an even x
        even split of nl exists (falls back to dense otherwise).  The
        threshold was set for another runtime's limit on the size of the
        dense [nl, nl] operator constants; it is unmeasured on the GPU,
        where cuFFT is the alternative to both (ROADMAP)."""
        from ..basis import fourier_factored as ff

        factored = getattr(p, "l_factored", None)
        if factored is None:
            factored = nl > 2048
            if factored:
                try:
                    ff.split_radix(nl)
                except ValueError:
                    factored = False
        elif factored:
            ff.split_radix(nl)  # unfactorable nl: raise the real reason
        return bool(factored)

    # --- periodic Cartesian y (XYZ box) ---------------------------------
    l_mats = None
    if p.geometry == "XYZ":
        from ..basis import fourier_factored as ff

        if not p.lDim or p.lDim % 2:
            raise ValueError("XYZ grids need an explicit even lDim (y points)")
        if p.ymax <= p.ymin:
            raise ValueError("XYZ grids need ymax > ymin")
        nl = p.lDim
        sc = 2.0 * np.pi / (p.ymax - p.ymin)  # d/dlambda -> d/dy
        factored = _pick_factored(p, nl, "XYZ y")
        if factored:
            fd = ff.FactoredDFT(nl)
            grid.l_fact = ff.FactOps(fd, prep, dtype, jnp, deriv_scale=sc)
            grid.nl = nl
            grid.kDim = fd.K
            # uniform 2/3-rule mask in the factored slot layout
            row = (fd.k_of_slot <= max(nl // 3, 1)) * fd.base_mask
            grid.ring_mask = jnp.asarray(np.tile(row, (p.rDim, 1)), dtype)
        else:
            # uniform 2/3-rule dealias mask (every "ring" identical)
            ks = fourier.coeff_wavenumbers(nl)
            row = (ks <= max(nl // 3, 1)).astype(np.float64)
            grid.ring_mask = jnp.asarray(np.tile(row, (p.rDim, 1)), dtype)
            l_mats = _dense_lon_ops(grid, nl, prep, deriv_scale=sc)

    # --- spherical longitude (SL / SLZ shells) --------------------------
    if p.geometry in ("SL", "SLZ"):
        from ..basis import fourier_factored as ff

        if not p.lDim or p.lDim % 2:
            raise ValueError("SL/SLZ grids need an explicit even lDim (lon points)")
        if not (p.xmax > p.xmin and abs(p.xmin) <= np.pi / 2 + 1e-9
                and abs(p.xmax) <= np.pi / 2 + 1e-9):
            raise ValueError(
                f"SL/SLZ latitude bounds must be RADIANS within [-pi/2, pi/2], "
                f"got [{p.xmin}, {p.xmax}] (degrees by mistake?)"
            )
        nl = p.lDim
        a_sph = p.sphere_radius
        dphi = (p.xmax - p.xmin) / p.num_cells
        # ring circumference radius a*cos(lat) plays the role the polar
        # grids give r: zonal modes resolved down to ~the meridional
        # resolution per ring, near-axisymmetric pole rings
        r_equiv = a_sph * np.cos(r_mish)
        factored = _pick_factored(p, nl, "SL/SLZ longitude")
        if factored:
            fd = ff.FactoredDFT(nl)
            grid.l_fact = ff.FactOps(fd, prep, dtype, jnp)
            grid.nl = nl
            grid.kDim = fd.K
            grid.ring_mask = jnp.asarray(
                fd.ring_mask(r_equiv, a_sph * dphi, p.l_q), dtype
            )
        else:
            grid.ring_mask = jnp.asarray(
                fourier.ring_coeff_mask(r_equiv, a_sph * dphi, nl, p.l_q),
                dtype,
            )
            l_mats = _dense_lon_ops(grid, nl, prep)

    # --- azimuthal ------------------------------------------------------
    if p.geometry in ("RL", "RLZ"):
        from ..basis import fourier_factored as ff

        nl = fourier.default_nl(p.num_cells, p.lDim)
        dr = (p.xmax - p.xmin) / p.num_cells
        grid.nl = nl
        factored = _pick_factored(p, nl, "azimuth")
        if factored:
            fd = ff.FactoredDFT(nl)
            grid.l_fact = ff.FactOps(fd, prep, dtype, jnp)
            grid.kDim = fd.K
            grid.ring_mask = jnp.asarray(fd.ring_mask(r_mish, dr, p.l_q), dtype)
        else:
            grid.ring_mask = jnp.asarray(
                fourier.ring_coeff_mask(r_mish, dr, nl, p.l_q), dtype
            )
            l_mats = _dense_lon_ops(grid, nl, prep)

    # --- vertical -------------------------------------------------------
    if p.geometry in ("RZ", "RLZ", "XYZ", "SLZ"):
        if p.zDim < 4:
            raise ValueError("zDim must be >= 4 for RZ/RLZ/XYZ/SLZ grids")
        anz = []
        for v in range(p.nvars):
            zops = chebyshev.build_ops(p.zDim, p.zmin, p.zmax, p.b_zDim, p.BCB[v], p.BCT[v])
            anz.append(zops.constrain @ zops.analysis)
        z0 = chebyshev.build_ops(p.zDim, p.zmin, p.zmax, p.b_zDim)
        grid.z_mish = z0.points
        grid.analysis_z = prep(np.stack(anz))
        grid.z_all = prep(np.stack([z0.synth, z0.dsynth, z0.d2synth]))
        r0a = z0.constrain @ z0.analysis
        grid.z_synth_val = prep(z0.synth)
        grid.zcol_int = prep(z0.isynth @ r0a)
        grid.zcol_deriv = prep(z0.dsynth @ r0a)
        grid.zcol_filter = prep(z0.synth @ r0a)
        # flux-divergence derivative with F = 0 imposed at the domain top:
        # used for the rain sedimentation flux (nothing falls in from
        # above).  The unconstrained (R0) fit rings at the top boundary
        # when differentiating a localized flux there — measured as an
        # explosive rain-at-model-top instability with active
        # sedimentation (docs/RESULTS.md).
        zf = chebyshev.build_ops(
            p.zDim, p.zmin, p.zmax, p.b_zDim, chebyshev.ZBC.R0,
            chebyshev.ZBC.R1T0,
        )
        grid.zcol_deriv_ftop = prep(z0.dsynth @ (zf.constrain @ zf.analysis))
        z_mats = (z0.dsynth, z0.d2synth)

    # --- selective single-pass bf16 derivative synthesis ----------------
    # Value-chain GEMMs stay compensated (their errors feed analysis and
    # accumulate over the integration); the 6 derivative slots only enter
    # the state through tendencies x dt, so single-pass bf16 is adequate
    # there (docs/NUMERICS.md).  Only meaningful in compensated mode; the
    # factored-DFT mode keeps its own (compensated) chain.
    fast_req = getattr(p, "deriv_single", None)
    if fast_req is None:
        # auto: ON in compensated mode — trajectory drift validated on the
        # production flagship config (tools/validate_fastderiv.py: 24 h
        # completes, Vmax within 0.06%/0.45% of the compensated run at the
        # 2.5 h/8.5 h gates, inside the f32-vs-f64 chaos band); 1.7x
        # measured on the all-slot RLZ roundtrip (docs/RESULTS.md).
        fast_req = True
    if fast_req and comp and p.geometry != "R" and grid.l_fact is None:
        grid.fast = True
        grid.synth_r_deriv_f = _bf16(synth[1:])
        grid.synth_r_val_f = _bf16(synth[0])
        if l_mats is not None:
            ls, ld, ld2 = l_mats
            grid.l_deriv_f = _bf16(np.stack([ld, ld2]))
            grid.l_synth_f = _bf16(ls)
        if p.geometry in ("RZ", "RLZ", "XYZ", "SLZ"):
            grid.z_deriv_f = _bf16(np.stack(z_mats))
    return grid
