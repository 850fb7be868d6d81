"""Chebyshev vertical column engine (DCT-based).

Reconstruction of the reference's `Chebyshev1D` column machinery (API pinned
at call sites: CBtransform!/CAtransform!/CItransform!/CIxtransform/
CIxxtransform/CIInttransform, src/semiimplicit.jl:408-413,
src/reference_state.jl:104-108, and the dense collocation matrices
Chebyshev.dct_matrix / dct_1st_derivative / dct_2nd_derivative used by the
semi-implicit Helmholtz solver, src/semiimplicit.jl:757-781).

Semantics
---------
* ``zDim`` physical points are interior Chebyshev-Gauss ("mish") points:
  theta_j = pi (j + 1/2) / nz,  zeta_j = -cos(theta_j)  (ascending),
  z_j = zmin + L (1 + zeta_j) / 2.  No boundary points -- matching the
  reference where e.g. surface drag is applied at the *first mish point*
  (src/shallowWaterModels.jl:469-483).
* Analysis (CB) is the DCT-II; we precompute it as a dense [nz, nz] matrix
  (one batched matmul over all columns at these sizes, nz <= O(100)).
* CA applies the 2/3-rule dealias truncation: coefficients k >= b_zDim are
  zeroed (reference: ``b_zDim = min(zDim, floor((2 zDim - 1)/3) + 1)``,
  spectralGrid.jl:36) plus optional boundary constraints (gammaBC).
* Derivatives / antiderivative are coefficient-space recurrences, provided
  as dense matrices so entire grids of columns batch into single matmuls.

All operators are float64 numpy, cast to the working dtype by callers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import lru_cache

import numpy as np


class ZBC(enum.Enum):
    """Vertical boundary condition families (only R0 is used by the live
    reference equation sets; value/slope constraints provided for parity
    with the gammaBC machinery)."""

    R0 = "R0"
    R1T0 = "R1T0"  # f = 0 at that boundary
    R1T1 = "R1T1"  # f' = 0 at that boundary


def b_zdim(nz: int) -> int:
    """2/3-rule truncated coefficient count (ref spectralGrid.jl:36)."""
    return int(min(nz, np.floor((2 * nz - 1) / 3) + 1))


def gauss_points(nz: int, zmin: float, zmax: float) -> np.ndarray:
    theta = np.pi * (np.arange(nz) + 0.5) / nz
    zeta = -np.cos(theta)
    return zmin + (zmax - zmin) * (1.0 + zeta) / 2.0


def _synthesis_matrix(nz: int) -> np.ndarray:
    """S[j, k] = T_k(zeta_j) with zeta the ascending Gauss points."""
    theta = np.pi * (np.arange(nz) + 0.5) / nz
    zeta = -np.cos(theta)
    k = np.arange(nz)
    return np.cos(k[None, :] * np.arccos(zeta[:, None]))


def _analysis_matrix(nz: int) -> np.ndarray:
    """Inverse of the synthesis matrix (DCT-II with our point ordering)."""
    s = _synthesis_matrix(nz)
    # Exact inverse via orthogonality: A = diag(c) * S^T / nz with c0=1, ck=2
    c = np.full(nz, 2.0)
    c[0] = 1.0
    return (c[:, None] * s.T) / nz


def _deriv_coeff_matrix(nz: int, length: float) -> np.ndarray:
    """Coefficient-space d/dz matrix via the Chebyshev recurrence.

    If f = sum a_k T_k then f' = sum c_k T_k with
    c_{k-1} = c_{k+1} + 2 k a_k (c_{nz} = c_{nz+1} = 0), then scale by
    dzeta/dz = 2/length.
    """
    d = np.zeros((nz, nz))
    for col in range(nz):
        a = np.zeros(nz)
        a[col] = 1.0
        c = np.zeros(nz + 2)
        for k in range(nz - 1, 0, -1):
            c[k - 1] = c[k + 1] + 2.0 * k * a[k]
        c[0] *= 0.5
        d[:, col] = c[:nz]
    return d * (2.0 / length)


def _integral_coeff_matrix(nz: int, length: float) -> np.ndarray:
    """Coefficient-space antiderivative (up to a constant in row 0).

    Int T_0 = T_1; Int T_1 = T_2/4; Int T_k = T_{k+1}/(2(k+1)) - T_{k-1}/(2(k-1)).
    Output truncated to nz coefficients; scaled by dz/dzeta = length/2.
    """
    m = np.zeros((nz + 1, nz))
    m[1, 0] = 1.0
    if nz > 1:
        m[2, 1] = 0.25
        m[0, 1] = -0.25  # constant part folded into row 0 (arbitrary)
    for k in range(2, nz):
        if k + 1 <= nz:
            m[k + 1, k] = 1.0 / (2.0 * (k + 1))
        m[k - 1, k] -= 1.0 / (2.0 * (k - 1))
    return m[:nz, :] * (length / 2.0)


@dataclass(frozen=True)
class ChebyshevOps:
    """Dense [nz, nz] operators for one vertical column configuration.

    Physical values live on ascending Gauss points.  ``analysis`` maps values
    -> raw coefficients b (CB); ``constrain`` maps b -> filtered/BC
    coefficients a (CA); ``synth``/``dsynth``/``d2synth`` map a -> values and
    derivatives on the points (CI/CIx/CIxx); ``isynth`` maps a -> the
    antiderivative anchored to zero at z = zmin (CIInt).
    """

    nz: int
    zmin: float
    zmax: float
    points: np.ndarray
    analysis: np.ndarray
    constrain: np.ndarray
    synth: np.ndarray
    dsynth: np.ndarray
    d2synth: np.ndarray
    isynth: np.ndarray
    dcoef: np.ndarray  # coefficient-space d/dz (for operator composition)

    @property
    def value_deriv_stack(self) -> np.ndarray:
        """[3, nz, nz]: value, d/dz, d2/dz2 synthesis."""
        return np.stack([self.synth, self.dsynth, self.d2synth], axis=0)


def _bc_projector(nz: int, bcb: ZBC, bct: ZBC) -> np.ndarray:
    """gammaBC: least-change projection of coefficients onto the subspace
    satisfying the endpoint constraints (identity for R0/R0)."""
    rows = []
    k = np.arange(nz)
    bottom_val = (-1.0) ** k  # T_k(-1)
    top_val = np.ones(nz)  # T_k(+1)
    bottom_slope = -(k**2) * (-1.0) ** (k + 1)  # T_k'(-1) = (-1)^(k+1) k^2
    top_slope = k**2  # T_k'(+1)
    if bcb == ZBC.R1T0:
        rows.append(bottom_val)
    elif bcb == ZBC.R1T1:
        rows.append(bottom_slope)
    if bct == ZBC.R1T0:
        rows.append(top_val)
    elif bct == ZBC.R1T1:
        rows.append(top_slope)
    if not rows:
        return np.eye(nz)
    c = np.stack(rows)  # [m, nz]
    # orthogonal projector onto null(c)
    q = c.T @ np.linalg.solve(c @ c.T, c)
    return np.eye(nz) - q


@lru_cache(maxsize=None)
def build_ops(
    nz: int,
    zmin: float,
    zmax: float,
    bdim: int | None = None,
    bcb: ZBC = ZBC.R0,
    bct: ZBC = ZBC.R0,
) -> ChebyshevOps:
    length = zmax - zmin
    if bdim is None:
        bdim = b_zdim(nz)
    pts = gauss_points(nz, zmin, zmax)
    s = _synthesis_matrix(nz)
    a = _analysis_matrix(nz)
    trunc = np.eye(nz)
    trunc[bdim:, bdim:] = 0.0
    constrain = _bc_projector(nz, bcb, bct) @ trunc
    dcoef = _deriv_coeff_matrix(nz, length)
    icoef = _integral_coeff_matrix(nz, length)
    isynth_raw = s @ icoef
    # anchor the antiderivative to zero at z = zmin (zeta = -1):
    k = np.arange(nz)
    bottom = ((-1.0) ** k) @ icoef  # value of antiderivative at zeta=-1
    isynth = isynth_raw - np.ones((nz, 1)) @ bottom[None, :]
    return ChebyshevOps(
        nz=nz,
        zmin=zmin,
        zmax=zmax,
        points=pts,
        analysis=a,
        constrain=constrain,
        synth=s,
        dsynth=s @ dcoef,
        d2synth=s @ dcoef @ dcoef,
        isynth=isynth,
        dcoef=dcoef,
    )


def dct_matrix(nz: int) -> np.ndarray:
    """Coefficients -> values on the Gauss points (ref Chebyshev.dct_matrix,
    used to build the semi-implicit Helmholtz system, semiimplicit.jl:757)."""
    return _synthesis_matrix(nz)


def dct_1st_derivative(nz: int, length: float) -> np.ndarray:
    return _synthesis_matrix(nz) @ _deriv_coeff_matrix(nz, length)


def dct_2nd_derivative(nz: int, length: float) -> np.ndarray:
    d = _deriv_coeff_matrix(nz, length)
    return _synthesis_matrix(nz) @ d @ d
