"""scythe-tpu: a semi-spectral atmospheric dynamical core in JAX.

A ground-up JAX/XLA reimagining of the capabilities of the reference
Julia core (mmbell/Scythe.jl): mixed cubic-B-spline / Fourier / Chebyshev
spectral transforms on R, RL, RZ, RLZ cylindrical grids, an IMEX AB3/AI2*
stepper with a semi-implicit vertical Helmholtz solve, reference-state moist
thermodynamics, warm-rain microphysics, and the two-layer shallow-water /
slab-boundary-layer tropical cyclone models of Cha & Bell (2024).
"""

from .config import BC, ZBC, GridParameters, ModelParameters
from .grids.base import Grid, create_grid

__all__ = [
    "BC",
    "ZBC",
    "GridParameters",
    "ModelParameters",
    "Grid",
    "create_grid",
    "integrate_model",
    "make_simulator",
]


def integrate_model(model, **kw):
    """Public driver (ref src/Scythe.jl:37-62).  Lazy import to keep basis
    modules importable without the full stack."""
    from .model import integrate_model as _run

    return _run(model, **kw)


def make_simulator(model, **kw):
    """Differentiable end-to-end simulator (adjoint.make_simulator): a pure
    sim(params, phys0) -> final fields for jax.grad/jit/vmap.  No reference
    counterpart — enabled by the functional re-architecture."""
    from .adjoint import make_simulator as _mk

    return _mk(model, **kw)
