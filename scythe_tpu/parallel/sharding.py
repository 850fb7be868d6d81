"""Radial domain decomposition over a device mesh.

Replacement for the reference's tile/halo runtime
(src/semiimplicit.jl:126-332).  The mapping (SURVEY.md 2.8):

* reference radial tiles (one per Distributed worker)  ->  a 1-D
  `jax.sharding.Mesh` axis ``"r"``; physical-space arrays are sharded along
  the radial mish dimension, cut on cell boundaries so each shard owns whole
  spline cells.
* reference halo exchange + SharedArray overlap-add of spectral
  coefficients (semiimplicit.jl:272-329)  ->  a single `psum` of the local
  quadrature projections.  Because the projection is an exact sum of
  per-cell contributions (basis/bspline.py), the psum reproduces the global
  analysis bit-for-bit up to reduction order: no approximation at tile
  boundaries, unlike the reference's per-tile refit.
* the replicated Gram/filter/BC solve (the reference's splineTransform! on
  every worker) stays replicated: it is a [b_rDim, b_rDim] matmul, far
  cheaper than the communication it would take to shard it.
* azimuthal FFTs and vertical Chebyshev columns stay chip-local (the
  reference never decomposes lambda or z either).

Per-step communication = one psum of ``[nvars, b_rDim(, nl)(, nz)]`` — a
few hundred KB at flagship sizes, over the device interconnect (NVLink
between the GPUs of one host).
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import timeintegration as ti
from ..grids.base import Grid, _split3
from ..model import build_context, build_step
from . import schur as schur_mod

AXIS = "r"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (AXIS,))


ENSEMBLE_AXIS = "e"


def make_ensemble_mesh(n_devices: int | None = None) -> Mesh:
    """Single-axis mesh for `model.integrate_ensemble(..., mesh=...)`:
    ensemble members shard across devices with zero inter-chip
    communication (members are independent)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (ENSEMBLE_AXIS,))


def gather_global(x) -> np.ndarray:
    """Device array (possibly sharded across processes) -> host numpy.

    Single-process: plain transfer.  Multi-process (the --multihost CLI
    path, ref run_Scythe.jl:35-44's worker launch): allgather so every
    process holds the full array — used at output boundaries only."""
    if jax.process_count() == 1 or getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _check_divisible(grid: Grid, n: int):
    if grid.params.num_cells % n != 0:
        raise ValueError(
            f"num_cells={grid.params.num_cells} must be divisible by the "
            f"mesh size {n} (shards own whole spline cells)"
        )


def _local_grid(grid: Grid, idx, rows: int) -> Grid:
    """A shallow grid copy whose radial-row operators are this shard's
    slice (synthesis rows, projection columns, ring masks, coords).
    Compensated operator stacks carry a leading length-3 axis."""
    start = idx * rows
    off = 1 if grid.comp else 0
    lg = copy.copy(grid)
    lg.synth_r = jax.lax.dynamic_slice_in_dim(grid.synth_r, start, rows, axis=1 + off)
    lg.synth_r_val = jax.lax.dynamic_slice_in_dim(
        grid.synth_r_val, start, rows, axis=0 + off
    )
    lg.project_r = jax.lax.dynamic_slice_in_dim(
        grid.project_r, start, rows, axis=1 + off
    )
    if grid.fast:  # single-pass bf16 derivative operators (no comp axis)
        lg.synth_r_deriv_f = jax.lax.dynamic_slice_in_dim(
            grid.synth_r_deriv_f, start, rows, axis=1
        )
        lg.synth_r_val_f = jax.lax.dynamic_slice_in_dim(
            grid.synth_r_val_f, start, rows, axis=0
        )
    if grid.ring_mask is not None:
        lg.ring_mask = jax.lax.dynamic_slice_in_dim(grid.ring_mask, start, rows, axis=0)
    # Smagorinsky per-ring arc spacing [rDim] -> this shard's rows (the
    # closure's only radially-shaped static input; physics/turbulence
    # ring_arc_spacing caches it on the global grid)
    from ..physics.turbulence import ring_arc_spacing

    dy = ring_arc_spacing(grid)
    if getattr(dy, "ndim", 0) >= 1:
        lg.smag_dy = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(dy), start, rows, axis=0
        )
    else:
        lg.smag_dy = dy
    return lg


def _local_coords(coords: dict, idx, rows: int) -> dict:
    """Slice every radially-shaped coordinate to this shard's rows.

    Keyed by shape, not name: "r" plus its geometry aliases ("lat" on SL
    shells, "x" on XYZ boxes) all span the full mish dimension on axis 0,
    while the non-radial coordinates ("l"/"lon"/"y"/"z") carry a leading
    broadcast axis of length 1."""
    full = coords["r"].shape[0]
    out = {}
    for key, val in coords.items():
        if hasattr(val, "shape") and val.ndim >= 1 and val.shape[0] == full:
            out[key] = jax.lax.dynamic_slice_in_dim(val, idx * rows, rows, axis=0)
        else:
            out[key] = val
    return out


# Radial axis of every known ctx.extras entry (None = not radially
# shaped, never sliced).  Keyed by NAME, not shape: a shape heuristic
# would silently mis-slice a future entry whose leading dim happens to
# coincide with rDim.  Register new extras here when adding them.
_EXTRAS_RADIAL_AXIS = {
    "hs_grad": 1,  # topography gradient [2, rDim, nl] (model.py:683)
    "hs_filtered": 0,  # filtered topography [rDim, nl] (model.py:684)
    "sponge_ref": 1,  # sponge reference state [nvars, rDim, ...] (model.py:697)
    "radiation_ref_dr": 1,  # radiation d/dr reference [nvars, rDim, ...] (model.py:699)
}


def _local_extras(extras: dict, idx, rows: int, rDim: int) -> dict:
    """Slice radially-shaped auxiliary fields (e.g. the sponge reference
    state [nvars, rDim, ...]) to this shard's rows.  Registered entries
    (_EXTRAS_RADIAL_AXIS) slice on their declared radial axis; for
    unregistered (user-supplied) entries fall back to the shape
    heuristic — axis 1 == rDim wins over axis 0 == rDim, matching the
    [nvars, rDim, ...] layout — which can misfire if a non-radial dim
    coincides with rDim, so production extras must be registered."""
    out = {}
    for key, val in extras.items():
        if key in _EXTRAS_RADIAL_AXIS:
            ax = _EXTRAS_RADIAL_AXIS[key]
            if ax is not None:
                val = jax.lax.dynamic_slice_in_dim(val, idx * rows, rows, axis=ax)
        elif hasattr(val, "ndim") and val.ndim >= 2 and val.shape[1] == rDim:
            val = jax.lax.dynamic_slice_in_dim(val, idx * rows, rows, axis=1)
        elif hasattr(val, "ndim") and val.ndim >= 1 and val.shape[0] == rDim:
            val = jax.lax.dynamic_slice_in_dim(val, idx * rows, rows, axis=0)
        out[key] = val
    return out


def state_specs(method: str = "psum") -> ti.ModelState:
    """PartitionSpecs for a ModelState.  psum path: spectral replicated;
    halo path: spectral sharded along its (windowed) radial-coefficient
    axis.  Physical histories sharded along the radial axis either way."""
    return ti.ModelState(
        spec=P() if method == "psum" else P(None, AXIS),
        expdot_nm1=P(None, AXIS),
        expdot_nm2=P(None, AXIS),
        impdot_nm1=P(None, AXIS),
        impdot_nm2=P(None, AXIS),
        t=P(),
    )


def shard_state(state: ti.ModelState, mesh: Mesh, method: str = "psum") -> ti.ModelState:
    specs = state_specs(method)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


# ---------------------------------------------------------------------------
# Halo (Schur) path: windowed spectral state, O(halo) per-step communication.
# See parallel/schur.py for the factorization; ref semiimplicit.jl:84-86.


def spec_to_blocks(spec, n: int, cl: int) -> jnp.ndarray:
    """Canonical spectral [v, nb, ...] -> windowed blocks [v, n*W, ...]
    (window i = raw coefficient rows [i*cl, i*cl+cl+3); halo rows are
    duplicated across neighbors by construction)."""
    W = cl + schur_mod.HALO
    blocks = [spec[:, i * cl : i * cl + W] for i in range(n)]
    return jnp.concatenate(blocks, axis=1)


def blocks_to_spec(blocks, n: int, cl: int) -> jnp.ndarray:
    """Windowed blocks [v, n*W, ...] -> canonical spectral [v, nb, ...]
    (drop halo duplicates; the last shard's window is fully owned)."""
    W = cl + schur_mod.HALO
    parts = [blocks[:, i * W : i * W + cl] for i in range(n - 1)]
    parts.append(blocks[:, (n - 1) * W : n * W])
    return jnp.concatenate(parts, axis=1)


def _take_shard(arr, idx, comp: bool):
    """Select shard idx from a stacked [n, ...] (or compensated
    [3, n, ...]) operator array inside shard_map."""
    off = 1 if comp else 0
    sl = jax.lax.dynamic_slice_in_dim(arr, idx, 1, axis=off)
    return jax.lax.squeeze(sl, (off,))


# shard counts at/above which the halo path defaults to the PCR interface
# solve (O(log n) 3-row ppermutes; measured <= 3 levels for any n) instead
# of the 3-rows-per-shard all_gather + dense [6, 3n] matvec (O(n)).
PCR_AUTO_MIN = 16


class HaloOps:
    """Device-prepped Schur matrices (stacked over shards, through the
    grid's matmul mode) + static partition facts.

    ``interface``: how the eliminated block-tridiagonal interface system is
    solved at runtime — "gather" (all_gather + precomputed dense inverse
    rows; comm O(n) per chip) or "pcr" (parallel cyclic reduction,
    parallel/schur.py::build_pcr_ops; comm O(log n), in practice <= 3
    3-row ppermute pairs for any n).  "auto" picks pcr for
    n >= PCR_AUTO_MIN."""

    def __init__(self, grid: Grid, n: int, interface: str = "auto"):
        if interface == "auto":
            interface = "pcr" if n >= PCR_AUTO_MIN else "gather"
        if interface not in ("gather", "pcr"):
            raise ValueError(f"unknown interface {interface!r}")
        # the per-var interior eliminations are the expensive setup step:
        # compute once and share; skip the O(n^2) CS inverse when PCR
        # solves the interface at runtime
        ifaces = schur_mod.var_interfaces(grid.params, n)
        sops = schur_mod.build_schur_ops(
            grid.params, n, ifaces=ifaces, include_cs=(interface == "gather")
        )
        prep = (
            _split3
            if grid.comp
            else (lambda a: jnp.asarray(np.asarray(a), grid.dtype))
        )
        self.interface = interface
        self.n, self.cl, self.W = sops.n, sops.cl, sops.W
        self.GL = prep(sops.GL)
        self.GRr = prep(sops.GRr)
        self.AP = prep(sops.AP)
        self.AC = prep(sops.AC)
        if interface == "pcr":
            pops = schur_mod.build_pcr_ops(grid.params, n, ifaces=ifaces)
            self.levels = pops.levels
            self.dists = pops.dists
            self.A = [prep(pops.A[k]) for k in range(pops.levels)]
            self.B = [prep(pops.B[k]) for k in range(pops.levels)]
            self.Dinv = prep(pops.Dinv)
        else:
            self.CS = prep(sops.CS)


def _window_grid(grid: Grid, idx, n: int) -> Grid:
    """A shallow grid copy whose radial operators are this shard's WINDOW
    slices: synthesis maps the local coefficient window [W] to the local
    physical rows, and projection maps local physical rows to the window.
    With the windowed state layout, sharded synthesis needs no
    communication at all."""
    cl = grid.params.num_cells // n
    W = cl + schur_mod.HALO
    rows = grid.params.rDim // n
    r0 = idx * rows
    b0 = idx * cl
    off = 1 if grid.comp else 0
    lg = copy.copy(grid)
    sr = jax.lax.dynamic_slice_in_dim(grid.synth_r, r0, rows, axis=1 + off)
    lg.synth_r = jax.lax.dynamic_slice_in_dim(sr, b0, W, axis=2 + off)
    sv = jax.lax.dynamic_slice_in_dim(grid.synth_r_val, r0, rows, axis=0 + off)
    lg.synth_r_val = jax.lax.dynamic_slice_in_dim(sv, b0, W, axis=1 + off)
    pr = jax.lax.dynamic_slice_in_dim(grid.project_r, b0, W, axis=0 + off)
    lg.project_r = jax.lax.dynamic_slice_in_dim(pr, r0, rows, axis=1 + off)
    if grid.fast:  # single-pass bf16 derivative operators (no comp axis)
        sd = jax.lax.dynamic_slice_in_dim(grid.synth_r_deriv_f, r0, rows, axis=1)
        lg.synth_r_deriv_f = jax.lax.dynamic_slice_in_dim(sd, b0, W, axis=2)
        sf = jax.lax.dynamic_slice_in_dim(grid.synth_r_val_f, r0, rows, axis=0)
        lg.synth_r_val_f = jax.lax.dynamic_slice_in_dim(sf, b0, W, axis=1)
    if grid.ring_mask is not None:
        lg.ring_mask = jax.lax.dynamic_slice_in_dim(grid.ring_mask, r0, rows, axis=0)
    from ..physics.turbulence import ring_arc_spacing

    dy = ring_arc_spacing(grid)
    if getattr(dy, "ndim", 0) >= 1:
        lg.smag_dy = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(dy), r0, rows, axis=0
        )
    else:
        lg.smag_dy = dy
    return lg


def _halo_analysis(grid: Grid, wg: Grid, hops: HaloOps, idx, phys):
    """Distributed exact analysis on the windowed layout: local projection,
    one 3-row overflow ppermute, local Schur elimination, the interface
    solve (per ``hops.interface``: a 3-row-per-shard all_gather + dense
    inverse-row matvec, or parallel cyclic reduction via O(log n) 3-row
    ppermute pairs), local back-substitution, and one 3-row halo ppermute.
    Returns the shard's spectral window [v, W, ...]."""
    n, cl, W = hops.n, hops.cl, hops.W
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    is_last = (idx == n - 1).astype(phys.dtype)

    p_loc = wg.project(phys)  # [v, W, ...]
    tail = p_loc[:, cl:] * (1.0 - is_last)  # last shard owns its tail
    recv = jax.lax.ppermute(tail, AXIS, right)
    p_own = p_loc.at[:, cl:].multiply(is_last).at[:, :3].add(recv)

    GL = _take_shard(hops.GL, idx, grid.comp)
    GRr = _take_shard(hops.GRr, idx, grid.comp)
    g = grid._mm("vsw,vw...->vs...", GL, p_own)
    gr = grid._mm("vsw,vw...->vs...", GRr, p_own)
    g = g + jax.lax.ppermute(gr, AXIS, right)

    if hops.interface == "pcr":
        # parallel cyclic reduction: O(log n) 3-row ppermute pairs
        y = g
        for k in range(hops.levels):
            dk = hops.dists[k]
            to_right = [(i, (i + dk) % n) for i in range(n)]
            to_left = [(i, (i - dk) % n) for i in range(n)]
            y_prev = jax.lax.ppermute(y, AXIS, to_right)  # delivers y_{i-d}
            y_next = jax.lax.ppermute(y, AXIS, to_left)  # delivers y_{i+d}
            Ak = _take_shard(hops.A[k], idx, grid.comp)
            Bk = _take_shard(hops.B[k], idx, grid.comp)
            y = (
                y
                + grid._mm("vab,vb...->va...", Ak, y_prev)
                + grid._mm("vab,vb...->va...", Bk, y_next)
            )
        Dinv = _take_shard(hops.Dinv, idx, grid.comp)
        c = grid._mm("vab,vb...->va...", Dinv, y)
        c_next = jax.lax.ppermute(c, AXIS, left)  # delivers c_{i+1}
        c6 = jnp.concatenate([c, c_next], axis=1)
    else:
        g_all = jax.lax.all_gather(g, AXIS, axis=0)  # [n, v, 3, ...]
        g_flat = jnp.moveaxis(g_all, 0, 1).reshape(
            (g.shape[0], 3 * n) + g.shape[2:]
        )
        CS = _take_shard(hops.CS, idx, grid.comp)
        c6 = grid._mm("vsg,vg...->vs...", CS, g_flat)

    AP = _take_shard(hops.AP, idx, grid.comp)
    AC = _take_shard(hops.AC, idx, grid.comp)
    a_own = grid._mm("vuw,vw...->vu...", AP, p_own) + grid._mm(
        "vus,vs...->vu...", AC, c6
    )
    head = jax.lax.ppermute(a_own[:, :3], AXIS, left)
    return a_own.at[:, cl:].add(head * (1.0 - is_last))


def build_sharded_step(
    model, grid: Grid, ctx, dtype, mesh: Mesh, method="psum", interface="auto"
):
    """Shard-mapped single step.  Returns step(state) -> state (not jitted;
    compose with model.make_scan).

    ``method``:
    * "psum" (default, best for small meshes): spectral state replicated;
      analysis = local projection + psum of the full projection array +
      replicated solve.
    * "halo" (scalable): spectral state sharded as per-shard coefficient
      windows; analysis = Schur-complement distributed solve with O(halo)
      communication (parallel/schur.py).  Bit-compatible physics, solution
      equal to "psum" to roundoff.  ``interface`` selects the interface
      solve: "gather" / "pcr" / "auto" (see HaloOps).
    """
    n = mesh.shape[AXIS]
    _check_divisible(grid, n)
    rows = grid.params.rDim // n
    hops = HaloOps(grid, n, interface) if method == "halo" else None

    # Per-step modal filter under sharding (model.build_modal_filter): the
    # base filter acts on the CANONICAL spectral layout.  psum path: the
    # spectral state is replicated and already canonical — apply directly
    # (purely local; stays replicated).  halo path: the state is per-shard
    # coefficient windows, and the radial factor F_v is a global [b_r, b_r]
    # operator — gather the (tiny) windowed state once at filter time,
    # apply canonically, and re-slice this shard's window.  The b_r axis is
    # the SMALL axis of the state (SURVEY.md 2.8: per-step global ops on it
    # are cheap by design), so filter-on halo runs trade one small
    # all_gather per step for the stabilizer.
    base_filter = None
    opts = model.opts()
    mf_tau = float(opts.get("modal_filter_tau", 0.0) or 0.0)
    if mf_tau > 0.0:
        from ..model import build_modal_filter

        base_filter = build_modal_filter(
            grid,
            mf_tau,
            int(opts.get("modal_filter_order", 4)),
            model.ts,
            dtype,
            axes=str(opts.get("modal_filter_axes", "rlz")),
        )
    cl = grid.params.num_cells // n
    W = cl + schur_mod.HALO

    def body(spec, e1, e2, i1, i2, t):
        idx = jax.lax.axis_index(AXIS)
        modal_filter_fn = base_filter
        if method == "halo":
            lg = _window_grid(grid, idx, n)

            def analysis_fn(phys):
                return _halo_analysis(grid, lg, hops, idx, phys)

            if base_filter is not None:

                def modal_filter_fn(win):
                    g_all = jax.lax.all_gather(win, AXIS, axis=0)
                    blocks = jnp.moveaxis(g_all, 0, 1).reshape(
                        (win.shape[0], n * W) + win.shape[2:]
                    )
                    out = spec_to_blocks(
                        base_filter(blocks_to_spec(blocks, n, cl)), n, cl
                    )
                    return jax.lax.dynamic_slice_in_dim(
                        out, idx * W, W, axis=1
                    )

        else:
            lg = _local_grid(grid, idx, rows)

            def analysis_fn(phys):
                proj = lg.project(phys)
                return grid.solve_spectral(jax.lax.psum(proj, AXIS))

        lctx = dataclasses.replace(
            ctx,
            grid=lg,
            coords=_local_coords(ctx.coords, idx, rows),
            extras=_local_extras(ctx.extras, idx, rows, grid.params.rDim),
        )
        step = build_step(
            model,
            lg,
            lctx,
            dtype,
            analysis_fn=analysis_fn,
            synthesis_fn=lg.synthesis,
            modal_filter_fn=modal_filter_fn,
        )
        st = ti.ModelState(spec, e1, e2, i1, i2, t)
        out = step(st)
        return tuple(out)

    specs = state_specs(method)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=tuple(specs),
        check_vma=False,
    )

    def step(state: ti.ModelState) -> ti.ModelState:
        return ti.ModelState(*mapped(*state))

    return step


def integrate_sharded(
    model,
    n_devices: int,
    dtype=None,
    method="psum",
    interface="auto",
    write_outputs=True,
    resume_from: str | None = None,
    profile_dir: str | None = None,
):
    """Sharded analog of model.integrate_model with full driver parity:
    same output cadence, watchdog, scythe_out.log, binary checkpoints,
    bitwise resume, and profiler trace — radial dimension split over
    ``n_devices`` using the selected analysis ``method`` (and, for
    method="halo", the selected interface solve)."""
    from ..model import default_dtype, logged_run, run_loop

    dtype = dtype or default_dtype()
    mesh = make_mesh(n_devices)
    n = mesh.shape[AXIS]
    with logged_run(model, profile_dir):
        grid, ctx, state = initialize_sharded(model, mesh, dtype, method)
        step = build_sharded_step(model, grid, ctx, dtype, mesh, method, interface)
        cl = grid.params.num_cells // n
        to_canonical = None
        from_canonical = None
        if method == "halo":
            to_canonical = lambda spec: blocks_to_spec(spec, n, cl)

            def from_canonical(st):
                st = st._replace(spec=spec_to_blocks(st.spec, n, cl))
                return shard_state(st, mesh, method)

        else:
            from_canonical = lambda st: shard_state(st, mesh, method)
        return run_loop(
            model,
            grid,
            ctx,
            state,
            step,
            dtype,
            write_outputs=write_outputs,
            resume_from=resume_from,
            to_canonical=to_canonical,
            from_canonical=from_canonical,
            gather=gather_global,
        )


def initialize_sharded(model, mesh: Mesh, dtype=None, method="psum", matmul="auto"):
    """Sharded analog of model.initialize: build grid/context/state and
    place the state according to the mesh.  ``matmul`` forwards to
    create_grid (tests use it to force "compensated")."""
    from .. import io as sio
    from ..grids.base import create_grid
    from ..model import default_dtype

    dtype = dtype or default_dtype()
    grid = create_grid(model.grid_params, dtype, matmul=matmul)
    n = mesh.shape[AXIS]
    _check_divisible(grid, n)
    ctx = build_context(model, grid, dtype)
    phys0 = sio.read_physical_grid(model.initial_conditions, grid)
    spec0 = grid.analysis(jnp.asarray(phys0, dtype))
    from ..model import _set_boundary_refs, _set_topography

    _set_boundary_refs(ctx, grid, spec0)
    _set_topography(ctx, grid)
    if method == "halo":
        spec0 = spec_to_blocks(spec0, n, grid.params.num_cells // n)
    from ..model import imp_history_rows

    state = ti.initial_state(
        spec0,
        (grid.nvars,) + grid.spatial_shape,
        dtype,
        imp_rows=imp_history_rows(model),
    )
    return grid, ctx, shard_state(state, mesh, method)
