#!/usr/bin/env python3
"""CLI launcher (ref run_Scythe.jl).

Usage:
    python run_scythe.py [options] model_file.py

The model file is executable config (as in the reference, README.md:27): a
Python script that defines a ``model = ModelParameters(...)`` variable.
Parallelism flags replace the reference's worker/SGE machinery: ``--devices``
selects how many local accelerator devices to shard the radial dimension
over (the reference's tiles); multi-host runs use standard
``jax.distributed`` initialization via environment variables.
"""

from __future__ import annotations

import argparse
import runpy
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", help="Python file defining `model = ModelParameters(...)`")
    p.add_argument(
        "-d",
        "--devices",
        type=int,
        default=1,
        help="number of devices to shard the radial dimension over (default 1)",
    )
    p.add_argument(
        "--dtype",
        choices=["f32", "f64"],
        default="f32",
        help="working precision (f64 enables jax x64 mode; slow on the GPU)",
    )
    p.add_argument("--platform", default=None, help="force a JAX platform (e.g. cpu)")
    p.add_argument(
        "--multihost",
        action="store_true",
        help="call jax.distributed.initialize() for multi-host pods "
        "(autodetects cluster env; or pass --coordinator/--num-processes/"
        "--process-id for a manual launch)",
    )
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--shard-method",
        choices=["psum", "halo"],
        default="psum",
        help="sharded-analysis method: psum (replicated spectral, small "
        "meshes) or halo (Schur solve, O(halo) comms, scalable)",
    )
    p.add_argument(
        "--shard-interface",
        choices=["auto", "gather", "pcr"],
        default="auto",
        help="halo-method interface solve: gather (all_gather + dense "
        "inverse rows, O(n)) or pcr (parallel cyclic reduction, O(log n) "
        "ppermutes); auto = pcr at n >= 16",
    )
    p.add_argument(
        "--format",
        choices=["csv", "nc"],
        default=None,
        help="output format: reference-schema CSV (default) or CF NetCDF",
    )
    p.add_argument(
        "--resume-from", default=None, help="binary checkpoint .npz to resume from"
    )
    p.add_argument(
        "--profile-dir", default=None, help="write a JAX profiler trace here"
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import os

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    if args.multihost:
        if args.coordinator:
            jax.distributed.initialize(
                args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
        else:
            jax.distributed.initialize()

    import jax.numpy as jnp

    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32

    ns = runpy.run_path(args.model)
    if "model" not in ns:
        sys.exit(f"{args.model} must define a `model = ModelParameters(...)`")
    model = ns["model"]
    if args.format:
        model = model.with_(options={**model.opts(), "output_format": args.format})

    print(
        f"Initializing {model.equation_set} on {len(jax.devices())} "
        f"available device(s), using {args.devices}"
    )
    t0 = time.time()
    if args.devices > 1:
        from scythe_tpu.parallel.sharding import integrate_sharded

        integrate_sharded(
            model,
            args.devices,
            dtype,
            method=args.shard_method,
            interface=args.shard_interface,
            resume_from=args.resume_from,
            profile_dir=args.profile_dir,
        )
    else:
        from scythe_tpu import integrate_model

        integrate_model(
            model,
            dtype=dtype,
            resume_from=args.resume_from,
            profile_dir=args.profile_dir,
        )
    print(f"All done! ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
