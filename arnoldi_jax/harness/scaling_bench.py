"""Scaling-efficiency benchmark (BASELINE: nnz/s scaling efficiency at
N devices).

Runs the Arnoldi hot loop (expansion cycle) on meshes of 1, 2, ..., N
devices over the same row-partitioned operator and reports nnz/s and
parallel efficiency relative to 1 device.  On the CPU this demonstrates
the mechanism against virtual devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``); on a multi-GPU
host the same command measures NVLink scaling.

    python -m arnoldi_jax.harness.scaling_bench --grid 256 --devices 1,2,4,8
"""

import argparse
import json
import time


def run_scaling(n_grid=256, device_counts=(1, 2, 4, 8), max_dim=40,
                cycles=2, dtype="float32", matrix="laplace", halo=True):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..linop import as_operator, pad_operator
    from ..matrices import laplace_2d, random_scattered
    from ..parallel import (halo_matvec_closure, make_mesh, shard_operator,
                            shard_workspace)
    from ..solvers.decomposition import _expand_jit
    from ..utils.random import rand_normalized_vector

    dt = np.dtype(dtype)
    if matrix == "laplace":
        base = as_operator(laplace_2d(n_grid).astype(dt))
        gran = 1
    elif matrix == "scattered":
        # BSR-8 halo path on banded-scattered sparsity (random columns
        # within a bandwidth that fits the largest mesh's shard size).
        n_s = n_grid * n_grid
        bw = max(n_s // (4 * max(device_counts)), 8)
        base = as_operator(random_scattered(n_s, 8, seed=0, bandwidth=bw,
                                            dtype=dt),
                           format=("bsr", (8, 8)))
        gran = 8
    else:
        raise ValueError(f"matrix={matrix!r}: expected laplace|scattered")
    n = base.shape[0]
    results = []

    for nd in device_counts:
        if nd > len(jax.devices()):
            continue
        mesh = make_mesh(nd)
        g = nd * gran
        n_pad = -(-n // g) * g
        op = shard_operator(pad_operator(base, n_pad), mesh)
        if halo:
            # Explicit ring halo exchange (no all-gather of x) — the
            # production distributed matvec.
            op = halo_matvec_closure(op, mesh)
        H = jnp.zeros((max_dim + 1, max_dim), dt)
        Vt0 = jnp.zeros((max_dim + 1, n_pad), dt)
        Vt0, H = shard_workspace(Vt0, H, mesh)

        def cycle(v0, Vt0=Vt0, H=H, op=op):
            Vt = Vt0.at[0, :].set(v0)
            return _expand_jit(op, Vt, H, np.float32(1e-6), start_dim=0,
                               max_dim=max_dim, ortho="cgs2")

        v0 = rand_normalized_vector(jax.random.key(0), n_pad, dt)
        out = cycle(v0)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        acc = 0.0
        for i in range(cycles):
            v0 = rand_normalized_vector(jax.random.key(77 + i), n_pad, dt)
            out = cycle(v0)
            acc += float(jnp.sum(out[0]))  # forced materialization
        per_iter = (time.perf_counter() - t0) / (cycles * max_dim)
        results.append({
            "devices": nd,
            "ms_per_iter": round(per_iter * 1e3, 4),
            "nnz_per_s": round(base.nnz / per_iter, 0),
        })

    # efficiency = per-device rate relative to the FIRST measured
    # configuration's per-device rate (the first row need not be 1 device)
    if results:
        base_per_dev = results[0]["nnz_per_s"] / results[0]["devices"]
        for r in results:
            r["efficiency"] = round(
                (r["nnz_per_s"] / r["devices"]) / base_per_dev, 4)
    # Honesty label: on virtual CPU devices every "shard" shares one
    # socket, so the efficiency column validates the MECHANISM (sharded
    # compile, collectives, no pathological comms) but says nothing about
    # interconnect scaling.  Label every row with the platform it ran on so
    # a CPU run cannot be mistaken for an accelerator measurement.
    dev = jax.devices()[0]
    kind = ("virtual-device mechanism check (single host CPU; "
            "efficiency is NOT an interconnect measurement)"
            if dev.platform == "cpu" else f"{dev.platform} hardware")
    for r in results:
        r["measurement"] = kind
        r["backend"] = dev.platform
        r["device_kind"] = dev.device_kind
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--max-dim", type=int, default=40)
    ap.add_argument("--matrix", default="laplace",
                    choices=("laplace", "scattered"))
    ap.add_argument("--no-halo", action="store_true",
                    help="use the GSPMD gather path instead of ring halos")
    args = ap.parse_args(argv)

    counts = tuple(int(x) for x in args.devices.split(","))
    results = run_scaling(n_grid=args.grid, device_counts=counts,
                          max_dim=args.max_dim, matrix=args.matrix,
                          halo=not args.no_halo)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
