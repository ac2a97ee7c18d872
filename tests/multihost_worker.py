"""Multi-process worker for test_multihost_spawn.py (NOT a pytest file).

Each spawned process initializes ``jax.distributed`` against a localhost
coordinator (gloo CPU collectives), builds the host-major slice mesh, runs a
REAL sharded ``partial_schur`` over the multi-process mesh, and validates:

* mesh device ordering is process-major (``make_slice_mesh`` contract),
* ``process_local_rows`` ranges tile [0, n) without gaps or overlap,
* the sharded solve's eigenvalues match single-process ARPACK,
* true residuals of the gathered Schur basis are at tolerance.

Prints ``MULTIHOST_OK {json}`` on success; any assertion kills the process
with a traceback the parent test surfaces.
"""

import json
import os
import sys


def main():
    pid, nproc, port, n_local_dev = (int(a) for a in sys.argv[1:5])
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_local_dev}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np

    from arnoldi_jax.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                         process_id=pid)
    assert jax.process_count() == nproc, (jax.process_count(), nproc)
    assert len(jax.devices()) == nproc * n_local_dev

    mesh = multihost.make_slice_mesh()
    procs = [d.process_index for d in mesh.devices.flat]
    assert procs == sorted(procs), f"mesh not process-major: {procs}"

    from arnoldi_jax.matrices import mark

    A = mark(40)
    n = A.shape[0]

    # Row-range contract: gather every process's range and check the tiling.
    lo, hi = multihost.process_local_rows(n, mesh)
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    ranges = np.asarray(multihost_utils.process_allgather(
        jnp.array([lo, hi], dtype=jnp.int64)))
    assert ranges.shape == (nproc, 2)
    assert ranges[0, 0] == 0 and ranges[-1, 1] == n
    for i in range(1, nproc):
        assert ranges[i, 0] == ranges[i - 1, 1], ranges

    from arnoldi_jax import partial_schur
    from arnoldi_jax.utils.sorting import sort_function_for

    Q, T, hist = partial_schur(
        A, 5, max_dim=20, stopping_criterion=1e-8,
        sort_function=sort_function_for("LM"), max_restarts=2000,
        mesh=mesh, dtype=np.float64, refine=None,
    )
    T = np.asarray(T)          # replicated: addressable on every process
    vals = np.linalg.eigvals(T)

    from scipy.sparse.linalg import eigs as scipy_eigs

    ref = scipy_eigs(A, 5, which="LM")[0]
    assert np.allclose(np.sort(np.abs(vals)), np.sort(np.abs(ref)),
                       atol=1e-7), (vals, ref)

    # True residuals on the gathered basis: ||A Q - Q T|| columnwise.
    Qg = np.asarray(multihost_utils.process_allgather(Q, tiled=True))
    assert Qg.shape == (n, T.shape[0])
    R = A @ Qg - Qg @ T
    res = np.linalg.norm(R, axis=0)
    assert res.max() < 5e-7, res

    # Per-process sharded checkpoint/resume across REAL processes: every
    # process writes only its own shard file; resume agrees with the
    # unbroken solve.
    ckpt = os.environ["MULTIHOST_CKPT"]
    try:
        partial_schur(A, 5, max_dim=20, stopping_criterion=1e-10,
                      sort_function=sort_function_for("LM"), max_restarts=3,
                      mesh=mesh, dtype=np.float64, refine=None,
                      checkpoint_path=ckpt)
        raise AssertionError("3-restart budget unexpectedly converged")
    except ValueError as e:
        assert "Has not converged" in str(e)
    multihost_utils.sync_global_devices("ckpt written")
    assert os.path.exists(f"{ckpt}.p{pid}"), "missing this process's shard"
    Q2, T2, _ = partial_schur(A, 5, max_dim=20, stopping_criterion=1e-8,
                              sort_function=sort_function_for("LM"),
                              max_restarts=2000, mesh=mesh,
                              dtype=np.float64, refine=None,
                              checkpoint_path=ckpt, resume=True)
    v2 = np.linalg.eigvals(np.asarray(T2))
    assert np.allclose(np.sort(np.abs(v2))[-5:], np.sort(np.abs(ref)),
                       atol=1e-7)

    # Ring-halo SpMV across REAL process boundaries: the production
    # distributed matvec (shard_map + ppermute) with its halo legs now
    # crossing processes, validated elementwise against scipy and
    # structurally against the HLO (collective-permute, no all-gather).
    from arnoldi_jax.linop import as_operator
    from arnoldi_jax.matrices import laplace
    from arnoldi_jax.parallel import halo_matvec_closure, shard_operator
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_h = 1024
    Ah = laplace(n_h).tocsr()
    hop = halo_matvec_closure(
        shard_operator(as_operator(Ah, format="banded",
                                   dtype=np.float64), mesh), mesh)
    xs = np.linspace(-1.0, 1.0, n_h)
    x = jax.device_put(jnp.asarray(xs), NamedSharding(mesh, P("rows")))
    # The operator must be a jit ARGUMENT (HaloOperator is a pytree whose
    # children are the sharded band arrays) — jitting the bound method
    # would close over multi-process global arrays, which jax rejects.
    mv = jax.jit(lambda o, v: o.matvec(v))
    txt = mv.lower(hop, x).compile().as_text()
    assert "collective-permute" in txt, "halo matvec lost its ring comms"
    assert "all-gather" not in txt, "halo matvec fell back to all-gather"
    y = np.asarray(multihost_utils.process_allgather(mv(hop, x),
                                                     tiled=True))
    assert np.allclose(y, Ah @ xs, atol=1e-12), np.abs(y - Ah @ xs).max()

    # Full Hermitian solve THROUGH the cross-process halo operator.
    from arnoldi_jax import partial_eigh

    vals_h, _, _ = partial_eigh(
        hop, 3, which="LA", mesh=mesh, dtype=np.float64,
        stopping_criterion=1e-9, max_restarts=2000, max_dim=20,
        key=jax.random.key(4), refine=None)
    from arnoldi_jax.matrices import laplace_eigen

    want_h = np.sort(laplace_eigen(n_h))[-3:][::-1]
    assert np.allclose(np.asarray(vals_h), want_h, atol=1e-8), (
        vals_h, want_h)

    print("MULTIHOST_OK " + json.dumps({
        "pid": pid, "nproc": nproc, "matvecs": int(hist.total_matvecs),
        "max_res": float(res.max()), "ranges": ranges.tolist(),
    }), flush=True)


if __name__ == "__main__":
    main()
