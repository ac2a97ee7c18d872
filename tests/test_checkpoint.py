"""Checkpoint/resume tests: a solve interrupted by its restart budget must
resume from the snapshot and converge to the same answer as an unbroken
run."""

import numpy as np
import pytest

import jax

from arnoldi_jax import partial_schur
from arnoldi_jax.matrices import mark
from arnoldi_jax.utils.checkpoint import load_checkpoint
from arnoldi_jax.utils.sorting import arg_largest_real

norm = np.linalg.norm


def test_resume_after_budget_exhaustion(tmp_path):
    A = mark(15)
    kwargs = dict(
        max_dim=12, stopping_criterion=1e-10,
        sort_function=arg_largest_real, key=jax.random.key(5),
    )
    ckpt = str(tmp_path / "ks.npz")

    # Unbroken reference run.
    Q_ref, T_ref, h_ref = partial_schur(A, 3, max_restarts=5000, **kwargs)
    total_restarts = int(h_ref.restarts.max())
    assert total_restarts > 3, "need a multi-restart problem for this test"

    # Interrupted run: budget smaller than needed, checkpoint every restart.
    budget = max(2, total_restarts // 2)
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=budget, checkpoint_path=ckpt,
                      **kwargs)

    ck = load_checkpoint(ckpt)
    assert ck.restart == budget
    assert ck.total_matvecs > 0

    # Resume and finish.
    Q, T, h = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, **kwargs)
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-8)
    # Same invariant subspace as the unbroken run.
    v1 = np.sort_complex(np.linalg.eigvals(np.asarray(T_ref)))
    v2 = np.sort_complex(np.linalg.eigvals(Th))
    np.testing.assert_allclose(v1, v2, rtol=1e-7, atol=1e-9)
    # Restart counter continued rather than resetting.
    assert int(h.restarts.max()) >= budget


def test_checkpoint_every(tmp_path):
    A = mark(15)
    ckpt = str(tmp_path / "every3.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(
            A, 3, max_dim=12, stopping_criterion=1e-12, max_restarts=7,
            sort_function=arg_largest_real, checkpoint_path=ckpt,
            checkpoint_every=3, key=jax.random.key(5),
        )
    ck = load_checkpoint(ckpt)
    assert ck.restart == 6  # last multiple of 3 within the budget


def test_block_driver_checkpoint_resume(tmp_path):
    # block_size > 1 (the flagship throughput config) must be resumable.
    A = mark(15)
    kwargs = dict(
        max_dim=16, stopping_criterion=1e-10,
        sort_function=arg_largest_real, key=jax.random.key(5), block_size=2,
    )
    ckpt = str(tmp_path / "blk.npz")

    Q_ref, T_ref, h_ref = partial_schur(A, 3, max_restarts=5000, **kwargs)
    total_restarts = int(h_ref.restarts.max())
    assert total_restarts > 2, "need a multi-restart problem for this test"

    budget = max(1, total_restarts // 2)
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=budget, checkpoint_path=ckpt,
                      **kwargs)
    ck = load_checkpoint(ckpt)
    assert ck.restart == budget

    Q, T, h = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, **kwargs)
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-8)
    v1 = np.sort_complex(np.linalg.eigvals(np.asarray(T_ref)))
    v2 = np.sort_complex(np.linalg.eigvals(Th))
    np.testing.assert_allclose(v1, v2, rtol=1e-7, atol=1e-9)


def test_resume_accepts_full_workspace_checkpoint(tmp_path):
    # Older checkpoints stored ALL max_dim+b workspace rows, not just the
    # head rows; resume must slice rather than assert.
    import dataclasses

    from arnoldi_jax.utils.checkpoint import RestartCheckpoint, save_checkpoint

    A = mark(15)
    n = A.shape[0]
    max_dim = 12
    kwargs = dict(
        max_dim=max_dim, stopping_criterion=1e-10,
        sort_function=arg_largest_real, key=jax.random.key(5),
    )
    ckpt = str(tmp_path / "oldfmt.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=2, checkpoint_path=ckpt, **kwargs)
    ck = load_checkpoint(ckpt)
    head = np.asarray(ck.V)
    V_full = np.zeros((max_dim + 1, n), dtype=head.dtype)
    V_full[: head.shape[0]] = head
    save_checkpoint(ckpt, dataclasses.replace(ck, V=V_full))

    Q, T, h = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, **kwargs)
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-8)


def test_resume_hard_lock_checkpoint_under_soft_unfreezes(tmp_path):
    # A frozen prefix is a hard-lock concept: resuming under the default
    # soft policy must reset k_lock so converged pairs rejoin the global
    # sort (freezing can lock a wrong tied subset).
    A = mark(15)
    kwargs = dict(
        max_dim=12, stopping_criterion=1e-10,
        sort_function=arg_largest_real, key=jax.random.key(5),
    )
    ckpt = str(tmp_path / "hard.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=4, checkpoint_path=ckpt,
                      lock="hard", **kwargs)
    Q, T, h = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, lock="soft", **kwargs)
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-8)
    Q2, T2, _ = partial_schur(A, 3, max_restarts=5000, **kwargs)
    v1 = np.sort_complex(np.linalg.eigvals(np.asarray(T2)))
    v2 = np.sort_complex(np.linalg.eigvals(Th))
    np.testing.assert_allclose(v1, v2, rtol=1e-7, atol=1e-9)


def test_resume_without_file_starts_fresh(tmp_path):
    A = mark(10)
    Q, T, _ = partial_schur(
        A, 2, stopping_criterion=1e-8, max_restarts=2000,
        sort_function=arg_largest_real,
        checkpoint_path=str(tmp_path / "none.npz"), resume=True,
        key=jax.random.key(0),
    )
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-8)


def test_sharded_checkpoint_resume_under_mesh(tmp_path):
    """Mesh checkpointing writes per-process shard files of the HEAD rows
    only (never a gathered full workspace) and resumes bit-compatibly."""
    import os

    from arnoldi_jax.parallel.mesh import make_mesh
    from arnoldi_jax.utils.checkpoint import (checkpoint_is_sharded,
                                              load_checkpoint)

    A = mark(15)  # n = 120
    mesh = make_mesh()
    assert mesh.devices.size == 8
    kwargs = dict(
        max_dim=12, stopping_criterion=1e-10,
        sort_function=arg_largest_real, key=jax.random.key(5), mesh=mesh,
        dtype=np.float64, refine=None,
    )
    ckpt = str(tmp_path / "mesh_ks.npz")

    Q_ref, T_ref, h_ref = partial_schur(A, 3, max_restarts=5000, **kwargs)
    total_restarts = int(h_ref.restarts.max())
    assert total_restarts > 3

    budget = max(2, total_restarts // 2)
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=budget, checkpoint_path=ckpt,
                      **kwargs)

    # On-disk contract: sharded meta + one shard file per process, holding
    # only the head rows (pa+1, n_local) — not the (max_dim+1, n) workspace.
    assert checkpoint_is_sharded(ckpt)
    assert os.path.exists(ckpt + ".p0")
    ck = load_checkpoint(ckpt)
    assert ck.V is None  # basis is NOT in the meta file
    with np.load(ckpt + ".p0") as z:
        keys = [k for k in z.files if k.startswith("c")]  # "gen" stamp aside
        shard_rows = {z[k].shape[0] for k in keys}
        shard_cols = sum(z[k].shape[1] for k in keys)
    assert shard_rows == {ck.pa + 1}
    assert shard_cols >= A.shape[0]  # all 8 shards live in this process

    Q, T, h = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, **kwargs)
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-8)
    v1 = np.sort_complex(np.linalg.eigvals(np.asarray(T_ref)))
    v2 = np.sort_complex(np.linalg.eigvals(Th))
    np.testing.assert_allclose(v1, v2, rtol=1e-7, atol=1e-9)
    assert int(h.restarts.max()) >= budget


@pytest.mark.parametrize("n_save,n_resume", [(8, 4), (4, 8), (8, 2)])
def test_sharded_checkpoint_reshards_across_mesh_shapes(tmp_path, n_save,
                                                        n_resume):
    """Mesh-ELASTIC resume: an N-way checkpoint loads into an M-way mesh
    (lose a host and resume on the survivors, or resume wider), including
    when the two meshes pad the row dimension differently."""
    from arnoldi_jax.parallel.mesh import make_mesh

    A = mark(15)  # n = 120
    kwargs = dict(
        max_dim=12, stopping_criterion=1e-10,
        sort_function=arg_largest_real, key=jax.random.key(5),
        dtype=np.float64, refine=None,
    )
    ckpt = str(tmp_path / "elastic_ks.npz")

    mesh_a = make_mesh(n_save)
    Q_ref, T_ref, h_ref = partial_schur(A, 3, max_restarts=5000,
                                        mesh=mesh_a, **kwargs)
    budget = max(2, int(h_ref.restarts.max()) // 2)
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=budget, checkpoint_path=ckpt,
                      mesh=mesh_a, **kwargs)

    mesh_b = make_mesh(n_resume)
    Q, T, h = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, mesh=mesh_b, **kwargs)
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-8)
    v1 = np.sort_complex(np.linalg.eigvals(np.asarray(T_ref)))
    v2 = np.sort_complex(np.linalg.eigvals(Th))
    np.testing.assert_allclose(v1, v2, rtol=1e-7, atol=1e-9)
    assert int(h.restarts.max()) >= budget


def test_sharded_checkpoint_rejects_stale_generation_shards(tmp_path):
    """Stale ``.p{k}`` files left by an earlier save under MORE processes
    must not be mixed into the assembled basis (their column offsets look
    valid but the data belongs to another restart).  Saves stamp a
    generation token into every file; the loader rejects mismatches and
    each save deletes surplus shard files beyond the process count."""
    import os

    from arnoldi_jax.parallel.mesh import make_mesh
    from arnoldi_jax.utils.checkpoint import (RestartCheckpoint,
                                              load_checkpoint_sharded,
                                              save_checkpoint_sharded)

    mesh = make_mesh(4)
    n = 64
    head = 5
    V = jax.device_put(
        np.arange(head * n, dtype=np.float64).reshape(head, n),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, mesh.axis_names[0])))
    ck = RestartCheckpoint(
        V=V, H_hp=np.eye(head, head - 1), pa=head - 1, restart=7,
        total_matvecs=70, matvecs=np.zeros(3, np.int64),
        restarts=np.zeros(3, np.int64), residual_trace=[1.0])
    path = str(tmp_path / "gen_ks.npz")
    save_checkpoint_sharded(path, ck)

    # Plant a stale shard from a fictitious wider save: an offset past the
    # current save's pieces, wrong generation, garbage data.  Without the
    # generation gate the loader would prefer this piece for columns >= 48.
    np.savez(path + ".p1", gen=np.asarray("deadbeefdeadbeef"),
             c48=np.full((head, 16), -999.0))
    out = load_checkpoint_sharded(path, mesh)
    np.testing.assert_array_equal(np.asarray(out.V), np.asarray(V))

    # A save under this (single-process) runtime deletes surplus .p{k>=1}
    # files left on disk.
    save_checkpoint_sharded(path, ck)
    assert not os.path.exists(path + ".p1")

    # If every shard file is from another generation, fail loudly.
    os.rename(path + ".p0", path + ".stash")
    np.savez(path + ".p0", gen=np.asarray("deadbeefdeadbeef"),
             c0=np.full((head, n), -999.0))
    with pytest.raises(FileNotFoundError, match="stale-generation"):
        load_checkpoint_sharded(path, mesh)
