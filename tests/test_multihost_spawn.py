"""REAL multi-process execution of the sharded solver (SURVEY §2b/L5).

Spawns N local CPU processes that initialize ``jax.distributed`` against a
localhost coordinator (gloo collectives) and run a sharded ``partial_schur``
over the resulting multi-process mesh — the configuration a multi-host
deployment runs, minus the hardware.  This is the test the in-process virtual-device suite
cannot provide: it exercises process_index interleaving, mesh ordering
across processes, and cross-process collectives for real.

Reference analog: the mpirun-able SLEPc comparison
(``/root/reference/scripts/compare-against-slepc.py``).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(nproc, n_local_dev, timeout=540):
    # Generous timeout: under a parallel (-n 8) pytest run this test's
    # spawned JAX processes share the box with every other worker; the
    # 4-process leg measured ~60 s solo and ~5x that under full load.
    import tempfile

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["MULTIHOST_CKPT"] = os.path.join(
        tempfile.mkdtemp(prefix="mh_ckpt_"), "ks.npz")
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(nproc), str(port),
             str(n_local_dev)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"worker {pid} exited {p.returncode}:\n{out}")
        assert "MULTIHOST_OK" in out, f"worker {pid} output:\n{out}"
    return outs


@pytest.mark.parametrize("nproc,n_local_dev", [(2, 2), (4, 1)])
def test_multiprocess_sharded_solve(nproc, n_local_dev):
    outs = _spawn(nproc, n_local_dev)
    # Every process must report the same matvec count (the restart loop is
    # replicated host logic over replicated H — any divergence means the
    # processes disagreed on control flow).
    import json

    recs = [json.loads(o.split("MULTIHOST_OK ", 1)[1].splitlines()[0])
            for o in outs]
    assert len({r["matvecs"] for r in recs}) == 1, recs
    assert all(r["max_res"] < 5e-7 for r in recs)
