"""chip_smoke.py's phases at tiny sizes on the CPU: every check runs for
real; only the GPU guard in ``main()`` is left out (and tested on its own).
"""

import json

import jax
import numpy as np
import pytest

import bench
import chip_smoke


def test_main_exits_nonzero_without_gpu(capsys):
    assert jax.devices()[0].platform != "gpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_ks_scattered_phase():
    from arnoldi_jax.matrices import random_scattered

    n = 1 << 12
    A = random_scattered(n, 24, seed=1, bandwidth=n // 64, block=8)
    out = chip_smoke.ks_phase(A, 5, compare_formats=True)
    assert set(out["routes"]) == {"f64", "f32_dw"}
    assert out["routes"]["f64"]["ran_on"] == ["cpu"]
    assert set(out["matvec_ms"]) == {"ell_float64", "ell_float32",
                                     "bsr_float64", "bsr_float32"}
    for r in out["routes"].values():
        assert r["schur_residual"] < 1e-8 and r["eig_match_relerr"] < 1e-6


def test_ks_complexpairs_phase():
    out = chip_smoke.phase_ks_complexpairs(n=1 << 12)
    for r in out["routes"].values():
        assert r["min_abs_imag"] > 1e-3


def test_lanczos_phase():
    out = chip_smoke.phase_lanczos(g=64)
    assert out["scalar"]["eig_relerr"] < 1e-8
    assert out["block4"]["eig_relerr"] < 1e-8


def test_hot_loop_phase(monkeypatch):
    kind = jax.devices()[0].device_kind
    monkeypatch.setitem(bench.HBM_PEAK, kind, 1e11)
    out = chip_smoke.phase_hot_loop(n_grid=24, max_dim=16)
    for b in ("b1", "b8"):
        assert out[b]["ms_per_matvec"] > 0 and out[b]["roofline_share"] > 0


def test_quickstart_phase():
    out = chip_smoke.phase_quickstart(subs=(
        ("laplace_2d(512)", "laplace_2d(24)"),
        ("laplace_2d(64)", "laplace_2d(24)")))
    # 64-bit types off: the real float32 path + double-word continuation.
    assert out["schur_dtype"] == "float64"
    assert out["schur_residual"] < 1e-7


def test_surface_phase():
    out = chip_smoke.phase_surface(n_complex=1 << 10, g_si=16,
                                   n_svd=1 << 12, g_win=16,
                                   window=(-11.12, -11.02), m_defl=20)
    assert out["dense_tier"] in ("native", "scipy")
    assert out["eigsh_window"]["count"] > 0


def test_multi_phase():
    out = chip_smoke.phase_multi(n_devices=4, nx=64)
    assert out["n"] == 64 * 64


def test_report_line(capsys):
    line = chip_smoke.Report("card, 1 W").emit("x", value=np.float64(1.5))
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(line, default=float))
    assert printed["platform"] == jax.devices()[0].platform
    assert printed["device_count"] == len(jax.devices())


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_ks_phase_on_gpu(gpu):
    """The Krylov-Schur phase at a small size on the card: both precision
    routes on the device, against ARPACK."""
    from arnoldi_jax.matrices import random_scattered

    n = 1 << 16
    A = random_scattered(n, 24, seed=1, bandwidth=n // 64, block=8)
    out = chip_smoke.ks_phase(A, 5)
    assert out["routes"]["f64"]["ran_on"] == ["gpu"]
