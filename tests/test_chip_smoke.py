"""chip_smoke.py's phases at tiny sizes on the CPU, called directly.

The script itself refuses to run off a GPU; its phase functions do not,
so their checks and oracles are exercised here (the Triton kernel in
interpret mode, the distributed phase on 4 of the 8 virtual devices).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402


def _assert_all_pass(ch):
    assert ch.failed == [], ch.failed
    assert ch.passed > 0


def test_phase_main_tiny():
    ch = cs.Checks("cpu")
    cs.phase_main(ch, n=1 << 12)
    _assert_all_pass(ch)


def test_phase_scan_kernel_tiny(capsys):
    ch = cs.Checks("cpu")
    medians = cs.phase_scan_kernel(ch, sizes=(1 << 12, 1000), reps=2,
                                   interpret=True)
    _assert_all_pass(ch)
    assert set(medians) == {1 << 12, 1000}
    assert "VERDICT scan n=1000" in capsys.readouterr().out


def test_phase_surface_tiny():
    ch = cs.Checks("cpu")
    cs.phase_surface(ch, n=1 << 12, rows_shape=(8, 512))
    _assert_all_pass(ch)


def test_phase_dist_tiny(multi_device):
    ch = cs.Checks("cpu")
    cs.phase_dist(ch, n_per_card=1 << 10, cards=min(4, len(multi_device)))
    _assert_all_pass(ch)


def test_check_records_exceptions_as_failures(capsys):
    ch = cs.Checks("cpu")
    assert not ch.check("boom", lambda: 1 / 0)
    assert ch.check("fine", lambda: (True, "detail"))
    out = capsys.readouterr().out
    assert "FAIL boom" in out and "ZeroDivisionError" in out
    assert "PASS fine  [detail]" in out
    assert ch.failed == ["boom"] and ch.passed == 1


@pytest.mark.parametrize("case", ["ok", "not_perm", "unstable",
                                  "unsorted"])
def test_stable_certificate(case):
    keys = np.array([3, 1, 3, 2, 1], np.uint32)
    perm = np.argsort(keys, kind="stable")
    out = keys[perm]
    if case == "not_perm":
        perm = perm.copy()
        perm[0] = perm[1]
    elif case == "unstable":
        perm = np.array([4, 1, 3, 2, 0])
    elif case == "unsorted":
        perm = np.arange(5)
        out = keys
    assert cs._stable_certificate(keys, out, perm) == (case == "ok")


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64,
                                   np.int64, np.uint16])
def test_radix_image_orders_like_sortx(dtype):
    import jax
    import jax.numpy as jnp

    import sortx

    rng = np.random.default_rng(0)
    a = (rng.standard_normal(2000) * 1000).astype(dtype)
    if np.dtype(dtype).kind == "f":
        a[:4] = [np.nan, -np.nan, -0.0, 0.0]
    with jax.enable_x64(True):
        got = np.asarray(sortx.sort(jnp.asarray(a)))
    exp = a[np.argsort(cs._radix_np(a), kind="stable")]
    assert got.tobytes() == exp.tobytes()


def test_script_refuses_a_non_gpu_platform():
    """Run as a script off the GPU it exits nonzero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(_REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=_REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "FAIL preflight" in r.stdout
    assert '"ok"' not in r.stdout
