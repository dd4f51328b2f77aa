"""The port's native ingest runtime (``ground_fusion_tpu_torch/native``)
against the JAX package's binding (``ground_fusion_tpu/native``), which
loads the library committed beside it; the port's builds its own copy of
the C++ source with ``g++`` at first use. The TSAN stress driver runs on
the port's copy as ``tests/test_native_tsan.py`` runs it on the JAX
package's, and skips as that test skips."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from ground_fusion_tpu import native as jnative
from ground_fusion_tpu_torch import native as tnative


def _pushes(rng, n, rate, jitter):
    ts = np.cumsum(np.full(n, 1.0 / rate) + rng.uniform(-jitter, jitter, n))
    return ts, rng.normal(size=(n, 3)), rng.normal(size=(n, 3))


def test_drains_and_sync_pairs_match_the_jax_binding():
    """Seeded IMU (200 Hz) and wheel (100 Hz) pushes, out of order in
    places, into both runtimes; every padded drain over frame intervals at
    10 Hz (including an empty interval and one that overflows ``cap``) and
    ``sync_pairs`` of jittered camera and depth stamps are equal, bit for
    bit."""
    rng = np.random.default_rng(0)
    imu = _pushes(rng, 400, 200.0, 1e-4)
    wheel = _pushes(rng, 200, 100.0, 1e-4)
    order = np.arange(400)
    order[100:110] = order[100:110][::-1]
    a, b = jnative.NativeIngest(), tnative.NativeIngest()
    for k in order:
        for ing in (a, b):
            ing.push_imu(imu[0][k], imu[1][k], imu[2][k])
    for k in range(200):
        for ing in (a, b):
            ing.push_wheel(wheel[0][k], wheel[1][k], wheel[2][k])
    cuts = [0.0, 0.1, 0.1, 0.2, 0.35, 0.5, 0.9, 1.2, 1.9, 2.5]
    for t0, t1 in zip(cuts[:-1], cuts[1:]):
        for drain, cap in (("drain_imu", 48), ("drain_imu", 16), ("drain_wheel", 24)):
            got = getattr(b, drain)(t0, t1, cap)
            want = getattr(a, drain)(t0, t1, cap)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and np.array_equal(x, y), (drain, t0, t1)
    assert int(b.drain_imu(0.1, 0.2, 48)[3].sum()) == 20
    assert not b.drain_imu(0.1, 0.1, 48)[3].any()

    cam = np.arange(60) / 30.0 + rng.uniform(-0.002, 0.002, 60)
    depth = np.delete(np.arange(60) / 30.0 + rng.uniform(-0.005, 0.005, 60), [7, 8, 30])
    for tol in (0.003, 0.001):
        gi, gj = tnative.sync_pairs(cam, depth, tol=tol)
        wi, wj = jnative.sync_pairs(cam, depth, tol=tol)
        assert np.array_equal(gi, wi) and np.array_equal(gj, wj)
        assert len(gi) > 0 and np.all(np.abs(cam[gi] - depth[gj]) <= tol)


def test_build_raises_without_gxx_or_on_a_failing_compile(monkeypatch, tmp_path):
    """No fallback: with no ``g++`` on the path, or a source that does not
    compile, building the library raises, and ``NativeIngest`` with it."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_LIB", None)
    real_which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None if name == "g++"
                        else real_which(name, *a, **k))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tnative.NativeIngest()
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tnative.sync_pairs([0.0], [0.0])
    monkeypatch.setattr(shutil, "which", real_which)
    if real_which("g++") is None:
        return
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.lib()
    assert not os.listdir(tmp_path / "build")


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_ingest_tsan_clean_on_the_ports_copy(tmp_path):
    """The port's ``ingest.cpp`` and ``stress_ingest.cpp`` under
    ThreadSanitizer: two producers, a drainer and a syncer, no race."""
    exe = str(tmp_path / "stress_tsan")
    build = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=thread",
         os.path.join(tnative.SRC_DIR, "ingest.cpp"),
         os.path.join(tnative.SRC_DIR, "stress_ingest.cpp"), "-o", exe, "-pthread"],
        capture_output=True, text=True, timeout=120,
    )
    if build.returncode != 0 and "tsan" in (build.stderr or "").lower():
        pytest.skip(f"toolchain lacks TSAN runtime: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr
    run = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    assert "WARNING: ThreadSanitizer" not in run.stderr, run.stderr[:2000]
    assert run.returncode == 0, (run.returncode, run.stderr[:2000])
    assert "stress OK" in run.stdout
