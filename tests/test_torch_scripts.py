"""The port's scripts (``ground_fusion_tpu_torch/scripts``) against the JAX
package's (``scripts/``), on the CPU at small size:

- ``make_synth_seq``: the same dataset directory (images and depth bit for
  bit, the CSVs' numbers within 1e-12) as ``scripts/make_synth_seq.py``;
- ``convert_bag``: the same output files, byte for byte, as
  ``scripts/convert_bag.py`` on every bag that ``tests/test_convert_bag.py``
  authors (plain and bz2 chunks, images and depth, NavSatFix, GPS and
  GLONASS ephemerides with measurement epochs), while that file's own
  checks run on the JAX converter's output;
- ``bow_sweep``: the same table as ``scripts/bow_sweep.py`` (24 scenes of
  each texture, rng 7);
- ``profile_step``, ``parity`` and ``long_horizon``: run on the CPU at tiny
  depth (a device ms there is "not measured")."""

import contextlib
import dataclasses
import importlib.util
import io
import os

import jax
import numpy as np
import pytest
import torch

from ground_fusion_tpu_torch.config import Config
from ground_fusion_tpu_torch.scripts import bow_sweep, convert_bag, long_horizon
from ground_fusion_tpu_torch.scripts import make_synth_seq, parity, profile_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for this file's window steps; the worker's count
    before them is restored after them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_script(name):
    """A module of the repo's ``scripts/`` directory, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_make_synth_seq_writes_the_jax_scripts_sequence(tmp_path):
    """Four frames through both scripts (the JAX script's sample functions
    jitted): the same files, the images and depth maps equal, the CSVs'
    numbers within 1e-12."""
    js = _jax_script("make_synth_seq")
    for n in ("imu_sample", "wheel_sample", "gt_pose7"):
        setattr(js, n, jax.jit(getattr(js, n), static_argnums=1))
    with contextlib.redirect_stdout(io.StringIO()):
        js.main(str(tmp_path / "jax"), 4)
        make_synth_seq.main(str(tmp_path / "port"), 4)
    a, b = tmp_path / "jax", tmp_path / "port"
    assert _files(a) == _files(b) and len(_files(a)) == 12
    for f in _files(a):
        if f.endswith(".npy"):
            x, y = np.load(a / f), np.load(b / f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        elif f == "frames.csv":
            assert (a / f).read_text() == (b / f).read_text()
        else:
            kw = dict(delimiter=",") if f != "gt.csv" else {}
            x, y = np.loadtxt(a / f, **kw), np.loadtxt(b / f, **kw)
            assert x.shape == y.shape, f
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-12, err_msg=f)


def test_convert_bag_writes_the_jax_converters_files(tmp_path, monkeypatch):
    """Each bag of ``tests/test_convert_bag.py``'s converter tests, converted
    by both converters: the same file names and bytes."""
    import test_convert_bag as oracle

    jax_convert = oracle.convert_bag.convert
    seen = []

    def both(bag, out_dir, *args, **kwargs):
        counts = jax_convert(bag, out_dir, *args, **kwargs)
        port_dir = out_dir.rstrip("/") + "_port"
        assert convert_bag.convert(bag, port_dir, *args, **kwargs) == counts
        assert _files(out_dir) == _files(port_dir)
        for f in _files(out_dir):
            with open(os.path.join(out_dir, f), "rb") as x, open(os.path.join(port_dir, f), "rb") as y:
                assert x.read() == y.read(), f
        seen.append(_files(out_dir))
        return counts

    monkeypatch.setattr(oracle.convert_bag, "convert", both)
    for k, test in enumerate((oracle.test_convert_bag_roundtrip, oracle.test_convert_bag_bz2_chunk,
                              oracle.test_convert_bag_gnss_satellite_states,
                              oracle.test_convert_bag_glo_ephemeris)):
        (tmp_path / str(k)).mkdir()
        test(tmp_path / str(k))
    assert len(seen) == 4
    assert "gnss.csv" in seen[2] and "frames.csv" in seen[0] and "gps.csv" in seen[0]


def test_bow_sweep_table_matches_the_jax_script(capsys):
    """The whole table (three textures, six gates, the medians) as
    ``scripts/bow_sweep.py`` prints it, and the same verdict on the 0.30
    gate (both say REVIEW: medium scenes pass 1.45 % impostors there)."""
    js = _jax_script("bow_sweep")
    rc_jax = js.main()
    jax_out = capsys.readouterr().out
    lines, summary = bow_sweep.table(bow_sweep.scores(CPU))
    assert "\n".join(lines) in jax_out
    assert bow_sweep.gate_ok(summary) == (rc_jax == 0)
    assert len(lines) == 2 + 3 * 7


def _tiny(cfg):
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, window_size=4, max_landmarks=16, max_iters=2))


def test_profile_step_prints_every_stage_on_the_cpu():
    """Every stage on a seeded window (window 4, 16 landmarks, 2
    iterations): host ms, "not measured" device ms, operations; the stages
    that the step runs one after another dispatch fewer operations than the
    step."""
    printed = []
    rows = profile_step.profile(_tiny(Config()), CPU, torch.float64, reps=1, out=printed.append)
    names = [r["stage"] for r in rows]
    assert names == ["preint imu", "preint wheel", "triangulate", "solve", "1 iteration",
                     "assemble_rows", "assemble_residuals", "JtJ", "cholesky solve",
                     "marginalize_old", "marginalize_second_new", "step"]
    assert all(r["device_ms"] is None and r["host_ms"] > 0 and r["ops"] > 0 for r in rows)
    assert all("device not measured" in line for line in printed)
    ops = {r["stage"]: r["ops"] for r in rows}
    assert sum(ops[n] for n in profile_step.TOP_LEVEL) < ops["step"]
    assert ops["1 iteration"] < ops["solve"]


def test_parity_drives_run_on_the_cpu():
    """The suite's drives on the port at window 4: the exact VIO-wheel
    replay in bursts of 4 stays within the suite's 0.05 m, the GNSS replay
    aligns and stays within 0.1 m and 1 m in ECEF; the card-against-CPU
    check and the Markdown record are built from the two result sets."""
    cfg = _tiny(Config())
    est, gt = parity.run_pipeline(n_frames=12, cfg=cfg, burst=4, device=CPU)
    assert len(est.trajectory) >= 4 and est.reboots == 0
    est = parity.run_gnss_pipeline(n_frames=12, epoch_every=3, device=CPU,
                                   cfg=dataclasses.replace(cfg, gnss=dataclasses.replace(
                                       cfg.gnss, enabled=True, track_num_thresh=1)))
    assert est.gnss_aligned and est.last_ate < 0.1 and est.last_ecef_err < 1.0
    res = {"vio_wheel_exact": {"ate_m": 0.001}, "vio_wheel_noisy": {"ate_m": 0.2},
           "gnss_tight": {"ate_m": 0.01, "aligned": True, "ecef_err_m": 0.5}}
    checks = parity.checks(res, res)
    assert [c["pass"] for c in checks.values()] == [True, False, True]


def test_long_horizon_runs_on_the_cpu():
    """A 14-frame float64 replay on the CPU at the study's defaults
    (window 10, bursts of 16) with the prior sampled every 7 frames: solved
    frames, a finite ATE, no reboot, cond(J0ᵀJ0) 0 before the first prior
    and above 1 after it."""
    out = long_horizon.run(torch.float64, 14, device=CPU, sample_every=7)
    assert out["solved_keyframes"] >= 3 and out["reboots"] == 0
    assert np.isfinite(out["ate_m"]) and out["ate_m"] < 0.05
    assert [c["frame"] for c in out["cond_samples"]] == [7, 14]
    assert out["cond_samples"][0]["cond"] == 0.0 and out["cond_samples"][1]["cond"] > 1.0
