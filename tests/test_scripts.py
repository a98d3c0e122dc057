"""Script-level utilities: correlation estimators, PSF generator, writejob."""

import sys

import numpy as np

sys.path.insert(0, "scripts")


def test_gg_correlation_constant_field():
    from correlation import gg_correlation, ng_correlation, nk_correlation

    rng = np.random.default_rng(0)
    n = 300
    ra = rng.uniform(0, 0.05, n)
    dec = rng.uniform(0, 0.05, n)
    e1 = np.full(n, 0.03)
    e2 = np.full(n, -0.01)
    xip, xim, cnt = gg_correlation(ra, dec, e1, e2, 1e-4, 0.05, 8)
    good = cnt > 50
    np.testing.assert_allclose(xip[good], 0.03 ** 2 + 0.01 ** 2, rtol=1e-10)
    assert np.abs(xim[good]).max() < 2e-4
    gt, _ = ng_correlation(ra, dec, e1, e2, 1e-4, 0.05, 8)
    assert np.all(np.abs(gt[good]) <= np.hypot(0.03, 0.01) + 1e-12)
    kk, _ = nk_correlation(ra, dec, np.full(n, 0.7), 1e-4, 0.05, 8)
    np.testing.assert_allclose(kk[good], 0.7, rtol=1e-10)


def test_genpsf_writes_ingestible_cubes(tmp_path):
    import genpsf

    rc = genpsf.main([str(tmp_path), "5", "--npix", "12", "--oversamp", "4",
                      "--grad", "0.1"])
    assert rc == 0
    from pyimcom_tpu.fitsio import fits_read
    from pyimcom_tpu.ops.psfmodels import eval_psf_cube

    f = fits_read(str(tmp_path / "psf_polyfit_5.fits"))
    assert len(f) == 19 and f[0].header["NCOEF"] == 4
    cube = np.asarray(f[3].data, np.float64)
    assert cube.shape[0] == 4
    psf = eval_psf_cube(cube, 100.0, 200.0, nside=4088)
    assert np.all(np.isfinite(psf)) and psf.sum() > 0


def test_writejob_emits_runnable_stage_commands(tmp_path):
    import json

    import writejob

    cfg = {"BLOCK": 2, "OUT": str(tmp_path / "o")}
    cfgfile = str(tmp_path / "c.json")
    with open(cfgfile, "w") as fh:
        json.dump(cfg, fh)
    paths = writejob.write_jobs(cfgfile, str(tmp_path / "jobs"))
    text = "".join(open(p).read() for p in paths if p.endswith(".sh"))
    # the splitpsf/imsubtract stages point at real CLIs now
    assert "python -m pyimcom_tpu.splitpsf.splitpsf" in text
    assert "python -m pyimcom_tpu.splitpsf.imsubtract" in text
    assert "print('configure" not in text
    assert "--array=1-18" in text


def test_production_artifact_writers(tmp_path, monkeypatch):
    """write_partial / write_complete parse the child log + checkpoint.

    Guards the production artifact: the warm rate must come from the
    FINAL resumed segment only (child clocks reset at each resume), and a
    completed run must report the child's own CHILD_DONE wall, not the
    parent's (which includes start-up and waits).
    """
    import json

    import run_production_block as rpb

    log = tmp_path / "production_block.log"
    art = tmp_path / "PRODUCTION_test.json"
    monkeypatch.setattr(rpb, "LOG", log)
    monkeypatch.setattr(rpb, "ARTIFACT", art)

    # two segments: a stale fast pre-restart segment, then the real one
    log.write_text(
        "postage stamp  1, 1  t=      1.00 s\n"
        "postage stamp  2, 1  t=      1.50 s\n"   # stale 0.5 s/group gap
        "postage stamp  1, 1  t=     10.00 s\n"   # clock reset = restart
        "postage stamp  2, 1  t=     14.00 s\n"
        "postage stamp  3, 1  t=     18.00 s\n"
        "postage stamp  4, 1  t=     22.00 s\n")  # 4 s/group warm
    ckpt = tmp_path / "ckpt.npz"
    np.savez(ckpt, groups_done=100, n_groups=1600, nrun=6400)

    rpb.write_partial(ckpt, n_restarts=1)
    got = json.loads(art.read_text())
    assert got["partial"] is True
    assert got["groups_done"] == 100 and got["n_groups"] == 1600
    assert got["warm_s_per_stamp"] == 1.0          # 4 s/group / 4 stamps
    assert got["extrapolated_block_hours"] == round(4.0 * 1600 / 3600, 2)
    assert got["restarts"] == 1

    log.write_text(log.read_text() + "CHILD_DONE wall=6400.0\n")
    rpb.write_complete(tmp_path / "out.fits", ckpt, n_restarts=1)
    got = json.loads(art.read_text())
    assert got["metric"] == "production_block_wall_hours"
    assert got["s_per_stamp"] == 1.0               # 6400 s / 6400 stamps
    assert got["blocks_per_hour_per_chip"] == round(3600 / 6400.0, 4)


def test_production_artifact_quality_medians(tmp_path, monkeypatch):
    """Quality medians ride the artifact: UC = median(sqUC)^2 etc."""
    import json

    import run_production_block as rpb

    log = tmp_path / "production_block.log"
    art = tmp_path / "PRODUCTION_test.json"
    monkeypatch.setattr(rpb, "LOG", log)
    monkeypatch.setattr(rpb, "ARTIFACT", art)
    log.write_text(
        "  sqUC,sqSig medians | 4.00E-04 5.00E-01\n"
        "  sqUC,sqSig medians | 6.00E-04 5.00E-01\n"
        "  sqUC,sqSig medians | 5.00E-04 5.00E-01\n"
        "CHILD_DONE wall=6400.0\n")
    rpb.write_complete(tmp_path / "out.fits",
                       tmp_path / "missing.npz", n_restarts=0)
    got = json.loads(art.read_text())
    assert got["UC_median"] == 2.5e-7          # (5e-4)^2
    assert got["Sigma_median"] == 0.25         # (5e-1)^2


def test_production_finalize_survives_truncated_log(tmp_path, monkeypatch):
    """A finalize-only pass over a lost/truncated log must still write an
    artifact instead of crashing (regression: ZeroDivisionError when the
    log carried no ``backend:`` markers and no timestamps at all)."""
    import json

    import run_production_block as rpb

    log = tmp_path / "production_block.log"
    art = tmp_path / "PRODUCTION_test.json"
    monkeypatch.setattr(rpb, "LOG", log)
    monkeypatch.setattr(rpb, "ARTIFACT", art)

    # worst case: an empty log (watchdog died before the child printed)
    log.write_text("")
    rpb.write_complete(tmp_path / "out.fits",
                       tmp_path / "missing.npz", n_restarts=0)
    got = json.loads(art.read_text())
    assert got["metric"] == "production_block_wall_hours"
    assert got["blocks_per_hour_per_chip"] is None      # honest: wall unknown
    assert got["value"] == 0.0

    # truncated mid-run: no backend marker, but stamp clocks survive;
    # prior_wall from earlier invocations must be added in
    log.write_text("postage stamp  1, 1  t=     10.00 s\n"
                   "postage stamp  2, 1  t=     50.00 s\n")
    rpb.write_complete(tmp_path / "out.fits", tmp_path / "missing.npz",
                       n_restarts=1, prior_wall=3150.0)
    got = json.loads(art.read_text())
    assert got["value"] == round(3200.0 / 3600.0, 3)
    assert got["s_per_stamp"] == 0.5                    # 3200 s / 6400
    assert got["blocks_per_hour_per_chip"] == round(3600.0 / 3200.0, 4)


def test_bench_refuses_to_fall_back_to_cpu(monkeypatch, capsys):
    """Without --cpu-only, bench.py fails on a machine with no GPU instead
    of measuring the CPU under an accelerator's name."""
    import importlib.util
    import pathlib

    import pytest

    path = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()
    assert "blocks/hour" not in capsys.readouterr().out
