"""chip_smoke.py: device check, precision audit, and its kernel comparisons
at small widths on the CPU (the card runs them at production widths)."""

import importlib.util
import pathlib

import numpy as np
import pytest

_PATH = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_main_refuses_cpu_before_any_result(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("name", chip_smoke.AUDITED)
def test_device_path_f32_products_pin_highest(name):
    assert chip_smoke.unpinned_f32_dots(name) == 0


def test_audit_catches_a_default_precision_product(monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setattr(chip_smoke, "_audit_case", lambda name: (
        lambda a, b: jnp.dot(a, b), (np.ones((4, 4), np.float32),) * 2))
    assert chip_smoke.unpinned_f32_dots("any") == 1


def test_checks_collect_and_raise(capsys):
    ck = chip_smoke.Checks("unit")
    ck("small", 1e-9, 1e-8, "passes")
    ck("large", 1e-7, 1e-8, "fails")
    ck("nan", float("nan"), 1.0, "non-finite never passes")
    with pytest.raises(AssertionError, match="large"):
        ck.done()
    assert ck.failed == ["large", "nan"]
    assert "FAILED" in capsys.readouterr().out


def _cpu_checks():
    import jax

    cpu = jax.devices("cpu")[0]
    return chip_smoke.Checks("kernels"), cpu


def test_kernel_checks_small_spectra_and_sweep():
    ck, cpu = _cpu_checks()
    ovl, geom = chip_smoke.check_spectra(ck, cpu, "cpu", n_psf=3,
                                         npixpsf=6)
    assert ovl.shape == (9, geom.novl + 12, geom.novl + 12)
    chip_smoke.check_sweep(ck, cpu, cpu, "cpu", ovl, geom, bucket=256,
                           rbatch=4, table=512, span=8.0)
    ck.done()


def test_kernel_checks_small_assembly_and_solve():
    ck, cpu = _cpu_checks()
    chip_smoke.check_assembly(ck, cpu, "cpu", n=180, keys=3, nsub=40,
                              stamps=2)
    chip_smoke.check_solve(ck, cpu, cpu, "cpu", n=256, m=64)
    ck.done()


def test_centered_ctr_puts_star_on_target(tmp_path):
    import survey_fixture as sf

    from pyimcom_tpu.config import Config
    from pyimcom_tpu.wcsutil import make_block_wcs

    cfg = dict(sf.CONFIG_TEMPLATE, OUTSIZE=[80, 32, 0.0390625],
               OBSFILE=str(tmp_path / "obs.fits"))
    target = (31.7, 31.4)
    cfg["CTR"] = chip_smoke.centered_ctr(cfg, target)
    ibx, iby = divmod(chip_smoke.PROD_SUB, cfg["BLOCK"])
    xs, ys = make_block_wcs(Config(cfg), ibx, iby).world2pix(sf.SRA, sf.SDEC)
    assert abs(float(xs) - target[0]) < 1e-3
    assert abs(float(ys) - target[1]) < 1e-3


@pytest.fixture
def gpu():
    """The first GPU; skips where JAX sees none (decided here, at run time)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.mark.gpu
def test_kernels_at_production_widths_on_gpu(gpu):
    import jax

    ck = chip_smoke.Checks("kernels")
    label = chip_smoke.card_lines()[0]
    chip_smoke.audit_precision(ck)
    ovl, geom = chip_smoke.check_spectra(ck, gpu, label)
    chip_smoke.check_sweep(ck, gpu, jax.devices("cpu")[0], label, ovl, geom)
    ck.done()
