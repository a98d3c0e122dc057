"""End-to-end parity of the fused dense (accelerator) assembly path.

The accelerator pipeline assembles A / -B/2 via ONE fused gather-free interpolation
sweep per output stamp (Block._precompute_stamp_mats); on CPU the default is
per-submatrix gather interpolation.  Forcing the dense path on CPU must
reproduce the gather-path coadd to interpolation roundoff.
"""

import numpy as np
import pytest

from survey_fixture import build_survey

import pyimcom_tpu.psfgrp as psfgrp
from pyimcom_tpu.coadd import Block
from pyimcom_tpu.config import Config
from pyimcom_tpu.fitsio import fits_read

pytestmark = pytest.mark.slow  # full block coadds (minutes on 1-core host)


def test_dense_fused_matches_gather(tmp_path, monkeypatch):
    base = build_survey(tmp_path, n_obs=8, extrainput=["cstar14"],
                        config_overrides={"STOP": 1})

    cfg_g = dict(base)
    cfg_g["OUT"] = base["OUT"] + "_gather"
    Block(cfg=Config(cfg_g), this_sub=1)

    monkeypatch.setattr(psfgrp, "_use_dense", lambda: True)
    cfg_d = dict(base)
    cfg_d["OUT"] = base["OUT"] + "_dense"
    Block(cfg=Config(cfg_d), this_sub=1)

    img_g = np.asarray(
        fits_read(str(tmp_path) + "/out/testout_F_gather_00_01.fits")[0].data,
        dtype=np.float64)
    img_d = np.asarray(
        fits_read(str(tmp_path) + "/out/testout_F_dense_00_01.fits")[0].data,
        dtype=np.float64)
    # same inputs, same solver; only the interpolation engine differs
    assert np.max(np.abs(img_d - img_g)) < 1e-8
