#!/usr/bin/env python
"""
Chained production pipeline on the accelerator: BASELINE config #5.

Runs the writejob stage chain (reference scripts/writejob_example.pl:66-120)
end to end ON CHIP over a small 2x2-block mosaic at PRODUCTION stamp
geometry (32x32-px output stamps at 0.0390625"/px, INPAD 1.055", NPIXPSF
48, PAD 1 so the padding-stamp halo exchange has real work):

    destripe -> input layers -> coadd (all 4 blocks) -> halo exchange ->
    compress -> validation report

and records per-stage wall seconds plus the science-star quality of the
coadd in <workdir>/pipeline.json.  The e2e CPU twin of this chain (plus the
splitpsf/imsubtract iteration stages) is tests/test_full_pipeline.py;
this script runs the *chained* flow on the accelerator at production
stamp shapes.

Usage: python scripts/run_chained_pipeline.py [--workdir DIR] [--n-obs 8]
"""

import argparse
import glob
import json
import os
import pathlib
import re
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=str(REPO / ".pipe_work"))
    ap.add_argument("--n-obs", type=int, default=8)
    ap.add_argument("--maxiter", type=int, default=5,
                    help="destripe CG iterations")
    ap.add_argument("--n1", type=int, default=8,
                    help="stamps per block side (production blocks use 80)")
    ap.add_argument("--npixpsf", type=int, default=48,
                    help="PSF postage size (production 48; shrink for a "
                         "CPU shakedown)")
    ap.add_argument("--inpad", type=float, default=1.055)
    ap.add_argument("--artifact", default=None,
                    help="where to write the JSON artifact (default "
                         "<workdir>/pipeline.json)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(REPO))       # `python scripts/...` puts scripts/
    sys.path.insert(0, str(REPO / "tests"))  # (not the repo root) on sys.path
    from pyimcom_tpu import jaxcache

    jaxcache.enable()
    from survey_fixture import SC, SDEC, SIG_OUT, SRA, build_survey

    from pyimcom_tpu.config import Config
    from pyimcom_tpu.fitsio import HDUList, Header, ImageHDU, fits_read, \
        fits_write

    work = pathlib.Path(args.workdir)
    work.mkdir(exist_ok=True)
    stages = {}
    backend = jax.default_backend()

    def stage(name):
        class _T:
            def __enter__(self):
                self.t0 = time.time()
                print(f"[pipeline] stage {name} ...", flush=True)

            def __exit__(self, *a):
                stages[name] = round(time.time() - self.t0, 2)
                print(f"[pipeline] stage {name}: {stages[name]} s",
                      flush=True)
        return _T()

    # ---- stage 0: survey build at production stamp geometry ---------------
    with stage("build_survey"):
        cfg_dict = build_survey(work, n_obs=args.n_obs,
                                extrainput=["cstar14", "whitenoise1"],
                                config_overrides={
                                    "OUTSIZE": [args.n1, 32, 0.0390625],
                                    "PAD": 1,
                                    "INPAD": args.inpad,
                                    "NPIXPSF": args.npixpsf,
                                    "STOP": 0})
        # inject detector row stripes so the destripe stage has real work
        rng = np.random.default_rng(99)
        raw = sorted(p for p in
                     glob.glob(str(work / "in" / "sim_L2_*.fits"))
                     if "_mask" not in p)
        for p in raw:
            f = fits_read(p)
            img = np.asarray(f[0].data, np.float64)
            stripes = rng.normal(scale=0.01, size=img.shape[0])
            fits_write(p, HDUList([ImageHDU(
                (img + stripes[:, None]).astype(np.float32),
                header=Header(f[0].header))]))

    # ---- stage 1: destripe (device-resident cost/gradient) ----------------
    with stage("destripe"):
        # PYIMCOM_DESTRIPE_DEVICE=0 selects the host cost/gradient
        os.environ.setdefault("PYIMCOM_DESTRIPE_DEVICE", "1")
        destripe_backend = (backend if os.environ["PYIMCOM_DESTRIPE_DEVICE"]
                            != "0" else "cpu")
        from pyimcom_tpu import imdestripe

        dsdir = str(work / "ds")
        d = dict(cfg_dict)
        d["DSOUT"] = [dsdir, "ds"]
        d["DSOBSFILE"] = str(work / "in" / "sim_L2_*[0-9].fits")
        cfgfile = str(work / "cfg_pipe.json")
        with open(cfgfile, "w") as f:
            json.dump(d, f)
        imdestripe.main(Config(cfgfile), maxiter=args.maxiter,
                        add_objmask=False, use_wcs_gain=False)
        # feed the destriped exposures back under the original L2 names
        pat = re.compile(r"(\w\d+)_(\d+)_(\d+)")
        for p in raw:
            name = pat.search(os.path.basename(p)).group(0)
            g = fits_read(os.path.join(dsdir, f"ds_{name}.fits"))
            fits_write(p, HDUList([ImageHDU(
                np.asarray(g[0].data, np.float32),
                header=Header(g[0].header))]))

    # ---- stage 2: input layers --------------------------------------------
    with stage("layers"):
        from pyimcom_tpu.layer_wrapper import build_all_layers

        with open(cfgfile, "w") as f:
            json.dump(d, f)
        build_all_layers(Config(cfgfile))

    # ---- stage 3: coadd all 2x2 blocks on the accelerator ------------------
    from pyimcom_tpu.coadd import Block

    nblock = int(d["BLOCK"])
    for sub in range(nblock * nblock):
        with stage(f"coadd_block_{sub}"):
            Block(cfg=Config(cfgfile), this_sub=sub)

    # ---- stage 4: padding-stamp halo exchange over the mosaic -------------
    with stage("halo_exchange"):
        from pyimcom_tpu.analysis import Mosaic

        mos = Mosaic(d["OUT"], nblock=nblock)
        mos.share_padding_stamps()

    # ---- stage 5: compress -------------------------------------------------
    with stage("compress"):
        from pyimcom_tpu.layer_wrapper import compress_all_blocks

        outs = compress_all_blocks(Config(cfgfile))
        assert outs, "compression produced no outputs"

    # ---- stage 6: validation report ----------------------------------------
    with stage("report"):
        from pyimcom_tpu.diagnostics.report import pull_from_file
        from pyimcom_tpu.diagnostics.run import run_report

        repstem = str(work / "rep")
        out01 = d["OUT"] + "_00_01.fits"
        pdf = run_report(out01, repstem, ds_dir=dsdir,
                         ds_pattern=r"ds_\w+?_(\d+)_(\d+)\.fits$")
        assert os.path.exists(pdf), "report PDF missing"
        blocks = pull_from_file(repstem + "_data.txt")
        assert blocks, "report emitted no machine-readable datablocks"

    # ---- quality: science star on its block --------------------------------
    from pyimcom_tpu.wcsutil import WCS

    f = fits_read(out01)
    w = WCS.from_header(f[0].header)
    xs, ys = w.world2pix(SRA, SDEC)
    dimg = np.asarray(f[0].data[0, 0], np.float64)
    ny, nx = dimg.shape
    x, y = np.meshgrid(np.arange(nx), np.arange(ny))
    p = np.exp(-0.5 * ((x - float(xs)) ** 2 + (y - float(ys)) ** 2)
               / SIG_OUT ** 2) / (2 * np.pi * SIG_OUT ** 2 * SC)
    SL1 = float(np.sum(p * dimg) / np.sum(p ** 2))
    VAR = float(np.sum((dimg - SL1 * p) ** 2) / np.sum(p ** 2))
    uc = 10.0 ** (np.asarray(f["FIDELITY"].data, np.float64) / -5000.0)
    uc_med = float(np.median(uc))

    result = {
        "metric": "chained_pipeline_wall_s",
        "value": round(sum(stages.values()), 1),
        "unit": (f"destripe->coadd(2x2 blocks of {args.n1}x{args.n1} "
                 f"32px-stamps, NPIXPSF {args.npixpsf}, INPAD "
                 f"{args.inpad}\")->halo->compress->report on {backend}"),
        "stages_s": stages,
        "backend": backend,
        "destripe_backend": destripe_backend,
        "star_SL1": round(SL1, 6),
        "star_VAR": float(f"{VAR:.3g}"),
        "UC_median": float(f"{uc_med:.3g}"),
        "report_pdf": pdf,
    }
    pathlib.Path(args.artifact or work / "pipeline.json").write_text(
        json.dumps(result) + "\n")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
