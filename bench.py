#!/usr/bin/env python
"""
End-to-end coaddition benchmark.

Coadds a standardized synthetic block (the survey fixture: simulated
complex-Airy input PSFs, Gaussian target, Cholesky solve, 8 exposures;
cf. BASELINE.json configs[0]) on the GPU and prints one JSON line:

    {"metric": "blocks/hour", "value": ..., "unit": ..., "vs_baseline": null,
     "device": {"platform": ..., "kind": ..., "count": ...}, "card": ...}

A run without --cpu-only that finds no GPU fails; --cpu-only runs on the
CPU and says so in every field.  `vs_baseline` stays null until the
benchmark defines its baseline.  --production times STOP postage stamps of
a 2560^2-px production block instead.

Usage: python bench.py [--cpu-only] [--production]
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent


def run_region(cfg_dict, this_sub=1, stop=0, out_suffix=""):
    from pyimcom_tpu.config import Config
    from pyimcom_tpu.coadd import Block

    d = dict(cfg_dict)
    if stop:
        d["STOP"] = stop
    d["OUT"] = d["OUT"] + out_suffix
    t0 = time.time()
    Block(cfg=Config(d), this_sub=this_sub)
    return time.time() - t0


def quality_check(path):
    """Star-recovery amplitude and median leakage of a bench output block."""
    sys.path.insert(0, str(REPO / "tests"))
    from survey_fixture import star_quality

    SL1, _VAR, uc_med = star_quality(path, region=(slice(0, 25),
                                                   slice(25, 50)))
    return SL1, uc_med


def device_info():
    """(device dict, nvidia-smi `name, power.limit` or None on the CPU)."""
    import jax

    d = jax.devices()[0]
    dev = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    card = None
    if d.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()[0].strip()
    return dev, card


def survey(workdir, **kw):
    sys.path.insert(0, str(REPO / "tests"))
    from survey_fixture import build_survey

    workdir.mkdir(exist_ok=True)
    marker = workdir / ".built"
    if marker.exists():
        return json.loads((workdir / "cfg.json").read_text())
    cfg = build_survey(workdir, n_obs=8, **kw)
    marker.write_text("ok")
    return cfg


def run_production_demo(dev, card, stop: int = 8):
    """
    Production geometry: coadd `stop` postage stamps of a real-size block
    (OUTSIZE [80, 32, 0.0390625] -> 2560^2 px, INPAD 1.055") and report
    per-stamp wall time and peak device memory.  A production stamp
    system is n ~ 5-6k input pixels with 383-sample overlap windows.
    """
    import jax

    overrides = {"OUTSIZE": [80, 32, 0.0390625], "INPAD": 1.055,
                 "NPIXPSF": 48, "STOP": stop}
    workdir = pathlib.Path(os.environ.get("PYIMCOM_PROD_DIR",
                                          str(REPO / ".prod_work")))
    cfg_dict = survey(workdir, extrainput=["cstar14"],
                      config_overrides=overrides)
    cfg_dict.update(overrides)
    run_region(cfg_dict, stop=stop, out_suffix="_prod")      # compiles
    dt = run_region(cfg_dict, stop=stop, out_suffix="_prod")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(json.dumps({
        "metric": "production_stamp_seconds",
        "value": dt / stop,
        "unit": f"s per 32x32-px production stamp ({stop} stamps of a "
                f"2560^2 block, warm) on {dev['kind']}",
        "vs_baseline": None,
        "peak_device_bytes": peak,
        "device": dev,
        "card": card,
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-only", action="store_true",
                    help="run on the CPU backend (labelled cpu)")
    ap.add_argument("--production", action="store_true",
                    help="production-geometry per-stamp timing")
    args = ap.parse_args()

    if args.cpu_only:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(REPO))
    from pyimcom_tpu import jaxcache

    jaxcache.enable()
    dev, card = device_info()
    if not args.cpu_only and dev["platform"] != "gpu":
        raise SystemExit(f"bench: no GPU found (JAX runs on "
                         f"{dev['platform']}); pass --cpu-only for a CPU run")
    if args.production:
        return run_production_demo(dev, card)

    cfg_dict = survey(REPO / ".bench_work", extrainput=["cstar14"])
    tag = "_" + dev["platform"]
    run_region(cfg_dict, out_suffix=tag)                    # compiles
    dt = run_region(cfg_dict, out_suffix=tag)
    ibx, iby = divmod(1, cfg_dict["BLOCK"])
    SL1, uc_med = quality_check(
        cfg_dict["OUT"] + f"{tag}_{ibx:02d}_{iby:02d}.fits")
    print(json.dumps({
        "metric": "blocks/hour",
        "value": 3600.0 / dt,
        "unit": f"synthetic 100px blocks/hour (16/16 stamps, warm) on "
                f"{dev['kind']}",
        "vs_baseline": None,
        "SL1": SL1,
        "uc_median": uc_med,
        "device": dev,
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
