#!/usr/bin/env python
"""
Generate chained batch-job scripts for a full mosaic production run.

Counterpart of the reference's Slurm pipeline generator
(scripts/writejob_example.pl:66-120): emits one script per stage with
dependency chaining, for either a Slurm cluster (``--scheduler slurm``,
job arrays over blocks with afterok chaining) or a multi-host GPU pod
(``--scheduler pod``, one process per host via jax.distributed with
round-robin block sharding handled by runner.run_mosaic_multihost).

Stage order (reference docs/run_README.rst):
    splitpsf -> layers -> coadd(iter0) -> imsubtract -> update -> coadd
    -> compress -> report

Usage:
    python scripts/writejob.py cfg.json outdir/ --scheduler slurm \
        --account myacct --time 12:00:00
"""

from __future__ import annotations

import argparse
import json
import os
import stat

STAGES = ["splitpsf", "layers", "coadd0", "imsubtract", "update",
          "coadd1", "compress", "report"]

_STAGE_CMD = {
    "splitpsf": "python -m pyimcom_tpu.splitpsf.splitpsf {cfg}",
    "layers": "python -c \"from pyimcom_tpu.layer_wrapper import "
              "build_all_layers; from pyimcom_tpu.config import Config; "
              "build_all_layers(Config('{cfg}'))\"",
    "coadd0": "python -m pyimcom_tpu.runner {cfg} --block $BLOCK",
    "imsubtract": "python -m pyimcom_tpu.splitpsf.imsubtract {cfg} $SCA",
    "update": "python -c \"from pyimcom_tpu.splitpsf.update_cube import "
              "update; from pyimcom_tpu.config import Config; "
              "update(Config('{cfg}'))\"",
    "coadd1": "python -m pyimcom_tpu.runner {cfg} --block $BLOCK",
    "compress": "python -c \"from pyimcom_tpu.layer_wrapper import "
                "compress_all_blocks; from pyimcom_tpu.config import "
                "Config; compress_all_blocks(Config('{cfg}'))\"",
    "report": "python -c \"from pyimcom_tpu.diagnostics.run import "
              "run_report; import glob; "
              "f=sorted(glob.glob('{outstem}_[0-9][0-9]_[0-9][0-9].fits'))"
              "[0]; run_report(f, '{outstem}')\"",
}

_ARRAY_STAGES = {"coadd0", "coadd1"}
# imsubtract runs as a job array over the 18 SCAs (reference
# scripts/writejob_example.pl:99-104)
_SCA_ARRAY_STAGES = {"imsubtract"}


def write_jobs(cfgfile: str, outdir: str, scheduler: str = "slurm",
               account: str = "", time: str = "24:00:00",
               stages=None) -> list:
    cfgd = json.loads(open(cfgfile).read())
    nblock = int(cfgd["BLOCK"]) ** 2
    outstem = cfgd["OUT"]
    os.makedirs(outdir, exist_ok=True)
    stages = stages or STAGES
    paths = []
    submit_lines = ["#!/bin/bash", "# submit the full pipeline with"
                    " dependency chaining", "set -e", "dep=''"]
    for st in stages:
        cmd = _STAGE_CMD[st].format(cfg=cfgfile, outstem=outstem)
        path = os.path.join(outdir, f"job_{st}.sh")
        with open(path, "w") as f:
            f.write("#!/bin/bash\n")
            if scheduler == "slurm":
                f.write(f"#SBATCH --job-name=pyimcom_{st}\n")
                if account:
                    f.write(f"#SBATCH --account={account}\n")
                f.write(f"#SBATCH --time={time}\n")
                if st in _ARRAY_STAGES:
                    f.write(f"#SBATCH --array=0-{nblock - 1}\n")
                    f.write("BLOCK=$SLURM_ARRAY_TASK_ID\n")
                elif st in _SCA_ARRAY_STAGES:
                    f.write("#SBATCH --array=1-18\n")
                    f.write("SCA=$SLURM_ARRAY_TASK_ID\n")
            else:  # pod: one process per host, jax.distributed ranks
                if st in _SCA_ARRAY_STAGES:
                    cmd = "for SCA in $(seq 1 18); do " + cmd + "; done"
                if st in _ARRAY_STAGES:
                    cmd = ("python -c \"import jax; "
                           "jax.distributed.initialize(); "
                           "from pyimcom_tpu.runner import "
                           "run_mosaic_multihost; from pyimcom_tpu.config "
                           f"import Config; "
                           f"run_mosaic_multihost(Config('{cfgfile}'))\"")
            f.write(cmd + "\n")
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        paths.append(path)
        if scheduler == "slurm":
            submit_lines.append(
                f"jid=$(sbatch --parsable $dep {path}); "
                f"dep=\"--dependency=afterok:$jid\"")
        else:
            submit_lines.append(f"bash {path}")
    sub = os.path.join(outdir, "submit_all.sh")
    with open(sub, "w") as f:
        f.write("\n".join(submit_lines) + "\n")
    os.chmod(sub, os.stat(sub).st_mode | stat.S_IEXEC)
    paths.append(sub)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("outdir")
    ap.add_argument("--scheduler", choices=["slurm", "pod"], default="slurm")
    ap.add_argument("--account", default="")
    ap.add_argument("--time", default="24:00:00")
    args = ap.parse_args(argv)
    for p in write_jobs(args.config, args.outdir, args.scheduler,
                        args.account, args.time):
        print("wrote", p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
