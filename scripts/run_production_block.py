#!/usr/bin/env python
"""
Full production-geometry block coadd, resumable from a checkpoint.

Coadds ONE production-size block -- OUTSIZE [80, 32, 0.0390625] (2560^2
output px, 6400 postage stamps), INPAD 1.055", NPIXPSF 48, the geometry of
the reference's default_config.json / writejob production envelope
(reference configs/default_config.json, scripts/writejob_example.pl:88-95)
-- on the default accelerator, end to end.

The block runs in a child process with PYIMCOM_CHECKPOINT=1 (Block
snapshots the accumulated maps + drained-group count); a rerun of this
script after an interruption resumes after the saved scan-order prefix.
The parent never imports JAX, so only the child opens the card.

Writes <workdir>/production_block.json with wall time, s/stamp and
blocks/hour/chip when the block completes, or the progress so far when
--max-hours runs out.

Usage: python scripts/run_production_block.py [--max-hours 11]
       [--ckpt-sec 300]
"""

import argparse
import json
import os
import pathlib
import signal
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
# override with PYIMCOM_PROD_DIR
WORK = pathlib.Path(os.environ.get("PYIMCOM_PROD_DIR",
                                   str(REPO / ".prod_work")))
LOG = WORK / "production_block.log"
ARTIFACT = WORK / "production_block.json"
CHILD = r"""
import json, pathlib, sys, time
import jax
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[2])
from pyimcom_tpu import jaxcache
jaxcache.enable()
from pyimcom_tpu.config import Config
from pyimcom_tpu.coadd import Block
cfg_dict = json.loads(pathlib.Path(sys.argv[1]).read_text())
cfg_dict["STOP"] = 0
cfg_dict["OUT"] = cfg_dict["OUT"] + "_full"
print("backend:", jax.default_backend(), flush=True)
t0 = time.time()
Block(cfg=Config(cfg_dict), this_sub=1)
print(f"CHILD_DONE wall={time.time() - t0:.1f}", flush=True)
"""


def launch(env):
    f = open(LOG, "ab")
    p = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(WORK / "cfg.json"), str(REPO)],
        stdout=f, stderr=subprocess.STDOUT, env=env,
        start_new_session=True)
    return p, f


def _quality_medians():
    """
    Median leakage U/C and noise Sigma over every per-stamp quality print
    in the child log ("sqUC,sqSig medians | <sqrt(U/C)> <sqrt(Sigma)>",
    the same accounting line the reference block log carries).  Returns
    {} when the log has none yet.
    """
    import re

    import numpy as np

    vals = [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"sqUC,sqSig medians \| ([0-9.E+-]+) ([0-9.E+-]+)",
        LOG.read_text(errors="replace"))]
    if not vals:
        return {}
    squc = np.median([v[0] for v in vals])
    sqsig = np.median([v[1] for v in vals])
    return {"UC_median": float(f"{squc ** 2:.3g}"),
            "Sigma_median": float(f"{sqsig ** 2:.3g}")}


def write_partial(ckpt, n_restarts):
    """
    Record partial progress when the run is paused by max-hours: groups
    drained so far (from the resumable checkpoint) plus a warm s/stamp
    measured from the child log's recent "postage stamp" timestamps, so
    an interrupted production block still yields a durable, honest
    extrapolation in the round artifact.
    """
    import re

    if not ckpt.exists():
        return
    import numpy as np

    z = np.load(ckpt)
    done, total = int(z["groups_done"]), int(z["n_groups"])
    stamps_per_group = int(z["nrun"]) // max(total, 1)

    # warm rate: median wall-clock gap between consecutive stamp-group
    # prints over the final restart segment (child-relative clocks reset
    # at each restart, so only use monotone tail times)
    times = [float(m.group(1)) for m in re.finditer(
        r"postage stamp\s+\d+,\s*\d+\s+t=\s*([0-9.]+) s",
        LOG.read_text(errors="replace"))]
    tail, prev = [], None
    for t in times:
        if prev is not None and t < prev:
            tail = []
        if prev is None or t > prev:
            tail.append(t)
        prev = t
    gaps = sorted(b - a for a, b in zip(tail, tail[1:]) if b > a)
    s_per_group = gaps[len(gaps) // 2] if gaps else float("nan")
    s_per_stamp = s_per_group / max(stamps_per_group, 1)
    result = {
        "metric": "production_block_progress",
        "partial": True,
        "groups_done": done,
        "n_groups": total,
        "pct_done": round(100.0 * done / max(total, 1), 2),
        "warm_s_per_stamp": round(s_per_stamp, 2),
        "extrapolated_block_hours": round(
            s_per_group * total / 3600.0, 2) if gaps else None,
        "restarts": n_restarts,
        "checkpoint": str(ckpt),
        "unit": ("2560^2-px production block (6400 stamps) on one chip; "
                 "resumable from checkpoint"),
        "note": "median stamp-gap over the log tail of the last segment",
    }
    result.update(_quality_medians())
    ARTIFACT.write_text(json.dumps(result) + "\n")
    print(json.dumps(result), flush=True)


def _segment_walls():
    """
    Per-child-segment on-chip wall seconds, from the appended log.

    Each child prints ``backend: <name>`` once at startup and timestamps
    every stamp group with its OWN clock (``postage stamp r,c  t= <s> s``),
    then ``CHILD_DONE wall=<s>`` on a clean finish.  The log is opened in
    append mode across every resumed invocation, so
    summing each segment's final timestamp gives the TRUE total on-chip
    wall for the block, including interrupted segments.

    A log with no ``backend:`` markers (lost/truncated by an outage, or a
    hand-assembled finalize-only log) is treated as ONE segment so the
    writer still produces an artifact instead of dividing by zero; in
    that degenerate case a trailing ``CHILD_DONE wall=`` (the child's own
    authoritative total) wins over intermediate stamp timestamps.
    """
    import re

    text = LOG.read_text(errors="replace")
    parts = text.split("backend: ")
    segments = parts[1:] if len(parts) > 1 else [text]
    walls = []
    for seg in segments:
        done = re.findall(r"CHILD_DONE wall=([0-9.]+)", seg)
        if done:
            walls.append(float(done[-1]))
            continue
        ts = re.findall(r"t=\s*([0-9.]+) s", seg)
        walls.append(float(ts[-1]) if ts else 0.0)
    return walls


def write_complete(out_fits, ckpt, n_restarts, prior_wall=0.0):
    """
    Record a COMPLETED block with the true accumulated on-chip wall.

    Total wall = sum of every log segment's final timestamp (see
    _segment_walls) + ``prior_wall`` for any invocations whose log was
    lost.  Used at the end of a run and by --finalize-only.
    """
    walls = _segment_walls()
    wall = sum(walls) + prior_wall
    n_stamps = 80 * 80
    result = {
        "metric": "production_block_wall_hours",
        "value": round(wall / 3600.0, 3),
        "unit": (f"hours for one 2560^2-px block (6400 stamps, INPAD "
                 f"1.055\") on one chip; {wall / n_stamps:.2f} s/stamp; "
                 f"{len(walls)} child segments (resumed runs)"),
        "blocks_per_hour_per_chip": (round(3600.0 / wall, 4)
                                     if wall > 0 else None),
        "s_per_stamp": round(wall / n_stamps, 3),
        "restarts": n_restarts,
        "segment_walls_s": [round(w, 1) for w in walls],
        "output": str(out_fits),
        "checkpoint_left": ckpt.exists(),
    }
    result.update(_quality_medians())
    ARTIFACT.write_text(json.dumps(result) + "\n")
    print(json.dumps(result), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-hours", type=float, default=11.0)
    ap.add_argument("--ckpt-sec", type=int, default=300)
    ap.add_argument("--prior-wall-sec", type=float, default=0.0,
                    help="on-chip wall seconds already spent on this block "
                         "by earlier invocations (checkpoint resumes); added "
                         "to the completion artifact")
    ap.add_argument("--finalize-only", action="store_true",
                    help="write the artifact from the existing log + "
                         "checkpoint without launching a child")
    args = ap.parse_args()

    assert (WORK / "cfg.json").exists(), \
        "run 'python bench.py --production' once first to build the survey"
    out_fits = WORK / "out" / "testout_F_full_00_01.fits"
    ckpt = WORK / "out" / "testout_F_full_00_01.ckpt.npz"

    if args.finalize_only:
        if out_fits.exists() and "CHILD_DONE" in LOG.read_text(
                errors="replace"):
            write_complete(out_fits, ckpt, n_restarts=0,
                           prior_wall=args.prior_wall_sec)
        else:
            write_partial(ckpt, n_restarts=0)
        return 0

    env = dict(os.environ, PYIMCOM_CHECKPOINT="1",
               PYIMCOM_CKPT_SEC=str(args.ckpt_sec))
    p, f = launch(env)
    try:
        rc = p.wait(timeout=args.max_hours * 3600.0)
    except subprocess.TimeoutExpired:
        print("max-hours reached; leaving the checkpoint for a later "
              "resume", flush=True)
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        write_partial(ckpt, n_restarts=0)
        return 2
    finally:
        f.close()
    if rc != 0 or not out_fits.exists():
        print(f"block child exited rc={rc}; see {LOG}", flush=True)
        return rc or 1
    write_complete(out_fits, ckpt, n_restarts=0,
                   prior_wall=args.prior_wall_sec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
