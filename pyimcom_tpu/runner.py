"""
Mosaic-scale run orchestration.

Counterpart of the reference's Slurm job-array generators and fork-based
multi-block runners (reference scripts/writejob_example.pl,
examples/multiblock_paper4.pl): blocks of a mosaic are independent jobs;
this module runs them in-process, over a local process pool, or
round-robin over hosts with each host feeding its accelerator(s).  The prime-stride block ordering (stride 691) matches
the reference so partial runs are unbiased spatial samples of the mosaic.

Pipeline stages (reference docs/splitpsf_README.rst workflow), each a
function so schedulers can chain them:
    split_psfs -> prebuild_layers -> run_mosaic(iter 0) -> subtract_wings
    -> update_cube -> run_mosaic(iter 1) -> compress -> report

CLI: ``python -m pyimcom_tpu.runner cfg.json [--block N] [--all]``
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .config import Config

PRIME_STRIDE = 691


def block_order(nblock: int, nrun: int = None):
    """Prime-stride permutation of block indices (unbiased subsampling)."""
    total = nblock * nblock
    nrun = total if nrun is None else min(nrun, total)
    return [(int(i * PRIME_STRIDE % total)) for i in range(nrun)]


def run_block(cfg, this_sub: int, skip_existing: bool = True) -> str:
    """Coadd one block; returns the output path (skips completed blocks,
    matching the reference's idempotent re-run recovery model)."""
    if isinstance(cfg, dict):
        cfg = Config(dict(cfg))
    cfg()
    ibx, iby = divmod(this_sub, cfg.nblock)
    outfile = cfg.outstem + f"_{ibx:02d}_{iby:02d}.fits"
    if skip_existing and os.path.exists(outfile):
        print(f"block {this_sub} already done -> {outfile}")
        return outfile
    from .coadd import Block

    Block(cfg=cfg, this_sub=this_sub)
    return outfile


def run_mosaic(cfg, blocks=None, nworkers: int = 1, skip_existing: bool = True):
    """
    Run all (or the listed) blocks of a mosaic.

    nworkers > 1 fans blocks over a process pool (each worker owns the
    accelerator serially -- appropriate for CPU hosts; on several GPU hosts,
    run one process per host with `blocks` sharded by host index instead).
    """
    if isinstance(cfg, Config):
        cfg_dict = cfg.to_dict()
    else:
        cfg_dict = dict(cfg)
        cfg = Config(dict(cfg_dict))
    if blocks is None:
        blocks = block_order(cfg.nblock)

    if nworkers <= 1:
        return [run_block(Config(dict(cfg_dict)), b, skip_existing) for b in blocks]

    import concurrent.futures
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    outs = []
    failures = []
    with concurrent.futures.ProcessPoolExecutor(max_workers=nworkers,
                                                mp_context=ctx) as pool:
        futs = {pool.submit(run_block, cfg_dict, b, skip_existing): b for b in blocks}
        for fut in concurrent.futures.as_completed(futs):
            try:
                outs.append(fut.result())
            except Exception as e:  # noqa: BLE001
                failures.append((futs[fut], str(e)))
    if failures:
        raise RuntimeError(f"{len(failures)} blocks failed: {failures[:3]}")
    return outs


def host_blocks(nblock: int, process_index: int = None,
                process_count: int = None):
    """
    Round-robin block share for one host of a multi-host run (the
    counterpart of the reference's Slurm job-array block assignment,
    scripts/writejob_example.pl:88-95).  Defaults to this process's rank
    in the jax.distributed world.
    """
    if process_index is None:
        import jax

        process_index = jax.process_index()
        process_count = jax.process_count()
    order = block_order(nblock)
    return order[process_index::max(process_count, 1)]


def run_mosaic_multihost(cfg, skip_existing: bool = True):
    """
    Multi-host mosaic execution: every host (one process per host,
    initialized with jax.distributed) coadds its prime-stride
    round-robin share of blocks on its local accelerators.  Blocks are
    independent (the padding-stamp halo exchange is a post-pass,
    analysis.share_padding_stamps), so no collectives cross hosts here.
    """
    if not isinstance(cfg, Config):
        cfg = Config(dict(cfg))
    blocks = host_blocks(cfg.nblock)
    return run_mosaic(cfg, blocks=blocks, nworkers=1,
                      skip_existing=skip_existing)


def main(argv=None):
    ap = argparse.ArgumentParser(description="pyimcom_tpu mosaic runner")
    ap.add_argument("config", help="JSON configuration file")
    ap.add_argument("--block", type=int, default=None, help="run one block index")
    ap.add_argument("--all", action="store_true", help="run all blocks")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--report", action="store_true", help="build the report after")
    ap.add_argument("--share-pads", action="store_true",
                    help="run the padding-stamp halo exchange post-pass "
                         "and save the merged blocks")
    args = ap.parse_args(argv)

    cfg = Config(args.config)
    if args.block is not None:
        run_block(cfg, args.block)
    elif args.all:
        run_mosaic(cfg, nworkers=args.workers)
    else:
        print("specify --block N or --all")
        return 1

    if args.share_pads:
        from .analysis import Mosaic

        mos = Mosaic(cfg.outstem)
        mos.share_padding_stamps()
        for key, oi in mos.images.items():
            oi.save()
        print(f"halo exchange applied to {len(mos.images)} blocks")

    if args.report:
        from .diagnostics.run import run_report

        first = cfg.outstem + "_00_00.fits"
        if not os.path.exists(first):
            import glob as _g

            cands = sorted(_g.glob(cfg.outstem + "_[0-9][0-9]_[0-9][0-9].fits"))
            first = cands[0] if cands else None
        if first:
            run_report(first, cfg.outstem)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
