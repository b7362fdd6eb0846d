"""CLI entry point: ``python -m optflow_tpu_torch.cli.main <job.json[.gz]>``.

Reference-compatible with ``optflow <file.json[.gz]>`` (src/optflow.cpp:29-72):
loads the (possibly gzipped) JSON job file and dispatches on ``style`` on
the GPU: 1 = the batch pair solve, with feature pre-alignment unless the job
or ``--no-features`` turns it off; 2 = the average-flow temporal aligner the
reference kept dormant (src/optflow.cpp:180-226, ``align/average_flow.py``).
``optflow align <matches.jsonl>`` solves the global stack alignment from a
match store.
"""

from __future__ import annotations

import argparse
import sys


def _align_main(argv) -> int:
    """``optflow align <matches.jsonl>`` — global stack alignment from an
    accumulated match store (the in-process replacement for the external
    solve the reference delegates to Render, SURVEY.md §1)."""
    parser = argparse.ArgumentParser(
        prog="optflow align",
        description="global stack alignment from a JSONL match store",
    )
    parser.add_argument("matches", help="JSONL match store (engine sink output)")
    parser.add_argument("--model", choices=("translation", "affine"),
                        default="affine")
    parser.add_argument("--solver", choices=("zblock", "cg"), default="zblock",
                        help="zblock: direct Schur solve (banded-z graphs); "
                        "cg: conjugate gradient over the match edges")
    parser.add_argument("--block-sections", type=int, default=256)
    parser.add_argument("--out", default="transforms.json",
                        help="output JSON: {groupId: 2x3 affine rows}")
    parser.add_argument("--device", default="cuda",
                        help="torch device the solve runs on (default: cuda)")
    ns = parser.parse_args(argv)

    import json

    from optflow_tpu_torch.sinks.store import JsonlMatchSink

    matches = JsonlMatchSink(ns.matches).read_all()
    if ns.solver == "zblock":
        from optflow_tpu_torch.align.zblock import solve_zblock_alignment

        res = solve_zblock_alignment(
            matches, model=ns.model, block_sections=ns.block_sections,
            device=ns.device,
        )
    else:
        from optflow_tpu_torch.align.global_solve import (
            solve_affine_alignment,
            solve_translation_alignment,
        )

        solve = (solve_affine_alignment if ns.model == "affine"
                 else solve_translation_alignment)
        res = solve(matches, device=ns.device)

    out = {
        g: res.transforms[i].tolist() for i, g in enumerate(res.group_ids)
    }
    with open(ns.out, "w") as f:
        json.dump({"model": ns.model, "residual_rms_px": res.residual,
                   "transforms": out}, f, indent=1)
    print(f"aligned {len(res.group_ids)} sections, "
          f"rms residual {res.residual:.4f} px -> {ns.out}")
    return 0


def _kernel_launches() -> dict:
    """Launches of the product's kernels in this process (the tools' kernels
    never run in a job): 0 when the job ran on the CPU."""
    from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
        tvl1_blocked_level_solve,
    )
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_level_solve

    return {
        "tvl1_level_solve": tvl1_level_solve.launches,
        "tvl1_blocked_level_solve": tvl1_blocked_level_solve.launches,
    }


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "align":
        return _align_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="optflow",
        description="dense optical flow over image-pair job files (PyTorch/CUDA)",
    )
    parser.add_argument("filename", help="json job file (optionally .gz)")
    parser.add_argument(
        "--no-features",
        action="store_true",
        help="disable feature pre-alignment regardless of job config",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="write a torch.profiler Chrome trace of the whole job here",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device the solves run on (default: cuda)",
    )
    ns = parser.parse_args(argv)

    from optflow_tpu_torch.core.config import load_job
    from optflow_tpu_torch.utils.metrics import profiler_trace

    args = load_job(ns.filename)
    if ns.no_features:
        args["features"] = False

    style = int(args.get("style", 1))
    if style == 1:
        import functools

        from optflow_tpu_torch.engine.features_glue import default_aligner

        # the package's aligner, on the device the solves run on
        aligner = functools.partial(default_aligner, device=ns.device)

        with profiler_trace(ns.profile_dir):
            if int(args.get("pair_batch", 1)) > 1:
                from optflow_tpu_torch.engine.batch_runner import run_job_batched

                stats = run_job_batched(
                    args, aligner=aligner, device=ns.device
                )
            else:
                from optflow_tpu_torch.engine.runner import run_job

                stats = run_job(
                    args, aligner=aligner, device=ns.device
                )
        if ns.profile_dir:
            print(f"profiler trace written to {ns.profile_dir}")
        stats["kernel_launches"] = _kernel_launches()
        print(f"done: {stats}")
        return 0
    if style == 2:
        from optflow_tpu_torch.align.average_flow import average_flow_job
        from optflow_tpu_torch.utils.metrics import StageTimer

        timer = StageTimer()
        with profiler_trace(ns.profile_dir):
            written = average_flow_job(args, device=ns.device, timer=timer)
        if ns.profile_dir:
            print(f"profiler trace written to {ns.profile_dir}")
        stats = {"sections": len(written),
                 "timing": timer.summary(len(written)),
                 "kernel_launches": _kernel_launches()}
        print(f"done: {stats}")
        return 0
    print(f"unknown style {style}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
