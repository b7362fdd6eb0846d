"""CLI entry point: ``python -m optflow_tpu_torch.cli.main <job.json[.gz]>``.

Reference-compatible with ``optflow <file.json[.gz]>`` (src/optflow.cpp:29-72):
loads the (possibly gzipped) JSON job file and runs a ``style`` 1 job (the
batch pair solve, with feature pre-alignment unless the job or
``--no-features`` turns it off) on the GPU. The ``align`` subcommand and
``style`` 2 (the average-flow temporal aligner) are not ported yet and exit
with a message.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "align":
        print(
            "optflow align: global stack alignment is not ported yet; it "
            "comes with the global-alignment slice of optflow_tpu_torch",
            file=sys.stderr,
        )
        return 2
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
        from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
            tvl1_blocked_level_solve,
        )
        from optflow_tpu_torch.ops.tvl1_cuda import tvl1_level_solve

        # launches of the product's kernels in this process (the tools'
        # kernels never run in a job): 0 when the job ran on the CPU
        stats["kernel_launches"] = {
            "tvl1_level_solve": tvl1_level_solve.launches,
            "tvl1_blocked_level_solve": tvl1_blocked_level_solve.launches,
        }
        print(f"done: {stats}")
        return 0
    if style == 2:
        print(
            "style 2 (average-flow temporal alignment) is not ported yet; "
            "it comes with the global-alignment slice of optflow_tpu_torch",
            file=sys.stderr,
        )
        return 2
    print(f"unknown style {style}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
