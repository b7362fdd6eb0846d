"""Multi-host launcher: one logical job over several hosts.

The reference scales by launching independent Singularity containers per
job file on an LSF cluster (singularity/janelia_run.sh). Here every host
starts this module; the hosts join through ``torch.distributed`` (the
``gloo`` backend, ``dist.mesh.initialize_multihost``), host ``r`` of ``N``
takes every N-th pair of the job's image list starting at ``r`` and the
journal ``<journal>.<r>``, and solves them with ``run_job_batched`` on a
pairs mesh over its local devices. Pair solving is embarrassingly parallel
(the reference's 5000-pair job files, gen_cross_file_list.py:26-27): the
hosts exchange only the rendezvous and a final barrier.

Usage (per host):
  python -m optflow_tpu_torch.cli.run_pod job.json.gz \\
      [--coordinator host:port --num-processes N --process-id I] \\
      [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import functools


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="optflow-pod",
        description="one job over several hosts, each on its local devices",
    )
    parser.add_argument("filename", help="json job file (optionally .gz)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of the rendezvous (process 0's)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                        help="the local devices: every visible card "
                             "(default) or the CPU")
    ns = parser.parse_args(argv)

    import torch

    from optflow_tpu_torch.core.config import load_job
    from optflow_tpu_torch.dist.mesh import initialize_multihost, make_pair_mesh
    from optflow_tpu_torch.engine.batch_runner import run_job_batched
    from optflow_tpu_torch.engine.features_glue import default_aligner

    initialize_multihost(ns.coordinator, ns.num_processes, ns.process_id)
    dist = torch.distributed
    joined = dist.is_available() and dist.is_initialized()
    n_proc = dist.get_world_size() if joined else 1
    pid = dist.get_rank() if joined else 0

    args = load_job(ns.filename)
    mesh = None
    if n_proc > 1:
        args["images"] = args.get("images", [])[pid::n_proc]
        if args.get("journal"):
            args["journal"] = f"{args['journal']}.{pid}"
        local = None if ns.device == "cuda" else [torch.device("cpu")]
        mesh = make_pair_mesh(devices=local)
    # the package's aligner, on the device the solves run on
    aligner = functools.partial(default_aligner, device=ns.device)
    try:
        stats = run_job_batched(args, aligner=aligner, mesh=mesh,
                                device=ns.device)
        print(f"[host {pid}/{n_proc}] done: {stats}", flush=True)
        if joined:
            dist.barrier()
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
