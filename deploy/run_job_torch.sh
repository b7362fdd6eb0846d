#!/usr/bin/env bash
# Single-host job wrapper of the PyTorch/CUDA port — the counterpart of
# run_job.sh and of the reference's singularity/janelia_run.sh (one
# invocation per job file). Runs on the card; `--device cpu` runs the plain
# versions.
# Usage: deploy/run_job_torch.sh /path/to/job.json[.gz] [extra CLI args]
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m optflow_tpu_torch.cli.main "$@"
