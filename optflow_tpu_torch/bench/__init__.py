"""The port's benches: counterparts of the repository's root ``bench.py``,
``bench_job.py``, ``bench_matrix.py`` and ``bench_scaling.py``, on the card
through the port's own entry points.

    python -m optflow_tpu_torch.bench.solve      # 16 pairs of 256x1024
    python -m optflow_tpu_torch.bench.job        # a 512-pair strip job
    python -m optflow_tpu_torch.bench.matrix [features features_chained
                                              roofline tiled scaling]
    python -m optflow_tpu_torch.bench.scaling    # the pair scheduler

Each prints one JSON line last (``matrix``: one a mode) with the keys of the
root script's line, runs on ``--device cuda`` unless the caller passes
``--device cpu``, and exits non-zero where a gate fails. ``--quick`` shrinks
shapes, depths and counts for a check on the CPU; a measurement never uses
it. :mod:`.synth` makes the inputs, equal to the root scripts' bit for bit;
:mod:`.roofline` holds the one work count behind every share.
"""

from __future__ import annotations

import json
from typing import Optional

import torch


def open_device(name: str) -> torch.device:
    """The device a bench runs on. A CUDA device that is not there ends the
    run with a message: a bench never carries on on the CPU unless asked."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{name}: torch.cuda.is_available() is false; this bench runs on "
            "the card (pass --device cpu for a check on the CPU)")
    return dev


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    from optflow_tpu_torch.tools.kernel_ablate import card_name_and_limit

    return card_name_and_limit()


def platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def emit(rec: dict, out: Optional[str] = None) -> None:
    """Print ``rec`` as one JSON line, and append it to ``out``."""
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
