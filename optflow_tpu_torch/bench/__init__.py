"""The port's benches: counterparts of the repository's root ``bench.py``,
``bench_job.py``, ``bench_matrix.py`` and ``bench_scaling.py``, on the card
through the port's own entry points.

    python -m optflow_tpu_torch.bench.solve      # 16 pairs of 256x1024
    python -m optflow_tpu_torch.bench.job        # a 512-pair strip job
    python -m optflow_tpu_torch.bench.matrix [features features_chained
                                              roofline tiled scaling]
    python -m optflow_tpu_torch.bench.scaling    # the pair scheduler
    python -m optflow_tpu_torch.bench.section [NxHxW ...]  # full sections

Each prints one JSON line last (``matrix``: one a mode) with the keys of the
root script's line, runs on ``--device cuda`` unless the caller passes
``--device cpu``, and exits non-zero where a gate fails. ``--quick`` shrinks
shapes, depths and counts for a check on the CPU; a measurement never uses
it. :mod:`.synth` makes the inputs, equal to the root scripts' bit for bit;
:mod:`.roofline` holds the one work count behind every share; :func:`timed`
is the one timer of :mod:`.section` and of the probes
(``optflow_tpu_torch/tools/probes/``).
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Callable, Dict, Optional, Tuple

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


def timed(dev: torch.device, fn: Callable, reps: int) -> Tuple[object, Dict]:
    """``fn()`` once to warm, then ``reps`` times, each call started on an
    idle card and ended by a synchronisation. Returns the last call's result
    and the medians over the ``reps`` calls of ``device_ms`` (CUDA events
    around the call; ``None`` off the card), ``wall_ms`` (the host clock to
    the synchronisation) and ``enqueue_ms`` (the host clock to the call's
    return: where it is near ``wall_ms`` the host, not the card, set the
    pace)."""
    fn()
    rows = []
    for _ in range(reps):
        sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        t_enq = time.perf_counter()
        if dev.type == "cuda":
            end.record()
        sync(dev)
        t1 = time.perf_counter()
        rows.append((start.elapsed_time(end) if dev.type == "cuda" else None,
                     (t1 - t0) * 1e3, (t_enq - t0) * 1e3))
    dev_ms, wall_ms, enq_ms = zip(*rows)
    return out, {
        "device_ms": None if dev.type != "cuda" else statistics.median(dev_ms),
        "wall_ms": statistics.median(wall_ms),
        "enqueue_ms": statistics.median(enq_ms)}


def elapsed_ms(t: Dict) -> float:
    """The time a rate divides by, of a :func:`timed` dict: the card's
    (``device_ms``) where there is one, else the host clock's."""
    return t["device_ms"] if t["device_ms"] is not None else t["wall_ms"]
