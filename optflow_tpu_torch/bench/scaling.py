"""Scaling of the pair scheduler over cards: image pairs a second of
``dist.scheduler.PairScheduler``'s batched solve at mesh sizes 1, 2, 4 and 8,
up to the cards visible, and the efficiency against linear scaling (the
target is >= 0.9, BASELINE.md). The port's counterpart of the root
``bench_scaling.py``.

    python -m optflow_tpu_torch.bench.scaling [--device cuda] [--quick]
    python -m optflow_tpu_torch.bench.scaling --device cpu --virtual 4

Each size solves 2 pairs a device of 128x256 at 3 scales, 3 warps, 60
iterations, epsilon 0 (a fixed work a pair). Besides the rates: the host
milliseconds that the scheduler's dispatch takes to return with every
device's solve enqueued, from its thread a device and from one thread in
turn, and the projection ``eff(N) = min(1, T_device / (N * e_enqueue))``
of a mesh of N cards whose host enqueues their work one card after the
other: ``T_device`` is a one-device dispatch's time on the card by CUDA
events, ``e_enqueue`` the one-device enqueue time.

On one card only size 1 runs, and the line says that scaling is not
measured: the card entered several times is not several cards.
``--device cpu --virtual N`` runs the mesh ``[cpu] * N``, a check of the
structure whose devices share the host's cores.

One JSON line with the keys of ``bench_scaling.py``'s and ``device``.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from optflow_tpu_torch.bench import device_label, emit, open_device, platform
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.dist.mesh import make_pair_mesh, pairs_axis_devices
from optflow_tpu_torch.dist.scheduler import PairScheduler
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched

PER_DEVICE = 2
TARGET = 0.9


def _drain(parts):
    for p in parts:
        p.cpu()


def _enqueue_ms(dispatch, reps) -> float:
    """Median host milliseconds for ``dispatch()`` to return, the results
    read back after each timing."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        parts = dispatch()
        ts.append(time.perf_counter() - t0)
        _drain(parts)
    return statistics.median(ts) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--virtual", type=int, default=0,
                    help="with --device cpu: a mesh of the CPU entered N "
                         "times")
    ap.add_argument("--quick", action="store_true",
                    help="32x64 pairs, 10 iterations a sweep, one timing "
                         "a size: a check of the bench, not a measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    if dev.type == "cuda":
        if ns.virtual:
            ap.error("--virtual is a mesh of the CPU (--device cpu)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev] * max(1, ns.virtual)
    params = TVL1Params(nscales=3, warps=3, iterations=10 if ns.quick else 60,
                        epsilon=0.0)
    h, w, reps = (32, 64, 1) if ns.quick else (128, 256, 3)
    rng = np.random.default_rng(0)

    sizes = [s for s in (1, 2, 4, 8) if s <= len(devices)]
    rates, enqueue_ms, enqueue_seq_ms = {}, {}, {}
    t_device_ms = None
    for n in sizes:
        mesh = make_pair_mesh(n, 1, devices=devices[:n])
        sched = PairScheduler(mesh, params)
        batch = PER_DEVICE * n
        i0s = (rng.random((batch, h, w)) * 255).astype(np.float32)
        i1s = (rng.random((batch, h, w)) * 255).astype(np.float32)
        pairs = list(zip(i0s, i1s))
        sched.solve_pairs(pairs)  # warm-up
        t0 = time.perf_counter()
        for _ in range(reps):
            sched.solve_pairs(pairs)
        rates[n] = batch / ((time.perf_counter() - t0) / reps)

        # the dispatch alone: threads a device (the scheduler's), and one
        # thread that copies and enqueues each device's share in turn
        enqueue_ms[str(n)] = _enqueue_ms(
            lambda: sched._dispatch(i0s, i1s), reps)
        mine = pairs_axis_devices(mesh)

        def in_turn():
            out = []
            for d, dv in enumerate(mine):
                share = slice(d * PER_DEVICE, (d + 1) * PER_DEVICE)
                out.append(tvl1_flow_batched(
                    torch.from_numpy(i0s[share]).to(dv),
                    torch.from_numpy(i1s[share]).to(dv), params))
            return out

        enqueue_seq_ms[str(n)] = _enqueue_ms(in_turn, reps)
        if n == 1 and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            parts = sched._dispatch(i0s, i1s)
            end.record()
            _drain(parts)
            t_device_ms = start.elapsed_time(end)

    base = rates[sizes[0]]
    effs = {str(n): rates[n] / (base * n) for n in sizes}
    e_ms = enqueue_ms["1"]
    projection = {
        "model": "eff(N) = min(1, T_device / (N * e_enqueue))",
        "t_device_ms_per_batch": t_device_ms,
        "t_device_source": ("CUDA events around one one-device dispatch"
                            if t_device_ms is not None else
                            "not measured: no card"),
        "e_enqueue_ms_per_device": e_ms,
        "projected_efficiency": None if t_device_ms is None else {
            str(nn): min(1.0, t_device_ms / (nn * e_ms))
            for nn in (4, 8, 16, 32, 64)},
        "chips_at_0.9_efficiency": None if t_device_ms is None else int(
            t_device_ms / (TARGET * e_ms)),
    }
    measured = len(sizes) > 1
    last = str(sizes[-1])
    if dev.type == "cpu":
        note = ("a mesh of the CPU entered several times: its devices share "
                "the host's cores, so the efficiency checks the structure "
                "only")
    elif measured:
        note = f"{len(devices)} cards"
    else:
        note = ("one card: scaling is not measured (size 1 only; the card "
                "entered several times is not several cards)")
    emit({
        "metric": "pairs/s scaling efficiency (sharded pair scheduler)",
        "value": effs[last] if measured else None,
        "unit": f"fraction of linear at {last} devices",
        "vs_baseline": effs[last] / TARGET if measured else None,
        "platform": platform(dev),
        "devices": len(devices),
        "pairs_per_s": {str(n): rates[n] for n in sizes},
        "efficiency": effs,
        "eager_dispatch_enqueue_ms": enqueue_ms,
        "eager_dispatch_enqueue_sequential_ms": enqueue_seq_ms,
        "scaling_projection": projection,
        "note": note,
        "device": device_label(dev),
    })
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
