"""The bench matrix on the card: the configurations beyond the headline
solve, one JSON line a mode. The port's counterpart of the root
``bench_matrix.py``.

    python -m optflow_tpu_torch.bench.matrix [features features_chained
        roofline tiled scaling] [--out FILE] [--device cuda]
        [--devices cuda:0,cuda:1,...] [--quick]

Modes (default: features, features_chained, roofline):

  features          16 pairs of 256x1024 misaligned by a small rigid motion
                    (:func:`synth.affine_pairs`) through the batched device
                    aligner (``features.align.find_alignment_batched_device``,
                    SURF-class), the exact ``affine_warp`` and the batched
                    solve. Gate: the end-to-end error of the composed map
                    against the true motion, <= 0.5 px, interior.
  features_chained  17 chained frames, 16 pairs, through the indexed aligner
                    (each frame detected and described once), the warp and
                    the solve; gated as ``features``.
  roofline          one 256x1024 level, 300 fixed iterations, 1 warp,
                    epsilon 0: ``plain`` (the plain level solve captured as
                    one CUDA graph and replayed, one submitted program as
                    ``bench_matrix.py``'s ``xla`` row is one compiled
                    program; its flow gated against the eager call's at
                    ``PLAIN_GRAPH_GATE_PX``), ``plain_eager`` (the same
                    solve called eagerly, ~100 operations an iteration each
                    dispatched from the host), ``chunk`` (the chunk kernel's
                    level entry, its ``pallas_legacy``) and ``level`` (the
                    level kernel at batch 16, per image, its
                    ``pallas_fused``): seconds per image, GFLOP/s and the
                    roofline share from :mod:`.roofline`'s count. ``value``
                    is ``level``'s speed-up over ``plain``, which
                    ``speedup_over`` names. The CPU has no CUDA graphs:
                    there ``plain`` is the eager call.
  tiled             512x512, 3 scales, 2 warps, 50 iterations, split by rows
                    over ``--devices`` (default every visible card; on the
                    CPU 8 entries, 4 with ``--quick``) through
                    ``dist.tiled.tiled_tvl1_flow``, against the monolithic
                    solve: the largest difference on every row, seams
                    included, <= 0.25 px.
  scaling           ``python -m optflow_tpu_torch.bench.scaling`` in a
                    process of its own, its line passed on.

Each line has the keys of the root script's mode, with ``device`` (the
card's name and power limit; for ``tiled`` also the rows axis) and these
differences: ``features`` has no ``warp_clamped_px`` (the exact warp clamps
nothing); ``features_chained`` adds ``e2e_epe_px`` and ``e2e_ok``, its gate;
``roofline``'s rows are named ``plain``, ``chunk`` and ``level`` (for
``xla``, ``pallas_legacy`` and ``pallas_fused``), each with
``seconds_per_image``, ``px_iter_per_s_G``, ``gflops``, ``share`` and
``bound`` (for the estimated VPU GFLOP/s and HBM GB/s),
``level_speedup_vs_plain`` is ``fused_speedup_vs_xla``, and it adds the row
``plain_eager``, ``speedup_over`` and ``plain_graph_vs_eager_max_abs_px``
(None on the CPU) with its gate ``plain_graph_gate_px``. Shares are the
card's: a CPU run reports none. A failed gate exits non-zero, after every
mode asked for has printed its line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from optflow_tpu_torch.bench import (
    device_label,
    emit,
    open_device,
    platform,
    roofline,
    sync,
)
from optflow_tpu_torch.bench.synth import (
    DX,
    DY,
    affine_pairs,
    chained_frames,
    make_pair,
)
from optflow_tpu_torch.core.config import (
    SURF_TYPE,
    MatchParams,
    OrbParams,
    SurfParams,
    TVL1Params,
)

MODES = ("features", "features_chained", "roofline", "tiled", "scaling")
DEFAULT_MODES = ("features", "features_chained", "roofline")
E2E_TARGET_PX = 0.5
TILED_TARGET_PX = 0.25
MARGIN = 16
# The captured plain solve replays the eager call's kernels with the eager
# call's launch configurations on the same inputs: its flow is the eager
# flow bit for bit.
PLAIN_GRAPH_GATE_PX = 0.0


def _inv23(a):
    m = np.eye(3)
    m[:2] = a
    return np.linalg.inv(m)[:2]


def e2e_error(flow, aff_rec, aff_true, margin=MARGIN) -> float:
    """Mean over pairs of the interior mean distance between where the
    composed estimate maps an output pixel x into i1, A_rec^-1(x + flow(x)),
    and where the truth maps it, A_true^-1(x). ``flow`` (N, H, W, 2),
    ``aff_*`` (N, 2, 3), numpy."""
    n, h, w, _ = flow.shape
    ys, xs = np.mgrid[margin:h - margin, margin:w - margin].astype(np.float64)
    errs = []
    for i in range(n):
        px = xs + flow[i, margin:-margin, margin:-margin, 0]
        py = ys + flow[i, margin:-margin, margin:-margin, 1]
        ar = _inv23(aff_rec[i])
        at = _inv23(aff_true[i])
        ex = (ar[0, 0] * px + ar[0, 1] * py + ar[0, 2]) - (
            at[0, 0] * xs + at[0, 1] * ys + at[0, 2])
        ey = (ar[1, 0] * px + ar[1, 1] * py + ar[1, 2]) - (
            at[1, 0] * xs + at[1, 1] * ys + at[1, 2])
        errs.append(float(np.sqrt(ex ** 2 + ey ** 2).mean()))
    return float(np.mean(errs))


def bench_features(dev, quick, out):
    """Pre-alignment (detect, describe, match, RANSAC), the warp and the
    solve, batched: the root script's config #3."""
    from optflow_tpu_torch.features.align import find_alignment_batched_device
    from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched
    from optflow_tpu_torch.ops.warp import affine_warp

    # 16-pair batches, the production granularity of the engine's groups
    h, w, batch, params = 256, 1024, 16, TVL1Params()
    if quick:
        h, w, batch, params = 128, 256, 2, TVL1Params(nscales=3)
    orb, surf, mp = OrbParams(), SurfParams(), MatchParams()
    i0_np, i1_np, aff_true = affine_pairs(batch, h, w)
    i0 = torch.from_numpy(i0_np).to(dev)
    i1 = torch.from_numpy(i1_np).to(dev)

    def fn(a, b):
        res = find_alignment_batched_device(b, a, SURF_TYPE, orb, surf, mp)
        warped = affine_warp(b, res.affine)
        flow = tvl1_flow_batched(a, warped, params)
        return flow, res.n_good.sum(), res.affine

    flow_d, good, aff = fn(i0, i1)
    flow = flow_d.double().cpu().numpy()
    n_good = int(good)
    aff_np = aff.double().cpu().numpy()
    # informational, not gated: the synthetic corner motion (<= ~5 px) lies
    # inside RANSAC's reprojection threshold (5.0), so the homography is
    # only loosely held and the solve absorbs the rest
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                        [w - 1, h - 1, 1]], np.float64).T
    corner_errs = [float(np.abs(aff_np[i] @ corners
                                - aff_true[i] @ corners).max())
                   for i in range(batch)]
    e2e = e2e_error(flow, aff_np, aff_true)

    times = []
    for _ in range(1 if quick else 3):
        sync(dev)
        t0 = time.perf_counter()
        fn(i0, i1)
        sync(dev)
        times.append(time.perf_counter() - t0)
    dt_lat = statistics.median(times)
    # steady state: batches enqueued back to back, one synchronisation
    reps = 1 if quick else 5
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(i0, i1)
    sync(dev)
    dt = (time.perf_counter() - t0) / reps
    mp_s = batch * h * w / 1e6 / dt
    emit({
        "metric": "features+TV-L1 MP-pairs/s per card (BASELINE config #3)",
        "value": mp_s,
        "unit": "MP-pairs/s",
        "vs_baseline": mp_s,
        "platform": platform(dev),
        "seconds_per_batch": dt,
        "latency_s_per_batch": dt_lat,
        "good_matches_total": n_good,
        "e2e_epe_px": e2e,
        "e2e_ok": e2e <= E2E_TARGET_PX,
        "affine_corner_err_px": float(np.mean(corner_errs)),
        "shape": [batch, h, w],
        "device": device_label(dev),
    }, out)
    return e2e <= E2E_TARGET_PX


def bench_features_chained(dev, quick, out):
    """Config #3 in the production pair pattern: a chained stack whose
    consecutive pairs share frames, each frame detected and described once
    (``find_alignment_indexed``, the engine's dedup path)."""
    from optflow_tpu_torch.features.align import find_alignment_indexed
    from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched
    from optflow_tpu_torch.ops.warp import affine_warp

    h, w, n_pairs, params = 256, 1024, 16, TVL1Params()
    if quick:
        h, w, n_pairs, params = 128, 256, 2, TVL1Params(nscales=3)
    orb, surf, mp = OrbParams(), SurfParams(), MatchParams()
    frames = torch.from_numpy(chained_frames(n_pairs, h, w)).to(dev)
    i0_idx = torch.arange(n_pairs, device=dev)
    i1_idx = i0_idx + 1

    def fn(fr):
        res = find_alignment_indexed(fr, i1_idx, i0_idx, SURF_TYPE, orb,
                                     surf, mp)
        warped = affine_warp(fr[i1_idx], res.affine)
        flow = tvl1_flow_batched(fr[:n_pairs], warped, params)
        return flow, res.n_good.sum(), res.affine

    flow_d, good, aff = fn(frames)
    n_good = int(good)
    # frame k + 1 is frame k moved by (1.5, -0.8): i1(p) = i0(p - d), so the
    # true map of i1 coordinates into i0's content space is p -> p - d
    truth = np.tile(np.array([[1.0, 0.0, -1.5], [0.0, 1.0, 0.8]]),
                    (n_pairs, 1, 1))
    e2e = e2e_error(flow_d.double().cpu().numpy(),
                    aff.double().cpu().numpy(), truth)

    reps = 1 if quick else 5
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(frames)
    sync(dev)
    dt = (time.perf_counter() - t0) / reps
    mp_s = n_pairs * h * w / 1e6 / dt
    emit({
        "metric": "features+TV-L1 chained z-stack MP-pairs/s "
                  "(production frame reuse)",
        "value": mp_s,
        "unit": "MP-pairs/s",
        "vs_baseline": mp_s,
        "platform": platform(dev),
        "seconds_per_batch": dt,
        "good_matches_total": n_good,
        "unique_frames": n_pairs + 1,
        "shape": [n_pairs, h, w],
        "e2e_epe_px": e2e,
        "e2e_ok": e2e <= E2E_TARGET_PX,
        "device": device_label(dev),
    }, out)
    return e2e <= E2E_TARGET_PX


def _median_seconds(fn, dev, reps=3) -> float:
    """Median of ``reps`` timed calls after a warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _captured(fn, dev):
    """``fn()`` captured as one CUDA graph, after a warm-up on a side stream
    as ``torch.cuda.graph`` asks: (a replay of the graph, the graph's
    outputs, which each replay overwrites). A capture that fails raises: the
    eager time never stands in for it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    return graph.replay, out


def bench_roofline(dev, quick, out):
    """Fixed-work economics of one level at the production strip size."""
    from optflow_tpu_torch.ops.tvl1 import level_solve_plain
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import tvl1_chunk_level_solve
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_level_solve

    h, w, iters, warps, nb = 256, 1024, 300, 1, 16
    if quick:
        h, w, iters, nb = 48, 128, 20, 2
    p = TVL1Params(iterations=iters, warps=warps, epsilon=0.0)
    a_np, b_np = make_pair(h, w, DX, DY, seed=0)
    a = torch.from_numpy(a_np).to(dev)[None]
    b = torch.from_numpy(b_np).to(dev)[None]
    u = torch.zeros_like(a)
    ab, bb = a.expand(nb, h, w).contiguous(), b.expand(nb, h, w).contiguous()
    ub = torch.zeros_like(ab)
    work = roofline.level_work(1, h, w, warps, iters)
    rec = {
        "metric": f"level-solver roofline ({h}x{w}, {iters} fixed "
                  "iterations)",
        "platform": platform(dev),
        "px_iterations": h * w * iters * warps,
    }

    def eager():
        return level_solve_plain(a, b, u, u, p)

    diff = None
    if dev.type == "cuda":
        # at epsilon 0 the plain loop reads nothing back: one program
        plain, graph_out = _captured(eager, dev)
        plain()
        want = eager()
        diff = max(float((graph_out[i] - want[i]).abs().max())
                   for i in (0, 1))
        rec["speedup_over"] = ("plain: level_solve_plain captured as one "
                               "CUDA graph, replayed")
    else:
        plain = eager
        rec["speedup_over"] = ("plain: level_solve_plain, eager (the CPU "
                               "has no CUDA graphs)")
    rec["plain_graph_vs_eager_max_abs_px"] = diff
    rec["plain_graph_gate_px"] = PLAIN_GRAPH_GATE_PX
    rows = (("plain", plain, 1), ("plain_eager", eager, 1),
            ("chunk", lambda: tvl1_chunk_level_solve(a, b, u, u, p), 1),
            ("level", lambda: tvl1_level_solve(ab, bb, ub, ub, p), nb))
    for name, fn, per in rows:
        dt = _median_seconds(fn, dev) / per
        share, bound = (roofline.share(work, dt) if dev.type == "cuda"
                        else (None, roofline.bound_seconds(work)[1]))
        rec[name] = {
            "seconds_per_image": dt,
            "px_iter_per_s_G": rec["px_iterations"] / dt / 1e9,
            "gflops": work.flops / dt / 1e9,
            "share": share,
            "bound": bound,
        }
    speedup = (rec["plain"]["seconds_per_image"]
               / rec["level"]["seconds_per_image"])
    rec.update({"level_speedup_vs_plain": speedup, "value": speedup,
                "unit": "x over the plain level solve (level kernel)",
                "vs_baseline": speedup, "device": device_label(dev)})
    emit(rec, out)
    return diff is None or diff <= PLAIN_GRAPH_GATE_PX


def bench_tiled(dev, quick, devices, out):
    """The row-tiled halo solve against the monolithic one: config #4."""
    from optflow_tpu_torch.dist.mesh import make_pair_mesh
    from optflow_tpu_torch.dist.tiled import default_halo, tiled_tvl1_flow
    from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched

    h, w = (128, 128) if quick else (512, 512)  # a section, split by rows
    p = TVL1Params(nscales=3, warps=2, iterations=50)
    a_np, b_np = make_pair(h, w, DX, DY, seed=0)
    mesh = make_pair_mesh(1, len(devices), devices=devices)
    first = devices[0]
    mono = tvl1_flow_batched(torch.from_numpy(a_np)[None].to(first),
                             torch.from_numpy(b_np)[None].to(first), p)[0]
    sync(first)
    t0 = time.perf_counter()
    tiled = tiled_tvl1_flow(a_np, b_np, p, mesh)
    sync(first)
    dt = time.perf_counter() - t0
    diff = float((tiled - mono).abs()[:, 8:-8].max())
    names = [str(d) for d in devices]
    if len(set(names)) == 1 and len(names) > 1:
        axis = f"{names[0]} entered {len(names)} times"
    else:
        axis = ", ".join(names)
    emit({
        "metric": "tiled halo solve vs monolithic (BASELINE config #4)",
        "value": diff,
        "unit": "max |tiled - monolithic| px (every row incl. seams)",
        "vs_baseline": TILED_TARGET_PX / max(diff, 1e-9),
        "platform": platform(dev),
        "halo_rows": default_halo(p, 8.0, h, w),
        "seconds": dt,
        "shape": [h, w],
        "device": f"{device_label(dev)}; rows axis: {axis}",
    }, out)
    return diff <= TILED_TARGET_PX


def bench_scaling(dev, quick, devices, out):
    """``bench.scaling`` in a process of its own; its line passed on."""
    cmd = [sys.executable, "-m", "optflow_tpu_torch.bench.scaling",
           "--device", str(dev)]
    if dev.type == "cpu":
        cmd += ["--virtual", str(len(devices))]
    if quick:
        cmd.append("--quick")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"scaling: exited with {proc.returncode}")
    emit(json.loads(proc.stdout.strip().splitlines()[-1]), out)
    return True


def mesh_devices(dev, spec, quick):
    """The devices ``--devices`` names (comma-separated, repeats allowed);
    by default every visible card, or 8 entries of the CPU (4 with
    ``quick``)."""
    if spec:
        return [open_device(d) for d in spec.split(",")]
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * (4 if quick else 8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*",
                    help=f"any of {', '.join(MODES)}; default "
                         f"{' '.join(DEFAULT_MODES)}")
    ap.add_argument("--out", help="also append each line to this file")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices",
                    help="the tiled solve's rows axis and the scaling "
                         "mesh: comma-separated devices, repeats allowed")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes and counts: a check of the bench, "
                         "not a measurement")
    ns = ap.parse_args(argv)
    unknown = sorted(set(ns.modes) - set(MODES))
    if unknown:
        ap.error(f"unknown modes {unknown}")
    dev = open_device(ns.device)
    devices = mesh_devices(dev, ns.devices, ns.quick)
    failed = []
    for mode in ns.modes or DEFAULT_MODES:
        if mode == "features":
            ok = bench_features(dev, ns.quick, ns.out)
        elif mode == "features_chained":
            ok = bench_features_chained(dev, ns.quick, ns.out)
        elif mode == "roofline":
            ok = bench_roofline(dev, ns.quick, ns.out)
        elif mode == "tiled":
            ok = bench_tiled(dev, ns.quick, devices, ns.out)
        else:
            ok = bench_scaling(dev, ns.quick, devices, ns.out)
        if not ok:
            failed.append(mode)
    if failed:
        raise SystemExit(f"matrix: the gate of {', '.join(failed)} failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
