"""The product's job loop on the card: job-level megapixel image-pairs a
second of ``engine.batch_runner.run_job_batched``, decode to sink. The
port's counterpart of the root ``bench_job.py``.

    python -m optflow_tpu_torch.bench.job [--pairs 512] [--device cuda] [--quick]

A style-1 job of strip-ROI pairs (top and bottom strips of 256 rows,
``random_points`` with 25 points each, groups of 16 pairs, the journal on)
over a synthetic stack of 1024x2048 PNG sections at scale 0.5
(:func:`synth.gen_stack`, cached on disk), its pairs at z-distance <= 3:
decoded by the port's prefetch loader (the native loader, or its header-free
resize behind cv2's decode, whichever builds: the line's ``prefetch``),
solved on the card, serialised into :class:`synth.MockRenderSink`. A warm
job of 32 pairs runs first. Gate: the emitted matches lie within 1.0
full-resolution px of the stack's known shift on the mean.

One JSON line, the keys of ``bench_job.py``'s, with ``device`` (the card's
name and power limit) and ``prefetch``. A failed gate exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import tempfile
import time

from optflow_tpu_torch.bench import (
    device_label,
    emit,
    open_device,
    platform,
    sync,
)
from optflow_tpu_torch.bench.synth import (
    MAX_DZ,
    SCALE,
    SRC_H,
    SRC_W,
    STRIP,
    MockRenderSink,
    build_job,
    gate_matches,
    gen_stack,
    stack_names,
)
from optflow_tpu_torch.engine.batch_runner import run_job_batched

WARM_PAIRS = 32


def run(job: dict, sink: MockRenderSink, dev) -> dict:
    """``job`` through ``run_job_batched`` on ``dev``, its per-pair progress
    lines dropped; the stats with ``wall``, host seconds to the last
    result."""
    sync(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = run_job_batched(job, sink=sink, device=dev)
    sync(dev)
    stats["wall"] = time.perf_counter() - t0
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="12 pairs of 128x256 sections, strips of 32 rows: "
                         "a check of the bench, not a measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    src_h, src_w, strip, n_pairs = SRC_H, SRC_W, STRIP, ns.pairs
    if ns.quick:
        src_h, src_w, strip, n_pairs = 128, 256, 32, 12

    n_frames = n_pairs // MAX_DZ + MAX_DZ + 1
    names = stack_names(gen_stack(n_frames, src_h, src_w), n_frames)
    with tempfile.TemporaryDirectory(prefix="optflow_bench_job_") as tmp:
        warm = build_job(names, WARM_PAIRS, os.path.join(tmp, "warm.jsonl"),
                         "warm", strip)
        run(warm, MockRenderSink(), dev)
        job = build_job(names, n_pairs, os.path.join(tmp, "job.jsonl"),
                        "job", strip)
        sink = MockRenderSink()
        stats = run(job, sink, dev)

    mp_per_pair = 2 * strip * (src_w * SCALE) / 1e6
    wall = stats["wall"]
    pairs = stats["pairs"]
    mp_s = pairs * mp_per_pair / wall
    gate = gate_matches(sink, job)
    rec = {
        "metric": "job-level MP-pairs/s (run_job_batched: decode->solve->"
                  "sample->sink, strip ROIs, random_points)",
        "value": mp_s,
        "unit": "MP-pairs/s",
        "vs_baseline": mp_s,
        "platform": platform(dev),
        "pairs": pairs,
        "pairs_per_s": pairs / wall,
        "wall_s": wall,
        "mp_per_pair": mp_per_pair,
        "stage_breakdown_s": {
            k: v for k, v in stats["timing"].items() if k.endswith("_s")
        },
        "batched": stats["batched"],
        "sequential": stats["sequential"],
        "uploads": stats["uploads"],
        "matches": stats["matches"],
        "sink_bytes": sink.bytes,
        **gate,
        "device": device_label(dev),
        "prefetch": stats["decoder"],
    }
    emit(rec)
    if not rec["match_ok"]:
        raise SystemExit(f"job: mean match error {rec['match_err_px']} "
                         "full-resolution px above 1.0")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
