#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths at the full width the product uses, reference
solver defaults, and holds every hand-written kernel against its plain
PyTorch version on the card:

- a style-1 job of strip-ROI pairs with ``random_points`` output through
  ``run_job_batched`` (2 strips x 16 pairs = 32 images of 256x1024): the
  level kernel;
- full-section solves and style-1 ``map`` / ``flow`` jobs of 512x1024 frames
  (1024x2048 sections at scale 0.5): the level kernel at every level, the
  finest ones included, held against the plain solver on the card;
- the per-level API, ``tvl1_flow(level_solver=default_level_solver(...))``:
  the chunk kernel's level entry;
- the two measurement tools, ``tools.kernel_ablate`` and ``tools.smem_cap``:
  the ablation kernel and the shared-memory capacity probe;
- style-1 jobs with feature pre-alignment (plain PyTorch on the card; the
  solve under it is the level kernel's);
- style 2, the average-flow stack aligner, through ``average_flow_job`` and
  the CLI: the level kernel at every pyramid level of every section;
- the global stack alignment of a production-sized match graph: the
  z-block and CG solves (plain PyTorch linear algebra on the card) and
  ``optflow align``;
- distribution over a mesh of the visible cards, or of one card entered
  four times: the pair scheduler, the row-tiled halo solve of a full
  1024x2048 section, ``run_job_batched`` on a pairs mesh (the level kernel
  once for each device and each tile), the sharded
  alignment solves, and two processes of the pod launcher;
- the port's benches (``optflow_tpu_torch/bench/``), the counterparts of the
  root ``bench*.py``, and its probes (``optflow_tpu_torch/tools/probes/``),
  the counterparts of the root ``tools/probes/``, at their full sizes: the
  level kernel on every one, the chunk kernel's level entry on the roofline;
- the native image loader, or its header-free resize behind cv2's decode
  where the loader cannot be built, which decodes every job's frames from
  files, and the deploy recipe: a wheel installed apart, which builds every kernel
  and the loader from its own sources and runs a job on the card.

Needs no file from outside the repository and no network: frames are
synthesised from a seed.

    python3 chip_smoke.py            # every phase, as the acceptance run
    python3 chip_smoke.py --phases device,build,kernels   # a subset

Phases, one JSON line each; any failure ends the run with a non-zero code:

  device   a CUDA device must be present (never carries on on the CPU)
  build    compile (one nvcc per source, together) and load the five
           kernel libraries from optflow_tpu_torch/csrc; then the image
           loader (g++, native/loader.cpp) and its header-free resize
           (native/frame.cpp): their seconds, commands and errors, and each
           library found built that did not load and was built again
  decode   the prefetch loader's native route on the card machine's host:
           the image loader, or where its image headers are missing the
           header-free route (cv2 decodes, frame.cpp resizes; a failed build
           of it where g++ is fails the run): PNG, JPEG and 8- and 16-bit
           gray and RGB TIFF frames of 1024x2048 and two odd sizes at scales
           1 and 0.5 against loader.cpp restated in numpy (0.0; JPEG against
           the Python decoder within 6 gray levels on the mean), the odd
           sizes' shapes against the lround rule, and frames a second of the
           route and of the Python decoder's pool, 8 threads each, in turns
  kernels  each kernel against its plain version on the card, with
           tolerances; the level kernel also against the blocked kernel (bit
           for bit; the blocked kernel, which no main path launches, counts
           its launches here); the chunk kernel's level
           entry, also against the level loop it replaced (PyTorch warp
           and the sweep entry, in turns), and its single chunk; the
           ablation kernel at its tool's shape and count, its launches on
           the card, its `full` variant also against the chunk kernel (bit
           for bit at 16 and 50 iterations) and against a rerun; the
           capacity probe at every size up to the card's limit and one
           above it, its kernel's time (events around the launch) beside
           its call's
  ablate   the ablation tool at (16, 256, 1024): microseconds per iteration
           of the six variants of the TV-L1 iteration
  smem_cap the capacity probe's table: sizes granted, occupancy, and the
           shared memory the kernels ask for (the replaced per-chunk
           window, the chunk kernel's one-block limit, the level grid's
           window, the ablation kernel's block)
  solve    tvl1_flow_batched at (16, 256, 1024), both EPE gates; then a
           `levels` line: per-level kernel times of a 32-image solve, the
           steps each level took on the card and how full its grid was,
           iterations computed against iterations counted, the launches
           each level enqueued and, where the profiler can trace the card,
           the kernels counted in a trace
  job      64 pairs through run_job_batched, match gate, launch count; the
           same job once more on the warm card
  cli      the same job (16 pairs) from PNG files through the CLI, when an
           image library (cv2 or PIL) is installed; else a printed skip. Its
           `done:` line must name the decode phase's route (`native` or
           `native-resize`), or the Python decoder where neither runs
  section  tvl1_flow_batched at (4, 512, 1024) and (1, 1024, 1024): the
           wrapper that launched each level (the level kernel at every
           level, the blocked kernel never), the iterations it computed
           (never fewer than counted), each level within 1e-3 px of the
           plain level solve on its own inputs and the whole flow within
           SECTION_VS_PLAIN_PX of the plain solver on the card, with equal
           counts at every level; then
           a `map` job of 8 full-section pairs and a `flow` job of 2
           through run_job_batched, TIFFs written, read back and gated
  level_api  tvl1_flow with the chunk-kernel level solver at 512x1024: one
           call into the chunk library and at most two launches per level;
           three timed runs, each started on an idle card
  features feature pre-alignment: the frame-deduplicated aligner on a
           chained stack of 17 strips with known affines (stage times), a
           job of 32 misaligned strip pairs with features on through
           run_job_batched, 16 pairs (two with the `default` ROI) through
           the CLI, and identical / flat frames
  style2   style 2 on 13 sections of 1024x2048 at scale 0.5, each displaced
           by a known jitter: 7 aligned sections, the flow toward the
           neighbourhood average gated against its truth, one section's
           solve against the plain solver on the card, 10 launches of the
           level kernel a section and none of the blocked kernel; then a
           small style-2 job from PNGs through the CLI
  align    9,604 sections at z-distance <= 3, 1.44 M matches: the z-block
           solve (translation and affine) against an exact sparse
           least-squares solve of the same equations and, for the
           translation model, the matched pairs against the truth; the CG
           solves on the first 256 sections against the z-block solve; and
           `optflow align` on a JSONL store of the affine stack
  dist     a mesh of the visible cards, or cuda:0 four times on one card
           (a line says which): 32 strip pairs through PairScheduler against
           one batched call (flows, counts, launches); a 1024x2048 section
           through tiled_tvl1_flow over 4 rows against the monolithic solve
           (every row, the seams included), ring against gather, the level
           kernel at every window level, and one window's finest, second and
           coarsest level against the plain version on the same inputs; the
           64-pair job through run_job_batched on 4 pairs devices against
           the one-device run; the sharded z-block (float64 solutions and
           the mesh call's transforms) and CG solves (4 runs each, distance
           and objective excess) of the align graph against the unsharded;
           two processes of optflow_tpu_torch.cli.run_pod on a 16-pair PNG
           job
  bench    each bench of optflow_tpu_torch/bench once, in this process, its
           line printed: solve (16, 256, 1024), job (the job phase's 64 pairs,
           not its default 512, from PNG files), the matrix's features,
           features_chained, roofline and tiled (512x512 split by rows over
           cuda:0 entered 8 times: a correctness check, as in dist), and
           scaling (the visible cards; one card: size 1, unmeasured); then
           the full-section bench (bench.section: 4x512x1024, 1x1024x1024,
           16x256x1024, each level timed) and the four probes: r4_budget
           (the solve's time budget), r4_feature_stages (pre-alignment by
           stage), r5_sample_stage (a job's device group by piece) and
           r5_transfer_cost (host<->device copies). Gates: both EPE gates,
           the match gate, both end-to-end feature gates, the tiled solve
           within 0.25 px, every roofline share <= 1.0, the roofline's plain
           solve captured as one CUDA graph equal to its eager call (a line
           gives both times and the difference), the solve line's and the
           r4_budget full row's counted pixel-iterations equal to the solve
           phase's on the same inputs, every section's EPE <= 0.5 px, the
           stages composed equal to the prealign (0.0 at the corners), the
           group's pieces equal to the whole call and every copy equal to
           its source (bit for bit), and the level kernel launched by every
           bench and probe, the chunk kernel by the roofline
  install  deploy/bootstrap_venv_torch.sh --device cuda: the wheel, an
           isolated install, its console scripts, every kernel and the host
           libraries of the decode route built from the installed tree, and a
           2-pair PNG job of 1024x2048
           sections through the installed CLI on the card (at least 10
           launches of the level kernel, the decode phase's decoder, no JAX)

Then the run's seconds, the card's name and power limit, one
``{"kernels": [...]}`` line with every kernel's launches on the main path,
its error against the plain version, its time, the plain version's time and
its bound, and the kernels and memory operations one call of its wrapper put
on the card (tallied by the library where it enqueues them), and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from optflow_tpu_torch.bench.roofline import (
    PEAK_BYTES_PER_S,
    chunk_bound_ms,
    level_bound_ms,
)
from optflow_tpu_torch.bench.synth import (
    BATCH as SOLVE_BATCH,
    DX,
    DX_STEP,
    DY,
    DY_STEP,
    H as SOLVE_H,
    MAX_DZ,
    SCALE,
    SRC_H,
    SRC_W,
    STRIP,
    W as SOLVE_W,
    MockRenderSink,
    build_job,
    gen_sections,
    make_pair,
    match_errors,
    oracle_flow,
)

ALL_PHASES = ("device", "build", "decode", "kernels", "ablate", "smem_cap",
              "solve", "job", "cli", "section", "level_api", "features",
              "style2", "align", "dist", "bench", "install")
KERNEL_STEMS = ("tvl1_level", "tvl1_blocked", "tvl1_chunk", "tvl1_ablate",
                "smem_cap")

# every kernel of the port: its source, the body of the TPU kernel it
# replaces, and the phases whose launches the kernels line counts (its main
# paths; the blocked kernel has none)
KERNELS = {
    "tvl1_level_solve": {
        "source": "optflow_tpu_torch/csrc/tvl1_level.cu",
        "replaces": "optflow_tpu/ops/tvl1_pallas.py:226",
        "launches_on": "job, section map job, style2, dist, bench",
    },
    "tvl1_blocked_level_solve": {
        "source": "optflow_tpu_torch/csrc/tvl1_blocked.cu",
        "replaces": "optflow_tpu/ops/tvl1_pallas.py:777",
        "launches_on": "kernels",
    },
    "tvl1_chunk": {
        "source": "optflow_tpu_torch/csrc/tvl1_chunk.cu",
        "replaces": "optflow_tpu/ops/tvl1_pallas.py:1250",
        "launches_on": "level_api, bench (roofline)",
    },
    "tvl1_ablate_chunks": {
        "source": "optflow_tpu_torch/csrc/tvl1_ablate.cu",
        "replaces": "tools_kernel_ablate.py:39",
        "launches_on": "ablate",
    },
    "smem_fill_mean": {
        "source": "optflow_tpu_torch/csrc/smem_cap.cu",
        "replaces": "tools/probes/r4_vmem_cap.py:17",
        "launches_on": "smem_cap",
    },
}
# One multiprocessor's shared memory moves 32 banks x 4 B a clock; the clock
# is the one the CUDA runtime reports for the card (cudaDevAttrClockRate).
SMEM_BYTES_PER_CLOCK = 128

# the solve phase's pairs and the job phase's geometry are the benches'
# (optflow_tpu_torch/bench/synth.py)
SECTION_H, SECTION_W = int(SRC_H * SCALE), int(SRC_W * SCALE)  # 512 x 1024
# section phase: the two full-section solves, (batch, height, width)
SECTION_SOLVES = ((4, SECTION_H, SECTION_W), (1, 1024, 1024))
# A whole section pyramid against the plain solver on the card, every
# level's count equal. Each level, held at 1e-3 px on its own inputs,
# rounds otherwise than plain (FMA contraction in the kernel); over ten
# levels that compounds to 1.94e-3 px at the worst of 2 M pixels at
# (4, 512, 1024) on an H100 (5.6e-6 px in the mean). 0.01 px is the
# tolerance of the repo's other whole-pyramid comparisons on the card
# (`style2`, the card-marked test in tests/test_torch_align.py); an exit
# rule that stops elsewhere moves the flow by ~0.1 px.
SECTION_VS_PLAIN_PX = 1e-2
# style2 phase: 13 sections of the job phase's geometry give 7 outputs (each
# needs 3 neighbours a side); each section displaced by a known jitter
STYLE2_SECTIONS = 13
STYLE2_JITTER_PX = 1.5
STYLE2_BORDER = 16  # the job's zero pad around each output, px
# align phase: the Sec26 VNC production graph (SURVEY.md:329), z 1..9604 at
# z-distance <= 3; a pair's matches are a job's random_points output, 25
# points in each of its two strip ROIs
ALIGN_SECTIONS = 9604
ALIGN_MAX_DZ = 3
ALIGN_NPOINTS = 25
ALIGN_NOISE_PX = 0.1
ALIGN_BLOCK = 256  # block_sections of the z-block solve (the CLI default)
ALIGN_CG_SECTIONS = 256
# The JAX package's affine CG (solve_affine_alignment, its default 400
# iterations) on the first ALIGN_CG_SECTIONS sections of the affine stack
# stops this far (relative objective excess) above the exact optimum: it
# does not converge there. The port's CG is held to it; the JAX package's
# reading on the CPU is recomputed by tests/test_torch_align.py.
AFFINE_CG_JAX_EXCESS = 29.556948


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def make_level_inputs(n, h, w, seed, shift=1.0, flow_amp=1.5):
    """Images and a smooth non-zero entry flow for a level solve: ``n``
    pairs cut from one texture pair, made from a numpy seed."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    hh, ww = h + 8, w + 8 * n
    im0, im1 = make_pair(hh, ww, shift, -0.6 * shift, seed=seed)
    i0 = np.stack([im0[4:4 + h, 8 * k:8 * k + w] for k in range(n)])
    i1 = np.stack([im1[4:4 + h, 8 * k:8 * k + w] for k in range(n)])
    u = ndi.gaussian_filter(rng.standard_normal((2, h, w)), 6.0)
    u = flow_amp * u / (np.abs(u).max() + 1e-9)
    u1 = np.broadcast_to(u[0], (n, h, w)) + shift * 0.5
    u2 = np.broadcast_to(u[1], (n, h, w))
    return (np.ascontiguousarray(a, dtype=np.float32)
            for a in (i0, i1, u1, u2))


def time_cuda(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace_device(fn):
    """What the card did during ``fn()``, from a torch.profiler trace of the
    device: ``busy_ms``, the sum of every kernel's and copy's duration (set
    beside the untraced time of the same work it says how much of that time
    no kernel was running; a block that waits at a barrier inside a kernel
    counts as busy); ``kernels``, kernel name -> times it was launched;
    ``memops``, the memsets and copies. ``busy_ms`` is None, with the reason
    in ``note``, when the profiler cannot trace this machine's card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    except Exception as e:  # the tracer, not the port: report, go on
        return {"busy_ms": None, "kernels": {}, "memops": 0,
                "note": f"torch.profiler failed: {e}"}
    total_us = sum(e.self_device_time_total for e in rows)
    if total_us <= 0:
        return {"busy_ms": None, "kernels": {}, "memops": 0,
                "note": "torch.profiler recorded no device time"}

    def is_memop(e):
        return e.key.startswith(("Memset", "Memcpy"))

    return {"busy_ms": total_us / 1e3,
            "kernels": {e.key: e.count for e in rows if not is_memop(e)},
            "memops": sum(e.count for e in rows if is_memop(e)),
            "note": "device events of a torch.profiler trace"}


def enqueued_launches(fn):
    """Kernel launches and memory operations (memsets, copies) that the
    package's libraries put on the card during one ``fn()``: (kernels,
    memops), the difference of the tallies each library keeps where it
    enqueues them. It needs no tracer, so it is the same on every machine;
    PyTorch's own operations (none inside a kernel wrapper but allocations)
    are not in it. It returns once the card has run them, so a timer
    started next does not time their tail."""
    import torch

    from optflow_tpu_torch.ops._build import enqueued

    k0, m0 = enqueued()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    k1, m1 = enqueued()
    return k1 - k0, m1 - m0


def kernel_wrappers():
    """name -> wrapper, for the launch counts. The chunk kernel has three:
    one chunk a call, a whole level a call (the per-level API's), and the
    replaced sweep a call."""
    from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
        tvl1_blocked_level_solve,
    )
    from optflow_tpu_torch.ops.smem_cap_cuda import smem_fill_mean
    from optflow_tpu_torch.ops.tvl1_ablate_cuda import tvl1_ablate_chunks
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import (
        tvl1_chunk,
        tvl1_chunk_level_solve,
        tvl1_chunk_sweep,
    )
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_level_solve

    return {"tvl1_level_solve": tvl1_level_solve,
            "tvl1_blocked_level_solve": tvl1_blocked_level_solve,
            "tvl1_chunk": tvl1_chunk,
            "tvl1_chunk_level_solve": tvl1_chunk_level_solve,
            "tvl1_chunk_sweep": tvl1_chunk_sweep,
            "tvl1_ablate_chunks": tvl1_ablate_chunks,
            "smem_fill_mean": smem_fill_mean}


def zero_launch_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launch_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def max_abs_diff(a, b):
    return float((a - b).abs().max())


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    card = gpu_name_and_limit()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "name_power_limit": card})
    print(card, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else ""


def phase_build():
    from optflow_tpu_torch.ops import (
        _build,
        smem_cap_cuda,
        tvl1_ablate_cuda,
        tvl1_blocked_cuda,
        tvl1_chunk_cuda,
        tvl1_cuda,
    )

    from optflow_tpu_torch import native
    from optflow_tpu_torch.native import frame

    stems = KERNEL_STEMS
    t0 = time.perf_counter()
    _build.build_libraries(stems)  # one nvcc per source, started together
    for mod in (tvl1_cuda, tvl1_blocked_cuda, tvl1_chunk_cuda,
                tvl1_ablate_cuda, smem_cap_cuda):
        mod._library()
    secs = time.perf_counter() - t0
    # the image loader and its header-free resize, with the host compiler,
    # after the kernels so that their seconds are their own; a failure is the
    # decode phase's to judge
    host = {}
    for stem, mod in (("loader", native), ("frame", frame)):
        t0 = time.perf_counter()
        error = mod.build_error()
        path = _build.library_path(stem)
        host[stem] = {
            "library": os.path.relpath(path, os.getcwd()),
            "compiled": stem in _build.build_seconds,
            "seconds": time.perf_counter() - t0,
            "command": " ".join(_build.compile_command(stem, path)),
            "error": error,
        }
    libs = {}
    for stem in stems:
        path = _build.library_path(stem)
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        libs[stem] = {
            "library": os.path.relpath(path, os.getcwd()),
            "compiled": stem in _build.build_seconds,
            # registers, shared memory and spills of every kernel
            "ptxas": [ln.strip() for ln in lines
                      if "registers" in ln or "spill" in ln][-16:],
        }
    # libraries found built but refused by the dynamic loader (built on
    # another machine, or truncated), each moved aside and built once more
    emit({"phase": "build", "seconds": round(secs, 3), "libraries": libs,
          **host, "rebuilt_after_load_error": dict(_build.rebuilds)})


# decode phase: frames of the job's source geometry, and two sizes whose
# scaled sides end in .5 (the loader rounds them half up, cv2 to even)
DECODE_FRAMES = 64
DECODE_ODD_SIZES = ((1025, 2049), (73, 75))
DECODE_THREADS = 8


def loader_resize(img, scale):
    """``resize_bilinear`` of optflow_tpu_torch/native/loader.cpp restated in
    numpy, float32 statement for statement (the half-pixel rule, clamped
    sources, ``std::lround`` sizes)."""
    import math

    f32 = np.float32
    img = img.astype(f32)
    s = f32(scale)
    if s == f32(1.0):
        return img
    h, w = img.shape
    # std::lround of the float product, a positive number
    nh = int(math.floor(float(f32(h) * s) + 0.5))
    nw = int(math.floor(float(f32(w) * s) + 0.5))

    def taps(n_out, n_in):
        f = (np.arange(n_out, dtype=f32) + f32(0.5)) * (f32(n_in) / f32(n_out))
        f = f - f32(0.5)
        f = np.minimum(np.maximum(f, f32(0)), f32(n_in - 1))
        i0 = np.minimum(f.astype(np.int64), n_in - 2)
        return i0, f - i0.astype(f32)

    y0, wy = taps(nh, h)
    x0, wx = taps(nw, w)
    r0, r1 = img[y0], img[y0 + 1]
    top = r0[:, x0] + wx * (r0[:, x0 + 1] - r0[:, x0])
    bot = r1[:, x0] + wx * (r1[:, x0 + 1] - r1[:, x0])
    return top + wy[:, None] * (bot - top)


def loader_tiff_luma(r, g=None, b=None):
    """``decode_tiff``'s BT.601 luma of 8-bit samples (a gray image: r = g =
    b), rounded to the nearest even as ``std::nearbyint`` does, in float32
    and in the source's order of operations."""
    f32 = np.float32
    r = r.astype(f32)
    g = r if g is None else g.astype(f32)
    b = r if b is None else b.astype(f32)
    return np.rint(f32(0.299) * r + f32(0.587) * g + f32(0.114) * b)


def write_image(path, arr, **jpeg):
    """Write ``arr`` with cv2, or PIL where cv2 is not installed."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        rgb = arr[..., ::-1] if arr.ndim == 3 else arr  # from OpenCV's order
        Image.fromarray(np.ascontiguousarray(rgb)).save(path, **jpeg)
        return
    params = [cv2.IMWRITE_JPEG_QUALITY, jpeg["quality"]] if jpeg else []
    if not cv2.imwrite(path, arr, params):
        fail(f"could not write {path}")


def decode_route():
    """The prefetch loader's route on this machine and its decoder (submit /
    wait / close): the native loader where it builds, else the header-free
    route where the host compiler is (a failed build of it fails the run),
    else (None, None)."""
    from optflow_tpu_torch import native
    from optflow_tpu_torch.engine import prefetch
    from optflow_tpu_torch.native import frame

    if native.available():
        return "native", native.NativeLoader(DECODE_THREADS)
    try:
        if frame.available():
            return "native-resize", prefetch._PoolDecoder(frame.load,
                                                          DECODE_THREADS)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr, flush=True)
        fail("decode: the host compiler is here, and the header-free frame "
             "library did not build")
    return None, None


def phase_decode(tmp):
    """The prefetch loader's native route on the card machine's host: the
    native loader, or where its image headers are missing the header-free
    route (cv2 decodes, native/frame.cpp resizes). Its frames held against
    the numpy restatement of loader.cpp (0.0 for PNG and TIFF, the Python
    decoder's within 6 gray levels on the mean for JPEG) at scales 1 and
    0.5, the shapes of the odd sizes, and frames a second of the route and
    of the Python decoder's pool, both with DECODE_THREADS threads. These
    are host CPU times, not the card's."""
    import math
    from concurrent.futures import ThreadPoolExecutor

    import scipy.ndimage as ndi

    from optflow_tpu_torch import native
    from optflow_tpu_torch.core import imgio

    folder = os.path.join(tmp, "decode")
    os.makedirs(folder)
    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    tex = ndi.gaussian_filter(
        rng.standard_normal((SRC_H, SRC_W + DECODE_FRAMES)), 2.0)
    tex = (20 + 215 * (tex - tex.min()) / np.ptp(tex)).astype(np.uint8)
    frames, pngs = [], []
    for z in range(DECODE_FRAMES):
        frame = np.ascontiguousarray(tex[:, z:z + SRC_W])
        frame = frame + rng.integers(0, 4, frame.shape, dtype=np.uint8)
        path = os.path.join(folder, f"sec_{z:04d}.png")
        write_image(path, frame)
        frames.append(frame)
        pngs.append(path)
    # (kind, path, the decode restated, the source)
    cases = [("png", pngs[z], frames[z].astype(np.float32)) for z in range(4)]
    for z in range(4):
        # an RGB section: three channels the luma weighs apart (written in
        # OpenCV's order, blue first)
        red, green, blue = frames[z], 255 - frames[z], frames[z] // 2
        bgr = np.ascontiguousarray(np.dstack([blue, green, red]))
        for kind, ext, arr, want in (
                ("jpeg", "jpg", frames[z], None),
                ("tiff8", "tiff", frames[z], loader_tiff_luma(frames[z])),
                # v * 257 + z is v after libtiff's reduction of a 16-bit
                # sample, whether it keeps the high byte or rounds v / 257
                ("tiff16", "tiff",
                 frames[z].astype(np.uint16) * 257 + z,
                 loader_tiff_luma(frames[z])),
                ("tiff_rgb8", "tiff", bgr, loader_tiff_luma(red, green, blue)),
                ("tiff_rgb16", "tiff", bgr.astype(np.uint16) * 257 + z,
                 loader_tiff_luma(red, green, blue))):
            path = os.path.join(folder, f"{kind}_{z}.{ext}")
            write_image(path, arr, **({"quality": 95} if kind == "jpeg"
                                      else {}))
            cases.append((kind, path, want))
    odd = []
    tall = np.pad(tex, ((0, 8), (0, 0)), mode="reflect")
    for h, w in DECODE_ODD_SIZES:
        arr = np.ascontiguousarray(tall[:h, :w])
        path = os.path.join(folder, f"odd_{h}x{w}.png")
        write_image(path, arr)
        cases.append(("png", path, arr.astype(np.float32)))
        odd.append((h, w, path))
    write_s = time.perf_counter() - t0

    def fps(decode_all):
        t0 = time.perf_counter()
        out = decode_all()
        return len(out) / (time.perf_counter() - t0), out

    def pool_all():
        with ThreadPoolExecutor(DECODE_THREADS) as pool:
            return list(pool.map(imgio.read_gray_scaled, pngs,
                                 [SCALE] * len(pngs)))

    # host clocks vary: the route and the pool are timed in turns (pool,
    # route, route, pool) and each reads the mean of its two rates
    pool_fps = [fps(pool_all)[0]]
    line = {"phase": "decode", "host": "the card machine's CPU",
            "threads": DECODE_THREADS, "frames": DECODE_FRAMES,
            "frame": [SRC_H, SRC_W], "scale": SCALE,
            "python_decoder": imgio.decoder_name(),
            "cv2": getattr(imgio._get_cv2(), "__version__", None),
            "write_s": write_s, "native": native.available()}
    if not native.available():
        error = native.build_error()
        print(f"chip_smoke: the native loader did not build:\n{error}",
              file=sys.stderr, flush=True)
        line.update(build_error=error[-2000:],
                    missing_header=native.missing_header())
        if line["missing_header"] is None:
            emit(line)
            fail("decode: the native loader did not build, and no header it "
                 "needs is missing")
    route, decoder = decode_route()
    if decoder is None:  # no host compiler or no cv2: the pool alone
        pool_fps.append(fps(pool_all)[0])
        emit({**line, "route": imgio.decoder_name(),
              "pool_frames_per_s": float(np.mean(pool_fps))})
        return
    try:
        def route_all():
            handles = [decoder.submit(p, SCALE) for p in pngs]
            return [decoder.wait(h) for h in handles]

        def load(path, scale):
            return decoder.wait(decoder.submit(path, scale))

        route_fps, got = fps(route_all)
        route_fps = [route_fps, fps(route_all)[0]]
        pool_fps.append(fps(pool_all)[0])
        errs = {}
        for scale in (1.0, SCALE):
            for kind, path, want in cases:
                out = load(path, scale)
                if want is None:  # JPEG: the Python decoder's decode
                    want = imgio.read_gray(path).astype(np.float32)
                    err = float(np.abs(out - loader_resize(want, scale))
                                .mean())
                else:
                    ref = loader_resize(want, scale)
                    err = (float(np.abs(out - ref).max())
                           if out.shape == ref.shape else math.inf)
                key = f"{kind}@{scale}"
                errs[key] = max(errs.get(key, 0.0), err)
        shapes = {}
        for h, w, path in odd:
            want = (int(math.floor(float(np.float32(h) * np.float32(SCALE))
                                   + 0.5)),
                    int(math.floor(float(np.float32(w) * np.float32(SCALE))
                                   + 0.5)))
            shapes[f"{h}x{w}"] = {
                "route": list(load(path, SCALE).shape),
                "lround": list(want),
                "python": list(imgio.read_gray_scaled(path, SCALE).shape)}
    finally:
        decoder.close()
    emit({**line, "route": route,
          "route_frames_per_s": float(np.mean(route_fps)),
          "pool_frames_per_s": float(np.mean(pool_fps)),
          "turns_frames_per_s": [pool_fps[0], *route_fps, pool_fps[1]],
          "err": errs, "err_is": "max abs; mean abs for jpeg",
          "gates": {"png, tiff": 0.0, "jpeg": 6.0}, "shapes": shapes})
    bad = [k for k, e in errs.items()
           if not (e < 6.0 if k.startswith("jpeg") else e == 0.0)]
    if bad:
        fail(f"decode: the {route} frames differ from loader.cpp restated: "
             f"{ {k: errs[k] for k in bad} }")
    if any(v["route"] != v["lround"] for v in shapes.values()):
        fail(f"decode: odd sizes off the lround rule: {shapes}")
    if len(got) != DECODE_FRAMES or any(
            g.shape != (SECTION_H, SECTION_W) for g in got):
        fail("decode: the timed frames have the wrong shape")


def phase_kernels(results):
    zero_launch_counts()
    results["kernel_cases"] = {
        "tvl1_level_solve": kernels_level(),
        "tvl1_blocked_level_solve": kernels_blocked(),
        "tvl1_chunk": kernels_chunk(),
        "tvl1_ablate_chunks": kernels_ablate(),
        "smem_fill_mean": kernels_smem(),
    }
    # no main path launches the blocked kernel: its launches are this
    # phase's, against its plain version, the level kernel and itself
    results.setdefault("launches", {})["tvl1_blocked_level_solve"] = (
        read_launch_counts()["tvl1_blocked_level_solve"])


def time_in_turns(old_fn, new_fn, reps=2):
    """Two versions timed within one process on one card, in turns: old,
    new, new, old. Returns (old ms, new ms), each the mean of its two
    timings, and the four timings in order."""
    order = (old_fn, new_fn, new_fn, old_fn)
    ms = [time_cuda(fn, reps) for fn in order]
    return (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2, ms


def flow_diff(a, b):
    return max(max_abs_diff(a[0], b[0]), max_abs_diff(a[1], b[1]))


def kernels_level():
    """The level kernel (csrc/tvl1_level.cu: the persistent grid with the
    exact exit) against its plain version, the plain emulation of its control
    flow and the blocked kernel (the same grid, an exit every 16)."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
        tvl1_blocked_level_solve,
    )
    from optflow_tpu_torch.ops.tvl1_cuda import (
        LEVEL_SCHEDULE,
        level_max_steps,
        tvl1_level_solve,
        tvl1_level_solve_plain,
        tvl1_level_solve_schedule_plain,
    )

    dev = torch.device("cuda")
    # Tolerance of the fixed-count comparison: kernel and plain version do
    # the same float32 arithmetic in another order (nvcc contracts to FMA),
    # and 50 accumulating iterations amplify the last-bit differences. The
    # blocked kernel runs the same device code: 0.0.
    tol_fixed = 1e-3
    fixed = TVL1Params(nscales=1, warps=2, iterations=25, epsilon=0.0)
    full = TVL1Params(nscales=1)
    cases = []
    main_case = None
    for shape in ((3, 37, 53), (32, 43, 171), (32, 256, 1024)):
        n, h, w = shape
        args = tuple(
            torch.from_numpy(a).to(dev)
            for a in make_level_inputs(n, h, w, seed=11 + h)
        )
        before = tvl1_level_solve.launches
        k = tvl1_level_solve(*args, fixed)
        steps, grid = tvl1_level_solve.last_steps[:2].tolist()
        torch.cuda.synchronize()
        if tvl1_level_solve.launches != before + 1:
            fail("the wrapper did not count its launch")
        p = tvl1_level_solve_plain(*args, fixed)
        blocked = tvl1_blocked_level_solve(*args, fixed)
        torch.cuda.synchronize()
        diff = flow_diff(k, p)
        finite = bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all())
        moved = max_abs_diff(k[0], args[2])
        iters_equal = bool((k[2] == p[2]).all() and (k[2] == blocked[2]).all())
        kernel_ms = time_cuda(lambda: tvl1_level_solve(*args, fixed), 2)
        plain_ms = time_cuda(lambda: tvl1_level_solve_plain(*args, fixed), 2)
        total_iters = int(k[2].sum())
        bound, bound_by = level_bound_ms(n, h, w, fixed.warps, total_iters)
        launched, memops = enqueued_launches(
            lambda: tvl1_level_solve(*args, fixed))
        case = {
            "kernel": "tvl1_level_solve", "shape": list(shape),
            "warps": fixed.warps, "iterations": fixed.iterations,
            "epsilon": 0.0, "max_abs_du": diff, "tolerance": tol_fixed,
            "max_abs_du_vs_blocked_kernel": flow_diff(k, blocked),
            "flow_moved_px": moved, "iters_equal": iters_equal,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            # kernels and memsets/copies one call put on the card, tallied
            # by the library; the steps its sweeps took inside the kernel,
            # and the blocks of its grid, as the kernel reports them
            "device_launches": launched, "device_memops": memops,
            "grid_steps": steps, "grid_blocks": grid,
            "grid_steps_at_most":
            level_max_steps(fixed.warps, fixed.iterations),
        }
        cases.append(case)
        if not finite or not diff <= tol_fixed:
            emit({"phase": "kernels", "cases": cases})
            fail(f"kernel differs from its plain version at {shape}: "
                 f"max|du| {diff} > {tol_fixed}")
        if case["max_abs_du_vs_blocked_kernel"] != 0.0:
            emit({"phase": "kernels", "cases": cases})
            fail(f"at epsilon 0 the level kernel must equal the blocked "
                 f"kernel bit for bit at {shape}")
        if not iters_equal or moved < 1e-3:
            emit({"phase": "kernels", "cases": cases})
            fail(f"kernel iteration count or flow update wrong at {shape}")
        if shape == (32, 256, 1024):
            main_case = case

        # full counts with the per-image exit, epsilon 0.01; a rerun must give
        # the same bits (no atomics). The counts, at the small shape, against
        # the plain emulation of the kernel's control flow, which adds its
        # sums in PyTorch's order without FMA: an image within rounding of
        # its threshold may stop an iteration apart, so no image more than 1
        # apart and at most one image in 16 apart at all (none was seen);
        # where the counts agree the emulation must have computed the same
        # iterations, speculation and replay included.
        if shape == (3, 37, 53):
            continue
        k = tvl1_level_solve(*args, full)
        work = tvl1_level_solve.last_work
        steps, grid = tvl1_level_solve.last_steps[:2].tolist()
        again = tvl1_level_solve(*args, full)
        torch.cuda.synchronize()
        kernel_ms = time_cuda(lambda: tvl1_level_solve(*args, full), 2)
        launched, memops = enqueued_launches(
            lambda: tvl1_level_solve(*args, full))
        eps_case = {
            "kernel": "tvl1_level_solve", "shape": list(shape),
            "warps": full.warps, "iterations": full.iterations,
            "epsilon": full.epsilon, "iters_sum": int(k[2].sum()),
            "iters_computed_sum": int(work[0].sum()),
            "iters_min_max": [int(k[2].min()), int(k[2].max())],
            "rerun_bit_identical": torch.equal(k[0], again[0])
            and torch.equal(k[1], again[1]) and torch.equal(k[2], again[2]),
            "kernel_ms": kernel_ms,
            "device_launches": launched, "device_memops": memops,
            "grid_steps": steps, "grid_blocks": grid,
            "grid_steps_at_most":
            level_max_steps(full.warps, full.iterations),
        }
        against = {}
        if n * h * w <= 1 << 18:
            e = tvl1_level_solve_schedule_plain(*args, full)
            against["emulation"] = e[2]
            agree = k[2] == e[2]
            eps_case["iters_equal_emulation"] = bool(agree.all())
            eps_case["computed_equal_emulation"] = torch.equal(work[0], e[3])
            eps_case["computed_equal_emulation_where_counts_agree"] = \
                torch.equal(work[0][agree], e[3][agree])
            eps_case["max_abs_du_vs_emulation"] = flow_diff(k, e)
            eps_case["tolerance_vs_emulation"] = tol_fixed
        cases.append(eps_case)
        for name, counts in against.items():
            apart = (k[2] - counts).abs()
            eps_case[f"iters_apart_{name}_max_images"] = [
                int(apart.max()), int((apart > 0).sum())]
            if int(apart.max()) > 1 or int((apart > 0).sum()) > n // 16:
                emit({"phase": "kernels", "cases": cases})
                fail(f"iteration counts at {shape} differ from the {name}'s: "
                     f"{k[2].tolist()} vs {counts.tolist()}")
        if not eps_case.get("computed_equal_emulation_where_counts_agree",
                            True):
            emit({"phase": "kernels", "cases": cases})
            fail(f"iterations computed at {shape} differ from the "
                 f"emulation's: {work[0].tolist()} vs {e[3].tolist()}")
        if not eps_case.get("max_abs_du_vs_emulation", 0.0) <= tol_fixed:
            emit({"phase": "kernels", "cases": cases})
            fail(f"flow at {shape} differs from the emulation's by "
                 f"{eps_case['max_abs_du_vs_emulation']}")
        if not eps_case["rerun_bit_identical"]:
            emit({"phase": "kernels", "cases": cases})
            fail(f"two runs of the level kernel differ at {shape}")
        if not bool((work[0] >= k[2]).all()):
            emit({"phase": "kernels", "cases": cases})
            fail(f"fewer iterations computed than counted at {shape}")
        del k, p, blocked, again, args

    # The per-image exit against the plain version on four images that stop
    # at different counts. Kernel and plain version sum every iteration's
    # error in another order and differ in the last bits of the flow (FMA),
    # so an image within rounding of its threshold could stop an iteration
    # apart. The sums are added in a fixed order and equal counts were seen
    # in every run on an H100, so equal counts are the gate: a replay from
    # the wrong buffer or one iteration short shows here. Solutions within 0.01 px of mean
    # end-point error, the flow within 1e-3 px at every pixel.
    n, h, w = 4, 256, 1024
    i0, i1, u1, u2, truth_x = eps_exit_inputs(dev, h, w)
    k1, k2, kit = tvl1_level_solve(i0, i1, u1, u2, full)
    work = tvl1_level_solve.last_work
    torch.cuda.synchronize()
    eps_kernel_ms = time_cuda(lambda: tvl1_level_solve(i0, i1, u1, u2, full),
                              2)
    eps_plain_ms = time_cuda(
        lambda: tvl1_level_solve_plain(i0, i1, u1, u2, full), 1)
    p1, p2, pit = tvl1_level_solve_plain(i0, i1, u1, u2, full)
    truth_y = -0.6 * truth_x

    def epe(a, b):
        return float(torch.hypot(a - truth_x, b - truth_y).mean())

    kit_l, pit_l = kit.tolist(), pit.tolist()
    margin = [0] * n
    epe_k, epe_p = epe(k1, k2), epe(p1, p2)
    eps_case = {
        "kernel": "tvl1_level_solve", "shape": [n, h, w], "warps": full.warps,
        "iterations": full.iterations, "epsilon": full.epsilon,
        "iters_kernel": kit_l, "iters_plain": pit_l, "iters_margin": margin,
        "iters_computed": work[0].tolist(),
        "epe_kernel": epe_k, "epe_plain": epe_p, "epe_diff_tolerance": 0.01,
        "mean_abs_du": float(((k1 - p1).abs() + (k2 - p2).abs()).mean() / 2),
        "max_abs_du": flow_diff((k1, k2), (p1, p2)), "tolerance": tol_fixed,
        "kernel_ms": eps_kernel_ms, "plain_ms": eps_plain_ms,
    }
    cases.append(eps_case)
    emit({"phase": "kernels", "cases": cases})
    if any(abs(a - b) > m for a, b, m in zip(kit_l, pit_l, margin)):
        fail(f"per-image iteration counts differ: {kit_l} vs {pit_l}")
    if len(set(kit_l)) < 2:
        fail(f"images were expected to stop at different counts: {kit_l}")
    if not abs(epe_k - epe_p) <= 0.01:
        fail(f"EPE of kernel {epe_k} and plain version {epe_p} differ")
    if not eps_case["max_abs_du"] <= tol_fixed:
        fail(f"flow of kernel and plain version differ by "
             f"{eps_case['max_abs_du']} px at equal counts")
    if any(not 0 <= c - i <= 2 * max(LEVEL_SCHEDULE) * full.warps
           for c, i in zip(work[0].tolist(), kit_l)):
        fail(f"iterations computed {work[0].tolist()} against counted "
             f"{kit_l}: at most one chunk run past the exit and one replay "
             f"a sweep")
    return main_case


def eps_exit_inputs(dev, h, w):
    """Four images that meet the epsilon exit at different iterations: shifts
    of 0.4 to 1.6 px, zero entry flow. Returns (i0, i1, u1, u2, truth_x)."""
    import torch

    shifts = (0.4, 0.8, 1.2, 1.6)
    parts = [make_level_inputs(1, h, w, seed=100 + k, shift=s, flow_amp=0.0)
             for k, s in enumerate(shifts)]
    i0, i1, u1, u2 = (
        torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(*parts)
    )
    truth_x = torch.tensor(shifts, device=dev)[:, None, None]
    return i0, i1, torch.zeros_like(u1), torch.zeros_like(u2), truth_x


def kernels_blocked():
    """The blocked level kernel (csrc/tvl1_blocked.cu: the persistent grid
    with an exit every k = 16 iterations, the counterpart of the JAX
    package's blocked kernel; no main path launches it) against its plain
    version and the level kernel, at a full section's finest level and at a
    level only 2-D tiling can take, 2 x 32 iterations and full counts."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
        BLOCKED_K,
        tvl1_blocked_level_solve,
        tvl1_blocked_level_solve_plain,
    )
    from optflow_tpu_torch.ops.tvl1_cuda import (
        level_max_steps,
        tvl1_level_solve,
    )

    new = tvl1_blocked_level_solve
    dev = torch.device("cuda")
    # Fixed counts, epsilon 0: kernel, plain version and level kernel do the
    # same float32 arithmetic (FMA contraction and the order of nothing
    # else differ), 64 accumulating iterations. The level kernel runs the
    # same device code on the same tiles' pixels: 0.0.
    tol = 1e-3
    fixed = TVL1Params(nscales=1, warps=2, iterations=32, epsilon=0.0)
    full = TVL1Params(nscales=1)
    cases = []
    main_case = None
    for shape in ((4, SECTION_H, SECTION_W), (1, 512, 8192)):
        n, h, w = shape
        args = tuple(
            torch.from_numpy(a).to(dev)
            for a in make_level_inputs(n, h, w, seed=31 + w)
        )
        before = new.launches
        k = new(*args, fixed)
        steps, grid = new.last_steps[:2].tolist()
        torch.cuda.synchronize()
        if new.launches != before + 1:
            fail("the blocked wrapper did not count its launch")
        p = tvl1_blocked_level_solve_plain(*args, fixed)
        a = tvl1_level_solve(*args, fixed)
        again = new(*args, fixed)
        torch.cuda.synchronize()
        diff = flow_diff(k, p)
        finite = bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all())
        ms = time_cuda(lambda: new(*args, fixed), 3)
        a_ms = time_cuda(lambda: tvl1_level_solve(*args, fixed), 3)
        plain_ms = time_cuda(
            lambda: tvl1_blocked_level_solve_plain(*args, fixed), 1)
        bound, bound_by = level_bound_ms(n, h, w, fixed.warps,
                                         int(k[2].sum()))
        launched, memops = enqueued_launches(lambda: new(*args, fixed))
        case = {
            "kernel": "tvl1_blocked_level_solve", "shape": list(shape),
            "warps": fixed.warps, "iterations": fixed.iterations,
            "k": BLOCKED_K, "epsilon": 0.0, "max_abs_du": diff,
            "max_abs_du_vs_level_kernel": flow_diff(k, a), "tolerance": tol,
            "flow_moved_px": max_abs_diff(k[0], args[2]),
            "rerun_bit_identical": all(
                torch.equal(x, y) for x, y in zip(k, again)),
            "iters": k[2].tolist(), "kernel_ms": ms,
            "level_kernel_ms": a_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            # kernels and memsets/copies of one call, tallied by the library
            "device_launches": launched, "device_memops": memops,
            "grid_steps": steps, "grid_blocks": grid,
            "grid_steps_at_most":
            level_max_steps(fixed.warps, fixed.iterations, BLOCKED_K),
        }
        cases.append(case)
        if not finite or not diff <= tol:
            emit({"phase": "kernels", "cases": cases})
            fail(f"blocked kernel at {shape}: max|du| {diff} against its "
                 f"plain version, tolerance {tol}")
        if case["max_abs_du_vs_level_kernel"] != 0.0 \
                or not case["rerun_bit_identical"]:
            emit({"phase": "kernels", "cases": cases})
            fail(f"at epsilon 0 the blocked kernel must equal the level "
                 f"kernel and its own rerun bit for bit at {shape}")
        if not all(torch.equal(k[2], x[2]) for x in (p, a)) \
                or case["flow_moved_px"] < 1e-3 or launched != 1:
            emit({"phase": "kernels", "cases": cases})
            fail(f"blocked kernel iteration count, flow update or launches "
                 f"wrong at {shape}")
        if main_case is None:
            main_case = case

        # Full counts, epsilon 0.01. The kernel adds a test's tile sums in
        # tile order on tiles of even height, the plain version in
        # PyTorch's order: an image within rounding of its threshold may
        # stop one chunk (k iterations) apart. Reported; gated at one image
        # at most. Nothing is speculated: iterations computed equal those
        # counted.
        k = new(*args, full)
        work = new.last_work
        steps, grid = new.last_steps[:2].tolist()
        again = new(*args, full)
        p = tvl1_blocked_level_solve_plain(*args, full)
        torch.cuda.synchronize()
        ms = time_cuda(lambda: new(*args, full), 2)
        plain_ms = time_cuda(
            lambda: tvl1_blocked_level_solve_plain(*args, full), 1)
        bound, bound_by = level_bound_ms(n, h, w, full.warps, int(k[2].sum()))
        launched, memops = enqueued_launches(lambda: new(*args, full))
        eps_case = {
            "kernel": "tvl1_blocked_level_solve", "shape": list(shape),
            "warps": full.warps, "iterations": full.iterations,
            "k": BLOCKED_K, "epsilon": full.epsilon,
            "iters_kernel": k[2].tolist(), "iters_plain": p[2].tolist(),
            "iters_computed": work[0].tolist(),
            "max_abs_du": flow_diff(k, p), "tolerance": tol,
            "rerun_bit_identical": all(
                torch.equal(x, y) for x, y in zip(k, again)),
            "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "device_launches": launched, "device_memops": memops,
            "grid_steps": steps, "grid_blocks": grid,
        }
        cases.append(eps_case)
        apart = (k[2] - p[2]).abs()
        eps_case["iters_apart_plain_max_images"] = [
            int(apart.max()), int((apart > 0).sum())]
        if int(apart.max()) > BLOCKED_K or int((apart > 0).sum()) > 1:
            emit({"phase": "kernels", "cases": cases})
            fail(f"blocked kernel counts at {shape} differ from the plain "
                 f"version's: {k[2].tolist()} vs {p[2].tolist()}")
        if not eps_case["rerun_bit_identical"] \
                or not torch.equal(work[0], k[2]):
            emit({"phase": "kernels", "cases": cases})
            fail(f"blocked kernel at full counts at {shape}: a rerun or the "
                 f"iterations computed differ")
        del args, k, p, a, again

    # The per-image exit at full counts. Kernel and plain version test the
    # same rule (after every k-th iteration, on that iteration's error), so
    # the counts must be identical unless an error lands within rounding of
    # the threshold.
    n, h, w = 4, SECTION_H, SECTION_W
    i0, i1, u1, u2, truth_x = eps_exit_inputs(dev, h, w)
    k1, k2, kit = tvl1_blocked_level_solve(i0, i1, u1, u2, full)
    p1, p2, pit = tvl1_blocked_level_solve_plain(i0, i1, u1, u2, full)
    a1, a2, ait = tvl1_level_solve(i0, i1, u1, u2, full)
    torch.cuda.synchronize()
    ms = time_cuda(lambda: tvl1_blocked_level_solve(i0, i1, u1, u2, full), 2)
    a_ms = time_cuda(lambda: tvl1_level_solve(i0, i1, u1, u2, full), 2)
    plain_ms = time_cuda(
        lambda: tvl1_blocked_level_solve_plain(i0, i1, u1, u2, full), 1)

    def epe(a, b):
        return float(torch.hypot(a - truth_x, b + 0.6 * truth_x).mean())

    bound, bound_by = level_bound_ms(n, h, w, full.warps, int(kit.sum()))
    eps_case = {
        "kernel": "tvl1_blocked_level_solve", "shape": [n, h, w],
        "warps": full.warps, "iterations": full.iterations, "k": BLOCKED_K,
        "epsilon": full.epsilon, "iters_kernel": kit.tolist(),
        "iters_plain": pit.tolist(), "iters_level_kernel": ait.tolist(),
        "epe_kernel": epe(k1, k2), "epe_plain": epe(p1, p2),
        "epe_level_kernel": epe(a1, a2),
        "max_abs_du": max(max_abs_diff(k1, p1), max_abs_diff(k2, p2)),
        "kernel_ms": ms, "level_kernel_ms": a_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
    }
    cases.append(eps_case)
    emit({"phase": "kernels", "cases": cases})
    if kit.tolist() != pit.tolist():
        fail(f"blocked kernel per-image iteration counts {kit.tolist()} "
             f"differ from its plain version's {pit.tolist()}")
    if len(set(kit.tolist())) < 2 or max(kit.tolist()) >= 1500:
        fail(f"images were expected to stop at different counts: "
             f"{kit.tolist()}")
    if any(c % BLOCKED_K not in (0, 300 % BLOCKED_K) for c in kit.tolist()):
        fail(f"counts are not whole chunks: {kit.tolist()}")
    if not abs(eps_case["epe_kernel"] - eps_case["epe_plain"]) <= 0.01:
        fail("EPE of blocked kernel and plain version differ")
    return main_case


def old_chunk_level_loop(i0, i1, u1, u2, params):
    """The per-level API's level solve before the chunk kernel's level entry,
    from public functions: the gradient, the state stack and every sweep's
    warp in plain PyTorch, one tvl1_chunk_sweep call a sweep.
    Returns (u1, u2, iters)."""
    import torch

    from optflow_tpu_torch.ops.tvl1_chunk_cuda import tvl1_chunk_sweep
    from optflow_tpu_torch.ops.warp import centered_gradient, warp_backward

    n, h, w = i0.shape
    thresh = params.epsilon ** 2 * h * w if params.epsilon > 0 else -1.0
    i1x, i1y = centered_gradient(i1)
    z = torch.zeros_like(u1)
    state = torch.stack([u1, u2, z, z, z, z], dim=1)
    iters = torch.zeros(n, dtype=torch.int32, device=i0.device)
    for _ in range(params.warps):
        _, wx, wy, _, rho = warp_backward(i0, i1, i1x, i1y, state[:, 0],
                                          state[:, 1])
        ro = torch.stack([wx, wy, rho], dim=1)
        state, _ = tvl1_chunk_sweep(ro, state, params.iterations, thresh,
                                    params, iters=iters)
    return state[:, 0], state[:, 1], iters


def kernels_chunk():
    """The chunk kernel (csrc/tvl1_chunk.cu) against its plain version. One
    chunk a call: tile mode at a full section's finest level, one-block mode
    at the coarsest level of a strip with the in-kernel exit. A level a call,
    the entry the per-level API runs (the persistent grid with an exit every
    8 iterations, or the exact exit in one block): at that API's finest
    level (1, 512, 1024), which is the case the `kernels` line reports, at
    (4, 512, 1024) and at (32, 34, 137) in one block, each also against the
    level loop it replaces (PyTorch warp + tvl1_chunk_sweep a sweep), in
    turns."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import (
        CHUNK_K,
        chunk_geometry,
        level_exit_every,
        tvl1_chunk,
        tvl1_chunk_level_solve,
        tvl1_chunk_level_solve_plain,
        tvl1_chunk_plain,
    )
    from optflow_tpu_torch.ops.warp import centered_gradient, warp_backward

    dev = torch.device("cuda")
    params = TVL1Params(nscales=1)
    cases = []

    def chunk_inputs(n, h, w, seed):
        """ro from a real warp, and a state that has run one chunk, so that
        the duals are not zero."""
        i0, i1, u1, u2 = (
            torch.from_numpy(a).to(dev)
            for a in make_level_inputs(n, h, w, seed=seed)
        )
        i1x, i1y = centered_gradient(i1)
        _, wx, wy, _, rho = warp_backward(i0, i1, i1x, i1y, u1, u2)
        ro = torch.stack([wx, wy, rho], dim=1).contiguous()
        z = torch.zeros_like(u1)
        state = torch.stack([u1, u2, z, z, z, z], dim=1).contiguous()
        state, _ = tvl1_chunk_plain(ro, state, CHUNK_K, -1.0, params)
        return ro, state.contiguous()

    # tile mode, m = 8: the same arithmetic on the same values, 8 iterations
    n, h, w = 4, SECTION_H, SECTION_W
    ro, state = chunk_inputs(n, h, w, seed=57)
    geo = chunk_geometry(h, w)
    active = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    before = tvl1_chunk.launches
    ks, ke = tvl1_chunk(ro, state, CHUNK_K, -1.0, params, active=active,
                        iters=iters)
    torch.cuda.synchronize()
    if tvl1_chunk.launches != before + 1:
        fail("the chunk wrapper did not count its launch")
    piters = torch.zeros_like(iters)
    ps, pe = tvl1_chunk_plain(ro, state, CHUNK_K, -1.0, params,
                              active=active, iters=piters)
    diff = max_abs_diff(ks, ps)
    err_rel = float(((ke - pe).abs() / pe.abs().clamp(min=1e-12)).max())
    ms = time_cuda(lambda: tvl1_chunk(ro, state, CHUNK_K, -1.0, params), 5)
    plain_ms = time_cuda(
        lambda: tvl1_chunk_plain(ro, state, CHUNK_K, -1.0, params), 2)
    bound, bound_by = chunk_bound_ms(n, h, w, geo.blocks, n * CHUNK_K)
    launched, memops = enqueued_launches(
        lambda: tvl1_chunk(ro, state, CHUNK_K, -1.0, params))
    chunk_case = {
        "kernel": "tvl1_chunk", "entry": "tvl1_chunk", "mode": "tiles",
        "shape": [n, h, w],
        "m": CHUNK_K, "blocks": geo.blocks, "max_abs_du": diff,
        "tolerance": 1e-4, "errs_max_rel": err_rel, "errs_tolerance": 1e-3,
        "iters": iters.tolist(), "stopped_image_passed_through":
        bool(torch.equal(ks[2], state[2])) and float(ke[2].abs().max()) == 0,
        "state_moved": max_abs_diff(ks[0], state[0]),
        "device_launches": launched, "device_memops": memops,
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by,
    }
    cases.append(chunk_case)
    if not (diff <= 1e-4 and err_rel <= 1e-3
            and bool(torch.isfinite(ks).all())):
        emit({"phase": "kernels", "cases": cases})
        fail(f"chunk kernel (tiles) differs from its plain version: state "
             f"{diff}, errs relative {err_rel}")
    if not (chunk_case["stopped_image_passed_through"]
            and iters.tolist() == piters.tolist() == [8, 8, 0, 8]
            and chunk_case["state_moved"] > 1e-3):
        emit({"phase": "kernels", "cases": cases})
        fail("chunk kernel (tiles): pass-through, iteration counts or "
             "update wrong")
    del ro, state, ks, ps

    # one-block mode: every image leaves its loop at its own iteration
    n, h, w = 32, 34, 137
    ro, state = chunk_inputs(n, h, w, seed=71)
    thresh = params.epsilon ** 2 * h * w
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    piters = torch.zeros_like(iters)
    ks, ke = tvl1_chunk(ro, state, params.iterations, thresh, params,
                        iters=iters)
    torch.cuda.synchronize()
    ps, pe = tvl1_chunk_plain(ro, state, params.iterations, thresh, params,
                              iters=piters)
    diff = max_abs_diff(ks, ps)
    ms = time_cuda(
        lambda: tvl1_chunk(ro, state, params.iterations, thresh, params), 5)
    plain_ms = time_cuda(
        lambda: tvl1_chunk_plain(ro, state, params.iterations, thresh,
                                 params), 1)
    bound, bound_by = chunk_bound_ms(n, h, w, 1, int(iters.sum()))
    case = {
        "kernel": "tvl1_chunk", "mode": "one block", "shape": [n, h, w],
        "m": params.iterations, "thresh": thresh, "max_abs_du": diff,
        "tolerance": 1e-4, "iters_kernel": iters.tolist(),
        "iters_plain": piters.tolist(), "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
    }
    cases.append(case)
    emit({"phase": "kernels", "cases": cases})
    if not chunk_geometry(h, w).one_block:
        fail(f"{h} x {w} was expected to run in one block")
    if iters.tolist() != piters.tolist():
        fail(f"chunk kernel (one block) left its loop at {iters.tolist()}, "
             f"its plain version at {piters.tolist()}")
    if not (0 < int(iters.min()) and int(iters.max()) < params.iterations):
        fail(f"the in-kernel exit was not taken: {iters.tolist()}")
    if not (diff <= 1e-4 and bool(torch.isfinite(ks).all())):
        fail(f"chunk kernel (one block) differs from its plain version: "
             f"{diff}")
    if not bool(((ke[:, 0] <= thresh) & (pe[:, 0] <= thresh)).all()):
        fail("an image left its loop above the threshold")
    del ro, state, ks, ps

    # The level entry at full counts: one library call a level. Against its
    # plain version (the plain level solve, an exit every 8 or every
    # iteration): the device adds a test's tile sums in tile order, the
    # plain version in PyTorch's, so an image within rounding of its
    # threshold could stop a test apart; equal counts were seen, and they
    # are the gate, the state within 1e-4 px. Against the old level loop, whose
    # warp is PyTorch's: reported, counts at most one test apart.
    new = tvl1_chunk_level_solve
    main_case = None
    for n, h, w in ((1, SECTION_H, SECTION_W), (4, SECTION_H, SECTION_W),
                    (32, 34, 137)):
        args = tuple(
            torch.from_numpy(a).to(dev)
            for a in make_level_inputs(n, h, w, seed=83 + h)
        )
        geo = chunk_geometry(h, w)
        step = level_exit_every(h, w)
        before = new.launches
        k = new(*args, params)
        steps, grid = new.last_steps[:2].tolist()
        torch.cuda.synchronize()
        if new.launches != before + 1:
            fail("the level entry's wrapper did not count its launch")
        p = tvl1_chunk_level_solve_plain(*args, params)
        o = old_chunk_level_loop(*args, params)
        again = new(*args, params)
        torch.cuda.synchronize()
        old_ms, ms, turns = time_in_turns(
            lambda: old_chunk_level_loop(*args, params),
            lambda: new(*args, params))
        plain_ms = time_cuda(
            lambda: tvl1_chunk_level_solve_plain(*args, params), 1)
        bound, bound_by = level_bound_ms(n, h, w, params.warps,
                                         int(k[2].sum()))
        launched, memops = enqueued_launches(lambda: new(*args, params))
        old_launched, old_memops = enqueued_launches(
            lambda: old_chunk_level_loop(*args, params))
        apart_old = (k[2] - o[2]).abs()
        case = {
            "kernel": "tvl1_chunk", "entry": "tvl1_chunk_level_solve",
            "mode": "one block" if geo.one_block else "tiles",
            "shape": [n, h, w], "warps": params.warps,
            "iterations": params.iterations, "exit_every": step,
            "max_abs_du": flow_diff(k, p), "tolerance": 1e-4,
            "iters_kernel": k[2].tolist(), "iters_plain": p[2].tolist(),
            "iters_old_loop": o[2].tolist(),
            "iters_apart_old_loop_max_images": [
                int(apart_old.max()), int((apart_old > 0).sum())],
            "max_abs_du_vs_old_loop": flow_diff(k, o),
            "rerun_bit_identical": all(
                torch.equal(x, y) for x, y in zip(k, again)),
            "kernel_ms": ms, "replaced_kernel_ms": old_ms,
            "ms_old_new_new_old": turns, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            # kernels and memsets/copies of one call, tallied by the library
            # (the old loop's PyTorch kernels are not in its tally)
            "device_launches": launched, "device_memops": memops,
            "replaced_kernel_device_launches": old_launched,
            "grid_steps": steps, "grid_blocks": grid,
        }
        cases.append(case)
        emit({"phase": "kernels", "cases": [case]})
        if not torch.equal(k[2], p[2]):
            fail(f"chunk level entry at {(n, h, w)} ran {k[2].tolist()} "
                 f"iterations, its plain version {p[2].tolist()}")
        if not case["max_abs_du"] <= 1e-4 \
                or not bool(torch.isfinite(k[0]).all()):
            fail(f"chunk level entry at {(n, h, w)} differs from its plain "
                 f"version by {case['max_abs_du']}")
        if int(apart_old.max()) > step or not case["rerun_bit_identical"]:
            fail(f"chunk level entry at {(n, h, w)}: counts more than a test "
                 f"apart from the old loop's, or a rerun differs")
        if launched != 1:
            fail(f"chunk level entry at {(n, h, w)} put {launched} kernels "
                 f"on the card, not one")
        if not (0 < int(k[2].min())
                and int(k[2].max()) < params.warps * params.iterations):
            fail(f"chunk level entry at {(n, h, w)}: the exit was not taken: "
                 f"{k[2].tolist()}")
        if main_case is None:
            main_case = case
        del args, k, p, o, again
    main_case["single_chunk"] = chunk_case
    return main_case


def ablate_full_vs_chunk(ro, state, m, h, w):
    """`full` after m iterations against the chunk kernel with the exit
    disabled, in chunks of CHUNK_K (the last what is left): the largest
    difference of the states, which must be 0.0, and of the error sums of
    the last iteration, relative."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1_ablate_cuda import (
        VARIANTS,
        tvl1_ablate_chunks,
    )
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import CHUNK_K, tvl1_chunk

    params = TVL1Params(nscales=1)
    cs = state
    for k in (CHUNK_K,) * (m // CHUNK_K) + (m % CHUNK_K,) * (m % CHUNK_K > 0):
        cs, ce = tvl1_chunk(ro, cs, k, -1.0, params)
    fs, fe = tvl1_ablate_chunks(ro, state, m, h, w, **VARIANTS["full"])
    torch.cuda.synchronize()
    errs = float(((fe[:, 0] - ce.sum(1)).abs() / ce.sum(1).abs()).max())
    return max_abs_diff(fs, cs), errs


def ablate_variants_vs_plain(ro, state, h, w, m_div, tol):
    """Each of the six variants against its plain version: m_div iterations
    with the divisions, 2 without (no contraction then: kernels_ablate).
    Returns one case a variant; fails on the first that is off."""
    import torch

    from optflow_tpu_torch.ops.tvl1_ablate_cuda import (
        VARIANTS,
        tvl1_ablate_chunks,
        tvl1_ablate_plain,
    )

    n = state.shape[0]
    cases = []
    for name, flags in VARIANTS.items():
        m = m_div if flags["div"] else 2
        ks, ke = tvl1_ablate_chunks(ro, state, m, h, w, **flags)
        ps, pe = tvl1_ablate_plain(ro, state, m, h, w, **flags)
        finite = bool(torch.isfinite(ks).all() and torch.isfinite(ps).all())
        scale = 1.0 if flags["div"] else float(ps.abs().max())
        diff = max_abs_diff(ks, ps) / scale
        err_rel = float(((ke - pe).abs() / pe.abs().clamp(min=1e-12)).max())
        cases.append({"variant": name, "m": m, "max_abs_du": diff,
                      "relative_to": scale, "errs_max_rel": err_rel})
        if not (finite and diff <= tol and err_rel <= 1e-3):
            emit({"phase": "kernels", "cases": cases})
            fail(f"ablation kernel at {tuple(state.shape)}, variant {name}: "
                 f"finite {finite}, state differs by {diff} (tolerance "
                 f"{tol}), errors by {err_rel}")
        if not flags["err"] and ke.flatten().tolist() != [1.0] * n:
            fail(f"variant {name} has no error sum and must return ones")
    return cases


def kernels_ablate():
    """The ablation kernel (csrc/tvl1_ablate.cu) at the shapes its tool gives
    it, (16, 256, 1024) and m = 50: each of the six variants against its
    plain version, and `full` against the chunk kernel with the exit
    disabled, which it must equal bit for bit. Then the same at (2, 96, 198),
    whose width, not a multiple of 4, takes the kernel's 4-byte window
    copies (1024 columns take the 16-byte ones)."""
    import torch

    from optflow_tpu_torch.ops.tvl1_ablate_cuda import (
        VARIANTS,
        launches_per_call,
        tvl1_ablate_chunks,
        tvl1_ablate_plain,
    )
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import chunk_geometry
    from optflow_tpu_torch.tools.kernel_ablate import make_inputs

    dev = torch.device("cuda")
    n, h, w = 16, 256, 1024
    lo, hi = 50, 600  # the tool's two iteration counts
    ro, state = make_inputs(n, h, w, dev)  # the tool's inputs, from a seed
    # Same float32 arithmetic in another order (FMA contraction, the block
    # sums) on values of order 1: as for the chunk kernel. With its divisions
    # the iteration contracts, so the tolerance holds at any count.
    tol = 1e-4
    cases = []
    main_case = None
    for name, flags in VARIANTS.items():
        # Without its divisions the iteration is no contraction: no_div
        # leaves the finite numbers within a few steps, and min_body stays
        # bounded but amplifies the last-bit differences between kernel and
        # plain version (`m50_max_abs_du` below). Both are compared after 2
        # steps and only reported at the tool's count.
        m = lo if flags["div"] else 2
        before = tvl1_ablate_chunks.launches
        ks, ke = tvl1_ablate_chunks(ro, state, m, h, w, **flags)
        torch.cuda.synchronize()
        if tvl1_ablate_chunks.launches != before + 1:
            fail("the ablation wrapper did not count its launch")
        ps, pe = tvl1_ablate_plain(ro, state, m, h, w, **flags)
        finite = bool(torch.isfinite(ks).all() and torch.isfinite(ps).all())
        # without divisions the values reach 30 (min_body) to 1e5 (no_div)
        # after two steps, from sums that cancel: the difference is taken
        # relative to the largest value
        scale = 1.0 if flags["div"] else float(ps.abs().max())
        diff = max_abs_diff(ks, ps) / scale
        err_rel = float(((ke - pe).abs() / pe.abs().clamp(min=1e-12)).max())
        ms = time_cuda(
            lambda: tvl1_ablate_chunks(ro, state, m, h, w, **flags), 5)
        plain_ms = time_cuda(
            lambda: tvl1_ablate_plain(ro, state, m, h, w, **flags), 2)
        bound, bound_by = chunk_bound_ms(n, h, w, 1, n * m)
        launched, memops = enqueued_launches(
            lambda: tvl1_ablate_chunks(ro, state, m, h, w, **flags))
        case = {
            "kernel": "tvl1_ablate_chunks", "variant": name,
            "shape": [n, h, w], "m": m, "max_abs_du": diff, "tolerance": tol,
            "relative_to": scale, "errs_max_rel": err_rel,
            "errs_tolerance": 1e-3, "errs": ke.flatten().tolist(),
            "state_moved": max_abs_diff(ks, state),
            # tallied by the library, beside what the wrapper says it enqueues
            "device_launches": launched, "device_memops": memops,
            "launches_enqueued": launches_per_call(m),
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by,
        }
        cases.append(case)
        if launched != launches_per_call(m):
            emit({"phase": "kernels", "cases": cases})
            fail(f"ablation kernel, variant {name}: {launched} launches on "
                 f"the card, {launches_per_call(m)} expected")
        if not (finite and diff <= tol and err_rel <= 1e-3):
            emit({"phase": "kernels", "cases": cases})
            fail(f"ablation kernel, variant {name}: finite {finite}, state "
                 f"differs by {diff} (tolerance {tol}), errors by {err_rel}")
        if not case["state_moved"] > 1e-3:
            emit({"phase": "kernels", "cases": cases})
            fail(f"ablation kernel, variant {name}: the state did not move")
        if not flags["err"] and ke.flatten().tolist() != [1.0] * n:
            fail(f"variant {name} has no error sum and must return ones")
        if name == "full":
            main_case = case
            # the tool's other count, where the iteration has converged
            ks, ke = tvl1_ablate_chunks(ro, state, hi, h, w, **flags)
            ps, pe = tvl1_ablate_plain(ro, state, hi, h, w, **flags)
            case[f"m{hi}_max_abs_du"] = max_abs_diff(ks, ps)
            if not case[f"m{hi}_max_abs_du"] <= tol:
                emit({"phase": "kernels", "cases": cases})
                fail(f"ablation kernel, variant full at m = {hi}: state "
                     f"differs by {case[f'm{hi}_max_abs_du']}")
        if name == "min_body":
            # reported, not gated: how far the two have drifted at the
            # tool's count
            ks, _ = tvl1_ablate_chunks(ro, state, lo, h, w, **flags)
            ps, _ = tvl1_ablate_plain(ro, state, lo, h, w, **flags)
            drift = (ks - ps).abs()
            case[f"m{lo}_max_abs_du"] = float(drift.max())
            case[f"m{lo}_share_above_1e-3"] = float(
                (drift > 1e-3).float().mean())
        if name == "no_div":
            # at the tool's count the state has left the finite numbers:
            # kernel and plain version must agree on where
            ks, _ = tvl1_ablate_chunks(ro, state, lo, h, w, **flags)
            ps, _ = tvl1_ablate_plain(ro, state, lo, h, w, **flags)
            same = float((torch.isfinite(ks) == torch.isfinite(ps))
                         .float().mean())
            case[f"m{lo}_finite_share"] = float(
                torch.isfinite(ks).float().mean())
            case[f"m{lo}_finiteness_agrees_share"] = same
            if not same >= 0.99:
                emit({"phase": "kernels", "cases": cases})
                fail(f"no_div at m = {lo}: kernel and plain version agree on "
                     f"finiteness at only {same} of the positions")

    # `full` is the chunk kernel's iteration with the exit disabled: two
    # chunks of 8 there (its tiles, its shared-memory window), four launches
    # of 4 here (registers), not one bit apart; at m = 50 six chunks of 8
    # and one of 2 there, 13 launches here (the last of 2)
    if chunk_geometry(h, w).one_block:
        fail(f"{h} x {w} was expected to run in tiles")
    vs_chunk, errs_vs_chunk = ablate_full_vs_chunk(ro, state, 16, h, w)
    vs_chunk_50, _ = ablate_full_vs_chunk(ro, state, lo, h, w)
    # a rerun gives the same bits, the error sums included
    fs, fe = tvl1_ablate_chunks(ro, state, 16, h, w, **VARIANTS["full"])
    fs2, fe2 = tvl1_ablate_chunks(ro, state, 16, h, w, **VARIANTS["full"])
    rerun_equal = bool(torch.equal(fs, fs2) and torch.equal(fe, fe2))
    main_case.update({"max_abs_vs_chunk_kernel": vs_chunk,
                      "max_abs_vs_chunk_kernel_m50": vs_chunk_50,
                      "errs_rel_vs_chunk_kernel": errs_vs_chunk,
                      "rerun_bit_identical": rerun_equal})
    # the 4-byte copies: a width that is not a multiple of 4
    nn, nh, nw = 2, 96, 198
    nro, nstate = make_inputs(nn, nh, nw, dev)
    if chunk_geometry(nh, nw).one_block:
        fail(f"{nh} x {nw} was expected to run in tiles")
    narrow = {"shape": [nn, nh, nw], "copies": "4 B",
              "variants": ablate_variants_vs_plain(nro, nstate, nh, nw, lo,
                                                   tol)}
    narrow["max_abs_vs_chunk_kernel"], narrow["errs_rel_vs_chunk_kernel"] = (
        ablate_full_vs_chunk(nro, nstate, 16, nh, nw))
    narrow["max_abs_vs_chunk_kernel_m50"], _ = ablate_full_vs_chunk(
        nro, nstate, lo, nh, nw)
    main_case["four_byte_copies"] = narrow
    emit({"phase": "kernels", "cases": cases})
    for where, case in (("", main_case), (f" at {nw} columns", narrow)):
        d16, d50 = (case["max_abs_vs_chunk_kernel"],
                    case["max_abs_vs_chunk_kernel_m50"])
        if d16 != 0.0 or d50 != 0.0:
            fail(f"ablation variant `full`{where} differs from the chunk "
                 f"kernel by {d16} (m = 16) and {d50} (m = 50): it must be "
                 f"the same arithmetic, bit for bit")
        if not case["errs_rel_vs_chunk_kernel"] <= 1e-5:
            fail(f"`full` error sums{where} differ from the chunk kernel's "
                 f"by {case['errs_rel_vs_chunk_kernel']}")
    if not rerun_equal:
        fail("a rerun of the ablation kernel's `full` gave other bits")
    return main_case


def smem_bound_ms(n_bytes, clock_khz):
    """Least time for the probe: n_bytes written and read once by one
    multiprocessor's shared memory."""
    return 2 * n_bytes / (SMEM_BYTES_PER_CLOCK * clock_khz * 1e3) * 1e3


def kernels_smem():
    """The capacity probe (csrc/smem_cap.cu) against its plain version:
    every size up to the card's opt-in limit runs and returns the mean,
    every size above it is refused, and the largest that ran is the limit."""
    import torch

    from optflow_tpu_torch.ops.smem_cap_cuda import (
        device_shared_memory,
        error_string,
        last_kernel_ms,
        smem_fill_mean,
        smem_fill_mean_plain,
    )
    from optflow_tpu_torch.tools.smem_cap import SIZES_KIB

    dev = torch.device("cuda")
    attrs = device_shared_memory(dev)
    x = torch.full((1,), 2.75, dtype=torch.float32, device=dev)
    sizes = sorted({k * 1024 for k in SIZES_KIB} | {attrs.optin_per_block})
    rows = []
    largest = 0
    worst = 0.0
    for n_bytes in sizes:
        before = smem_fill_mean.launches
        status, means = smem_fill_mean(n_bytes, x)
        expect_ok = n_bytes <= attrs.optin_per_block
        row = {"bytes": n_bytes, "ok": status.ok, "status": list(status)}
        if status.ok:
            _, plain = smem_fill_mean_plain(n_bytes, x)
            row["abs_err"] = max_abs_diff(means, plain)
            worst = max(worst, row["abs_err"])
            largest = max(largest, n_bytes)
            if smem_fill_mean.launches != before + 1:
                fail("the probe's wrapper did not count its launch")
        else:
            row["refused_by"] = error_string(status.attribute or status.launch)
        rows.append(row)
        if status.ok != expect_ok:
            emit({"phase": "kernels", "cases": rows})
            fail(f"probe at {n_bytes} B: ran {status.ok}, expected "
                 f"{expect_ok} (opt-in limit {attrs.optin_per_block} B)")
        if status.ok and not row["abs_err"] <= 1e-6:
            emit({"phase": "kernels", "cases": rows})
            fail(f"probe at {n_bytes} B: mean off by {row['abs_err']}")
    # Two times of the largest size: `kernel_ms`, the kernel with its
    # launch latency on the card, by the CUDA events the call records around
    # its launch (mean of 20); and `call_ms`, the whole call as a caller
    # waits for it (it synchronises, as the TPU probe blocked on its
    # result), by events around 20 calls.
    n_bytes = attrs.optin_per_block
    kernel_times = []

    def timed_call():
        smem_fill_mean(n_bytes, x)
        kernel_times.append(last_kernel_ms())

    call_ms = time_cuda(timed_call, 20)
    ms = sum(kernel_times) / len(kernel_times)
    plain_ms = time_cuda(lambda: smem_fill_mean_plain(n_bytes, x), 20)
    # the kernel's own duration on the card, without the events' launch
    # latency, where the profiler can trace the card (reported, not gated)
    traced = trace_device(
        lambda: [smem_fill_mean(n_bytes, x) for _ in range(20)])
    case = {
        "kernel": "smem_fill_mean", "shape": [n_bytes // 4],
        "max_abs_du": worst, "tolerance": 1e-6,
        "largest_ok_bytes": largest, "attrs": attrs._asdict(),
        "sizes": rows, "kernel_ms": ms, "call_ms": call_ms,
        "traced_kernel_ms": (None if traced["busy_ms"] is None
                             else traced["busy_ms"] / 20),
        "plain_ms": plain_ms,
        "bound_ms": smem_bound_ms(n_bytes, attrs.clock_khz),
        "bound_by": "bytes",
    }
    emit({"phase": "kernels", "cases": [case]})
    if largest != attrs.optin_per_block:
        fail(f"the largest size that ran, {largest} B, is not the card's "
             f"opt-in limit {attrs.optin_per_block} B")
    if not 0.0 < ms <= call_ms:
        fail(f"the probe's kernel time {ms} ms is not within its call's "
             f"{call_ms} ms")
    return case


def phase_ablate(results):
    """The ablation tool at its defaults: what each class of cost is worth
    per iteration on this card."""
    import math

    import torch

    from optflow_tpu_torch.tools.kernel_ablate import run_ablation

    zero_launch_counts()  # a main path of its kernel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = run_ablation(16, 256, 1024, 50, 600, "cuda")
    wall = time.perf_counter() - t0
    launches = read_launch_counts()["tvl1_ablate_chunks"]
    slopes = {r["name"]: r["slope_us_per_iter"] for r in rows}
    emit({"phase": "ablate", "shape": [16, 256, 1024], "lo": 50, "hi": 600,
          "slope_us_per_iter": slopes,
          "g_px_iter_per_s": {r["name"]: r["g_px_iter_per_s"] for r in rows},
          "t_lo_ms": {r["name"]: r["t_lo_ms"] for r in rows},
          "t_hi_ms": {r["name"]: r["t_hi_ms"] for r in rows},
          "device_launches_lo_hi": [rows[0]["launches_lo"],
                                    rows[0]["launches_hi"]],
          "launches": launches, "wall_s": wall})
    if not all(math.isfinite(v) and v > 0 for v in slopes.values()):
        fail(f"ablation slopes must be finite and positive: {slopes}")
    if not slopes["min_body"] <= slopes["full"]:
        fail(f"min_body ({slopes['min_body']} us/iter) is slower than full "
             f"({slopes['full']})")
    if launches < 1:
        fail("the ablation tool did not launch its kernel")
    results.setdefault("launches", {})["tvl1_ablate_chunks"] = launches


def phase_smem_cap(results):
    """The capacity probe's table, and the port's constants against it."""
    from optflow_tpu_torch.tools.smem_cap import CONSTANTS, run_probe

    zero_launch_counts()  # a main path of its kernel
    table = run_probe("cuda")
    launches = read_launch_counts()["smem_fill_mean"]
    emit({"phase": "smem_cap", **table, "launches": launches})
    optin = table["attrs"]["optin_per_block"]
    for r in table["sizes"]:
        if r["ok"] != (r["bytes"] <= optin):
            fail(f"smem_cap: {r['kib']} KiB ran {r['ok']}, the opt-in limit "
                 f"is {optin} B")
        if r["ok"] and not (r["resident"] and r["one_more_refused"]):
            fail(f"smem_cap: at {r['kib']} KiB the reported occupancy "
                 f"{r['occupancy']} does not hold: {r}")
    too_big = [key for key in CONSTANTS if not table[key + "_fits"]]
    if too_big:
        fail(f"the shared memory of {too_big} exceeds the largest size "
             f"that ran, {table['largest_ok_bytes']} B")
    if launches < 1:
        fail("the probe tool did not launch its kernel")
    results.setdefault("launches", {})["smem_fill_mean"] = launches


def phase_solve(results):
    import torch

    from optflow_tpu_torch.bench.roofline import pyramid_work
    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1 import (
        get_last_iteration_stats,
        tvl1_flow_batched,
    )
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_level_solve

    try:
        oracle = oracle_flow()
    except ValueError as e:
        fail(str(e))

    pairs = [make_pair(SOLVE_H, SOLVE_W, DX, DY, seed=s)
             for s in range(SOLVE_BATCH)]
    dev = torch.device("cuda")
    i0 = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    i1 = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    params = TVL1Params()  # reference defaults

    tvl1_level_solve.launches = 0
    flow = tvl1_flow_batched(i0, i1, params)  # warm-up, also the checked one
    torch.cuda.synchronize()
    launches = tvl1_level_solve.launches
    t0 = time.perf_counter()
    flow2 = tvl1_flow_batched(i0, i1, params)
    # the call returns when every launch is enqueued: if that takes as long
    # as the whole solve, the host's launch loop is on the critical path
    # (it is the limit, or it is blocked on a full launch queue)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = [
        {"shape": list(shape), "iters_mean": float(it.float().mean()),
         "iters_min": int(it.min()), "iters_max": int(it.max())}
        for shape, it in get_last_iteration_stats()
    ]
    # the counted pixel-iterations, as the solve bench counts them
    px_iters = pyramid_work(get_last_iteration_stats(),
                            params.warps).px_iterations
    results["solve_px_iterations"] = px_iters

    if tuple(flow.shape) != (SOLVE_BATCH, SOLVE_H, SOLVE_W, 2):
        fail(f"flow has shape {tuple(flow.shape)}")
    if not bool(torch.isfinite(flow).all()):
        fail("flow is not finite")
    epe = float(torch.hypot(flow[..., 0] - DX, flow[..., 1] - DY).mean())
    orc = torch.from_numpy(oracle).to(dev)
    epe_oracle = float(
        torch.hypot(flow[0, ..., 0] - orc[..., 0],
                    flow[0, ..., 1] - orc[..., 1]).mean()
    )
    rerun = float((flow - flow2).abs().max())
    emit({"phase": "solve", "shape": [SOLVE_BATCH, SOLVE_H, SOLVE_W],
          "epe_px": epe, "epe_vs_oracle_px": epe_oracle, "gate_px": 0.5,
          "solve_ms": ms, "enqueue_ms": enqueue_ms, "mp_pairs_per_s":
          SOLVE_BATCH * SOLVE_H * SOLVE_W / 1e6 / (ms / 1e3),
          "launches": launches, "device": str(flow.device),
          "px_iterations": px_iters, "rerun_max_abs_diff": rerun,
          "levels": stats})
    if launches < 1:
        fail("the solve did not launch the level kernel")
    if not epe <= 0.5:
        fail(f"mean EPE against truth {epe} > 0.5 px")
    if not epe_oracle <= 0.5:
        fail(f"mean EPE against the oracle fixture {epe_oracle} > 0.5 px")
    phase_levels(pairs)


def phase_levels(pairs):
    """Where a main-path solve spends its time: the 32-image solve of the
    job's groups (2 strips x 16 pairs), each level's kernel call timed with
    CUDA events, beside its bound, the steps it took inside its one launch,
    how full the grid was over them, the iterations it computed (chunks run
    past an exit and replays included) against the iterations counted, and
    the time the device-memory traffic of the tiled design itself would take
    at the memory rate; then, from a profiler trace of the whole solve, the
    kernels the card ran and its busy share."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops._build import enqueued
    from optflow_tpu_torch.ops.tvl1 import solve_pyramid
    from optflow_tpu_torch.ops.tvl1_cuda import (
        level_max_steps,
        level_tiles,
        level_window_px,
        tvl1_level_solve,
    )

    dev = torch.device("cuda")
    i0 = torch.from_numpy(np.stack([p[0] for p in pairs] * 2)).to(dev)
    i1 = torch.from_numpy(np.stack([p[1] for p in pairs] * 2)).to(dev)
    params = TVL1Params()
    records = []

    def timed(a, b, u1, u2, p, u3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = enqueued()
        start.record()
        r1, r2, iters = tvl1_level_solve(a, b, u1, u2, p)
        end.record()
        put = [x - y for x, y in zip(enqueued(), before)]
        records.append((tuple(a.shape), start, end, iters,
                        tvl1_level_solve.last_work,
                        tvl1_level_solve.last_steps, put))
        return r1, r2, u3, iters

    solve_pyramid(i0, i1, params, None, timed)  # warm-up
    records.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_pyramid(i0, i1, params, None, timed)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    levels = []
    for (n, h, w), start, end, iters, work, steps, put in records:
        total_iters = int(iters.sum())
        bound, bound_by = level_bound_ms(n, h, w, params.warps, total_iters)
        computed, runs = (int(x) for x in work.sum(dim=1))
        steps, grid, *live = steps.tolist()
        tiles = level_tiles(h, w)
        # a step of `x` images is ceil(x * tiles / grid) rounds of the grid
        items = [x * tiles for x in live if x]
        slots = sum(-(-i // grid) * grid for i in items)
        # What the design moves through device memory for these counts: a
        # chunk that ran loaded 9 planes of every tile's window and stored
        # 6 planes of the image; a sweep's warp reads u1, u2, i0 and
        # gathers from i1 and its gradient (counted once) and writes 3
        # planes; state set-up, gradient and output move 60 B a pixel once.
        traffic = (36 * tiles * level_window_px(h) * runs + 24 * h * w * runs
                   + n * h * w * (36 * params.warps + 60))
        levels.append({
            "shape": [n, h, w], "kernel_ms": start.elapsed_time(end),
            # kernels and memsets the level's call put on the card, tallied
            # by the library
            "device_launches": put[0], "device_memops": put[1],
            "iters_sum": total_iters, "iters_max": int(iters.max()),
            "iters_computed_sum": computed,
            "computed_per_counted": computed / max(total_iters, 1),
            # the steps the level's sweeps took inside its launch, each
            # ended by two grid-wide barriers, against the most the
            # schedule allows; the share of the blocks' turns in those steps
            # that had an (image, tile) item: the others waited at the
            # barrier, inside the kernel
            "grid_steps": steps, "grid_blocks": grid,
            "grid_steps_at_most":
            level_max_steps(params.warps, params.iterations),
            "items_per_step": sum(items) / max(steps, 1),
            "grid_fill": sum(items) / max(slots, 1),
            "chunks_that_ran_max": int(work[1].max()),
            "bound_ms": bound, "bound_by": bound_by,
            "design_traffic_ms": traffic / PEAK_BYTES_PER_S * 1e3,
        })
    trace = trace_device(lambda: solve_pyramid(i0, i1, params, None, timed))
    busy_ms = trace["busy_ms"]
    records.clear()
    level_launches = sum(c for name, c in trace["kernels"].items()
                         if "level_kernel" in name)
    weighted = sum(l["grid_fill"] * l["kernel_ms"] for l in levels)
    emit({"phase": "levels", "shape": list(i0.shape), "solve_ms": total_ms,
          "enqueue_ms": enqueue_ms, "device_busy_ms": busy_ms,
          "device_busy_share":
          None if busy_ms is None else busy_ms / total_ms,
          # the busy share counts a block that waits at a grid barrier
          # inside the level kernel as busy: it says the card is never
          # without a kernel, not that its multiprocessors have work
          "profiler": trace["note"],
          # what the levels' calls put on the card, tallied by the library
          "device_launches": sum(l["device_launches"] for l in levels),
          "device_memops": sum(l["device_memops"] for l in levels),
          # counted in the trace, where the profiler can trace this card
          # (else 0): the level kernel's launches, every kernel of the solve
          # (the pyramid's PyTorch operations included), and the memsets
          # and copies
          "level_kernel_launches_traced": level_launches,
          "device_kernels_traced": sum(trace["kernels"].values()),
          "device_memops_traced": trace["memops"],
          "grid_fill_weighted_by_kernel_ms":
          weighted / sum(l["kernel_ms"] for l in levels),
          "kernel_ms_sum": sum(l["kernel_ms"] for l in levels),
          "bound_ms_sum": sum(l["bound_ms"] for l in levels),
          "design_traffic_ms_sum":
          sum(l["design_traffic_ms"] for l in levels),
          "iters_sum": sum(l["iters_sum"] for l in levels),
          "iters_computed_sum":
          sum(l["iters_computed_sum"] for l in levels),
          "grid_steps_sum": sum(l["grid_steps"] for l in levels),
          "levels": levels})


def phase_job(results, tmp):
    import torch

    from optflow_tpu_torch.engine.batch_runner import run_job_batched

    n_pairs = 64
    n_frames = n_pairs // MAX_DZ + MAX_DZ + 1
    t0 = time.perf_counter()
    sections = gen_sections(n_frames)
    synth_s = time.perf_counter() - t0
    names = [f"mem://sec_{z:04d}" for z in range(n_frames)]
    # what decode + cv::resize(0.5) gives: the 2x2 mean of the uint8 section
    half = {
        nm: s.reshape(SRC_H // 2, 2, SRC_W // 2, 2).astype(np.float32)
        .mean(axis=(1, 3))
        for nm, s in zip(names, sections)
    }

    def loader(path, scale):
        if scale != SCALE:
            raise ValueError(f"loader serves scale {SCALE} only")
        return half[path]  # the same ndarray per (path, scale)

    job = build_job(names, n_pairs, os.path.join(tmp, "job.journal"), "job")
    sink = MockRenderSink()
    # the main path: counts are set to 0 just before and read just after
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the per-pair progress
        stats = run_job_batched(job, sink=sink, loader=loader, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launch_counts()["tvl1_level_solve"]

    err, n_matches = match_errors(sink.match_sets, job)
    mp_per_pair = 2 * STRIP * (SRC_W * SCALE) / 1e6
    emit({"phase": "job", "pairs": stats["pairs"],
          "batched": stats["batched"], "sequential": stats["sequential"],
          "uploads": stats["uploads"], "matches": stats["matches"],
          "gated_matches": n_matches, "match_err_px": err, "gate_px": 1.0,
          "wall_s": wall, "mp_pairs_per_s": stats["pairs"] * mp_per_pair / wall,
          "launches": launches, "solve_device": stats.get("solve_device"),
          "sink_bytes": sink.bytes, "synth_s": round(synth_s, 2),
          "timing": stats["timing"]})
    if stats["batched"] != n_pairs or stats["sequential"] != 0:
        fail(f"expected all {n_pairs} pairs batched: {stats}")
    if launches < 1:
        fail("the job did not launch the level kernel")
    if not str(stats.get("solve_device", "")).startswith("cuda"):
        fail(f"the job's solve ran on {stats.get('solve_device')}")
    if stats["matches"] != n_pairs * 2 * 25:
        fail(f"expected {n_pairs * 50} matches, got {stats['matches']}")
    if err is None or not err <= 1.0:
        fail(f"mean match error {err} > 1.0 full-res px")
    results.setdefault("launches", {})["tvl1_level_solve"] = launches
    results["sections"] = sections

    # The same job once more. The frames above took seconds of host work to
    # make, with the card idle; this run starts on a card that has just
    # worked, as every group after the first of a long job does.
    job = build_job(names, n_pairs, os.path.join(tmp, "job2.journal"), "job")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = run_job_batched(job, sink=MockRenderSink(), loader=loader,
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit({"phase": "job", "run": "second", "pairs": stats["pairs"],
          "wall_s": wall, "mp_pairs_per_s": stats["pairs"] * mp_per_pair / wall,
          "timing": stats["timing"]})
    if stats["batched"] != n_pairs:
        fail(f"second run of the job: {stats}")


def write_pngs(sections, folder, decoder):
    """Write uint8 sections as PNG files; returns their paths."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for z, section in enumerate(sections):
        path = os.path.join(folder, f"sec_{z:04d}.png")
        if decoder == "cv2":
            import cv2

            if not cv2.imwrite(path, section):
                fail(f"could not write {path}")
        else:
            from PIL import Image

            Image.fromarray(section).save(path)
        paths.append(path)
    return paths


def run_cli(job, tmp, tag, extra_args=()):
    """Run ``job`` through the CLI in a new process with the JSON-lines
    sink. Returns (finished process, match sets, wall seconds); fails the
    run unless the exit code is 0."""
    import torch

    out = os.path.join(tmp, f"{tag}_matches.jsonl")
    job["match_sink"] = "jsonl"
    job["match_output"] = out
    job_path = os.path.join(tmp, f"{tag}.json.gz")
    with gzip.open(job_path, "wb") as f:
        f.write(json.dumps(job).encode("utf-8"))
    torch.cuda.synchronize()  # none of this process's work beside the CLI's
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "optflow_tpu_torch.cli.main", job_path,
         *extra_args],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
        fail(f"the CLI exited with code {proc.returncode}")
    with open(out) as f:
        match_sets = [json.loads(line) for line in f if line.strip()]
    return proc, match_sets, wall


def expected_decoder():
    """The decoder a job's prefetch loader uses on this machine: the native
    loader where it builds (the decode phase fails where it does not and no
    header is missing), else the header-free route where the host compiler
    is (it raises where that does not build), else the Python decoder."""
    from optflow_tpu_torch import native
    from optflow_tpu_torch.core import imgio
    from optflow_tpu_torch.native import frame

    if native.available():
        return "native"
    return "native-resize" if frame.available() else imgio.decoder_name()


def phase_cli(results, tmp):
    from optflow_tpu_torch.core import imgio

    decoder = imgio.decoder_name()
    if decoder is None:
        emit({"phase": "cli", "skipped": "no image decoder installed"})
        return
    n_pairs = 16
    n_frames = n_pairs // MAX_DZ + MAX_DZ + 1
    sections = results.get("sections") or gen_sections(n_frames)
    names = write_pngs(sections[:n_frames], os.path.join(tmp, "stack"),
                       decoder)
    job = build_job(names, n_pairs, os.path.join(tmp, "cli.journal"), "cli")
    proc, match_sets, wall = run_cli(job, tmp, "cli")
    err, n_matches = match_errors(match_sets, job)
    last_line = proc.stdout.strip().splitlines()[-1]
    # the CLI's own count of level-kernel launches, from its `done:` line:
    # 16 pairs are one group, whose solve launches once per pyramid level
    found = re.search(r"'tvl1_level_solve': (\d+)", last_line)
    launches = int(found.group(1)) if found else None
    # the decoder the CLI's runner used, from its `done:` line
    found = re.search(r"'decoder': '([\w-]+)'", last_line)
    used = found.group(1) if found else None
    expected = expected_decoder()
    decode_s = re.search(r"'decode_s': ([0-9.e-]+)", last_line)
    emit({"phase": "cli", "decoder": used, "expected_decoder": expected,
          "decode_s": float(decode_s.group(1)) if decode_s else None,
          "pairs": len(match_sets),
          "gated_matches": n_matches, "match_err_px": err, "gate_px": 1.0,
          "launches": launches, "wall_s": wall, "last_line": last_line})
    if used != expected:
        fail(f"the CLI decoded with {used}, expected {expected}")
    if launches is None or launches < 10:
        fail(f"the CLI reported {launches} level-kernel launches, "
             "expected at least 10 (one per pyramid level)")
    if len(match_sets) != n_pairs:
        fail(f"the CLI emitted {len(match_sets)} match sets, not {n_pairs}")
    if err is None or not err <= 1.0:
        fail(f"CLI mean match error {err} > 1.0 full-res px")


def section_job(names, n_pairs, output_type, out_dir, tag):
    """Reference-schema job dict: chained pairs of whole sections, one
    `custom` ROI covering the scaled frame, TIFF output."""
    job = build_job(names, n_pairs, None, tag)
    del job["journal"], job["npoints"]
    job.update({
        "output_type": output_type, "output_dir": out_dir, "pair_batch": 4,
        "rois": {"custom": [0, 0, SECTION_W, SECTION_H]}, "features": False,
        "match_sink": "null",  # TIFF output: nothing goes to a match service
    })
    return job


def gate_tiffs(job, output_type, border=16):
    """Mean error of the written fields against the known shift
    dz * (DX_STEP, DY_STEP) * SCALE, working-resolution px, away from the
    border (where the content the shift needs has left the frame)."""
    from optflow_tpu_torch.core.imgio import read_float_tiff

    ys, xs = np.mgrid[0:SECTION_H, 0:SECTION_W].astype(np.float32)
    inner = (slice(border, -border), slice(border, -border))
    errs = []
    for im in job["images"]:
        base = f"{job['output_dir']}/{im['output_name']}_{SCALE:0.2f}"
        fx = read_float_tiff(base + "_x.tiff")
        fy = read_float_tiff(base + "_y.tiff")
        if fx.shape != (SECTION_H, SECTION_W) or fy.shape != fx.shape:
            fail(f"{base}_x.tiff has shape {fx.shape}")
        if not (np.isfinite(fx).all() and np.isfinite(fy).all()):
            fail(f"{base}: field is not finite")
        if output_type == "map":
            fx, fy = fx - xs, fy - ys
        errs.append(float(np.hypot(
            fx[inner] - im["dz"] * DX_STEP * SCALE,
            fy[inner] - im["dz"] * DY_STEP * SCALE,
        ).mean()))
    return errs


def phase_section(results, tmp):
    """Full sections: the level kernel at every level, the finest ones
    included, each section solve held against the plain solver on the card;
    then style-1 jobs of whole sections."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.engine.batch_runner import run_job_batched
    from optflow_tpu_torch.ops import tvl1_cuda
    from optflow_tpu_torch.ops.tvl1 import (
        get_last_iteration_stats,
        level_solve_plain,
        solve_pyramid,
        tvl1_flow_batched,
    )

    dev = torch.device("cuda")
    params = TVL1Params()  # reference defaults
    for n, h, w in SECTION_SOLVES:
        pairs = [make_pair(h, w, DX, DY, seed=40 + s) for s in range(n)]
        i0 = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
        i1 = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
        zero_launch_counts()
        flow = tvl1_flow_batched(i0, i1, params)  # the entry point, checked
        torch.cuda.synchronize()
        counts = read_launch_counts()
        iters = [it.tolist() for _, it in get_last_iteration_stats()]
        epe = float(torch.hypot(flow[..., 0] - DX, flow[..., 1] - DY).mean())

        # the same solve once more, each level's kernel call timed
        records = []

        def timed(a, b, u1, u2, p, u3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = tvl1_cuda._level_solver(a, b, u1, u2, p, u3)
            end.record()
            records.append((tuple(a.shape), start, end, out[3],
                            tvl1_cuda.tvl1_level_solve.last_work))
            return out

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow2 = solve_pyramid(i0, i1, params, None, timed)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3

        # and once more, untimed: the wrapper that launched each level, read
        # from the launch counts, and the level's inputs and results (the
        # solver makes new tensors at every level) for the plain level solve
        checked = []

        def recording(a, b, u1, u2, p, u3):
            before = read_launch_counts()
            out = tvl1_cuda._level_solver(a, b, u1, u2, p, u3)
            after = read_launch_counts()
            checked.append(([k for k in after if after[k] != before[k]],
                            (a, b, u1, u2), out))
            return out

        solve_pyramid(i0, i1, params, None, recording)
        levels = []
        for ((ln, lh, lw), start, end, it, work), (kernels, ins, out) in zip(
                records, checked):
            total = int(it.sum())
            bound, bound_by = level_bound_ms(ln, lh, lw, params.warps, total)
            p1, p2, pit = tvl1_cuda.tvl1_level_solve_plain(*ins, params)
            levels.append({
                "shape": [ln, lh, lw], "kernels": kernels,
                "kernel_ms": start.elapsed_time(end), "iters_sum": total,
                # chunks run past an exit and replays included: never fewer
                # than the iterations counted
                "iters_computed_sum": int(work[0].sum()),
                "iters_computed_at_least_counted":
                bool((work[0] >= it).all()),
                "iters_max": int(it.max()), "bound_ms": bound,
                "bound_by": bound_by,
                "vs_plain_same_inputs_max_abs_px":
                flow_diff(out[:2], (p1, p2)),
                "iters_equal_plain_same_inputs":
                bool(torch.equal(out[3], pit)),
            })
        # the plain solver on the same card and inputs: the exit after every
        # iteration at every level, as the kernel's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = solve_pyramid(i0, i1, params, None, level_solve_plain)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        plain_iters = [it.tolist() for _, it in get_last_iteration_stats()]
        plain_diff = max_abs_diff(flow, plain)
        plain_mean = float((flow - plain).abs().mean())
        emit({"phase": "section", "shape": [n, h, w], "epe_px": epe,
              "gate_px": 0.5, "solve_ms": ms, "enqueue_ms": enqueue_ms,
              "mp_pairs_per_s": n * h * w / 1e6 / (ms / 1e3),
              "launches": counts,
              "rerun_max_abs_diff": max_abs_diff(flow, flow2),
              "plain_solve_ms": plain_ms, "vs_plain_max_abs_px": plain_diff,
              "vs_plain_mean_abs_px": plain_mean,
              "vs_plain_tolerance": SECTION_VS_PLAIN_PX,
              "level_vs_plain_tolerance": 1e-3, "iters_per_level": iters,
              "iters_per_level_plain": plain_iters, "levels": levels})
        if tuple(flow.shape) != (n, h, w, 2) or not bool(
                torch.isfinite(flow).all()):
            fail(f"section flow at {(n, h, w)}: wrong shape or not finite")
        if counts["tvl1_blocked_level_solve"] != 0 \
                or counts["tvl1_level_solve"] != len(levels):
            fail(f"the {(n, h, w)} solve launched {counts}, expected the "
                 f"level kernel at each of its {len(levels)} levels and the "
                 "blocked kernel never")
        if any(l["kernels"] != ["tvl1_level_solve"]
               or not l["iters_computed_at_least_counted"] for l in levels):
            fail(f"a level of the {(n, h, w)} solve was not solved by one "
                 f"launch of the level kernel, or computed fewer iterations "
                 f"than it counted: {levels}")
        if any(not l["vs_plain_same_inputs_max_abs_px"] <= 1e-3
               or not l["iters_equal_plain_same_inputs"] for l in levels):
            fail(f"a level of the {(n, h, w)} solve is more than 1e-3 px "
                 f"from the plain level solve on its own inputs, or counted "
                 f"other iterations: {levels}")
        if not plain_diff <= SECTION_VS_PLAIN_PX or iters != plain_iters:
            fail(f"section solve at {(n, h, w)}: {plain_diff} px from the "
                 f"plain solver (tolerance {SECTION_VS_PLAIN_PX}), counts "
                 f"{iters} against {plain_iters}")
        if not epe <= 0.5:
            fail(f"section solve at {(n, h, w)}: mean EPE {epe} > 0.5 px")
        del i0, i1, flow, flow2, plain

    # style-1 jobs of whole sections with TIFF output, frames from memory
    n_frames = 8 // MAX_DZ + MAX_DZ + 1
    sections = (results.get("sections")
                or gen_sections(n_frames, SRC_H, SRC_W))[:n_frames]
    names = [f"mem://sec_{z:04d}" for z in range(n_frames)]
    half = {
        nm: s.reshape(SRC_H // 2, 2, SRC_W // 2, 2).astype(np.float32)
        .mean(axis=(1, 3))
        for nm, s in zip(names, sections)
    }
    for output_type, n_pairs in (("map", 8), ("flow", 2)):
        out_dir = os.path.join(tmp, f"section_{output_type}")
        job = section_job(names, n_pairs, output_type, out_dir, output_type)
        # a main path: counts are set to 0 just before and read just after
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = run_job_batched(
                job, loader=lambda path, scale: half[path], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launch_counts()
        errs = gate_tiffs(job, output_type)
        emit({"phase": "section", "job": output_type, "pairs": stats["pairs"],
              "batched": stats["batched"], "files": 2 * n_pairs,
              "field_err_px": errs, "gate_px": 0.5, "wall_s": wall,
              "mp_pairs_per_s":
              stats["pairs"] * SECTION_H * SECTION_W / 1e6 / wall,
              "launches": counts, "solve_device": stats.get("solve_device"),
              "timing": stats["timing"]})
        if stats["batched"] != n_pairs or stats["sequential"] != 0:
            fail(f"expected all {n_pairs} {output_type} pairs batched: {stats}")
        if counts["tvl1_level_solve"] < 1 \
                or counts["tvl1_blocked_level_solve"] != 0:
            fail(f"the {output_type} job launched {counts}, expected the "
                 "level kernel and never the blocked kernel")
        if not str(stats.get("solve_device", "")).startswith("cuda"):
            fail(f"the {output_type} job ran on {stats.get('solve_device')}")
        if not max(errs) <= 0.5:
            fail(f"{output_type} job: field error {max(errs)} > 0.5 px")
        if output_type == "map":
            launches = results.setdefault("launches", {})
            launches["tvl1_level_solve"] = (
                launches.get("tvl1_level_solve", 0)
                + counts["tvl1_level_solve"])


def phase_level_api(results):
    """The per-level API: tvl1_flow with the level solver that
    default_level_solver picks for CUDA tensors, the chunk kernel's level
    entry: one library call and at most two kernel launches a level."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1 import default_level_solver, tvl1_flow

    dev = torch.device("cuda")
    im0, im1 = make_pair(SECTION_H, SECTION_W, DX, DY, seed=3)
    i0 = torch.from_numpy(im0).to(dev)
    i1 = torch.from_numpy(im1).to(dev)
    params = TVL1Params()
    solver = default_level_solver(i0, i1)
    tvl1_flow(i0, i1, params, level_solver=solver)  # warm-up
    # a main path: counts are set to 0 just before and read just after
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = tvl1_flow(i0, i1, params, level_solver=solver)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_launch_counts()
    # the chunk library's kernel launches and memsets for one pair, tallied
    # by the library (no other library runs on this path)
    chunk_enqueued, chunk_memops = enqueued_launches(
        lambda: tvl1_flow(i0, i1, params, level_solver=solver))
    # two more runs show the spread, each on an idle card
    more_ms, more_enqueue_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tvl1_flow(i0, i1, params, level_solver=solver)
        more_enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        more_ms.append((time.perf_counter() - t0) * 1e3)
    # what the card ran for one pair, where the profiler can trace it (else
    # None and 0): the level kernel's launches, and everything else (the
    # plain PyTorch pyramid and the flow's upscaling between levels)
    trace = trace_device(
        lambda: tvl1_flow(i0, i1, params, level_solver=solver))
    level_launches = sum(c for name, c in trace["kernels"].items()
                         if "level_kernel" in name)
    epe = float(torch.hypot(flow[..., 0] - DX, flow[..., 1] - DY).mean())
    emit({"phase": "level_api", "shape": [SECTION_H, SECTION_W],
          "solver": solver.__name__, "epe_px": epe, "gate_px": 0.5,
          "solve_ms": ms, "enqueue_ms": enqueue_ms,
          "solve_ms_two_more_runs": more_ms,
          "enqueue_ms_two_more_runs": more_enqueue_ms,
          "device_busy_ms": trace["busy_ms"], "profiler": trace["note"],
          "chunk_library_launches": chunk_enqueued,
          "chunk_library_memops": chunk_memops,
          "chunk_library_launches_at_most": 2 * params.nscales,
          "level_kernel_launches_traced": level_launches,
          "device_kernels_traced": sum(trace["kernels"].values()),
          "device_memops_traced": trace["memops"],
          "wrapper_launches": counts["tvl1_chunk_level_solve"],
          "wrapper_launches_expected": params.nscales,
          "launches": counts})
    if tuple(flow.shape) != (SECTION_H, SECTION_W, 2) or not bool(
            torch.isfinite(flow).all()):
        fail("level_api flow: wrong shape or not finite")
    # one call into the chunk kernel's library per level, and nothing else
    # of it
    if counts["tvl1_chunk_level_solve"] != params.nscales \
            or counts["tvl1_chunk_sweep"] or counts["tvl1_chunk"]:
        fail(f"tvl1_flow(level_solver=...) called the chunk kernel's "
             f"library {counts}, expected the level entry once per level: "
             f"{params.nscales}")
    if chunk_enqueued > 2 * params.nscales:
        fail(f"the chunk library enqueued {chunk_enqueued} kernels for "
             f"{params.nscales} levels, more than two a level")
    if not epe <= 0.5:
        fail(f"level_api: mean EPE {epe} > 0.5 px")
    # the chunk kernel's launches on this path
    results.setdefault("launches", {})["tvl1_chunk"] = (
        counts["tvl1_chunk_level_solve"])


# --------------------------------------------------------------------------
# features: pre-alignment end to end
# --------------------------------------------------------------------------


def rigid(theta, tx, ty, cx, cy):
    """3x3 rotation by ``theta`` about (cx, cy) followed by a shift."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, s, cx - c * cx - s * cy + tx],
                     [-s, c, cy + s * cx - c * cy + ty],
                     [0.0, 0.0, 1.0]])


def render_frames(tex, mats, h, w):
    """frame_k(p) = tex(C_k p) for each 3x3 ``C_k`` (x, y order), cubic."""
    import scipy.ndimage as ndi

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = []
    for c in mats:
        sx = c[0, 0] * xs + c[0, 1] * ys + c[0, 2]
        sy = c[1, 0] * xs + c[1, 1] * ys + c[1, 2]
        frames.append(ndi.map_coordinates(tex, [sy, sx], order=3,
                                          mode="nearest"))
    return frames


def chained_strip_stack(n_frames, h=SOLVE_H, w=SOLVE_W, seed=5, pad=128):
    """A chained stack of strips with a KNOWN affine per consecutive pair, as
    the JAX package's feature bench makes its pairs: frame k+1 is frame k
    seen through a small rigid motion M_k (rotation <= 0.5 degrees about the
    centre, translation <= 6 px), every frame rendered from one texture.
    Returns (frames (n, h, w) float32, M (n-1, 2, 3)): M_k maps frame k+1's
    coordinates into frame k's, what find_alignment(frame k+1, frame k)
    should recover."""
    rng = np.random.default_rng(seed)
    tex, _ = make_pair(h + 2 * pad, w + 2 * pad, 0.0, 0.0, seed=seed)
    cum = np.eye(3)
    cum[:2, 2] = pad
    mats, rel = [cum], []
    for _ in range(n_frames - 1):
        m = rigid(np.deg2rad(rng.uniform(-0.5, 0.5)), rng.uniform(-6, 6),
                  rng.uniform(-6, 6), w / 2, h / 2)
        rel.append(m[:2])
        mats.append(mats[-1] @ m)
    frames = render_frames(tex.astype(np.float64), mats, h, w)
    return (np.stack(frames).astype(np.float32), np.stack(rel))


def misaligned_sections(n_frames, seed=13):
    """uint8 sections as :func:`gen_sections` makes them (the same per-z
    shift), each also shifted (<= 3 full-res px) and slightly rotated
    (<= 0.02 degrees about its centre) on its own, so a pair differs by up
    to 6 px beside its z shift. The rotation is kept small on purpose: the
    reference resamples a strip's ROI-LOCAL map with the FULL-FRAME affine
    (src/optflow.cpp:429-432, kept by both packages for output parity), so
    a rotation theta displaces the matches of a strip that starts at row y
    by theta * y; 0.5 degrees would cost the bottom strip 4 px. Returns
    (sections, C): section z shows the texture at C_z p (3x3, full-res
    x, y)."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    pad_h = int(abs(DY_STEP) * n_frames) + 48
    pad_w = int(abs(DX_STEP) * n_frames) + 48
    big_h, big_w = SRC_H + pad_h, SRC_W + pad_w
    base = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 4.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 36.0)
    tex = base * 2.0 + lowf * 4.0
    tex = 20.0 + 215.0 * (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    mats = []
    for z in range(n_frames):
        c = rigid(np.deg2rad(rng.uniform(-0.02, 0.02)), rng.uniform(-3, 3),
                  rng.uniform(-3, 3), SRC_W / 2, SRC_H / 2)
        c[0, 2] += pad_w / 2 - DX_STEP * (z - n_frames / 2)
        c[1, 2] += pad_h / 2 - DY_STEP * (z - n_frames / 2)
        mats.append(c)
    sections = [
        np.clip(f + rng.normal(0.0, 1.5, f.shape), 0, 255).astype(np.uint8)
        for f in render_frames(tex, mats, SRC_H, SRC_W)
    ]
    return sections, mats


def gate_matches_rigid(match_sets, job, mats, margin=32):
    """Distance, full-res px, of every emitted q from where the known motion
    puts p: q_true = C_q^-1 C_p p. Returns (mean over the interior samples,
    their count, count of all samples, median over all samples).

    With features on, the emitted map is resampled by the pair's affine with
    a constant border (cv::warpAffine): a sample within a few pixels of its
    ROI's border reads the fill value and lands far off, in the reference as
    here. The gate is over the samples at least ``margin`` full-res px
    inside their ROI; the others are counted and reported."""
    inv_scale = 1.0 / SCALE
    errs, inner = [], []
    for ms, im in zip(match_sets, job["images"]):
        if (ms["pId"], ms["qId"]) != (im["pId"], im["qId"]):
            fail("match sets are not in the job's order")
        m = ms["matches"]
        if not m["w"] or max(m["w"]) == 0:
            continue
        p = np.asarray(m["p"], np.float64)
        q = np.asarray(m["q"], np.float64)
        t = np.linalg.inv(mats[im["z1"]]) @ mats[im["z0"]]
        truth = t[:2, :2] @ p + t[:2, 2:3]
        errs.append(np.hypot(*(q - truth)))
        rois = im.get("rois", job.get("rois"))
        bands = [(0, SRC_H)] if rois is None else [
            (0, rois["top"] * inv_scale),
            (SRC_H - rois["bottom"] * inv_scale, SRC_H)]
        in_band = np.zeros(p.shape[1], bool)
        for lo, hi in bands:
            in_band |= (p[1] >= lo + margin) & (p[1] < hi - margin)
        inner.append(in_band & (p[0] >= margin) & (p[0] < SRC_W - margin))
    if not errs:
        return None, 0, 0, None
    allerr, inner = np.concatenate(errs), np.concatenate(inner)
    return (float(allerr[inner].mean()), int(inner.sum()), int(allerr.size),
            float(np.median(allerr)))


def feature_job(names, n_pairs, journal, tag, default_roi_pairs=0):
    """The strip job of :func:`build_job` with features ON: the SURF-class
    detector (``features: 2``) at its defaults, hessianThreshold 400. The
    last ``default_roi_pairs`` pairs carry no ROI: they take the `default`
    ROI, the whole frame, which forces features by itself."""
    job = build_job(names, n_pairs, journal, tag)
    job["features"] = 2
    index = {nm: z for z, nm in enumerate(names)}
    for im in job["images"]:
        im["z0"], im["z1"] = index[im["p"]], index[im["q"]]
    if default_roi_pairs:
        rois = job.pop("rois")
        for im in job["images"][:-default_roi_pairs]:
            im["rois"] = rois
    return job


def phase_features(results, tmp):
    """Feature pre-alignment: the indexed aligner on a chained stack with
    known affines, a style-1 job with features on through run_job_batched
    and through the CLI, and the two degenerate cases."""
    import torch

    from optflow_tpu_torch.core import imgio
    from optflow_tpu_torch.core.config import (
        MatchParams, OrbParams, SurfParams, SURF_TYPE,
    )
    from optflow_tpu_torch.engine.batch_runner import run_job_batched
    from optflow_tpu_torch.features import align, detect
    from optflow_tpu_torch.ops.warp import affine_warp

    dev = torch.device("cuda")
    orb, surf, mp = OrbParams(), SurfParams(), MatchParams()

    # the detector's convolutions must run in full float32 on the card
    probe = torch.from_numpy(make_pair(128, 256, 0.0, 0.0, seed=2)[0])[None]
    k2 = detect._gauss_kernel(2.0, 2)
    on_card = detect._conv1d(detect._conv1d(probe.to(dev), k2, 0), k2, 1).cpu()
    on_host = detect._conv1d(detect._conv1d(probe, k2, 0), k2, 1)
    conv_rel = float((on_card - on_host).abs().max() / on_host.abs().max())
    if not conv_rel <= 1e-5:
        fail(f"the detector's convolution differs between the card and the "
             f"host by {conv_rel} of its range: not float32 arithmetic")

    # (a) the frame-deduplicated aligner, 17 frames -> 16 pairs
    n_pairs = 16
    frames_np, truth = chained_strip_stack(n_pairs + 1)
    frames = torch.from_numpy(frames_np).to(dev)
    dst_idx = torch.arange(n_pairs, device=dev)
    src_idx = dst_idx + 1

    def stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        kps, desc, binary = align._detect_describe_device(
            frames, SURF_TYPE, orb, surf)
        ev[1].record()
        res = align.match_and_fit_indexed(
            kps, desc, src_idx, dst_idx, binary, mp)
        ev[2].record()
        warped = affine_warp(frames[src_idx], res.affine)
        ev[3].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        return kps, res, warped, ms

    stages()  # warm-up
    kps, res, warped, ms = stages()
    whole = align.find_alignment_indexed(
        frames, src_idx, dst_idx, SURF_TYPE, orb, surf, mp)
    aff = res.affine.double().cpu().numpy()
    h, w = frames_np.shape[1:]
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                        [w - 1, h - 1, 1]], np.float64).T
    corner_errs = [float(np.abs(aff[i] @ corners - truth[i] @ corners).max())
                   for i in range(n_pairs)]
    # what the warp leaves for the solver: warped frame k+1 against frame k
    inner = (slice(None), slice(16, -16), slice(16, -16))
    residual = float((warped - frames[:n_pairs])[inner].abs().mean())
    unaligned = float((frames[1:] - frames[:n_pairs])[inner].abs().mean())
    emit({"phase": "features", "part": "indexed",
          "shape": list(frames_np.shape), "pairs": n_pairs,
          "capacity": int(kps.x.shape[1]),
          "valid_keypoints_mean": float(kps.valid.sum(1).float().mean()),
          "n_good": res.n_good.tolist(), "enough": res.enough.tolist(),
          "homo_ok": res.homo_ok.tolist(),
          "corner_err_px": corner_errs,
          "corner_err_mean_px": float(np.mean(corner_errs)), "gate_px": 3.0,
          "abs_diff_unaligned": unaligned, "abs_diff_aligned": residual,
          "detect_describe_ms": ms[0], "match_fit_ms": ms[1],
          "warp_ms": ms[2], "conv_card_vs_host_rel": conv_rel,
          "same_affine_from_entry_point":
          max_abs_diff(whole.affine, res.affine)})
    if not (bool(res.enough.all()) and bool(res.homo_ok.all())):
        fail("a pair of the chained stack failed its gates")
    if not np.mean(corner_errs) <= 3.0:
        fail(f"mean affine corner error {np.mean(corner_errs)} > 3.0 px")
    if not residual < unaligned:
        fail("warping by the recovered affines did not bring the frames "
             "closer")
    if max_abs_diff(whole.affine, res.affine) != 0.0:
        fail("find_alignment_indexed differs from its two halves")
    del frames, warped, kps, res, whole

    # (b) 32 misaligned strip pairs through run_job_batched, features on
    n_pairs = 32
    n_frames = n_pairs // MAX_DZ + MAX_DZ + 1
    t0 = time.perf_counter()
    sections, mats = misaligned_sections(n_frames)
    synth_s = time.perf_counter() - t0
    names = [f"mem://mis_{z:04d}" for z in range(n_frames)]
    half = {
        nm: s.reshape(SRC_H // 2, 2, SRC_W // 2, 2).astype(np.float32)
        .mean(axis=(1, 3))
        for nm, s in zip(names, sections)
    }
    job = feature_job(names, n_pairs, os.path.join(tmp, "feat.journal"),
                      "feat")
    sink = MockRenderSink()
    # a main path: counts are set to 0 just before and read just after
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = run_job_batched(job, sink=sink,
                                loader=lambda path, scale: half[path],
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launch_counts()["tvl1_level_solve"]
    err, n_inner, n_matches, err_median = gate_matches_rigid(
        sink.match_sets, job, mats)
    groups = -(-n_pairs // job["pair_batch"])
    uniq = [len({nm for im in job["images"][g * 16:(g + 1) * 16]
                 for nm in (im["p"], im["q"])}) for g in range(groups)]
    mp_per_pair = 2 * STRIP * (SRC_W * SCALE) / 1e6
    t = stats["timing"]
    emit({"phase": "features", "part": "job", "pairs": stats["pairs"],
          "batched": stats["batched"], "sequential": stats["sequential"],
          "matches": stats["matches"], "emitted_matches": n_matches,
          "gated_matches": n_inner, "match_err_px": err, "gate_px": 1.0,
          "match_err_median_all_px": err_median, "wall_s": wall,
          "mp_pairs_per_s": stats["pairs"] * mp_per_pair / wall,
          "detected_frames": stats["detected_frames"],
          "unique_frames_per_group": uniq, "launches": launches,
          "gate_messages": out.getvalue().count("transformation"),
          "prealign_share_of_prealign_plus_solve":
          t.get("prealign_device_s", 0.0)
          / max(t.get("prealign_device_s", 0.0)
                + t.get("solve_device_s", 0.0), 1e-9),
          "synth_s": round(synth_s, 2), "timing": t})
    if stats["batched"] != n_pairs or stats["sequential"] != 0:
        fail(f"expected all {n_pairs} feature pairs batched: {stats}")
    if stats["detected_frames"] != sum(uniq):
        fail(f"{stats['detected_frames']} frames went through detect + "
             f"describe; the groups hold {uniq} unique frames")
    if launches < 1:
        fail("the feature job did not launch the level kernel")
    if stats["matches"] != n_pairs * 2 * 25:
        fail(f"expected {n_pairs * 50} matches, got {stats['matches']}")
    if err is None or not err <= 1.0:
        fail(f"feature job: mean match error {err} > 1.0 full-res px")

    # (c) 16 pairs from PNG files through the CLI without --no-features;
    # the last two pairs carry no ROI and take the `default` one
    decoder = imgio.decoder_name()
    if decoder is None:
        emit({"phase": "features", "part": "cli",
              "skipped": "no image decoder installed"})
    else:
        n_pairs = 16
        n_cli_frames = n_pairs // MAX_DZ + MAX_DZ + 1
        paths = write_pngs(sections[:n_cli_frames],
                           os.path.join(tmp, "mis_stack"), decoder)
        job = feature_job(paths, n_pairs, os.path.join(tmp, "fcli.journal"),
                          "fcli", default_roi_pairs=2)
        proc, match_sets, wall = run_cli(job, tmp, "fcli")
        if len(match_sets) != n_pairs:
            fail(f"the CLI emitted {len(match_sets)} match sets, "
                 f"not {n_pairs}")
        err, n_inner, n_matches, err_median = gate_matches_rigid(
            match_sets, job, mats)
        last_line = proc.stdout.strip().splitlines()[-1]
        found = re.search(r"'tvl1_level_solve': (\d+)", last_line)
        emit({"phase": "features", "part": "cli", "decoder": decoder,
              "pairs": len(match_sets), "default_roi_pairs": 2,
              "emitted_matches": n_matches, "gated_matches": n_inner,
              "match_err_px": err, "gate_px": 1.0,
              "match_err_median_all_px": err_median, "wall_s": wall,
              "last_line": last_line})
        if "'sequential': 0" not in last_line or not found \
                or int(found.group(1)) < 1:
            fail(f"the CLI's feature job did not batch every pair through "
                 f"the level kernel: {last_line}")
        if err is None or not err <= 1.0:
            fail(f"CLI feature job: mean match error {err} > 1.0 px")

    # (d) the degenerate cases
    frame = half[names[0]]
    same = align.find_alignment(frame, frame, {}, {}, device="cuda")
    fh, fw = frame.shape
    corners = np.array([[0, 0, 1], [fw - 1, 0, 1], [0, fh - 1, 1],
                        [fw - 1, fh - 1, 1]], np.float64).T
    ident_err = float(np.abs(same.astype(np.float64) @ corners
                             - corners[:2]).max())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        flat = align.find_alignment(np.full_like(frame, 90.0), frame, {}, {},
                                    device="cuda")
    emit({"phase": "features", "part": "degenerate",
          "identical_frames_corner_err_px": ident_err, "gate_px": 0.05,
          "flat_frame_message": out.getvalue().strip(),
          "flat_frame_affine": flat.tolist()})
    if not ident_err <= 0.05:
        fail(f"identical frames gave an affine {ident_err} px from the "
             f"identity at the corners")
    if "Not enough matches. Using no transformation" not in out.getvalue() \
            or not np.array_equal(flat, align.IDENTITY):
        fail("a flat frame must print the reference's message and fall to "
             "the identity")


# --------------------------------------------------------------------------
# style 2: the average-flow stack aligner
# --------------------------------------------------------------------------


def jittered_stack(n_frames, seed=21, src_h=SRC_H, src_w=SRC_W):
    """uint8 sections cut from one band-limited texture (that of
    ``gen_sections``), each displaced by its own sub-pixel jitter, uniform
    in +-STYLE2_JITTER_PX on each axis, plus per-section noise. Returns
    (sections, offsets (n, 2), texture): section z at pixel (x, y) shows
    ``texture(y + pad, x + pad)`` at (x, y) + offsets[z], pad = 8."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    pad = 8
    big_h, big_w = src_h + 2 * pad, src_w + 2 * pad
    base = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 4.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 36.0)
    tex = base * 2.0 + lowf * 4.0
    tex = 20.0 + 215.0 * (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    offsets = rng.uniform(-STYLE2_JITTER_PX, STYLE2_JITTER_PX, (n_frames, 2))
    ys, xs = np.arange(src_h) + pad, np.arange(src_w) + pad
    frames = []
    for ox, oy in offsets:
        gy, gx = np.meshgrid(ys + oy, xs + ox, indexing="ij")
        sec = ndi.map_coordinates(tex, [gy, gx], order=3, mode="nearest")
        sec = sec + rng.normal(0.0, 1.5, sec.shape)
        frames.append(np.clip(np.round(sec), 0, 255).astype(np.uint8))
    return frames, offsets, tex


def registration_error(image, tex, origin, step=4, sweeps=3):
    """The shift s (x, y) at which ``image`` best matches the texture placed
    at ``origin``: image(x, y) ~ tex(y + origin_y + s_y, x + origin_x + s_x),
    by Gauss-Newton on a grid of every ``step``-th pixel; and the rms of the
    gray levels left over."""
    import scipy.ndimage as ndi

    gy, gx = np.mgrid[0:image.shape[0]:step, 0:image.shape[1]:step]
    vals = image[gy, gx].ravel().astype(np.float64)
    d_y, d_x = np.gradient(tex)
    s = np.zeros(2)
    for _ in range(sweeps):
        at = [(gy + origin[1] + s[1]).ravel(), (gx + origin[0] + s[0]).ravel()]
        r = vals - ndi.map_coordinates(tex, at, order=3, mode="nearest")
        jac = np.stack([ndi.map_coordinates(d_x, at, order=1),
                        ndi.map_coordinates(d_y, at, order=1)], axis=1)
        s += np.linalg.lstsq(jac, r, rcond=None)[0]
    at = [(gy + origin[1] + s[1]).ravel(), (gx + origin[0] + s[0]).ravel()]
    rest = vals - ndi.map_coordinates(tex, at, order=3, mode="nearest")
    return s, float(np.sqrt(np.mean(rest**2)))


def phase_style2(results, tmp):
    """Style 2 through ``average_flow_job``: 13 sections of the bench's
    1024x2048 frames at scale 0.5 (512x1024 solves, reference solver
    defaults) and a zero border of STYLE2_BORDER px give 7 aligned sections;
    every section's pyramid is solved by the level kernel at every level
    with the exact exit. Gates: the flows the job solved toward each
    neighbourhood average against their known truth; the TIFFs it wrote
    against the texture at the neighbourhood's mean jitter; one of its
    solves against the plain solver on the card; and the kernel counts: 10
    launches of the level kernel a section, none of the blocked kernel.
    Then a small style-2 job through the CLI."""
    import torch

    from optflow_tpu_torch.align import average_flow
    from optflow_tpu_torch.align.average_flow import WEIGHTS, average_flow_job
    from optflow_tpu_torch.core import imgio
    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops import tvl1 as tv
    from optflow_tpu_torch.ops.pyramid import resize_bilinear
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_flow_batched_cuda
    from optflow_tpu_torch.utils.metrics import StageTimer

    decoder = imgio.decoder_name()
    if decoder is None:
        emit({"phase": "style2", "skipped": "no image decoder installed"})
        return
    n = STYLE2_SECTIONS
    t0 = time.perf_counter()
    sections, offsets, tex = jittered_stack(n)
    synth_s = time.perf_counter() - t0
    paths = write_pngs(sections, os.path.join(tmp, "style2"), decoder)
    out_dir = os.path.join(tmp, "style2_out")
    job = {"style": 2, "file_list": paths, "output_dir": out_dir,
           "scale": SCALE, "border": STYLE2_BORDER}
    # TV-L1 keys absent: the reference defaults
    params = TVL1Params.from_config({}, job)
    timer = StageTimer()
    # the job's own solves, in order: (section, average, flow)
    solved = []
    solve_flow = average_flow._solve_flow

    def recording_solve(frame, blur, scale, prm):
        flow = solve_flow(frame, blur, scale, prm)
        solved.append((frame, blur, flow))
        return flow

    # a main path: counts are set to 0 just before and read just after
    average_flow._solve_flow = recording_solve
    try:
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as progress:
            written = average_flow_job(job, device="cuda", timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launch_counts()
    finally:
        average_flow._solve_flow = solve_flow
    timing = timer.summary(len(written))
    n_out = n - 6
    levels = len(tv.pyramid_shapes(SECTION_H, SECTION_W, params.nscales,
                                   params.scale_step))
    if len(solved) != n_out:
        fail(f"style 2 solved {len(solved)} sections, expected {n_out}")

    # the flow the job solved for output section i, toward its neighbourhood
    # average, against the truth: section i shows the texture at x + o_i,
    # the average at x + mean_i, mean_i = sum_k w_k o_(i+k)
    m = 16  # full-res px of border left out of the EPE
    means, epes = {}, []
    for i, (_, _, flow) in zip(range(3, n - 3), solved):
        neighbours = list(range(i - 3, i)) + list(range(i + 1, i + 4))
        means[i] = sum(w * offsets[j] for w, j in zip(WEIGHTS, neighbours))
        truth = offsets[i] - means[i]
        err = torch.hypot(flow[0] - truth[0], flow[1] - truth[1])
        epes.append(float(err[m:-m, m:-m].mean()))
    # each written section, resampled onto the average's frame and padded,
    # against the texture at the average's jitter: its interior at
    # (x, y) should show tex(y - border + pad + mean_y, x - border + pad +
    # mean_x)
    outputs = [imgio.read_float_tiff(p) for p in written]
    inner = STYLE2_BORDER + m
    shifts, rests = [], []
    for i, out in zip(range(3, n - 3), outputs):
        if out.shape != (SRC_H + 2 * STYLE2_BORDER, SRC_W + 2 * STYLE2_BORDER) \
                or not np.isfinite(out).all():
            fail(f"style 2 wrote {written[i - 3]} of shape {out.shape}, "
                 "expected a finite 1024x2048 section and its border")
        origin = means[i] + 8 - STYLE2_BORDER + inner
        shift, rest = registration_error(out[inner:-inner, inner:-inner], tex,
                                         origin)
        shifts.append(float(np.hypot(*shift)))
        rests.append(rest)

    # one of the job's solves through the level kernel at every level
    # against the plain solver on the same card
    frame, blur, _ = solved[n_out // 2]
    sh = (SECTION_H, SECTION_W)
    f_s = resize_bilinear(frame, sh)[None]
    b_s = resize_bilinear(blur, sh)[None]
    t_exact = time_cuda(lambda: tvl1_flow_batched_cuda(f_s, b_s, params), 1)
    exact = tvl1_flow_batched_cuda(f_s, b_s, params)
    exact_iters = [int(it.sum()) for _, it in tv.get_last_iteration_stats()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = tv.solve_pyramid(f_s, b_s, params, None, tv.level_solve_plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_iters = [int(it.sum()) for _, it in tv.get_last_iteration_stats()]
    plain_diff = max_abs_diff(exact, plain)

    emit({"phase": "style2", "sections": n, "outputs": len(written),
          "shape": [SRC_H, SRC_W], "solve_shape": [SECTION_H, SECTION_W],
          "scale": SCALE, "border": STYLE2_BORDER,
          "epe_px": epes, "epe_mean_px": float(np.mean(epes)),
          "gate_px": 0.5, "output_shift_px": shifts,
          "output_rest_rms_gray": rests,
          "wall_s": wall, "ms_per_section": wall / n_out * 1e3,
          "solve_device_ms_per_section":
          timing.get("solve_device_s", 0.0) / n_out * 1e3,
          "remap_device_ms_per_section":
          timing.get("remap_device_s", 0.0) / n_out * 1e3,
          "write_ms_per_section": timing.get("write_s", 0.0) / n_out * 1e3,
          "timing": timing, "launches": counts,
          "launches_expected": {"tvl1_level_solve": levels * n_out,
                                "tvl1_blocked_level_solve": 0},
          "exact_solve_ms": t_exact, "plain_solve_ms": plain_ms,
          "exact_vs_plain_max_abs_px": plain_diff, "tolerance": 1e-2,
          "iters_per_level_exact": exact_iters,
          "iters_per_level_plain": plain_iters,
          "progress_lines": len(progress.getvalue().splitlines()),
          "synth_s": round(synth_s, 2)})
    if len(written) != n_out:
        fail(f"style 2 wrote {len(written)} sections, expected {n_out}")
    if counts["tvl1_level_solve"] != levels * n_out \
            or counts["tvl1_blocked_level_solve"] != 0:
        fail(f"style 2 launched {counts}, expected the level kernel "
             f"{levels} times a section and the blocked kernel never")
    if not np.mean(epes) <= 0.5:
        fail(f"style 2: mean interior EPE {np.mean(epes)} > 0.5 px")
    if not max(shifts) <= 0.5:
        fail(f"style 2: a written section lies {max(shifts)} px off the "
             "average's frame, gate 0.5 px")
    if not plain_diff <= 1e-2:
        fail(f"style 2: the exact-exit solve is {plain_diff} px from the "
             "plain solver's, tolerance 0.01 px")
    results.setdefault("launches", {})["tvl1_level_solve"] = (
        results.get("launches", {}).get("tvl1_level_solve", 0)
        + counts["tvl1_level_solve"])

    # a small style-2 job from PNGs through the CLI: 7 sections of 256x512,
    # one output
    small = [s[:256, :512] for s in sections[:7]]
    paths = write_pngs(small, os.path.join(tmp, "style2_cli"), decoder)
    cli_out = os.path.join(tmp, "style2_cli_out")
    job_path = os.path.join(tmp, "style2.json")
    with open(job_path, "w") as f:
        json.dump({"style": 2, "file_list": paths, "output_dir": cli_out,
                   "scale": SCALE}, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "optflow_tpu_torch.cli.main", job_path],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
        fail(f"the style-2 CLI exited with code {proc.returncode}")
    last_line = proc.stdout.strip().splitlines()[-1]
    found = {k: re.search(rf"'{k}': (\d+)", last_line)
             for k in ("tvl1_level_solve", "tvl1_blocked_level_solve")}
    cli_counts = {k: int(v.group(1)) if v else None for k, v in found.items()}
    out = os.path.join(cli_out, "3.tiff")
    cli_levels = len(tv.pyramid_shapes(
        *(int(round(d * SCALE)) for d in small[0].shape), params.nscales,
        params.scale_step))
    emit({"phase": "style2", "cli": True, "sections": 7,
          "shape": list(small[0].shape),
          "wall_s": cli_wall, "launches": cli_counts, "last_line": last_line})
    if cli_counts != {"tvl1_level_solve": cli_levels,
                      "tvl1_blocked_level_solve": 0}:
        fail(f"the style-2 CLI reported launches {cli_counts}, expected "
             f"{cli_levels} of the level kernel and none of the blocked one")
    if not os.path.exists(out) or not np.isfinite(
            imgio.read_float_tiff(out)).all():
        fail(f"the style-2 CLI did not write a finite {out}")


# --------------------------------------------------------------------------
# align: the global stack alignment
# --------------------------------------------------------------------------


def alignment_graph(n_sections, seed, affine):
    """Render-schema match records of a production-shaped stack: sections z
    1..n at z-distance <= ALIGN_MAX_DZ, each pair carrying ALIGN_NPOINTS
    points in each of its two strip ROIs (the top and bottom halves of a
    1024x2048 section, in full-res px), and the truth: per-section 2x3
    affines mapping section to global coordinates, translations a random
    walk of steps uniform in +-2 px, with ``affine`` also linear parts
    within 1e-3 of the identity; section 1 is the identity. A match is a
    point p of section a and q = A_b^-1(A_a(p)) + noise of
    ALIGN_NOISE_PX (standard deviation, each axis)."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(-2.0, 2.0, (n_sections, 2))
    steps[0] = 0.0
    mats = np.zeros((n_sections, 2, 3))
    mats[:, 0, 0] = mats[:, 1, 1] = 1.0
    mats[:, :, 2] = np.cumsum(steps, axis=0)
    if affine:
        mats[1:, :, :2] += rng.uniform(-1e-3, 1e-3, (n_sections - 1, 2, 2))
    a = np.concatenate([np.arange(n_sections - dz)
                        for dz in range(1, ALIGN_MAX_DZ + 1)])
    b = np.concatenate([np.arange(dz, n_sections)
                        for dz in range(1, ALIGN_MAX_DZ + 1)])
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    k = ALIGN_NPOINTS
    p = np.empty((len(a), 2 * k, 2))
    p[..., 0] = rng.uniform(0, SRC_W, (len(a), 2 * k))
    p[:, :k, 1] = rng.uniform(0, SRC_H / 2, (len(a), k))
    p[:, k:, 1] = rng.uniform(SRC_H / 2, SRC_H, (len(a), k))
    A, B = mats[a], mats[b]
    g = np.einsum("nij,nmj->nmi", A[:, :, :2], p) + A[:, None, :, 2]
    q = np.einsum("nij,nmj->nmi", np.linalg.inv(B[:, :, :2]),
                  g - B[:, None, :, 2])
    q += rng.normal(0.0, ALIGN_NOISE_PX, q.shape)
    w = [1.0] * (2 * k)
    recs = [{"pGroupId": f"{i + 1}.0", "qGroupId": f"{j + 1}.0",
             "pId": f"tile_{i + 1}", "qId": f"tile_{j + 1}",
             "matches": {"p": pp.T.tolist(), "q": qq.T.tolist(), "w": w}}
            for i, j, pp, qq in zip(a.tolist(), b.tolist(), p, q)]
    return recs, mats, (a, b)


SECTION_CORNERS = np.array([[0.0, 0.0, 1.0], [SRC_W, 0.0, 1.0],
                            [0.0, SRC_H, 1.0], [SRC_W, SRC_H, 1.0]])


def corner_gap(t1, t2):
    """Largest distance, over sections and the four corners of a section,
    between where two stacks of 2x3 transforms send a corner (px)."""
    c1 = np.einsum("zij,cj->zci", np.asarray(t1, np.float64), SECTION_CORNERS)
    c2 = np.einsum("zij,cj->zci", np.asarray(t2, np.float64), SECTION_CORNERS)
    return float(np.linalg.norm(c1 - c2, axis=-1).max())


def relative_gap(t1, t2, a, b):
    """The same for the relative transforms A_b^-1 A_a of the matched pairs
    (a, b): how far apart two solutions register each pair's sections."""
    def rel(t):
        t = np.asarray(t, np.float64)
        full = np.concatenate(
            [t, np.broadcast_to([[[0.0, 0.0, 1.0]]], (len(t), 1, 3))], axis=1)
        return (np.linalg.inv(full[b]) @ full[a])[:, :2]
    return corner_gap(rel(t1), rel(t2))


def exact_alignment(edges, model, reg_lambda=1e-3, products=np.float32):
    """The plain reference of the z-block solve: the same normal equations
    (the same regularisation and gauge pin) assembled as one sparse matrix
    and solved by scipy's sparse LU on the host, in float64. ``edges`` are
    ``_collect_edges``'s arrays. Each edge's products enter rounded to
    ``products``: float32 is what both packages' assembly sums (the JAX
    package's per-edge loop), float64 the exact equations. Returns the
    (Z, 2, 3) float64 transforms in group-id order."""
    from scipy import sparse
    from scipy.sparse.linalg import spsolve

    groups, a, b, p, q, w = edges
    z, m = len(groups), len(w)
    w = w.astype(products)
    ones = np.ones((m, 1), products)
    if model == "translation":
        k, ca, cb, reg = 1, ones, ones, 1e-9
    else:
        k, reg = 3, reg_lambda
        ca = np.concatenate([p.astype(products), ones], axis=1)
        cb = np.concatenate([q.astype(products), ones], axis=1)
    d = (q - p).astype(products)
    rows, cols, vals = [], [], []
    for ia, c1, ib, c2, sign in ((a, ca, a, ca, 1.0), (a, ca, b, cb, -1.0),
                                 (b, cb, a, ca, -1.0), (b, cb, b, cb, 1.0)):
        for j in range(k):
            for col in range(k):
                rows.append(ia * k + j)
                cols.append(ib * k + col)
                vals.append(sign * (w * (c1[:, j] * c2[:, col])))
    pin = np.zeros(z * k)
    pin[:k] = alignment_pin(w)
    N = (sparse.coo_matrix(
        (np.concatenate(vals).astype(np.float64),
         (np.concatenate(rows), np.concatenate(cols))), shape=(z * k, z * k))
         + sparse.diags(reg + pin)).tocsc()
    rhs = np.zeros((z * k, 2))
    for idx, c, sign in ((a, ca, 1.0), (b, cb, -1.0)):
        for j in range(k):
            wc = w * c[:, j]
            for comp in range(2):
                rhs[:, comp] += sign * np.bincount(
                    idx * k + j, weights=(wc * d[:, comp]).astype(np.float64),
                    minlength=z * k)
    x = spsolve(N, rhs).reshape(z, k, 2)
    out = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]]), (z, 1, 1))
    if model == "translation":
        out[:, :, 2] += x[:, 0, :]
    else:
        out += np.transpose(x, (0, 2, 1))
    return out


def alignment_pin(w):
    """The gauge pin on section 0's parameters, as both packages set it."""
    return 2.0 * float(np.sum(w)) + 1.0


def alignment_objective(edges, transforms, model, reg_lambda=1e-3):
    """What the z-block solve minimises, in float64: the weighted squared
    match residuals of ``transforms`` plus the regularisation and the gauge
    pin on their offsets from the identity."""
    groups, a, b, p, q, w = edges
    t = np.asarray(transforms, np.float64)
    ones = np.ones((len(w), 1))
    ph_p = np.concatenate([p.astype(np.float64), ones], axis=1)
    ph_q = np.concatenate([q.astype(np.float64), ones], axis=1)
    res = (np.einsum("mij,mj->mi", t[a], ph_p)
           - np.einsum("mij,mj->mi", t[b], ph_q))
    delta = t - np.array([[1.0, 0, 0], [0, 1.0, 0]])
    if model == "translation":
        delta, reg = delta[:, :, 2], 1e-9
    else:
        reg = reg_lambda
    return float(np.sum(w * np.sum(res**2, axis=1)) + reg * np.sum(delta**2)
                 + alignment_pin(w) * np.sum(delta[0] ** 2))


def objective_excess(recs, transforms, model):
    """How far ``transforms`` stop above the optimum of the alignment
    objective of ``recs``: (f - f*) / f*, f* at the exact solve."""
    from optflow_tpu_torch.align.global_solve import _collect_edges

    edges = _collect_edges(recs)
    f_exact = alignment_objective(
        edges, exact_alignment(edges, model, products=np.float64), model)
    return alignment_objective(edges, transforms, model) / f_exact - 1.0


def first_sections(recs, n):
    """The match records among the first ``n`` sections of a stack."""
    return [r for r in recs if float(r["qGroupId"]) <= n]


def phase_align(results, tmp):
    """Global alignment of the Sec26 VNC production graph's shape: 9,604
    sections at z-distance <= 3 (SURVEY.md:329), 28,806 pairs of 2 strip
    ROIs x 25 points, 1.44 M matches, by the z-block solve on the card
    (blocks of 256) for the translation and the affine model; the CG solves
    on the first 256 sections against the z-block solve of the same
    matches; and ``optflow align`` on a JSONL store of the affine stack."""
    import torch

    from optflow_tpu_torch.align.global_solve import (
        _collect_edges,
        solve_affine_alignment,
        solve_translation_alignment,
    )
    from optflow_tpu_torch.align import zblock
    from optflow_tpu_torch.align.zblock import solve_zblock_alignment
    from optflow_tpu_torch.sinks.store import JsonlMatchSink
    from optflow_tpu_torch.utils.metrics import StageTimer

    n = ALIGN_SECTIONS
    expected_rms = ALIGN_NOISE_PX * np.sqrt(2.0)
    stores = {}
    for model in ("translation", "affine"):
        t0 = time.perf_counter()
        recs, mats, (a, b) = alignment_graph(n, seed=11, affine=model == "affine")
        synth_s = time.perf_counter() - t0
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_zblock_alignment(recs, model=model,
                                     block_sections=ALIGN_BLOCK,
                                     device="cuda", timer=timer)
        wall = time.perf_counter() - t0
        timing = timer.summary()
        edges = _collect_edges(recs)
        t0 = time.perf_counter()
        exact = exact_alignment(edges, model)  # the same equations
        exact_s = time.perf_counter() - t0
        exact64 = exact_alignment(edges, model, products=np.float64)
        # the z-block solution attains the optimum of the exact equations
        f_exact = alignment_objective(edges, exact64, model)

        def readings(t):
            return {"vs_exact_px": corner_gap(t, exact),
                    "vs_exact_float64_products_px": corner_gap(t, exact64),
                    "pair_registration_vs_truth_px":
                    relative_gap(t, mats, a, b),
                    "objective_excess":
                    alignment_objective(edges, t, model) / f_exact - 1.0}

        got = readings(res.transforms)
        # the same solve factorised in float32, the JAX package's dtype
        zblock._SOLVE_DTYPE = torch.float32
        try:
            res32 = solve_zblock_alignment(recs, model=model,
                                           block_sections=ALIGN_BLOCK,
                                           device="cuda")
        finally:
            zblock._SOLVE_DTYPE = torch.float64
        if res.group_ids != [f"{z + 1}.0" for z in range(n)]:
            fail(f"align {model}: sections out of z order")
        vs_truth = corner_gap(res.transforms, mats)
        # the CG solve on the first ALIGN_CG_SECTIONS sections (and on the
        # first 8), and the z-block solve of the same matches
        cg = (solve_affine_alignment if model == "affine"
              else solve_translation_alignment)
        cg_gap, cg_s, cg_excess = {}, {}, {}
        for n_cg in (8, ALIGN_CG_SECTIONS):
            sub = first_sections(recs, n_cg)
            t0 = time.perf_counter()
            cg_res = cg(sub, device="cuda")
            cg_s[n_cg] = time.perf_counter() - t0
            zb_sub = solve_zblock_alignment(sub, model=model,
                                            block_sections=ALIGN_BLOCK,
                                            device="cuda")
            cg_gap[n_cg] = corner_gap(cg_res.transforms, zb_sub.transforms)
            cg_excess[n_cg] = objective_excess(sub, cg_res.transforms, model)
        emit({"phase": "align", "model": model, "sections": len(res.group_ids),
              "pairs": len(recs), "matches": len(recs) * 2 * ALIGN_NPOINTS,
              "block_sections": ALIGN_BLOCK, "noise_px": ALIGN_NOISE_PX,
              "wall_s": wall, "collect_s": timing.get("collect_s"),
              "assemble_s": timing.get("assemble_s"),
              "device_solve_s": timing.get("solve_device_s"),
              "solve_s": timing.get("solve_s"),
              "rms_residual_px": res.residual,
              "rms_expected_px": expected_rms, **got, "exact_s": exact_s,
              "float32_solve": readings(res32.transforms),
              "vs_truth_px": vs_truth,
              "cg_s": cg_s, "cg_vs_zblock_px": cg_gap,
              "cg_objective_excess": cg_excess,
              "synth_s": round(synth_s, 2)})
        if res.transforms.shape != (n, 2, 3) or not np.isfinite(
                res.transforms).all():
            fail(f"align {model}: transforms of shape "
                 f"{res.transforms.shape} or not finite")
        if not got["vs_exact_px"] <= 0.01:
            fail(f"align {model}: the z-block solve is {got['vs_exact_px']} "
                 "px from the exact solve of the same equations, "
                 "tolerance 0.01 px")
        # 1e-5: the transforms come back in float32
        if not abs(got["objective_excess"]) <= 1e-5:
            fail(f"align {model}: the z-block solution's objective is "
                 f"{got['objective_excess']} (relative) off the exact "
                 "least-squares optimum")
        if not res.residual <= 1.5 * expected_rms:
            fail(f"align {model}: rms residual {res.residual} px, the noise "
                 f"gives {expected_rms}")
        if model == "translation":
            pair_gap = got["pair_registration_vs_truth_px"]
            if not pair_gap <= 0.5:
                fail(f"align: the matched pairs are registered {pair_gap} px "
                     "from the truth, gate 0.5 px")
            if not cg_gap[ALIGN_CG_SECTIONS] <= 0.01:
                fail(f"align: CG on {ALIGN_CG_SECTIONS} sections is "
                     f"{cg_gap[ALIGN_CG_SECTIONS]} px from the z-block solve")
        else:
            # on 8 sections the CG reaches the optimum; on 256 it stops
            # where the JAX package's CG stops, within 10 % (float32 sums
            # in another order move an unconverged CG's path)
            if not cg_excess[8] <= 1e-4:
                fail(f"align: the affine CG on 8 sections stops "
                     f"{cg_excess[8]} (relative) above the optimum")
            ratio = cg_excess[ALIGN_CG_SECTIONS] / AFFINE_CG_JAX_EXCESS
            if not abs(ratio - 1.0) <= 0.1:
                fail(f"align: the affine CG on {ALIGN_CG_SECTIONS} sections "
                     f"stops {cg_excess[ALIGN_CG_SECTIONS]} above the "
                     f"optimum, the JAX package's {AFFINE_CG_JAX_EXCESS}")
        stores[model] = (recs, res)
    results["align_stores"] = stores

    # the CLI on a JSONL store of the affine stack
    recs, res = stores["affine"]
    store = os.path.join(tmp, "matches.jsonl")
    t0 = time.perf_counter()
    JsonlMatchSink(store).put(recs)
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "transforms.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "optflow_tpu_torch.cli.main", "align", store,
         "--out", out],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
        fail(f"optflow align exited with code {proc.returncode}")
    with open(out) as f:
        doc = json.load(f)
    cli_t = np.array([doc["transforms"][g] for g in res.group_ids])
    cli_gap = corner_gap(cli_t, res.transforms)
    emit({"phase": "align", "cli": True, "model": doc["model"],
          "sections": len(doc["transforms"]), "store_mb":
          os.path.getsize(store) / 2**20, "store_write_s": write_s,
          "wall_s": cli_wall, "vs_library_px": cli_gap,
          "last_line": proc.stdout.strip().splitlines()[-1]})
    if doc["model"] != "affine" or len(doc["transforms"]) != n \
            or not cli_gap <= 1e-3:
        fail(f"optflow align: {len(doc['transforms'])} sections, "
             f"{cli_gap} px from the library's solve")


# --------------------------------------------------------------------------
# dist: the mesh, the pair scheduler, the tiled solve, the batch runner on a
# mesh, the sharded alignment solves and the pod launcher
# --------------------------------------------------------------------------

DIST_PAIRS = 32  # strip pairs through the scheduler: the job's group size
DIST_ROWS = 4  # rows axis of the tiled solve; the scheduler's pairs axis
DIST_POD_PAIRS = 16  # the cli phase's job
# The translation CGs on the align graph's first sections: float32 atomics
# move each CG's stop run to run, 2.1e-3 px between two runs of the
# one-device CG on an H100, every answer 2.3e-3-3.6e-3 px from the z-block
# optimum. So each runs DIST_CG_RUNS times, every sharded run is held within
# DIST_CG_GATE_PX of every one-device run (3.5e-3 and 3.9e-3 px the widest
# of 16 pairs in two runs) and its objective excess under
# DIST_CG_EXCESS_GATE (3.8e-8-7.3e-8 seen).
DIST_CG_RUNS = 4
DIST_CG_GATE_PX = 7.5e-3
DIST_CG_EXCESS_GATE = 2e-7


def dist_devices():
    """The mesh's devices: every visible card, or cuda:0 entered DIST_ROWS
    times on a one-card machine (its entries share the card and its
    stream). Returns (devices, description)."""
    import torch

    n = torch.cuda.device_count()
    if n > 1:
        # a count that divides the section's 1024 rows
        devs = [torch.device("cuda", i)
                for i in range(DIST_ROWS if n >= DIST_ROWS else 2)]
        return devs, f"{len(devs)} visible cards: " + ", ".join(map(str, devs))
    return ([torch.device("cuda:0")] * DIST_ROWS,
            f"one visible card: cuda:0 entered {DIST_ROWS} times, one stream")


def strip_pairs(sections, n_pairs):
    """``n_pairs`` strip pairs of the job's geometry (half-resolution frames,
    top and bottom strips of STRIP rows) at z-distance <= MAX_DZ, and each
    pair's z-distance."""
    half = [s.reshape(SRC_H // 2, 2, SRC_W // 2, 2).astype(np.float32)
            .mean(axis=(1, 3)) for s in sections]
    pairs, dzs = [], []
    for z in range(len(half)):
        for dz in range(1, MAX_DZ + 1):
            for top in (0, STRIP):
                if z + dz < len(half) and len(pairs) < n_pairs:
                    pairs.append((half[z][top:top + STRIP],
                                  half[z + dz][top:top + STRIP]))
                    dzs.append(dz)
    return pairs, dzs


def interior_epe(flow, dx, dy, margin=16):
    f = np.asarray(flow)[margin:-margin, margin:-margin]
    return float(np.hypot(f[..., 0] - dx, f[..., 1] - dy).mean())


def dist_scheduler(devs, sections):
    """32 strip pairs through PairScheduler over a pairs axis of the mesh's
    devices against one tvl1_flow_batched_cuda call on the same 32."""
    import threading

    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.dist import scheduler as sched_mod
    from optflow_tpu_torch.dist.mesh import make_pair_mesh
    from optflow_tpu_torch.ops.tvl1 import get_last_iteration_stats
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_flow_batched_cuda

    pairs, dzs = strip_pairs(sections, DIST_PAIRS)
    params = TVL1Params()
    mesh = make_pair_mesh(devices=devs)
    sched = sched_mod.PairScheduler(mesh, params)
    i0s = np.stack([p[0] for p in pairs])
    i1s = np.stack([p[1] for p in pairs])

    def one_call():
        flow = tvl1_flow_batched_cuda(torch.from_numpy(i0s).cuda(),
                                      torch.from_numpy(i1s).cuda(), params)
        return flow.cpu().numpy()

    one = one_call()
    one_counts = [it.cpu() for _, it in get_last_iteration_stats()]

    # the shards' iteration counts, read in their own threads (the counts
    # are kept per thread) by a wrapper around the scheduler's solver
    solve, seen, lock = sched_mod.tvl1_flow_batched, [], threading.Lock()

    def recording(a, b, p):
        flow = solve(a, b, p)
        counts = [it.cpu() for _, it in get_last_iteration_stats()]
        with lock:
            seen.append((a[0].cpu().numpy(), counts))
        return flow

    sched_mod.tvl1_flow_batched = recording
    try:
        flows = sched.solve_pairs(pairs)
    finally:
        sched_mod.tvl1_flow_batched = solve
    per = DIST_PAIRS // len(devs)
    order = [next(d for d in range(len(devs))
                  if np.array_equal(a0, i0s[d * per])) for a0, _ in seen]
    shard_counts = [torch.cat([seen[order.index(d)][1][lv]
                               for d in range(len(devs))])
                    for lv in range(len(one_counts))]
    counts_equal = all(torch.equal(a, b)
                       for a, b in zip(shard_counts, one_counts))
    diff = max(float(np.abs(f - o).max()) for f, o in zip(flows, one))
    epe = float(np.mean([interior_epe(f, dz * DX_STEP * SCALE,
                                      dz * DY_STEP * SCALE)
                         for f, dz in zip(flows, dzs)]))

    # the main path: counts set to 0 just before, read just after
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernels, memops = enqueued_launches(lambda: sched.solve_pairs(pairs))
    sched_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_call()
    one_ms = (time.perf_counter() - t0) * 1e3
    return {
        "pairs": len(pairs), "shape": list(i0s.shape[1:]),
        "pairs_axis": len(devs), "max_abs_diff_px": diff, "gate_px": 1e-4,
        "counts_equal": counts_equal, "epe_px": epe, "epe_gate_px": 0.5,
        "scheduler_ms": sched_ms, "single_call_ms": one_ms,
        "level_kernel_launches": launches["tvl1_level_solve"],
        "blocked_kernel_launches": launches["tvl1_blocked_level_solve"],
        "device_launches": kernels, "device_memops": memops,
        "expected_device_launches": len(devs) * len(one_counts),
    }, launches


def dist_tiled(devs, sections):
    """One 1024x2048 section at full resolution through tiled_tvl1_flow over
    a rows axis of the mesh's devices against the monolithic solve."""
    import torch

    import threading

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.dist import tiled
    from optflow_tpu_torch.dist.mesh import make_pair_mesh
    from optflow_tpu_torch.ops import tvl1_cuda
    from optflow_tpu_torch.ops.pyramid import pyramid_shapes
    from optflow_tpu_torch.ops.tvl1 import get_last_iteration_stats
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_flow_batched_cuda

    params = TVL1Params()
    mesh = make_pair_mesh(1, len(devs), devices=devs)
    im0 = sections[0].astype(np.float32)
    im1 = sections[1].astype(np.float32)
    h, w = im0.shape
    n_rows = len(devs)
    block = h // n_rows
    halo = tiled.default_halo(params, 8.0, h, w)
    win = block + 2 * halo
    n_levels = len(pyramid_shapes(win, w, params.nscales, params.scale_step))

    def mono_call():
        return tvl1_flow_batched_cuda(torch.from_numpy(im0)[None].cuda(),
                                      torch.from_numpy(im1)[None].cuda(),
                                      params)[0]

    mono = mono_call()
    # the gather run keeps every window's level solves (inputs and the
    # kernels' results) for the check against the plain versions below
    solver, calls, lock = tvl1_cuda._level_solver, [], threading.Lock()

    def recording(i0, i1, u1, u2, p, u3):
        out = solver(i0, i1, u1, u2, p, u3)
        with lock:
            calls.append((threading.get_ident(),
                          [t.clone() for t in (i0, i1, u1, u2)],
                          [out[0].clone(), out[1].clone(), out[3].clone()]))
        return out

    tvl1_cuda._level_solver = recording
    try:
        gathered = tiled.tiled_tvl1_flow(im0, im1, params, mesh,
                                         neighbor_exchange=False)
    finally:
        tvl1_cuda._level_solver = solver
    # the main path: counts set to 0 just before, read just after
    zero_launch_counts()
    torch.cuda.synchronize()
    kernels, memops = enqueued_launches(
        lambda: tiled.tiled_tvl1_flow(im0, im1, params, mesh))
    launches = read_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = tiled.tiled_tvl1_flow(im0, im1, params, mesh)
    clip = tiled.get_last_clip_fraction()
    tiled_ms = (time.perf_counter() - t0) * 1e3
    shortfall = tiled.get_last_halo_shortfall()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mono_call().cpu()
    mono_ms = (time.perf_counter() - t0) * 1e3
    # the monolithic solve alone, by events on the card, and its levels'
    # iteration counts
    a, b = (torch.from_numpy(im)[None].cuda() for im in (im0, im1))
    mono_device_ms = time_cuda(lambda: tvl1_flow_batched_cuda(a, b, params), 1)
    mono_iters = [int(it.sum()) for _, it in get_last_iteration_stats()]

    window_levels = window_levels_vs_plain(calls, im0[:win], params)
    diff = (flow - mono).abs()
    seams = [d * block + k for d in range(1, n_rows) for k in (-1, 0)]
    f = flow.cpu().numpy()
    return {
        "shape": [h, w], "rows_axis": n_rows, "halo": halo,
        "window": [win, w], "device": str(flow.device),
        "max_abs_diff_px": float(diff[:, 8:-8].max()),
        "max_abs_diff_all_columns_px": float(diff.max()),
        "max_abs_diff_seam_rows_px": float(diff[seams][:, 8:-8].max()),
        "gate_px": 0.25, "epe_px": interior_epe(f, DX_STEP, DY_STEP),
        "epe_gate_px": 0.5, "finite": bool(np.isfinite(f).all()),
        "ring_equals_gather": bool(torch.equal(flow, gathered)),
        "clip_fraction": clip, "halo_shortfall": shortfall,
        "window_levels": n_levels,
        "window_levels_vs_plain": window_levels,
        "level_kernel_launches": launches["tvl1_level_solve"],
        "blocked_kernel_launches": launches["tvl1_blocked_level_solve"],
        "expected_launches": {"level": n_rows * n_levels, "blocked": 0},
        "device_launches": kernels, "device_memops": memops,
        "tiled_ms": tiled_ms, "monolithic_ms": mono_ms,
        "monolithic_device_ms": mono_device_ms,
        "monolithic_iters_per_level": mono_iters,
    }, launches


def window_levels_vs_plain(calls, top, params):
    """The first window's (rows 0..) level solves, as the tiled solve's
    kernels computed them, against the plain version on the same inputs:
    the window's finest, second and coarsest level, every one the level
    kernel's. ``calls`` are (thread, inputs, kernel results) of every
    window's levels, coarsest first; ``top`` the image rows of the first
    window. Each level is also solved again by the kernel, which must repeat
    the tiled solve's result bit for bit."""
    import torch

    from optflow_tpu_torch.ops.tvl1_cuda import (
        tvl1_level_solve,
        tvl1_level_solve_plain,
    )

    top = torch.from_numpy(top)
    thread = next(t for t, ins, _ in calls
                  if torch.equal(ins[0][0].cpu(), top))
    mine = [(ins, outs) for t, ins, outs in calls if t == thread][::-1]
    out = []
    for lv in (0, 1, len(mine) - 1):
        ins, (u1, u2, iters) = mine[lv]
        again = tvl1_level_solve(*ins, params)
        p1, p2, pit = tvl1_level_solve_plain(*ins, params)
        out.append({
            "level": lv, "shape": list(ins[0].shape),
            "kernel": "tvl1_level_solve",
            "max_abs_du": flow_diff((u1, u2), (p1, p2)), "tolerance": 1e-3,
            "iters_kernel": iters.tolist(), "iters_plain": pit.tolist(),
            "rerun_bit_identical": all(torch.equal(a, b) for a, b in
                                       zip((u1, u2, iters), again)),
        })
    return out


def dist_engine(devs, sections, tmp):
    """The job phase's 64-pair strip job through run_job_batched on a pairs
    mesh of the devices, against the one-device run."""
    import torch

    from optflow_tpu_torch.dist.mesh import make_pair_mesh
    from optflow_tpu_torch.engine.batch_runner import run_job_batched

    n_pairs = 64
    n_frames = n_pairs // MAX_DZ + MAX_DZ + 1
    names = [f"mem://sec_{z:04d}" for z in range(n_frames)]
    half = {nm: s.reshape(SRC_H // 2, 2, SRC_W // 2, 2).astype(np.float32)
            .mean(axis=(1, 3)) for nm, s in zip(names, sections)}

    def loader(path, scale):
        return half[path]

    runs = {}
    for side in ("single", "mesh"):
        job = build_job(names, n_pairs,
                        os.path.join(tmp, f"dist_{side}.journal"), "job")
        sink = MockRenderSink()
        kw = ({"mesh": make_pair_mesh(devices=devs)} if side == "mesh"
              else {"device": "cuda"})
        if side == "mesh":
            zero_launch_counts()  # the main path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = run_job_batched(job, sink=sink, loader=loader, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err, n_matches = match_errors(sink.match_sets, job)
        runs[side] = {"stats": stats, "wall_s": wall, "match_err_px": err,
                      "gated_matches": n_matches}
    launches = read_launch_counts()
    keys = ("pairs", "batched", "sequential", "uploads", "matches")
    return {
        "pairs_axis": len(devs), "pair_batch": 16,
        "stats_equal": all(runs["mesh"]["stats"][k] == runs["single"]["stats"][k]
                           for k in keys),
        "counts": {k: runs["mesh"]["stats"][k] for k in keys},
        "match_err_px": runs["mesh"]["match_err_px"],
        "single_match_err_px": runs["single"]["match_err_px"],
        "gated_matches": runs["mesh"]["gated_matches"], "gate_px": 1.0,
        "solve_device": runs["mesh"]["stats"].get("solve_device"),
        "wall_s": runs["mesh"]["wall_s"],
        "single_wall_s": runs["single"]["wall_s"],
        "level_kernel_launches": launches["tvl1_level_solve"],
        "timing": runs["mesh"]["stats"]["timing"],
    }, launches


def schur_gap_px(xa, xb, k):
    """Largest distance, over sections and the four corners of a section,
    between where two float64 solutions (x_I, x_S) of the z-block system
    move a corner: the solutions before they are rounded into float32
    transforms. ``k`` parameters per section and component."""
    d = np.concatenate([(xa[0] - xb[0]).reshape(-1, k, 2),
                        (xa[1] - xb[1]).reshape(-1, k, 2)])
    if k == 1:
        return float(np.linalg.norm(d[:, 0], axis=-1).max())
    moved = np.einsum("ck,skd->scd", SECTION_CORNERS, d)
    return float(np.linalg.norm(moved, axis=-1).max())


def dist_align(devs, results):
    """The align phase's graph: the sharded z-block solve over the pairs
    devices against the unsharded one, in float64 (the Schur solve of the
    same assembled system) and through the library (float32 transforms)
    against the exact solve; the sharded CG on the first ALIGN_CG_SECTIONS
    sections against the one-device CG and the z-block solve."""
    import torch

    from optflow_tpu_torch.align import zblock
    from optflow_tpu_torch.align.distributed import (
        solve_affine_alignment_sharded,
        solve_translation_alignment_sharded,
    )
    from optflow_tpu_torch.align.global_solve import (
        _collect_edges,
        solve_affine_alignment,
        solve_translation_alignment,
    )
    from optflow_tpu_torch.align.zblock import solve_zblock_alignment
    from optflow_tpu_torch.dist.mesh import make_pair_mesh

    mesh = make_pair_mesh(devices=devs)
    stores = results.get("align_stores", {})
    out = {}
    for model in ("translation", "affine"):
        if model in stores:
            recs = stores[model][0]
        else:
            recs, _, _ = alignment_graph(ALIGN_SECTIONS, seed=11,
                                         affine=model == "affine")
        # the unsharded solve, its assembled system and float64 solution
        # kept by a wrapper around the Schur solve
        schur, seen = zblock._schur_solve, {}

        def keep(*system, **kw):
            seen["system"] = system[:5]
            seen["x"] = schur(*system, **kw)
            return seen["x"]

        zblock._schur_solve = keep
        try:
            single = solve_zblock_alignment(recs, model=model,
                                            block_sections=ALIGN_BLOCK,
                                            device="cuda")
        finally:
            zblock._schur_solve = schur
        x_sharded = zblock._schur_solve_sharded(*seen["system"], devs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = solve_zblock_alignment(recs, model=model,
                                         block_sections=ALIGN_BLOCK,
                                         mesh=mesh)
        wall = time.perf_counter() - t0
        exact = exact_alignment(_collect_edges(recs), model)
        sub = first_sections(recs, ALIGN_CG_SECTIONS)
        if model == "translation":
            cg, cg_sharded = (solve_translation_alignment,
                              solve_translation_alignment_sharded)
        else:
            cg, cg_sharded = (solve_affine_alignment,
                              solve_affine_alignment_sharded)
        # float32 atomics make each CG's answer move run to run: the
        # translation CGs run DIST_CG_RUNS times each, every pair compared
        runs = DIST_CG_RUNS if model == "translation" else 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cg_shs = [cg_sharded(sub, mesh)]
        cg_s = time.perf_counter() - t0
        cg_shs += [cg_sharded(sub, mesh) for _ in range(runs - 1)]
        cg_ones = [cg(sub, device="cuda") for _ in range(runs)]
        cg_sh, cg_one = cg_shs[0], cg_ones[0]

        def widest(xs, ys):
            return max(corner_gap(x.transforms, y.transforms)
                       for x in xs for y in ys if x is not y)
        zb_sub = solve_zblock_alignment(sub, model=model,
                                        block_sections=ALIGN_BLOCK,
                                        device="cuda")
        out[model] = {
            "zblock_sharded_vs_unsharded_float64_px": schur_gap_px(
                x_sharded, seen["x"], 1 if model == "translation" else 3),
            "zblock_sharded_vs_unsharded_px":
            corner_gap(sharded.transforms, single.transforms),
            "zblock_sharded_vs_exact_px": corner_gap(sharded.transforms,
                                                     exact),
            "zblock_unsharded_vs_exact_px": corner_gap(single.transforms,
                                                       exact),
            "zblock_sharded_s": wall,
            "cg_runs": runs,
            "cg_sharded_vs_single_px": widest(cg_shs, cg_ones),
            "cg_single_reruns_px": widest(cg_ones, cg_ones) if runs > 1
            else None,
            "cg_sharded_reruns_px": widest(cg_shs, cg_shs) if runs > 1
            else None,
            "cg_sharded_vs_zblock_px": corner_gap(cg_sh.transforms,
                                                  zb_sub.transforms),
            "cg_single_vs_zblock_px": corner_gap(cg_one.transforms,
                                                 zb_sub.transforms),
            "cg_sharded_objective_excess": max(
                objective_excess(sub, x.transforms, model) for x in cg_shs),
            "cg_single_objective_excess":
            objective_excess(sub, cg_one.transforms, model),
            "cg_sharded_s": cg_s,
        }
    return out


def dist_pod(sections, tmp):
    """Two processes of ``python -m optflow_tpu_torch.cli.run_pod`` on the
    cli phase's 16-pair job from PNG files, as `flow` TIFFs, gloo on a free
    local port, both on the card."""
    import socket

    import torch

    from optflow_tpu_torch.core import imgio
    from optflow_tpu_torch.core.imgio import read_float_tiff

    decoder = imgio.decoder_name()
    if decoder is None:
        fail("dist pod: no image decoder installed for the PNG job")
    n_frames = DIST_POD_PAIRS // MAX_DZ + MAX_DZ + 1
    names = write_pngs(sections[:n_frames], os.path.join(tmp, "pod_stack"),
                       decoder)
    journal = os.path.join(tmp, "pod.journal")
    job = build_job(names, DIST_POD_PAIRS, journal, "pod")
    out_dir = os.path.join(tmp, "pod_out")
    job.update(output_type="flow", output_dir=out_dir, match_sink="null")
    job_path = os.path.join(tmp, "pod.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "optflow_tpu_torch.cli.run_pod", job_path,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r)],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                print(out[-2000:], err[-4000:], file=sys.stderr)
                fail(f"dist pod: host {r} exited with {proc.returncode}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    lines = [next((ln for ln in out.splitlines()
                   if ln.startswith(f"[host {r}/2] done:")), None)
             for r, out in enumerate(outs)]
    want = sorted(f"{im['output_name']}_{SCALE:0.2f}_{roi}_{c}.tiff"
                  for im in job["images"] for roi in ("top", "bottom")
                  for c in "xy")
    written = sorted(os.listdir(out_dir))
    per_rank = []
    for r in range(2):
        with open(f"{journal}.{r}") as f:
            recs = [json.loads(ln) for ln in f if '"pair"' in ln]
        per_rank.append(sorted(rec["key"].split("|")[2] for rec in recs))
    epes = []
    for im in job["images"]:
        for roi in ("top", "bottom"):
            base = os.path.join(out_dir, f"{im['output_name']}_"
                                f"{SCALE:0.2f}_{roi}")
            fx = read_float_tiff(base + "_x.tiff")
            fy = read_float_tiff(base + "_y.tiff")
            epes.append(interior_epe(np.stack([fx, fy], axis=-1),
                                     im["dz"] * DX_STEP * SCALE,
                                     im["dz"] * DY_STEP * SCALE))
    names_all = sorted(im["output_name"] for im in job["images"])
    return {
        "processes": 2, "pairs": len(job["images"]),
        "host_lines": [ln[:160] if ln else None for ln in lines],
        "files": len(written), "files_expected": len(want),
        "outputs_exactly_once": written == want,
        "journal_pairs": [len(p) for p in per_rank],
        "journals_disjoint": not set(per_rank[0]) & set(per_rank[1])
        and sorted(per_rank[0] + per_rank[1]) == names_all,
        "mean_epe_px": float(np.mean(epes)), "epe_gate_px": 0.5,
        "wall_s": wall,
    }


# Heights of the images that the threads of dist_concurrent solve at once,
# 512 columns each: every one tiles its levels with another tile height, so
# another shared memory size a launch.
DIST_CONCURRENT_HEIGHTS = (64, 96, 136, 200, 264, 328, 392, 840)
DIST_CONCURRENT_ROUNDS = 10


def dist_concurrent(devs):
    """One thread per height of DIST_CONCURRENT_HEIGHTS on the mesh's
    devices, taken in turn, each solving its own shape at the same time as
    the others, DIST_CONCURRENT_ROUNDS times: every flow must equal the same
    solve made alone, bit for bit, and no launch may be refused. A refusal
    is counted and fails the phase. This is the race of a kernel's shared
    memory attribute between two threads, which refused launches with CUDA
    error 701 before the libraries held a lock around it."""
    import torch

    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.dist.mesh import on_devices
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_flow_batched_cuda

    rng = np.random.default_rng(7)
    threads = [devs[i % len(devs)]
               for i in range(len(DIST_CONCURRENT_HEIGHTS))]
    inputs = []
    for dev, h in zip(threads, DIST_CONCURRENT_HEIGHTS):
        a = rng.random((1, h, 512), dtype=np.float32)
        inputs.append((torch.from_numpy(a).to(dev),
                       torch.from_numpy(np.roll(a, 1, axis=-1)).to(dev)))
    params = TVL1Params()
    alone = [tvl1_flow_batched_cuda(a, b, params) for a, b in inputs]
    torch.cuda.synchronize()
    refused = []

    def solve(dev, i):
        try:
            return tvl1_flow_batched_cuda(*inputs[i], params)
        except RuntimeError as e:  # counted below; it fails the phase
            refused.append(str(e))
            return None

    differ = 0
    t0 = time.perf_counter()
    for _ in range(DIST_CONCURRENT_ROUNDS):
        outs = on_devices(solve, threads, range(len(threads)))
        torch.cuda.synchronize()
        differ += sum(o is not None and not torch.equal(o, f)
                      for o, f in zip(outs, alone))
    return {"threads": len(threads), "devices": [str(d) for d in threads],
            "shapes": [[1, h, 512] for h in DIST_CONCURRENT_HEIGHTS],
            "rounds": DIST_CONCURRENT_ROUNDS, "refused": len(refused),
            "first_refusal": refused[0] if refused else None,
            "flows_differing": differ,
            "ms": (time.perf_counter() - t0) * 1e3}


def phase_dist(results, tmp):
    """Distribution on the card: a mesh of the visible cards, or of cuda:0
    entered four times (its shards then run in turn on one stream). Prints
    which, then one JSON line; every gate is checked after it."""
    devs, described = dist_devices()
    print(f"chip_smoke: dist mesh: {described}", flush=True)
    sections = results.get("sections")
    if sections is None or len(sections) < 25:
        sections = gen_sections(64 // MAX_DZ + MAX_DZ + 1)
    sched, l_sched = dist_scheduler(devs, sections)
    til, l_tiled = dist_tiled(devs, sections)
    eng, l_eng = dist_engine(devs, sections, tmp)
    aln = dist_align(devs, results)
    pod = dist_pod(sections, tmp)
    conc = dist_concurrent(devs)
    emit({"phase": "dist", "mesh": described, "scheduler": sched,
          "tiled": til, "engine": eng, "align": aln, "pod": pod,
          "concurrent": conc})

    failed = []
    if not sched["max_abs_diff_px"] <= sched["gate_px"]:
        failed.append(f"scheduler {sched['max_abs_diff_px']} px from one "
                      "batched call")
    if not sched["counts_equal"]:
        failed.append("scheduler iteration counts differ from one call's")
    if not sched["epe_px"] <= 0.5:
        failed.append(f"scheduler EPE {sched['epe_px']} px")
    if sched["device_launches"] != sched["expected_device_launches"] or \
            sched["level_kernel_launches"] != sched["expected_device_launches"]:
        failed.append(f"scheduler launches {sched['device_launches']} / "
                      f"{sched['level_kernel_launches']}, expected "
                      f"{sched['expected_device_launches']}")
    if not (til["finite"] and til["max_abs_diff_px"] <= til["gate_px"]):
        failed.append(f"tiled {til['max_abs_diff_px']} px from monolithic")
    if not til["epe_px"] <= 0.5:
        failed.append(f"tiled EPE {til['epe_px']} px")
    if not til["ring_equals_gather"]:
        failed.append("tiled: ring and gather differ")
    for lv in til["window_levels_vs_plain"]:
        if not (lv["max_abs_du"] <= lv["tolerance"]
                and lv["iters_kernel"] == lv["iters_plain"]
                and lv["rerun_bit_identical"]):
            failed.append(f"tiled window level {lv['level']} {lv['shape']}: "
                          f"{lv['kernel']} {lv['max_abs_du']} px from its "
                          f"plain version, counts {lv['iters_kernel']} / "
                          f"{lv['iters_plain']}, rerun "
                          f"{lv['rerun_bit_identical']}")
    if til["halo_shortfall"] != 0:
        failed.append(f"tiled: shortfall {til['halo_shortfall']}")
    if {"level": til["level_kernel_launches"],
            "blocked": til["blocked_kernel_launches"]} != \
            til["expected_launches"]:
        failed.append(f"tiled launches {til['level_kernel_launches']} / "
                      f"{til['blocked_kernel_launches']}, expected "
                      f"{til['expected_launches']}")
    if not eng["stats_equal"] or eng["counts"]["pairs"] != 64:
        failed.append(f"engine stats {eng['counts']} differ from one device's")
    if eng["match_err_px"] is None or not eng["match_err_px"] <= 1.0:
        failed.append(f"engine match error {eng['match_err_px']} px")
    if eng["level_kernel_launches"] < 1 or \
            not str(eng["solve_device"]).startswith("cuda"):
        failed.append(f"engine ran on {eng['solve_device']} with "
                      f"{eng['level_kernel_launches']} launches")
    # the float64 Schur solutions, and the float32 transforms of the mesh
    # call, which may stand an ulp or two apart (7.6e-6 / 1.2e-4 px on the
    # CPU at 9,604 sections)
    for model, gate, gate32 in (("translation", 1e-6, 1e-5),
                                ("affine", 1e-4, 2e-4)):
        a = aln[model]
        if not (a["zblock_sharded_vs_unsharded_float64_px"] <= gate
                and a["zblock_sharded_vs_unsharded_px"] <= gate32):
            failed.append(f"{model} z-block sharded "
                          f"{a['zblock_sharded_vs_unsharded_float64_px']} px "
                          f"(float64), {a['zblock_sharded_vs_unsharded_px']} "
                          "px (transforms) from unsharded")
        if not (a["zblock_sharded_vs_exact_px"] <= 0.01
                and a["zblock_unsharded_vs_exact_px"] <= 0.01):
            failed.append(f"{model} z-block off the exact solve")
    # every sharded run within DIST_CG_GATE_PX of every one-device run, no
    # further above the optimum than DIST_CG_EXCESS_GATE, and within the
    # align phase's 0.01 px of the z-block solve
    cg = aln["translation"]
    if not (cg["cg_sharded_vs_single_px"] <= DIST_CG_GATE_PX
            and cg["cg_sharded_objective_excess"] <= DIST_CG_EXCESS_GATE
            and cg["cg_sharded_vs_zblock_px"] <= 0.01):
        failed.append(f"sharded translation CG {cg['cg_sharded_vs_single_px']}"
                      f" px from the one-device CG, objective excess "
                      f"{cg['cg_sharded_objective_excess']}, "
                      f"{cg['cg_sharded_vs_zblock_px']} px from z-block")
    ratio = aln["affine"]["cg_sharded_objective_excess"] / AFFINE_CG_JAX_EXCESS
    if not abs(ratio - 1.0) <= 0.1:
        failed.append(f"sharded affine CG excess "
                      f"{aln['affine']['cg_sharded_objective_excess']}")
    if not (all(pod["host_lines"]) and pod["outputs_exactly_once"]
            and pod["journals_disjoint"]
            and pod["journal_pairs"] == [DIST_POD_PAIRS // 2] * 2):
        failed.append(f"pod run incomplete: {pod}")
    if not pod["mean_epe_px"] <= 0.5:
        failed.append(f"pod flows: mean EPE {pod['mean_epe_px']} px")
    if conc["refused"] or conc["flows_differing"]:
        failed.append(f"concurrent threads: {conc['refused']} solves refused "
                      f"({conc['first_refusal']}), {conc['flows_differing']} "
                      "flows differ from the same solves made alone")
    if any(l["tvl1_blocked_level_solve"] for l in (l_sched, l_tiled, l_eng)):
        failed.append(f"the blocked kernel was launched: {l_sched}, "
                      f"{l_tiled}, {l_eng}")
    if failed:
        fail("dist: " + "; ".join(failed))
    launches = results.setdefault("launches", {})
    launches["tvl1_level_solve"] = launches.get("tvl1_level_solve", 0) + sum(
        l["tvl1_level_solve"] for l in (l_sched, l_tiled, l_eng))


# bench phase: the tiled solve's rows axis on one card (a correctness check,
# as in the dist phase), and the job's depth (the job phase's: the bench's
# default of 512 pairs needs 174 synthetic sections, each a cubic resampling
# on the host)
BENCH_TILED_ROWS = 8
BENCH_JOB_PAIRS = 64


def run_bench(name, main, argv):
    """One bench's ``main(argv)`` in this process, its output captured:
    (its last JSON line, launches of the level kernel and the chunk kernel's
    level entry during the run). A bench that exits non-zero fails the run."""
    import torch

    zero_launch_counts()
    torch.cuda.synchronize()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    except SystemExit as e:
        print(out.getvalue()[-3000:], file=sys.stderr)
        fail(f"bench {name}: {e.code}")
    torch.cuda.synchronize()
    counts = read_launch_counts()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return line, counts["tvl1_level_solve"], counts["tvl1_chunk_level_solve"]


def phase_bench(results, tmp):
    """The port's benches at their full sizes, through the entry points a
    user calls, their lines and gates."""
    import torch

    from optflow_tpu_torch.bench import (
        job,
        matrix,
        scaling,
        section,
        solve,
        synth,
    )
    from optflow_tpu_torch.bench.roofline import pyramid_work
    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1 import (
        get_last_iteration_stats,
        tvl1_flow_batched,
    )
    from optflow_tpu_torch.tools.probes import (
        r4_budget,
        r4_feature_stages,
        r5_sample_stage,
        r5_transfer_cost,
    )

    px_iters = results.get("solve_px_iterations")
    if px_iters is None:  # the solve phase did not run: its count here
        i0, i1 = (torch.from_numpy(x).cuda() for x in solve.solve_inputs(
            SOLVE_BATCH, SOLVE_H, SOLVE_W))
        tvl1_flow_batched(i0, i1, TVL1Params())
        px_iters = pyramid_work(get_last_iteration_stats(),
                                TVL1Params().warps).px_iterations
    rows = ",".join(["cuda:0"] * BENCH_TILED_ROWS)
    benches = (
        ("solve", solve.main, []),
        ("job", job.main, ["--pairs", str(BENCH_JOB_PAIRS)]),
        ("features", matrix.main, ["features"]),
        ("features_chained", matrix.main, ["features_chained"]),
        ("roofline", matrix.main, ["roofline"]),
        ("tiled", matrix.main, ["tiled", "--devices", rows]),
        ("scaling", scaling.main, []),
        ("section", section.main, []),
        ("r4_budget", r4_budget.main, []),
        ("r4_feature_stages", r4_feature_stages.main, []),
        ("r5_sample_stage", r5_sample_stage.main, []),
        ("r5_transfer_cost", r5_transfer_cost.main, []),
    )
    saved = os.environ.get(synth.STACK_ENV)
    os.environ[synth.STACK_ENV] = os.path.join(tmp, "bench_stack")
    lines, level, chunk = {}, {}, {}
    try:
        for name, main, argv in benches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lines[name], level[name], chunk[name] = run_bench(name, main, argv)
            emit({"phase": "bench", "bench": name, "argv": argv,
                  "wall_s": time.perf_counter() - t0,
                  "level_kernel_launches": level[name],
                  "chunk_kernel_launches": chunk[name],
                  "line": lines[name]})
    finally:
        if saved is None:
            os.environ.pop(synth.STACK_ENV, None)
        else:
            os.environ[synth.STACK_ENV] = saved

    roof = lines["roofline"]
    plain_diff = roof["plain_graph_vs_eager_max_abs_px"]
    emit({"phase": "bench", "roofline_plain": {
        "plain_s_per_image": roof["plain"]["seconds_per_image"],
        "plain_eager_s_per_image": roof["plain_eager"]["seconds_per_image"],
        "graph_vs_eager_max_abs_px": plain_diff,
        "gate_px": matrix.PLAIN_GRAPH_GATE_PX,
        "speedup_over": roof["speedup_over"]}})

    failed = []
    if plain_diff is None or not plain_diff <= matrix.PLAIN_GRAPH_GATE_PX:
        failed.append(f"the captured plain level solve is {plain_diff} px "
                      "from the eager call's, gate "
                      f"{matrix.PLAIN_GRAPH_GATE_PX} px")
    sol = lines["solve"]
    if not (sol["epe_ok"] and sol["oracle_epe_ok"] is True):
        failed.append(f"solve EPE {sol['epe_px']}, against the oracle "
                      f"{sol['epe_vs_oracle_px']} (gate 0.5 px)")
    if round(sol["gpx_iters_per_batch"] * 1e9) != round(px_iters):
        failed.append(f"the solve bench counted {sol['gpx_iters_per_batch']}"
                      f" G pixel-iterations, the solve phase {px_iters / 1e9}")
    if not lines["job"]["match_ok"]:
        failed.append(f"job match error {lines['job']['match_err_px']} px")
    for name in ("features", "features_chained"):
        if not lines[name]["e2e_ok"]:
            failed.append(f"{name} end-to-end error "
                          f"{lines[name]['e2e_epe_px']} px")
    if not lines["tiled"]["value"] <= 0.25:
        failed.append(f"tiled solve {lines['tiled']['value']} px from the "
                      "monolithic one")
    shares = {"solve_mfu": sol["mfu"], **{
        row: lines["roofline"][row]["share"]
        for row in ("plain", "plain_eager", "chunk", "level")}}
    if not all(x is not None and 0.0 < x <= 1.0 for x in shares.values()):
        failed.append(f"roofline shares {shares}")
    sections = lines["section"]["sections"]
    if [tuple(sec["shape"]) for sec in sections] != list(section.SHAPES) \
            or not all(sec["epe_px"] <= 0.5 for sec in sections):
        failed.append("section shapes and EPE: " + str(
            [(sec["shape"], sec["epe_px"]) for sec in sections]))
    budget_px = lines["r4_budget"]["rows"]["full"]["px_iterations"]
    if round(budget_px) != round(px_iters):
        failed.append(f"the r4_budget full row counted {budget_px} pixel-"
                      f"iterations, the solve phase {px_iters}")
    for name, gate in (("r4_feature_stages", "gate_ok"),
                       ("r5_sample_stage", "pieces_equal_whole"),
                       ("r5_transfer_cost", "readback_equal")):
        if lines[name][gate] is not True:
            failed.append(f"{name}: {gate} {lines[name][gate]}")
    if min(level.values()) < 1 or chunk["roofline"] < 1:
        failed.append(f"a bench did not launch its kernel: level {level}, "
                      f"chunk {chunk}")
    emit({"phase": "bench", "gates": "failed" if failed else "passed",
          "solve_phase_px_iterations": px_iters, "shares": shares,
          "tiled_rows_axis": f"cuda:0 entered {BENCH_TILED_ROWS} times "
          "(one card: a correctness check, not scaling)"})
    if failed:
        fail("bench: " + "; ".join(failed))
    launches = results.setdefault("launches", {})
    launches["tvl1_level_solve"] = (launches.get("tvl1_level_solve", 0)
                                    + sum(level.values()))
    launches["tvl1_chunk"] = launches.get("tvl1_chunk", 0) + chunk["roofline"]


def phase_install(tmp):
    """deploy/bootstrap_venv_torch.sh with the card: the wheel, an isolated
    install and its console scripts, every kernel and the host libraries
    built from the installed tree's own sources, and a 2-pair PNG `flow` job at scale
    0.5 through the installed CLI on the card, with no JAX imported."""
    import importlib.util

    packaging = {m: importlib.util.find_spec(m) is not None
                 for m in ("pip", "setuptools", "wheel")}
    line = {"phase": "install", "python": sys.executable,
            "packaging": packaging}
    if not (packaging["pip"] and packaging["setuptools"]):
        emit(line)
        fail("install: this Python has no pip or setuptools to build the "
             "wheel with")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    # the script's python3 is this interpreter, and the job imports the
    # port from the install only
    env["PATH"] = f"{os.path.dirname(sys.executable)}:{env.get('PATH', '')}"
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["bash", os.path.join(repo, "deploy", "bootstrap_venv_torch.sh"),
         os.path.join(tmp, "install"), "--device", "cuda"],
        capture_output=True, text=True, timeout=600, env=env)
    wall = time.perf_counter() - t0
    out = proc.stdout
    done = [ln for ln in out.splitlines() if ln.startswith("done: ")]
    done = done[-1] if done else ""
    found = re.search(r"'tvl1_level_solve': (\d+)", done)
    launches = int(found.group(1)) if found else None
    found = re.search(r"'decoder': '([\w-]+)'", done)
    decoder = found.group(1) if found else None
    emit({**line, "rc": proc.returncode, "wall_s": wall,
          "seconds": {m.group(1): float(m.group(2)) for m in re.finditer(
              r"^   (\w+): ([0-9.]+) s$", out, re.MULTILINE)},
          "built": re.findall(r"^(\w+): (\S+\.so)$", out, re.MULTILINE),
          "loader_not_built": re.findall(r"loader: not built, (.*)$", out,
                                         re.MULTILINE),
          "flow_err_px": [float(e) for e in re.findall(
              r"mean error ([0-9.]+) px", out)],
          "launches": launches, "decoder": decoder, "done": done})
    if proc.returncode != 0:
        print(out[-3000:], proc.stderr[-3000:], file=sys.stderr)
        fail(f"install: deploy/bootstrap_venv_torch.sh exited with "
             f"{proc.returncode}")
    if launches is None or launches < 10:
        fail(f"install: the installed CLI reported {launches} level-kernel "
             "launches, expected at least 10")
    expected = expected_decoder()
    if decoder != expected:
        fail(f"install: the installed CLI decoded with {decoder}, expected "
             f"{expected}")
    built = {stem for stem, _ in re.findall(r"^(\w+): (\S+\.so)$", out,
                                            re.MULTILINE)}
    # the host libraries each route decodes with (the bootstrap builds the
    # header-free one wherever the host compiler is)
    host = {"native": {"loader", "frame"}, "native-resize": {"frame"}}
    want = set(KERNEL_STEMS) | host.get(expected, set())
    if not want <= built:
        fail(f"install: {sorted(want - built)} not built from the installed "
             "tree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of: " + ", ".join(ALL_PHASES))
    ns = ap.parse_args(argv)
    phases = [p for p in ns.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    run_t0 = time.perf_counter()
    phase_device()  # always: nothing runs without a card
    results = {}
    tmp = tempfile.mkdtemp(prefix="optflow_chip_smoke_")
    try:
        if "build" in phases:
            phase_build()
        if "decode" in phases:
            phase_decode(tmp)
        if "kernels" in phases:
            phase_kernels(results)
        if "ablate" in phases:
            phase_ablate(results)
        if "smem_cap" in phases:
            phase_smem_cap(results)
        if "solve" in phases:
            phase_solve(results)
        if "job" in phases:
            phase_job(results, tmp)
        if "cli" in phases:
            phase_cli(results, tmp)
        if "section" in phases:
            phase_section(results, tmp)
        if "level_api" in phases:
            phase_level_api(results)
        if "features" in phases:
            phase_features(results, tmp)
        if "style2" in phases:
            phase_style2(results, tmp)
        if "align" in phases:
            phase_align(results, tmp)
        if "dist" in phases:
            phase_dist(results, tmp)
        if "bench" in phases:
            phase_bench(results, tmp)
        if "install" in phases:
            phase_install(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    complete = set(ALL_PHASES) <= set(phases)
    emit({"run_s": time.perf_counter() - run_t0, "phases": phases})
    print(gpu_name_and_limit(), flush=True)
    cases = results.get("kernel_cases")
    if cases is not None:
        launches = results.get("launches", {})
        emit({"kernels": [{
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches.get(name, 0),
            "shape": case["shape"],
            **{k: case[k] for k in (
                "entry", "warps", "iterations", "k", "m", "mode", "variant",
                "replaced_kernel_ms", "call_ms", "device_launches",
                "device_memops",
                "replaced_kernel_device_launches", "grid_steps",
                "grid_blocks", "single_chunk") if k in case},
            "max_abs_err": case["max_abs_du"], "tolerance": case["tolerance"],
            "ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            # no PyTorch call computes a TV-L1 level or chunk, or fills a
            # block's shared memory
            "library_ms": None,
        } for name, case in cases.items()]})
        if complete and any(launches.get(name, 0) < 1 for name in cases):
            fail(f"a kernel was not launched on its main path: {launches}")
    if not complete:
        print("chip_smoke: partial run (--phases): no result line",
              file=sys.stderr)
        return 0
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
