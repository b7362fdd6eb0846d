"""Batched job runner: same-shape pairs solved together in one batch.

The reference's pair loop is strictly sequential — one GPU solve per pair
(src/optflow.cpp:87-171). Here pairs whose frames, ROI set, solver
parameters, and output type match are grouped, their ROI slices stacked
along a leading batch dimension, and solved in a single batched
coarse-to-fine solve on one explicit device, or split over the ``pairs``
devices of a mesh (``dist/mesh.py``), one host thread each. Match
accumulation and upload batching preserve the reference's ordering and
semantics.

``random_points`` groups on one device take the device-resident path
(engine/device_group.py): frames uploaded once, ROI strips sliced on the
device, one batched solve, post-processing and sampling on the device, one
packed readback a few groups behind the dispatch front. ``map``/``flow``
groups, ``device_sample: false`` and every group of a mesh with more than
one pairs device take the host path, which reads the full fields back and
writes TIFFs / samples on the host.

Feature pre-alignment pairs DO batch: the group's unique frames are
detected and described once, matching and RANSAC run per pair, frame 1 of
every pair is warped by its affine with the exact ``affine_warp`` — all on
the device; the gates are read back for the reference's messages with the
group's samples (device path) or before its solve (host path).
Pairs that still can't batch — custom_diff ROIs, mismatched frame shapes, a
caller-supplied host aligner — fall back to the sequential solve_rois path.

As in the JAX package, a batched feature group is aligned by the package's
own device aligner whether ``aligner`` is None or ``default_aligner``,
while the sequential path with ``aligner=None`` aligns by the identity
(engine/pair.py): the same call gives the same stats in both packages.

Enable via the job key ``pair_batch`` (int > 1) or call
:func:`run_job_batched` directly.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from optflow_tpu_torch.core.config import JobConfig, TVL1Params, resolve_features
from optflow_tpu_torch.core.imgio import ImageReadError, write_float_tiff
from optflow_tpu_torch.dist.mesh import (
    make_pair_mesh,
    on_shares,
    pairs_axis_devices,
)
from optflow_tpu_torch.engine import device_group as dg
from optflow_tpu_torch.engine.features_glue import is_default_aligner
from optflow_tpu_torch.engine.journal import JobJournal, pair_key, pair_key_aliases
from optflow_tpu_torch.engine.prefetch import frame_decoder, make_prefetch_loader
from optflow_tpu_torch.engine.pair import (
    Aligner,
    _solve_mode,
    postprocess_flow,
    solve_rois,
)
from optflow_tpu_torch.engine.rois import Roi, resolve_rois
from optflow_tpu_torch.engine.runner import FrameCache
from optflow_tpu_torch.engine.sampler import move_pm, random_points
from optflow_tpu_torch.features.align import (
    find_alignment_indexed,
    print_align_warnings,
    resolve_feature_params,
)
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched
from optflow_tpu_torch.ops.warp import affine_warp
from optflow_tpu_torch.sinks.http import make_sink
from optflow_tpu_torch.utils.metrics import StageTimer


def _batched_solver(params: TVL1Params, mode: str, devices=None):
    """Batched ROI solve + flow post-processing for the host path. ``mode``
    follows engine.pair._solve_mode; the features_* modes take the pairs'
    (N, 2, 3) affines and reproduce solve_wrapper's map composition
    (src/optflow.cpp:411-443). With several ``devices`` the batch is split
    into one sub-batch a device, each solved from a thread of its own, and
    the results come back to the inputs' device."""

    def f(i0s: torch.Tensor, i1s: torch.Tensor,
          affines: Optional[torch.Tensor] = None):
        flow = tvl1_flow_batched(i0s, i1s, params)
        return postprocess_flow(flow, i0s, i1s, mode, affines)

    if devices is None or len(devices) == 1:
        return f

    def sharded(i0s: torch.Tensor, i1s: torch.Tensor,
                affines: Optional[torch.Tensor] = None):
        outs = on_shares(lambda dev, a, b, af: f(a, b, af), devices,
                         i0s, i1s, affines)
        return tuple(torch.cat([o[k].to(i0s.device) for o in outs])
                     for k in range(3))

    return sharded


def _job_devices(device: torch.device, mesh) -> list:
    """The pairs devices a job solves on: the mesh's; else, for the
    unindexed ``cuda`` with more than one visible card, a pairs mesh over
    all of them; else ``device`` alone (an indexed card, e.g. one process
    pinned to each card, stays on its card)."""
    if mesh is None and device.type == "cuda" and device.index is None \
            and torch.cuda.device_count() > 1:
        mesh = make_pair_mesh()
    return pairs_axis_devices(mesh) if mesh is not None else [device]


def _prealign_group(frames_dev: torch.Tensor, f1_idx, f0_idx, fparams):
    """Batched feature pre-alignment + frame-1 warp: the device equivalent
    of find_alignment + cv::cuda::warpAffine (src/optflow.cpp:366-377) for
    a whole group. FRAME-DEDUPLICATED: detect + describe run once per
    unique frame of ``frames_dev`` (U, fh, fw) and matching/RANSAC per pair
    via the index arrays. The affine maps frame1 into frame0's space:
    src = frame1, dst = frame0. Returns (AlignResult, warped (n, fh, fw))."""
    dev = frames_dev.device
    f1 = torch.as_tensor(f1_idx, dtype=torch.int64, device=dev)
    f0 = torch.as_tensor(f0_idx, dtype=torch.int64, device=dev)
    res = find_alignment_indexed(frames_dev, f1, f0, *fparams)
    warped = affine_warp(frames_dev[f1], res.affine)
    return res, warped


def _report_alignment(res, n: int, debug: bool) -> None:
    """One readback of a group's gates, then the reference's per-pair
    messages (and, under ``debug``, the match counts and homographies)."""
    gates = torch.stack(
        [res.n_good.to(torch.float32), res.enough.to(torch.float32),
         res.homo_ok.to(torch.float32)], dim=1,
    )
    packed = torch.cat([gates, res.H.reshape(-1, 9).to(torch.float32)], dim=1)
    packed = packed.cpu().numpy()
    for j in range(n):
        if debug:
            print(f"Number of good features: {int(packed[j, 0])}")
        print_align_warnings(
            bool(packed[j, 1]), bool(packed[j, 2]),
            packed[j, 3:].reshape(3, 3), debug,
        )


def _dedup_frames(tasks, n: int):
    """Identity-keyed frame dedup: the FrameCache hands the SAME ndarray to
    every pair reusing a (path, scale), so id() keys one upload per unique
    section. Returns (uniq, f0_idx, f1_idx)."""
    uniq: List[np.ndarray] = []
    uniq_ids: Dict[int, int] = {}
    f0_idx = np.zeros(n, np.int64)
    f1_idx = np.zeros(n, np.int64)

    def slot(arr: np.ndarray) -> int:
        key = id(arr)
        if key not in uniq_ids:
            uniq_ids[key] = len(uniq)
            uniq.append(arr)
        return uniq_ids[key]

    for j, t in enumerate(tasks):
        f0_idx[j] = slot(t.frame0)
        f1_idx[j] = slot(t.frame1)
    return uniq, f0_idx, f1_idx


@dataclasses.dataclass
class _Task:
    index: int
    im_data: Dict
    # references into the FrameCache's decoded arrays (never mutated, so
    # no defensive copies — array IDENTITY keys the device frame cache)
    frame0: np.ndarray
    frame1: np.ndarray
    rois: Dict[str, Roi]


def _wants_features(im_data, args, rois) -> bool:
    return resolve_features(im_data, args) or any(
        k == "default" for k in rois
    )


def _group_key(im_data, args, frame0, frame1, rois, cfg: JobConfig):
    params = TVL1Params.from_config(im_data, args)
    roi_sig = tuple(sorted((k, v) for k, v in rois.items()))
    features = _wants_features(im_data, args, rois)
    return (
        frame0.shape,
        frame1.shape,
        params,
        cfg.output_type(im_data),
        roi_sig,
        features,
        resolve_feature_params(im_data, args) if features else None,
        # per-image npoints overrides must not inherit the group
        # leader's count in the device sampler
        cfg.npoints(im_data),
        cfg.scale(im_data),
    )


def _batchable(im_data, args, frame0, frame1, rois, can_batch_features) -> bool:
    if frame0.shape != frame1.shape:
        return False  # forces the feature path (src/optflow.cpp:366-377)
    if _wants_features(im_data, args, rois) and not can_batch_features:
        return False  # a custom host aligner can't run inside the batch
    for k, v in rois.items():
        if k == "custom_diff" or not isinstance(v, Roi):
            return False
    return True


def run_job_batched(
    args: Dict,
    *,
    aligner: Optional[Aligner] = None,
    sink=None,
    loader=None,
    write_outputs: bool = True,
    pair_batch: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> Dict:
    """Batched equivalent of runner.run_job (same stats contract, plus
    ``solve_device`` and ``detected_frames``, the frames that went through
    detect + describe) on one explicit ``device``.
    ``loader(path, scale) -> float32 ndarray`` replaces the default decode
    (it must return the same array for a repeated key: array identity keys
    the device frame cache and the once-per-frame detection).

    ``aligner=None`` and ``default_aligner`` (or a ``functools.partial`` of
    it) both let feature groups batch through the device aligner; any other aligner is a host function and
    sends its pairs down the sequential path, where ``None`` means the
    identity — the JAX package's behaviour, kept so that the same call
    gives the same stats.

    ``mesh`` (``dist.mesh.PairMesh``): group solves split data-parallel over
    its ``pairs`` devices (``pair_batch`` rounded up to a multiple of them),
    and its first pairs device takes ``device``'s place (pre-alignment, the
    sequential path). With the unindexed ``cuda`` device, more than one
    visible card and no mesh, a pairs mesh over all of them is built; an
    indexed card (``cuda:1``) is kept."""
    cfg = JobConfig(args)
    pairs_devices = _job_devices(torch.device(device), mesh)
    device = pairs_devices[0]
    n_shards = len(pairs_devices)
    # a caller-supplied host aligner forces feature pairs onto the
    # sequential path so its behavior is preserved
    can_batch_features = aligner is None or is_default_aligner(aligner)
    if pair_batch is None:
        pair_batch = int(args.get("pair_batch", 8))
    if n_shards > 1:
        pair_batch = -(-pair_batch // n_shards) * n_shards
    prefetch = None
    if loader is None and args.get("prefetch", True):
        prefetch = make_prefetch_loader(args)
        loader = prefetch
    cache = FrameCache(loader)
    if sink is None:
        sink = make_sink(args)
    journal = JobJournal(str(args["journal"])) if args.get("journal") else None
    completed = (
        journal.completed_keys(cfg.output_type({})) if journal else set()
    )
    timer = StageTimer()

    stats = {"pairs": 0, "skipped": 0, "uploads": 0, "matches": 0,
             "resumed": 0, "batched": 0, "sequential": 0,
             "solve_device": None, "detected_frames": 0,
             "decoder": frame_decoder(loader)}
    batch_size = cfg.batch_size()
    upload_state = {"last": 0, "pending": False}

    def maybe_flush(i: int, force: bool = False):
        if not upload_state["pending"]:
            return
        if force or i > upload_state["last"] + batch_size:
            batch = args.get("point_matches", [])
            stats["matches"] += sum(
                len(m["matches"].get("w", [])) for m in batch
            )
            with timer.stage("sink"):
                sink.put(batch)
            args["point_matches"] = []
            stats["uploads"] += 1
            upload_state["last"] = i
            upload_state["pending"] = False
            if journal:
                journal.record_flush()

    def post_process(task: _Task, roi_key: str, roi: Roi, fx, fy, valid,
                     features: bool):
        im_data = task.im_data
        suffix = "_" + roi_key if roi_key in ("top", "bottom") else ""
        im_data["output_suffix"] = suffix
        output_type = cfg.output_type(im_data)
        if output_type in ("map", "flow") and write_outputs:
            base = str(im_data.get("output", "")) + suffix
            write_float_tiff(base + "_x.tiff", fx)
            write_float_tiff(base + "_y.tiff", fy)
        if output_type == "random_points":
            scale = cfg.scale(im_data)
            im_data["point_matches"] = random_points(
                fx, fy, valid, (roi, roi),
                npoints=cfg.npoints(im_data),
                inv_scale=1.0 / scale,
                features=features,
                debug=cfg.debug,
                point_matches=im_data.get("point_matches"),
            )

    def flush_group(tasks: List[_Task]):
        if not tasks:
            return
        t0 = tasks[0]
        params = TVL1Params.from_config(t0.im_data, args)
        output_type = cfg.output_type(t0.im_data)
        features = _wants_features(t0.im_data, args, t0.rois)
        mode = _solve_mode(features, output_type)
        if (
            output_type == "random_points"
            and n_shards == 1
            and args.get("device_sample", True)
        ):
            # random_points needs nothing full-sized on the host: the
            # device-resident pipeline uploads unique frames once and
            # reads back only sampled points, a few groups behind the
            # dispatch front (engine/device_group.py)
            flush_group_device(tasks, params, mode, features)
            return
        affines = warped = None
        if features:
            # one pass pre-aligns + warps the whole group (ref: per-pair
            # find_alignment + warpAffine, src/optflow.cpp:366-377)
            fparams = resolve_feature_params(t0.im_data, args)
            uniq, f0_idx, f1_idx = _dedup_frames(tasks, len(tasks))
            with timer.device_stage("h2d", device):
                frames_dev = torch.from_numpy(
                    np.stack([np.asarray(u, np.float32) for u in uniq])
                ).to(device)
            with timer.device_stage("prealign", device):
                res, warped = _prealign_group(
                    frames_dev, f1_idx, f0_idx, fparams
                )
                affines = res.affine
            stats["detected_frames"] += len(uniq)
            _report_alignment(res, len(tasks), cfg.debug)
            timer.read_device_events()
        solver = _batched_solver(params, mode, pairs_devices)
        for roi_key in sorted(t0.rois.keys()):
            roi: Roi = t0.rois[roi_key]
            with timer.device_stage("h2d", device):
                a = torch.from_numpy(np.stack(
                    [np.asarray(t.frame0[roi.slices()], np.float32)
                     for t in tasks]
                )).to(device)
                if features:
                    b = warped[(slice(None), *roi.slices())].contiguous()
                else:
                    b = torch.from_numpy(np.stack(
                        [np.asarray(t.frame1[roi.slices()], np.float32)
                         for t in tasks]
                    )).to(device)
            with timer.device_stage("solve", device):
                fxs, fys, valids = solver(a, b, affines)
            stats["solve_device"] = str(fxs.device)
            with timer.stage("d2h"):
                fxs = fxs.cpu().numpy()
                fys = fys.cpu().numpy()
                valids = valids.cpu().numpy()
            timer.read_device_events()
            with timer.stage("postprocess"):
                for j, task in enumerate(tasks):
                    post_process(
                        task, roi_key, roi, fxs[j], fys[j], valids[j],
                        features,
                    )
        finish_tasks(tasks)

    def finish_tasks(tasks: List[_Task]):
        for task in tasks:
            stats["pairs"] += 1
            stats["batched"] += 1
            if cfg.output_type(task.im_data) == "random_points":
                move_pm(task.im_data, args)
                upload_state["pending"] = True
            if journal:
                journal.record_pair(pair_key(task.im_data, args))
            maybe_flush(task.index)

    dev_cache = dg.DeviceFrameCache(device)
    group_rng = np.random.default_rng()
    # device-path groups whose packed readbacks are still in flight:
    # deferring the (single, small) per-group sync a few groups deep
    # lets the host decode/upload group g+1 while the device solves
    # group g — without it every group pays the full serial chain
    pending_groups: List[Dict] = []
    pipeline_depth = int(args.get("device_pipeline_depth", 3))

    def drain_pending(all_groups: bool = False):
        while pending_groups and (
            all_groups or len(pending_groups) > pipeline_depth
        ):
            complete_device_group(pending_groups.pop(0))

    def flush_group_device(tasks: List[_Task], params, mode: str,
                           features: bool):
        t0 = tasks[0]
        n = len(tasks)
        npoints = cfg.npoints(t0.im_data)

        with timer.device_stage("h2d", device):
            uniq, f0_idx, f1_idx = _dedup_frames(tasks, n)
            # one stacked upload for the group's cache misses, at the
            # scale-appropriate dtype (f16 only where lossless)
            handles = dev_cache.get_many(
                uniq, dg.frame_upload_dtype(cfg.scale(t0.im_data))
            )
            frames_dev = dg.stack_frames(handles)

        res = aff_d = warped_d = None
        if features:
            fparams = resolve_feature_params(t0.im_data, args)
            with timer.device_stage("prealign", device):
                res, warped_d = _prealign_group(
                    frames_dev, f1_idx, f0_idx, fparams
                )
                aff_d = res.affine
            stats["detected_frames"] += len(uniq)

        # same-shape ROIs solve together (top/bottom strips share one
        # solve and one readback); shapes differ -> separate passes
        by_shape: Dict[Tuple[int, int], List[Tuple[str, Roi]]] = {}
        for roi_key in sorted(t0.rois.keys()):
            roi: Roi = t0.rois[roi_key]
            by_shape.setdefault(roi.shape, []).append((roi_key, roi))

        payloads = []
        for roi_list in by_shape.values():
            seed = int(group_rng.integers(1, 2 ** 31))
            with timer.device_stage("solve", device):
                packed, _i0s, _i1s, flow = dg.solve_group_on_device(
                    frames_dev, f0_idx, f1_idx, roi_list, params, mode,
                    npoints, affines_dev=aff_d, warped_dev=warped_d,
                    debug=cfg.debug, seed=seed,
                )
            stats["solve_device"] = str(flow.device)
            payloads.append({"roi_list": roi_list, "packed": packed})
        pending_groups.append(
            {"tasks": tasks, "payloads": payloads, "npoints": npoints,
             "features": features, "alignment": res}
        )
        drain_pending()

    def complete_device_group(ent: Dict):
        tasks = ent["tasks"]
        n = len(tasks)
        npoints = ent["npoints"]
        for k, pl in enumerate(ent["payloads"]):
            with timer.stage("sample"):
                packed_np = pl["packed"].cpu().numpy()  # the one sync
            timer.read_device_events()  # no wait: what the sync has passed
            if k == 0 and ent["alignment"] is not None:
                # the gates were decided on the device before the solve:
                # reading them here, behind the samples, costs no wait
                _report_alignment(ent["alignment"], n, cfg.debug)
            samples, counts = dg.unpack_samples(packed_np, n, npoints)
            with timer.stage("postprocess"):
                for r, (_roi_key, roi) in enumerate(pl["roi_list"]):
                    for j, task in enumerate(tasks):
                        task.im_data["point_matches"] = (
                            dg.matches_from_samples(
                                samples[r, j], int(counts[r, j]), roi,
                                1.0 / cfg.scale(task.im_data),
                                ent["features"],
                                task.im_data.get("point_matches"),
                            )
                        )
        finish_tasks(tasks)

    groups: Dict[Tuple, List[_Task]] = {}

    def run_pairs():
        for i, im_data in enumerate(cfg.images):
            p = str(im_data["p"])
            q = str(im_data["q"])
            scale = cfg.scale(im_data)
            im_data["scale"] = scale
            if journal and any(
                k in completed for k in pair_key_aliases(im_data, args)
            ):
                stats["resumed"] += 1
                continue
            print(f"{p} {q}")
            try:
                with timer.stage("decode"):
                    frame0, frame1 = cache.get_pair(p, q, scale)
            except ImageReadError as e:
                print(f"Error: {e.args[0]} ", file=sys.stderr)
                stats["skipped"] += 1
                continue
            rows = min(frame0.shape[0], frame1.shape[0])
            cols = min(frame0.shape[1], frame1.shape[1])
            rois = resolve_rois(im_data, args, rows, cols)
            im_data["output"] = cfg.output_path(im_data)

            if _batchable(im_data, args, frame0, frame1, rois, can_batch_features):
                key = _group_key(im_data, args, frame0, frame1, rois, cfg)
                groups.setdefault(key, []).append(
                    _Task(i, im_data, frame0, frame1, rois)
                )
                if len(groups[key]) >= pair_batch:
                    flush_group(groups.pop(key))
            else:
                with timer.stage("solve"):
                    solve_rois(
                        frame0, frame1, rois, im_data, args,
                        aligner=aligner, write_outputs=write_outputs,
                        device=device,
                    )
                stats["pairs"] += 1
                stats["sequential"] += 1
                if cfg.output_type(im_data) == "random_points":
                    move_pm(im_data, args)
                    upload_state["pending"] = True
                if journal:
                    journal.record_pair(pair_key(im_data, args))
                maybe_flush(i)

        for tasks in groups.values():
            flush_group(tasks)
        drain_pending(all_groups=True)
        maybe_flush(len(cfg.images), force=True)

    try:
        run_pairs()
    finally:
        if prefetch is not None:
            prefetch.close()  # quiesce the decode threads on any exit

    if journal:
        journal.close()
    stats["timing"] = timer.summary(stats["pairs"])
    return stats
