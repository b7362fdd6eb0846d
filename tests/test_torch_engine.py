"""The ported path as a whole: the same tiny style-1 strip-ROI job through the JAX
package's run_job_batched and the port's, on the CPU, frames served from
memory. Random numbers differ between jax.random and torch, so the sampled
points are held by structure, validity and error against the known shift,
not one by one."""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch

from optflow_tpu.dist.mesh import make_pair_mesh
from optflow_tpu.engine import batch_runner as jbr
from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.engine import batch_runner as tbr
from optflow_tpu_torch.engine import device_group as tdg
from optflow_tpu_torch.engine.rois import Roi
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

SRC_H, SRC_W, STRIP, SCALE = 128, 256, 32, 0.5
DX_STEP, DY_STEP, MAX_DZ, N_PAIRS = 2.2, -1.2, 3, 12
DARK_COLS = 5  # working-resolution columns of background, where asked
FAST_TV = {"nscales": 3, "warps": 3, "iterations": 40}


def _stack(n_frames, dark=False):
    """Half-resolution float frames of a shifted texture stack (what decode
    + resize(0.5) gives), optionally with a dark band that is background
    (<= 1.0) in every frame."""
    rng = np.random.default_rng(7)
    pad = 16
    tex = ndi.gaussian_filter(
        rng.standard_normal((SRC_H + 2 * pad, SRC_W + 2 * pad)), 4.0
    )
    tex = 20.0 + 215.0 * (tex - tex.min()) / np.ptp(tex)
    ys, xs = np.arange(SRC_H), np.arange(SRC_W)
    frames = {}
    for z in range(n_frames):
        gy, gx = np.meshgrid(
            ys + pad - DY_STEP * (z - n_frames / 2),
            xs + pad - DX_STEP * (z - n_frames / 2), indexing="ij",
        )
        sec = ndi.map_coordinates(tex, [gy, gx], order=3, mode="nearest")
        sec = np.clip(sec, 0, 255).astype(np.uint8)
        half = sec.reshape(SRC_H // 2, 2, SRC_W // 2, 2).astype(
            np.float32).mean(axis=(1, 3))
        if dark:
            half[:, :DARK_COLS] = 0.0
        frames[f"mem://sec_{z:04d}"] = half
    return frames


def _job(names, journal=None, **kw):
    images = []
    n_frames = len(names)
    for z in range(n_frames):
        for dz in range(1, MAX_DZ + 1):
            if z + dz < n_frames and len(images) < N_PAIRS:
                images.append({
                    "p": names[z], "q": names[z + dz],
                    "pId": f"tile_{z}", "qId": f"tile_{z + dz}",
                    "pGroupId": f"{z}.0", "qGroupId": f"{z + dz}.0",
                    "output_name": f"t_{z}_{z + dz}", "dz": dz,
                })
    job = {
        "style": 1, "scale": SCALE, "output_type": "random_points",
        "rois": {"top": STRIP, "bottom": STRIP}, "npoints": 25,
        "batch_size": 100, "pair_batch": 16, "debug": True,
        "images": images, **FAST_TV,
    }
    if journal:
        job["journal"] = journal
    job.update(kw)
    return job


class _ListSink:
    def __init__(self):
        self.match_sets = []

    def put(self, matches):
        self.match_sets.extend(copy.deepcopy(matches))
        return True


@pytest.fixture(scope="module")
def frames():
    return _stack(N_PAIRS // MAX_DZ + MAX_DZ + 1)


@pytest.fixture(scope="module")
def port_run(frames, tmp_path_factory):
    job = _job(sorted(frames),
               journal=str(tmp_path_factory.mktemp("port") / "j.jsonl"))
    sink = _ListSink()
    stats = tbr.run_job_batched(
        job, sink=sink, loader=lambda p, s: frames[p], device="cpu"
    )
    return job, sink, stats


@pytest.fixture(scope="module")
def jax_run(frames, tmp_path_factory):
    job = _job(sorted(frames),
               journal=str(tmp_path_factory.mktemp("jax") / "j.jsonl"))
    sink = _ListSink()
    # one device: both sides take the device-group path (the test process's
    # 8 virtual devices would otherwise shard the JAX side over a mesh)
    stats = jbr.run_job_batched(
        job, sink=sink, loader=lambda p, s: frames[p],
        mesh=make_pair_mesh(n_pairs_axis=1, n_rows_axis=1),
    )
    return job, sink, stats


def _errors(sink, job):
    """Error of every emitted q - p against dz * (2.2, -1.2), full-res px,
    and whether its p lies in the interior: within 8 px of the frame's
    border the content a 3-section shift needs has left the image, and no
    solver can recover the flow there."""
    dz = {(im["pId"], im["qId"]): im["dz"] for im in job["images"]}
    errs, interior = [], []
    for ms in sink.match_sets:
        m = ms["matches"]
        p = np.asarray(m["p"], np.float64)
        d = np.asarray(m["q"], np.float64) - p
        k = dz[(ms["pId"], ms["qId"])]
        errs.append(np.hypot(d[0] - k * DX_STEP, d[1] - k * DY_STEP))
        interior.append((p[0] >= 8) & (p[0] < SRC_W - 8)
                        & (p[1] >= 8) & (p[1] < SRC_H - 8))
    return np.concatenate(errs), np.concatenate(interior)


def test_job_stats_equal_the_jax_package(port_run, jax_run):
    _, _, ps = port_run
    _, _, js = jax_run
    for key in ("pairs", "batched", "sequential", "uploads", "matches",
                "skipped", "resumed"):
        assert ps[key] == js[key], key
    assert ps["pairs"] == ps["batched"] == N_PAIRS
    assert ps["matches"] == N_PAIRS * 2 * 25
    assert ps["solve_device"] == "cpu"


def test_sink_order_and_counts_equal_the_jax_package(port_run, jax_run):
    _, psink, _ = port_run
    _, jsink, _ = jax_run
    assert [(m["pId"], m["qId"]) for m in psink.match_sets] == [
        (m["pId"], m["qId"]) for m in jsink.match_sets
    ]
    for a, b in zip(psink.match_sets, jsink.match_sets):
        assert a["pGroupId"] == b["pGroupId"] and a["qGroupId"] == b["qGroupId"]
        assert len(a["matches"]["w"]) == len(b["matches"]["w"]) == 50
        assert a["matches"]["w"] == b["matches"]["w"]


def test_every_match_within_a_pixel_of_the_true_shift(port_run, jax_run):
    """Every emitted q - p of the interior within 1.0 full-res px of
    dz * (2.2, -1.2), on both sides (border samples within 3 px), and the
    two sides' mean errors within 0.1 px of each other."""
    pe, p_in = _errors(port_run[1], port_run[0])
    je, j_in = _errors(jax_run[1], jax_run[0])
    assert p_in.mean() > 0.8 and j_in.mean() > 0.8
    assert pe[p_in].max() <= 1.0 and pe.max() <= 3.0
    assert je[j_in].max() <= 1.0 and je.max() <= 3.0
    assert pe.mean() <= 0.5 and je.mean() <= 0.5
    assert abs(pe.mean() - je.mean()) <= 0.1


def test_samples_lie_on_valid_pixels_and_carry_the_flow():
    """With a band of background in every frame: p is a valid pixel of its
    strip (never in the band), and q - p is the port's post-processed flow
    at that pixel."""
    from optflow_tpu_torch.engine.pair import postprocess_flow

    frames = _stack(4, dark=True)
    job = _job(sorted(frames))
    job["images"] = job["images"][:3]
    sink = _ListSink()
    tbr.run_job_batched(
        job, sink=sink, loader=lambda p, s: frames[p], device="cpu"
    )
    params = TVL1Params.from_config({}, job)
    rois = {"bottom": Roi(0, SRC_H // 2 - STRIP, SRC_W // 2, STRIP),
            "top": Roi(0, 0, SRC_W // 2, STRIP)}
    assert len(sink.match_sets) == 3
    for im, ms in zip(job["images"], sink.match_sets):
        f0, f1 = frames[im["p"]], frames[im["q"]]
        m = ms["matches"]
        p = np.asarray(m["p"]) * SCALE
        q = np.asarray(m["q"]) * SCALE
        # sorted ROI keys: bottom's 25 samples first, then top's
        for r, name in enumerate(("bottom", "top")):
            roi = rois[name]
            i0 = torch.from_numpy(f0[roi.slices()])[None]
            i1 = torch.from_numpy(f1[roi.slices()])[None]
            flow = tvl1_flow_batched(i0, i1, params)
            fx, fy, valid = (
                t[0].numpy() for t in postprocess_flow(flow, i0, i1, "displacement")
            )
            assert not valid[:, :DARK_COLS].any() and valid[:, DARK_COLS:].all()
            for k in range(25 * r, 25 * (r + 1)):
                px, py = int(round(p[0, k])), int(round(p[1, k] - roi.y))
                assert 0 <= py < STRIP and valid[py, px]
                assert abs(q[0, k] - p[0, k] - fx[py, px]) <= 1e-3
                assert abs(q[1, k] - p[1, k] - fy[py, px]) <= 1e-3


def test_debug_runs_are_deterministic(port_run, frames):
    job = _job(sorted(frames))
    sink = _ListSink()
    tbr.run_job_batched(
        job, sink=sink, loader=lambda p, s: frames[p], device="cpu"
    )
    assert [m["matches"] for m in sink.match_sets] == [
        m["matches"] for m in port_run[1].match_sets
    ]


def test_journal_resume_skips_flushed_pairs(port_run, frames):
    done_job = port_run[0]
    job = _job(sorted(frames), journal=done_job["journal"])
    stats = tbr.run_job_batched(
        job, sink=_ListSink(), loader=lambda p, s: frames[p], device="cpu"
    )
    assert stats["resumed"] == N_PAIRS and stats["pairs"] == 0


@pytest.mark.parametrize("mode", ["displacement", "map"])
def test_postprocessing_matches_jax_batched_solver(frames, mode):
    """Map/displacement composition, background zeroing and the union valid
    mask against the JAX package's _batched_solver on the same frames:
    outputs within 0.02 px, masks equal."""
    names = sorted(frames)
    roi = Roi(0, 0, SRC_W // 2, STRIP)
    i0 = np.stack([frames[names[0]][roi.slices()],
                   frames[names[1]][roi.slices()]])
    i1 = np.stack([frames[names[1]][roi.slices()],
                   frames[names[3]][roi.slices()]]).copy()
    i0 = i0.copy()
    i0[:, :, :DARK_COLS] = 0.0  # background in both frames: invalid
    i1[:, :, :DARK_COLS] = 0.0
    i1[:, 10:14, 40:60] = 0.5  # background in frame1 only: zeroed, valid
    jf, _ = jbr._batched_solver(STRIP, SRC_W // 2, JaxParams(**FAST_TV), mode, None)
    affs = jnp.broadcast_to(jnp.eye(2, 3, dtype=jnp.float32), (2, 2, 3))
    wx, wy, wv = (np.asarray(a) for a in jf(jnp.asarray(i0), jnp.asarray(i1), affs))
    gx, gy, gv = tbr._batched_solver(TVL1Params(**FAST_TV), mode)(
        torch.from_numpy(i0), torch.from_numpy(i1)
    )
    assert np.array_equal(gv.numpy(), wv)
    assert not gv.numpy()[:, :, :DARK_COLS].any() and gv.numpy()[:, 12, 50].all()
    assert np.abs(gx.numpy() - wx).max() <= 0.02
    assert np.abs(gy.numpy() - wy).max() <= 0.02
    assert float(gx[:, 10:14, 40:60].abs().max()) == 0.0
    if mode == "map":
        assert abs(float(gx[0, 5, 100]) - 100.0) < 4.0


def test_host_path_writes_the_same_matches_structure(frames):
    """device_sample: false takes the host path (full fields read back,
    host sampler); same counts, every match within a pixel of the truth."""
    job = _job(sorted(frames), device_sample=False)
    sink = _ListSink()
    stats = tbr.run_job_batched(
        job, sink=sink, loader=lambda p, s: frames[p], device="cpu"
    )
    assert stats["batched"] == N_PAIRS and stats["matches"] == N_PAIRS * 50
    err, interior = _errors(sink, job)
    assert err[interior].max() <= 1.0 and err.mean() <= 0.5


def test_unbatchable_pair_takes_the_sequential_path(frames):
    names = sorted(frames)
    job = _job(names)
    job["images"] = job["images"][:2]
    job["images"][1]["rois"] = {"custom": {"0": [8, 0, 64, 32], "1": [8, 0, 64, 32]}}
    stats = tbr.run_job_batched(
        job, sink=_ListSink(), loader=lambda p, s: frames[p], device="cpu"
    )
    assert stats["batched"] == 1 and stats["sequential"] == 1


def test_feature_groups_name_the_later_slice(frames):
    job = _job(sorted(frames), features=2)
    with pytest.raises(NotImplementedError, match="features slice"):
        tbr.run_job_batched(
            job, sink=_ListSink(), loader=lambda p, s: frames[p], device="cpu"
        )


def test_packed_payload_layout():
    """(n, 4 * npoints + 1): [px, py, out_x, out_y] * npoints + [count]; an
    image with fewer valid pixels than npoints reports its count."""
    gen = torch.Generator().manual_seed(0)
    fx = torch.arange(24, dtype=torch.float32).reshape(1, 4, 6).repeat(2, 1, 1)
    fy = -fx
    valid = torch.zeros(2, 4, 6, dtype=torch.bool)
    valid[0] = True
    valid[1, 2, 3] = True
    packed = tdg.sample_points(fx, fy, valid, 5, gen).numpy()
    assert packed.shape == (2, 21)
    samples, counts = tdg.unpack_samples(packed, 2, 5)
    assert samples.shape == (1, 2, 5, 4) and counts.tolist() == [[5, 1]]
    s = samples[0, 1, 0]
    assert (s[0], s[1], s[2], s[3]) == (3.0, 2.0, 15.0, -15.0)
    pts = {(a[0], a[1]) for a in samples[0, 0]}
    assert len(pts) == 5  # without replacement
    empty = tdg.matches_from_samples(samples[0, 1], 0, Roi(0, 0, 6, 4), 2.0, False)
    assert empty["w"] == [0] and empty["p"] == [[-1], [-1]]


# --- full-frame map / flow jobs and the prefetch loader ---------------------


def _tiff_job(names, output_type, out_dir):
    """4 pairs, one `custom` ROI over the whole scaled frame, TIFF output."""
    job = _job(names, output_type=output_type, output_dir=str(out_dir),
               rois={"custom": [0, 0, SRC_W // 2, SRC_H // 2]},
               features=False, pair_batch=2, match_sink="null")
    job["images"] = job["images"][:4]
    return job


@pytest.mark.parametrize("output_type", ["map", "flow"])
def test_tiff_jobs_equal_the_jax_package(frames, tmp_path, output_type):
    """The slice as a whole: a 4-pair style-1 job with a `custom` ROI and
    `map` or `flow` output through both packages' run_job_batched. Same
    file names; fields within 0.02 px of each other (the tolerance of the
    whole-pyramid comparison) and, away from the border, within 0.5 px of
    the known shift."""
    from optflow_tpu_torch.core.imgio import read_float_tiff

    names = sorted(frames)
    pjob = _tiff_job(names, output_type, tmp_path / "port")
    jjob = _tiff_job(names, output_type, tmp_path / "jax")
    ps = tbr.run_job_batched(
        pjob, loader=lambda p, s: frames[p], device="cpu")
    js = jbr.run_job_batched(
        jjob, loader=lambda p, s: frames[p],
        mesh=make_pair_mesh(n_pairs_axis=1, n_rows_axis=1),
    )
    for key in ("pairs", "batched", "sequential", "uploads", "matches"):
        assert ps[key] == js[key], key
    assert ps["pairs"] == ps["batched"] == 4 and ps["uploads"] == 0
    pfiles = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert pfiles == sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert pfiles == sorted(
        f"{im['output_name']}_0.50_{c}.tiff"
        for im in pjob["images"] for c in "xy"
    )
    h, w = SRC_H // 2, SRC_W // 2
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for im in pjob["images"]:
        got, want = (
            [read_float_tiff(str(tmp_path / side /
                                 f"{im['output_name']}_0.50_{c}.tiff"))
             for c in "xy"]
            for side in ("port", "jax")
        )
        assert got[0].shape == (h, w)
        assert np.abs(got[0] - want[0]).max() <= 0.02
        assert np.abs(got[1] - want[1]).max() <= 0.02
        fx, fy = got
        if output_type == "map":
            fx, fy = fx - xs, fy - ys
        err = np.hypot(fx - im["dz"] * DX_STEP * SCALE,
                       fy - im["dz"] * DY_STEP * SCALE)
        assert err[8:-8, 8:-8].mean() <= 0.5


def test_stage_timer_device_stage_is_a_plain_stage_on_the_cpu(port_run):
    """The CUDA-event bracket needs a CUDA device; on the CPU the runner's
    stages are host-clock stages and no `_device_s` key appears."""
    from optflow_tpu_torch.utils.metrics import StageTimer

    timer = StageTimer()
    with timer.device_stage("solve", "cpu"):
        pass
    timer.read_device_events()
    out = timer.summary(1)
    assert "solve_s" in out and not any(k.endswith("_device_s") for k in out)
    timing = port_run[2]["timing"]
    assert {"solve_s", "h2d_s", "sample_s"} <= set(timing)
    assert not any(k.endswith("_device_s") for k in timing)


def _write_pngs(tmp_path, n):
    import cv2

    rng = np.random.default_rng(5)
    paths = []
    for k in range(n):
        im = ndi.gaussian_filter(rng.standard_normal((64, 96)), 2.0)
        im = (20 + 215 * (im - im.min()) / np.ptp(im)).astype(np.uint8)
        path = str(tmp_path / f"sec_{k}.png")
        assert cv2.imwrite(path, im)
        paths.append(path)
    return paths


def test_prefetch_loader_matches_the_jax_package(tmp_path):
    """PrefetchLoader against the JAX package's on the same PNG files: the
    same frames in the same order (within one gray level: that package
    decodes and resizes with its own native code, this one with cv2), the
    same array object for a repeated key while it is cached, a new one once
    it has been evicted, and close() leaves no thread behind."""
    import threading

    from optflow_tpu.engine.prefetch import PrefetchLoader as JaxPrefetch
    from optflow_tpu.native import available
    from optflow_tpu_torch.engine.prefetch import PrefetchLoader

    assert available(), "the JAX package's native loader did not build"
    paths = _write_pngs(tmp_path, 5)
    order = [0, 1, 1, 2, 0, 3, 4, 1]
    schedule = [(paths[k], 0.5) for k in order]
    port = PrefetchLoader(schedule, lookahead=3, n_threads=2, cache_frames=3)
    ref = JaxPrefetch(schedule, lookahead=3, n_threads=2, cache_frames=3)
    got, want = [], []
    for path, scale in schedule:
        got.append(port(path, scale))
        want.append(ref(path, scale))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (32, 48)
        assert np.abs(a - b).max() <= 1.0
    for frames_ in (got, want):
        assert frames_[2] is frames_[1]  # cache hit: the same object
        assert frames_[4] is frames_[0]  # still cached after 3 distinct keys
        # the hit refreshed frame 0; frame 1 was the oldest when 4 came in
        assert frames_[7] is not frames_[1]  # evicted by then: decoded anew
        assert np.array_equal(frames_[7], frames_[1])
    # a key that was never scheduled is decoded on demand
    extra = port(paths[2], 1.0)
    assert extra.shape == (64, 96)
    port.close()
    ref.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("optflow-decode")]


def test_prefetch_is_wired_into_the_runners(tmp_path, monkeypatch):
    """Without a caller's loader the runners decode through a PrefetchLoader
    built from the job's schedule and close it; `prefetch: false` and a
    caller's loader leave it out; a missing file is skipped as before."""
    from optflow_tpu_torch.engine import prefetch as tpf
    from optflow_tpu_torch.engine import runner as trn

    paths = _write_pngs(tmp_path, 3)
    made = []
    real = tpf.make_prefetch_loader

    def spy(args):
        made.append(real(args))
        return made[-1]

    monkeypatch.setattr(tbr, "make_prefetch_loader", spy)
    monkeypatch.setattr(trn, "make_prefetch_loader", spy)

    def job(**kw):
        return {
            "style": 1, "scale": 1.0, "output_type": "flow",
            "output_dir": str(tmp_path / "out"), "match_sink": "null",
            "rois": {"custom": [0, 0, 96, 64]}, "features": False,
            "nscales": 2, "warps": 1, "iterations": 5,
            "images": [
                {"p": paths[0], "q": paths[1], "output_name": "a"},
                {"p": paths[1], "q": str(tmp_path / "missing.png"),
                 "output_name": "b"},
                {"p": paths[1], "q": paths[2], "output_name": "c"},
            ], **kw,
        }

    stats = tbr.run_job_batched(job(pair_batch=2), device="cpu")
    assert (stats["pairs"], stats["skipped"]) == (2, 1)
    stats = trn.run_job(job(), device="cpu")
    assert (stats["pairs"], stats["skipped"]) == (2, 1)
    assert len(made) == 2 and all(m is not None for m in made)
    assert all(m._pool._shutdown for m in made)  # closed by the runner
    assert (tmp_path / "out" / "c_1.00_x.tiff").exists()
    tbr.run_job_batched(job(pair_batch=2, prefetch=False), device="cpu")
    trn.run_job(job(), device="cpu", loader=tbr.FrameCache()._loader)
    assert len(made) == 2
    assert tpf.make_prefetch_loader({"images": []}) is None


# --- feature pre-alignment ---------------------------------------------------

FEATURE_ARGS = {"features": 2, "hessianThreshold": 30, "ratio": 0.85}


def _interior(p, roi_rows, margin=12):
    """p (2, n) full-res: at least ``margin`` px inside its strip and the
    frame. The feature branch resamples the map by the affine with a
    constant border, so a sample near its ROI's border reads the fill."""
    ok = np.zeros(p.shape[1], bool)
    for lo, hi in roi_rows:
        ok |= (p[1] >= lo + margin) & (p[1] < hi - margin)
    return ok & (p[0] >= margin) & (p[0] < SRC_W - margin)


def _feature_errors(sink, job):
    """Error of every interior q against p + dz * (2.2, -1.2): with
    features on, q is the absolute map."""
    dz = {(im["pId"], im["qId"]): im["dz"] for im in job["images"]}
    rows = [(0, STRIP / SCALE), (SRC_H - STRIP / SCALE, SRC_H)]
    errs = []
    for ms in sink.match_sets:
        m = ms["matches"]
        p = np.asarray(m["p"], np.float64)
        d = np.asarray(m["q"], np.float64) - p
        k = dz[(ms["pId"], ms["qId"])]
        e = np.hypot(d[0] - k * DX_STEP, d[1] - k * DY_STEP)
        errs.append(e[_interior(p, rows)])
    return np.concatenate(errs)


@pytest.fixture(scope="module")
def feature_runs(frames):
    """The same 8-pair feature job through both packages' device paths."""
    out = {}
    for name, run, kw in (
        ("port", tbr.run_job_batched, {"device": "cpu"}),
        ("jax", jbr.run_job_batched,
         {"mesh": make_pair_mesh(n_pairs_axis=1, n_rows_axis=1)}),
    ):
        job = _job(sorted(frames), pair_batch=8, debug=False, **FEATURE_ARGS)
        job["images"] = job["images"][:8]
        sink = _ListSink()
        stats = run(job, sink=sink, loader=lambda p, s: frames[p], **kw)
        out[name] = (job, sink, stats)
    return out


def test_feature_groups_name_the_later_slice(feature_runs):
    """Feature groups were a later slice's; they now run, batched, with the
    JAX package's stats and counts, and detect each unique frame once."""
    (job, psink, ps), (_, jsink, js) = feature_runs["port"], feature_runs["jax"]
    for key in ("pairs", "batched", "sequential", "uploads", "matches",
                "skipped", "resumed"):
        assert ps[key] == js[key], key
    assert ps["batched"] == 8 and ps["sequential"] == 0
    assert ps["matches"] == 8 * 2 * 25
    unique = {nm for im in job["images"] for nm in (im["p"], im["q"])}
    assert ps["detected_frames"] == len(unique) < 16
    assert "prealign_s" in ps["timing"] and "prealign_s" in js["timing"]
    assert [(m["pId"], m["qId"]) for m in psink.match_sets] == [
        (m["pId"], m["qId"]) for m in jsink.match_sets]
    src = "".join(f.read_text() for f in (
        __import__("pathlib").Path(tbr.__file__).parent.glob("*.py")))
    assert "FEATURES_LATER" not in src and "NotImplementedError" not in src


def test_feature_job_matches_within_a_pixel_in_both_packages(feature_runs):
    """The JAX device path warps with its shift-compose approximation, the
    port with the exact gather, and their RANSAC hypotheses differ: the two
    are held by the match-error gate only. Interior samples: mean <= 1.0
    full-res px on either side, the two means within 0.5 px."""
    pe = _feature_errors(feature_runs["port"][1], feature_runs["port"][0])
    je = _feature_errors(feature_runs["jax"][1], feature_runs["jax"][0])
    assert len(pe) > 150 and len(je) > 150
    assert pe.mean() <= 1.0 and je.mean() <= 1.0
    assert np.median(pe) <= 0.75
    assert abs(pe.mean() - je.mean()) <= 0.5


def _fixed_aligner(affine):
    def aligner(frame1, frame0, im_args, args):
        return np.asarray(affine, np.float32)
    return aligner


@pytest.mark.parametrize("output_type,rois", [
    ("flow", {"top": STRIP}), ("map", None), ("random_points", {"bottom": STRIP}),
])
def test_sequential_feature_path_equals_the_jax_package(frames, output_type,
                                                        rois):
    """solve_rois with the SAME affine handed to both packages (a caller's
    aligner, so nothing depends on either's random hypotheses), frame 1
    larger than frame 0, the `default` ROI where none is given: warped
    frame, map composition and masks of the sequential path. Fields within
    0.02 px (0.05 px at the few pixels beside the warp's border), masks
    equal."""
    from optflow_tpu.engine import pair as jpair
    from optflow_tpu.engine.rois import resolve_rois as j_resolve
    from optflow_tpu_torch.engine import pair as tpair
    from optflow_tpu_torch.engine.rois import resolve_rois as t_resolve

    names = sorted(frames)
    f0 = frames[names[0]]
    f1 = np.pad(frames[names[2]], ((0, 6), (0, 10)), mode="edge")
    affine = np.array([[0.999, 0.012, -1.5], [-0.012, 0.999, 1.25]])
    args = {"output_type": output_type, "features": 2, "scale": SCALE,
            "debug": True, **FAST_TV}
    if rois:
        args["rois"] = rois
    rows, cols = f0.shape
    out = {}
    for name, mod, resolve, kw in (
        ("jax", jpair, j_resolve, {}),
        ("port", tpair, t_resolve, {"device": "cpu"}),
    ):
        im_args = {}
        res = mod.solve_rois(
            f0, f1, resolve(im_args, args, rows, cols), im_args, dict(args),
            aligner=_fixed_aligner(affine), write_outputs=False, **kw)
        out[name] = (res, im_args)
    (want, wargs), (got, gargs) = out["jax"], out["port"]
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key]["valid"], want[key]["valid"])
        for f in ("flow_x", "flow_y"):
            d = np.abs(got[key][f] - want[key][f])
            assert np.quantile(d, 0.99) <= 0.02 and d.max() <= 0.05, (key, f)
    if output_type == "random_points":
        assert gargs["point_matches"]["w"] == wargs["point_matches"]["w"]
        # debug: the host sampler is seeded alike, so the same pixels
        assert np.abs(np.asarray(gargs["point_matches"]["p"])
                      - np.asarray(wargs["point_matches"]["p"])).max() == 0
        assert np.abs(np.asarray(gargs["point_matches"]["q"])
                      - np.asarray(wargs["point_matches"]["q"])).max() <= 0.1


@pytest.mark.parametrize("mode", ["features_map", "features_flow"])
def test_feature_postprocessing_matches_jax_batched_solver(frames, mode):
    """The host path's batched solve + composition with per-pair affines
    against the JAX package's (which resamples with the exact affine_warp
    there too): within 0.02 px, masks equal."""
    names = sorted(frames)
    roi = Roi(0, 0, SRC_W // 2, STRIP)
    i0 = np.stack([frames[names[0]][roi.slices()],
                   frames[names[1]][roi.slices()]])
    i1 = np.stack([frames[names[1]][roi.slices()],
                   frames[names[3]][roi.slices()]])
    affs = np.array([[[1.0, 0.004, 0.7], [-0.004, 1.0, -0.4]],
                     [[1.002, 0.0, -1.1], [0.0, 0.998, 0.3]]], np.float32)
    jf, _ = jbr._batched_solver(
        STRIP, SRC_W // 2, JaxParams(**FAST_TV), mode, None)
    wx, wy, wv = (np.asarray(a) for a in jf(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(affs)))
    gx, gy, gv = tbr._batched_solver(TVL1Params(**FAST_TV), mode)(
        torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(affs))
    assert np.array_equal(gv.numpy(), wv)
    assert np.abs(gx.numpy() - wx).max() <= 0.02
    assert np.abs(gy.numpy() - wy).max() <= 0.02
    with pytest.raises(ValueError, match="affines"):
        tbr._batched_solver(TVL1Params(**FAST_TV), mode)(
            torch.from_numpy(i0), torch.from_numpy(i1))


def test_library_call_without_an_aligner_means_the_identity(frames):
    """As in the JAX package: on the sequential path ``aligner=None`` aligns
    by the identity (the CLI passes the real aligner); a batched group is
    aligned by the device aligner either way, so only a pair that cannot
    batch shows it. Same stats from the same call in both packages."""
    from optflow_tpu_torch.engine.features_glue import default_aligner
    from optflow_tpu_torch.engine import pair as tpair
    from optflow_tpu_torch.engine.rois import resolve_rois

    names = sorted(frames)
    f0, f1 = frames[names[0]], frames[names[1]]
    args = {"output_type": "flow", "rois": {"top": STRIP}, **FEATURE_ARGS,
            **FAST_TV}
    rois = resolve_rois({}, args, *f0.shape)
    none = tpair.solve_rois(f0, f1, rois, {}, dict(args), aligner=None,
                            write_outputs=False, device="cpu")
    ident = tpair.solve_rois(
        f0, f1, rois, {}, dict(args), write_outputs=False, device="cpu",
        aligner=_fixed_aligner([[1, 0, 0], [0, 1, 0]]))
    real = tpair.solve_rois(f0, f1, rois, {}, dict(args),
                            aligner=functools.partial(default_aligner,
                                                      device="cpu"),
                            write_outputs=False, device="cpu")
    assert np.array_equal(none["top"]["flow_x"], ident["top"]["flow_x"])
    assert not np.array_equal(none["top"]["flow_x"], real["top"]["flow_x"])

    def job():
        j = _job(names, pair_batch=4, debug=False, **FEATURE_ARGS)
        j["images"] = j["images"][:3]
        # one pair that cannot batch: it takes the sequential path
        j["images"][1]["rois"] = {
            "custom": {"0": [8, 0, 64, 32], "1": [8, 0, 64, 32]}}
        return j

    ps = tbr.run_job_batched(job(), sink=_ListSink(),
                             loader=lambda p, s: frames[p], device="cpu")
    js = jbr.run_job_batched(
        job(), sink=_ListSink(), loader=lambda p, s: frames[p],
        mesh=make_pair_mesh(n_pairs_axis=1, n_rows_axis=1))
    for key in ("pairs", "batched", "sequential", "uploads", "matches"):
        assert ps[key] == js[key], key
    assert (ps["batched"], ps["sequential"]) == (2, 1)
    # a caller's host aligner keeps feature pairs off the batched path
    ps = tbr.run_job_batched(
        job(), sink=_ListSink(), loader=lambda p, s: frames[p], device="cpu",
        aligner=_fixed_aligner([[1, 0, 0], [0, 1, 0]]))
    assert (ps["batched"], ps["sequential"]) == (0, 3)


def test_the_package_aligner_is_known_by_identity_not_by_name():
    """A ``functools.partial`` of the package's aligner still batches; a
    caller's function that merely shares its name is a host aligner."""
    from optflow_tpu_torch.engine.features_glue import (
        default_aligner as package_aligner,
        is_default_aligner,
    )

    def default_aligner(frame1, frame0, im_args, args):
        return np.eye(2, 3, dtype=np.float32)

    assert is_default_aligner(package_aligner)
    assert is_default_aligner(functools.partial(package_aligner, device="cpu"))
    assert not is_default_aligner(default_aligner)
    assert not is_default_aligner(functools.partial(default_aligner))


def test_prefetch_hands_one_array_to_every_pair_that_reuses_a_frame(tmp_path):
    """The frame dedup keys on id(array): the default loader must return the
    SAME ndarray for a (path, scale) that several pairs of a group use, or
    every pair would detect and upload its frames again."""
    from optflow_tpu_torch.engine.prefetch import make_prefetch_loader
    from optflow_tpu_torch.engine.runner import FrameCache

    paths = _write_pngs(tmp_path, 4)
    pairs = [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3)]
    job = {
        "style": 1, "scale": 1.0, "output_type": "random_points",
        "npoints": 5, "match_sink": "null", "rois": {"top": 32},
        "pair_batch": 8, **FEATURE_ARGS, "nscales": 2, "warps": 1,
        "iterations": 5,
        "images": [{"p": paths[a], "q": paths[b], "pId": f"t{a}",
                    "qId": f"t{b}", "pGroupId": f"{a}.0",
                    "qGroupId": f"{b}.0"} for a, b in pairs],
    }
    loader = make_prefetch_loader(job)
    cache = FrameCache(loader)
    seen = {}
    for a, b in pairs:
        f0, f1 = cache.get_pair(paths[a], paths[b], 1.0)
        assert seen.setdefault(a, f0) is f0 and seen.setdefault(b, f1) is f1
    loader.close()
    tasks = [tbr._Task(i, {}, seen[a], seen[b], {})
             for i, (a, b) in enumerate(pairs)]
    uniq, f0_idx, f1_idx = tbr._dedup_frames(tasks, len(tasks))
    assert len(uniq) == 4
    assert f0_idx.tolist() == [0, 0, 1, 1, 2] and f1_idx.tolist() == [1, 2, 2, 3, 3]
    stats = tbr.run_job_batched(job, device="cpu")  # its own prefetch loader
    assert stats["batched"] == 5 and stats["detected_frames"] == 4


def test_cli_runs_feature_jobs_and_still_honours_no_features(tmp_path, capsys):
    """The CLI passes the package's aligner: a job that asks for features
    detects its frames (batched runner and, with pair_batch 1, the
    sequential one, where the `default` ROI forces features by itself);
    --no-features turns them off. Its `done:` line names the product's
    kernels only."""
    import json

    from optflow_tpu_torch.cli import main as cli

    paths = _write_pngs(tmp_path, 3)

    def write(name, **kw):
        job = {
            "style": 1, "scale": 1.0, "output_type": "random_points",
            "npoints": 5, "match_sink": "null", "nscales": 2, "warps": 1,
            "iterations": 5, "hessianThreshold": 30,
            "images": [{"p": paths[a], "q": paths[b], "pId": f"t{a}",
                        "qId": f"t{b}", "pGroupId": f"{a}.0",
                        "qGroupId": f"{b}.0"} for a, b in ((0, 1), (1, 2))],
            **kw,
        }
        path = str(tmp_path / name)
        with open(path, "w") as f:
            json.dump(job, f)
        return path

    batched = write("b.json", features=2, rois={"top": 32}, pair_batch=2)
    assert cli.main([batched, "--device", "cpu"]) == 0
    done = capsys.readouterr().out.strip().splitlines()[-1]
    assert "'batched': 2" in done and "'detected_frames': 3" in done
    assert "prealign_s" in done
    assert "'kernel_launches': {'tvl1_level_solve': 0, " \
        "'tvl1_blocked_level_solve': 0}" in done
    assert cli.main([batched, "--device", "cpu", "--no-features"]) == 0
    done = capsys.readouterr().out.strip().splitlines()[-1]
    assert "'batched': 2" in done and "'detected_frames': 0" in done
    assert "prealign_s" not in done
    # no ROI at all: the `default` ROI, pair by pair through run_job
    sequential = write("s.json")
    assert cli.main([sequential, "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "reverting to features even though it wasn't selected" in captured.err
    assert "'pairs': 2" in captured.out.strip().splitlines()[-1]
