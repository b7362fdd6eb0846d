"""Synthetic inputs of the benches, made from numpy seeds: the port's own
copies of the generators of the root ``bench.py``, ``bench_job.py`` and
``bench_matrix.py``, equal to theirs bit for bit (``tests/test_torch_bench.py``
holds them so).

- :func:`make_pair`: a FIB-SEM-like pair with a known constant flow, and
  :func:`oracle_flow`, the committed IPOL-oracle flow of seed 0 at 256x1024;
- :func:`gen_sections` / :func:`gen_stack`: a stack of uint8 sections, each
  shifted by ``(DX_STEP, DY_STEP)`` full-resolution px a z step, in memory or
  as PNG files cached on disk; :func:`build_job`, :class:`MockRenderSink` and
  :func:`gate_matches`: the strip job over it, a sink that serialises and
  sends nothing, and the gate of its point matches;
- :func:`affine_pairs`: pairs misaligned by a small rigid motion, with the
  affine the pre-alignment should recover;
- :func:`chained_frames`: a chained z-stack whose consecutive frames share
  content.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import List, Optional, Sequence

import numpy as np

# the headline solve: production strips (SURVEY.md §6) in 16-pair batches
H, W = 256, 1024
BATCH = 16
DX, DY = 2.0, -1.25  # the pairs' true flow, px

# the job: 1024x2048 sections at scale 0.5, top/bottom strips of 256 rows
SRC_H, SRC_W = 1024, 2048
SCALE = 0.5  # the reference's default (src/optflow.cpp:92)
STRIP = 256
DX_STEP, DY_STEP = 2.2, -1.2  # per z step, full-resolution px
MAX_DZ = 3  # the pair graph's z-distance (docs/example_gen_cross:1)

ORACLE_FIXTURE = (pathlib.Path(__file__).resolve().parents[2] / "tests"
                  / "fixtures" / "golden_oracle_256x1024.npz")
STACK_ENV = "OPTFLOW_TPU_TORCH_BENCH_STACK"


def make_pair(h, w, dx, dy, seed=0):
    """Synthetic FIB-SEM-like pair with known ground-truth flow (dx, dy)."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    base = rng.standard_normal((h, w))
    tex = ndi.gaussian_filter(base, 2.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((h, w)), 18.0)
    im = tex * 2.0 + lowf * 4.0
    im = (im - im.min()) / (np.ptp(im) + 1e-9)
    im0 = (20.0 + 215.0 * im).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    im1 = ndi.map_coordinates(
        im0, [ys - dy, xs - dx], order=3, mode="nearest"
    ).astype(np.float32)
    return im0, im1


def oracle_flow(path=ORACLE_FIXTURE) -> np.ndarray:
    """The committed flow of :func:`make_pair` seed 0 at 256x1024, (DX, DY),
    solved once by the independent IPOL oracle (``tests/reference_tvl1.py``)
    at the reference defaults: ``(256, 1024, 2)``. Raises where the fixture's
    metadata names another pair."""
    d = np.load(path)
    meta = (float(d["dx"]), float(d["dy"]), int(d["seed"]))
    if meta != (DX, DY, 0):
        raise ValueError(f"{path}: the oracle flow is of (dx, dy, seed) = "
                         f"{meta}, not {(DX, DY, 0)}")
    return d["flow"]


def gen_sections(n_frames: int, src_h: int = SRC_H,
                 src_w: int = SRC_W) -> List[np.ndarray]:
    """uint8 sections: crops of one band-limited texture, section z at
    offset ``z * (DY_STEP, DX_STEP)`` (a backward-warped crop, so fractional
    offsets stay exact), plus per-section noise. The flow between sections
    z and z + dz is ``dz * (DX_STEP, DY_STEP)`` up to the noise."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(7)
    pad_h = int(abs(DY_STEP) * n_frames) + 8
    pad_w = int(abs(DX_STEP) * n_frames) + 8
    big_h, big_w = src_h + pad_h, src_w + pad_w
    base = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 4.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 36.0)
    tex = base * 2.0 + lowf * 4.0
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    tex = 20.0 + 215.0 * tex
    ys = np.arange(src_h)
    xs = np.arange(src_w)
    frames = []
    for z in range(n_frames):
        oy = pad_h / 2 - DY_STEP * (z - n_frames / 2)
        ox = pad_w / 2 - DX_STEP * (z - n_frames / 2)
        gy, gx = np.meshgrid(ys + oy, xs + ox, indexing="ij")
        sec = ndi.map_coordinates(tex, [gy, gx], order=3, mode="nearest")
        sec = sec + rng.normal(0.0, 1.5, sec.shape)
        frames.append(np.clip(sec, 0, 255).astype(np.uint8))
    return frames


def stack_names(stack: pathlib.Path, n_frames: int) -> List[str]:
    """The PNG paths of a stack written by :func:`gen_stack`."""
    return [str(stack / f"sec_{z:04d}.png") for z in range(n_frames)]


def gen_stack(n_frames: int, src_h: int = SRC_H, src_w: int = SRC_W,
              root: Optional[str] = None) -> pathlib.Path:
    """:func:`gen_sections` written as 8-bit grayscale PNG files
    ``sec_0000.png`` ... into a folder keyed by frame count and shape under
    ``root`` (default: the environment variable ``OPTFLOW_TPU_TORCH_BENCH_STACK``,
    else the temporary directory), and kept there for the next run: a
    ``DONE`` file marks a complete stack."""
    import cv2

    if root is None:
        root = os.environ.get(STACK_ENV) or os.path.join(
            tempfile.gettempdir(), "optflow_tpu_torch_bench_stack")
    d = pathlib.Path(root) / f"v1_{n_frames}_{src_h}x{src_w}"
    done = d / "DONE"
    if done.exists():
        return d
    d.mkdir(parents=True, exist_ok=True)
    for path, sec in zip(stack_names(d, n_frames),
                         gen_sections(n_frames, src_h, src_w)):
        if not cv2.imwrite(path, sec):
            raise OSError(f"could not write {path}")
    done.write_text("ok")
    return d


def build_job(names: Sequence[str], n_pairs: int, journal, tag: str,
              strip: int = STRIP) -> dict:
    """Reference-schema job dict over the sections ``names``: chained pairs
    at z-distance <= MAX_DZ (the production pair graph), strip ROIs of
    ``strip`` rows, ``random_points`` output. Each image entry carries its
    ``dz`` for the gate."""
    n_frames = len(names)
    images = []
    for z in range(n_frames):
        for dz in range(1, MAX_DZ + 1):
            if z + dz >= n_frames or len(images) >= n_pairs:
                continue
            images.append({
                "p": names[z], "q": names[z + dz],
                "pId": f"tile_{z}", "qId": f"tile_{z + dz}",
                "pGroupId": f"{z}.0", "qGroupId": f"{z + dz}.0",
                "output_name": f"{tag}_{z}_{z + dz}",
                "dz": dz,
            })
    return {
        "style": 1, "scale": SCALE, "output_type": "random_points",
        "rois": {"top": strip, "bottom": strip}, "npoints": 25,
        "batch_size": 100, "pair_batch": 16, "journal": journal,
        "images": images[:n_pairs],
    }


class MockRenderSink:
    """Stand-in for the render-ws match service: JSON-serialises every batch
    it is given (the host cost the real sink pays) and sends nothing."""

    def __init__(self):
        self.puts = 0
        self.bytes = 0
        self.match_sets = []

    def put(self, matches):
        payload = json.dumps(matches).encode("utf-8")
        self.puts += 1
        self.bytes += len(payload)
        self.match_sets.extend(matches)
        return True


def match_errors(match_sets, job):
    """Mean distance of the emitted ``q - p`` from the known shift
    ``dz * (DX_STEP, DY_STEP)``, full-resolution px, and the number of
    points it is over; ``(None, 0)`` when no set has a weighted point."""
    by_name = {(im["pId"], im["qId"]): im["dz"] for im in job["images"]}
    errs = []
    for ms in match_sets:
        dz = by_name.get((ms["pId"], ms["qId"]))
        m = ms["matches"]
        if dz is None or not m["w"] or max(m["w"]) == 0:
            continue
        d = np.asarray(m["q"], np.float64) - np.asarray(m["p"], np.float64)
        errs.append(np.hypot(d[0] - dz * DX_STEP, d[1] - dz * DY_STEP))
    if not errs:
        return None, 0
    allerr = np.concatenate(errs)
    return float(allerr.mean()), int(allerr.size)


def gate_matches(sink: MockRenderSink, job: dict) -> dict:
    """The job's end-to-end gate: mean match error <= 1.0 full-resolution px
    (the solve itself is gated at 0.5 px at scale 0.5)."""
    err, _ = match_errors(sink.match_sets, job)
    if err is None:
        return {"match_err_px": None, "match_ok": False}
    return {"match_err_px": round(err, 4), "match_ok": err <= 1.0}


def affine_pairs(batch, h, w, seed0=0, misalign=True):
    """``batch`` pairs of :func:`make_pair` (seeds ``seed0`` ...), the second
    frame of each moved by a small rotation about the centre and a shift, and
    the affine that maps i1 coordinates into i0's content space: i1(p)
    matches i0(A p) up to the constant (DX, DY) flow, so A is what the
    pre-alignment (``find_alignment(frame1, frame0)``) should recover.
    Returns ``(i0s, i1s, affines)``, float32, float32 and float64."""
    import scipy.ndimage as ndi

    i0s, i1s, affs = [], [], []
    rng = np.random.default_rng(99)
    for i in range(batch):
        a, b = make_pair(h, w, DX, DY, seed=seed0 + i)
        if misalign:
            th = rng.uniform(-0.01, 0.01)
            c, s = np.cos(th), np.sin(th)
            tx, ty = rng.uniform(-2, 2), rng.uniform(-2, 2)
            ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
            cx, cy = w / 2, h / 2
            sx = c * (xs - cx) + s * (ys - cy) + cx + tx
            sy = -s * (xs - cx) + c * (ys - cy) + cy + ty
            b = ndi.map_coordinates(b, [sy, sx], order=1, mode="nearest")
            # i1(p) = im0(M p - d): M the rotation and shift, d the pair's
            # (DX, DY) translation
            affs.append(np.array(
                [[c, s, cx - c * cx - s * cy + tx - DX],
                 [-s, c, cy + s * cx - c * cy + ty - DY]], np.float64,
            ))
        else:
            affs.append(np.array([[1, 0, 0], [0, 1, 0]], np.float64))
        i0s.append(a)
        i1s.append(b.astype(np.float32))
    return np.stack(i0s), np.stack(i1s), np.stack(affs)


def chained_frames(n_pairs: int, h: int, w: int) -> np.ndarray:
    """``n_pairs + 1`` chained frames, ``(n_pairs + 1, h, w)`` float32: the
    first frame of :func:`make_pair` seed 0, each next one the previous
    moved by (1.5, -0.8) px (bilinear). Consecutive frames make the pairs, so
    every frame but the ends is in two."""
    import scipy.ndimage as ndi

    base, _ = make_pair(h, w, DX, DY, seed=0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = [base]
    for _ in range(n_pairs):
        frames.append(ndi.map_coordinates(
            frames[-1], [ys + 0.8, xs - 1.5], order=1, mode="nearest"
        ).astype(np.float32))
    return np.stack(frames)
