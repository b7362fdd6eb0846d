"""Job-file configuration system.

Pure-Python implementation of the reference's config semantics:

- Job files are JSON or gzipped JSON (ref: src/optflow.cpp:43-58). The
  reference parses with jsoncpp's tolerant reader, so we strip JS-style
  comments (the documented schema, docs/example.json, uses them) and accept
  trailing commas.
- Three-level key precedence: per-image ``im_args`` -> job-global ``args`` ->
  compiled default, i.e. ``im_args.get(k, args.get(k, default))`` everywhere
  (ref: src/optflow.cpp:92,503-512; features.cpp:22-30,37-43;
  docs/example.json:55-57).
- Tri-state ``features`` boolean resolution where an explicit falsy value at
  either level wins (ref: src/optflow.cpp:323-338), while the *detector type*
  is the integer value with default SURF(2) (ref: src/features.cpp:53,
  src/features.h:11-12).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import json
import re
from typing import Any, Mapping

# Detector type flags (ref: src/features.h:11-12)
ORB_TYPE = 1
SURF_TYPE = 2

_COMMENT_RE = re.compile(
    r'("(?:[^"\\]|\\.)*")|(/\*.*?\*/|//[^\n]*)', re.DOTALL
)
_TRAILING_COMMA_RE = re.compile(r",(\s*[}\]])")


def _strip_json_comments(text: str) -> str:
    """Remove //... and /*...*/ comments outside of string literals."""

    def repl(m: re.Match) -> str:
        if m.group(1) is not None:
            return m.group(1)
        return ""

    return _COMMENT_RE.sub(repl, text)


def parse_job_text(text: str) -> dict:
    """Parse job-file JSON, tolerating comments and trailing commas."""
    cleaned = _strip_json_comments(text)
    cleaned = _TRAILING_COMMA_RE.sub(r"\1", cleaned)
    return json.loads(cleaned)


def load_job(path: str) -> dict:
    """Load a job file, transparently gunzipping ``*.gz``.

    Mirrors the reference CLI entry (src/optflow.cpp:43-58).
    """
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            raw = f.read()
    else:
        with open(path, "rb") as f:
            raw = f.read()
    return parse_job_text(raw.decode("utf-8"))


def dump_job(args: dict, path: str) -> None:
    """Write a job dict as JSON, gzipping when the path ends in .gz."""
    payload = json.dumps(args).encode("utf-8")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def cfg_get(im_args: Mapping, args: Mapping, key: str, default: Any) -> Any:
    """``im_args.get(k, args.get(k, default))`` — the reference's universal
    config-precedence idiom (docs/example.json:55-57)."""
    if key in im_args:
        return im_args[key]
    return args.get(key, default)


def _as_bool(v: Any) -> bool:
    """jsoncpp ``asBool`` semantics: numbers are truthy unless 0."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    if isinstance(v, str):
        return v.lower() not in ("", "0", "false")
    return bool(v)


def resolve_features(im_args: Mapping, args: Mapping) -> bool:
    """Tri-state features-enabled resolution (ref: src/optflow.cpp:323-338).

    Explicit falsy at the per-image level wins, then explicit falsy at the
    job level, then truthy at either level enables, else disabled.
    """
    if "features" in im_args and not _as_bool(im_args["features"]):
        return False
    if "features" in args and not _as_bool(args["features"]):
        return False
    if _as_bool(im_args.get("features", False)) or _as_bool(
        args.get("features", False)
    ):
        return True
    return False


def feature_type(im_args: Mapping, args: Mapping) -> int:
    """Detector selection integer, default SURF-class (ref: features.cpp:53)."""
    v = cfg_get(im_args, args, "features", SURF_TYPE)
    try:
        return int(v)
    except (TypeError, ValueError):
        return SURF_TYPE


@dataclasses.dataclass(frozen=True)
class TVL1Params:
    """TV-L1 solver parameters with the reference's tuned defaults
    (ref: src/optflow.cpp:500-514 ``generate_TV_args``)."""

    tau: float = 0.25
    lambda_: float = 0.05  # much smoother than stock 0.15; tuned for resin
    theta: float = 0.3
    nscales: int = 10
    warps: int = 5
    epsilon: float = 0.01
    iterations: int = 300
    scale_step: float = 0.8
    gamma: float = 0.0
    use_initial_flow: bool = False

    @classmethod
    def from_config(cls, im_args: Mapping, args: Mapping) -> "TVL1Params":
        return cls(
            tau=float(cfg_get(im_args, args, "tau", 0.25)),
            lambda_=float(cfg_get(im_args, args, "lambda", 0.05)),
            theta=float(cfg_get(im_args, args, "theta", 0.3)),
            nscales=int(cfg_get(im_args, args, "nscales", 10)),
            warps=int(cfg_get(im_args, args, "warps", 5)),
            epsilon=float(cfg_get(im_args, args, "epsilon", 0.01)),
            iterations=int(cfg_get(im_args, args, "iterations", 300)),
            scale_step=float(cfg_get(im_args, args, "scaleStep", 0.8)),
            gamma=float(cfg_get(im_args, args, "gamma", 0.0)),
            use_initial_flow=_as_bool(
                cfg_get(im_args, args, "useInitialFlow", False)
            ),
        )


@dataclasses.dataclass(frozen=True)
class OrbParams:
    """ORB-class detector/descriptor parameters (ref: features.cpp:19-32)."""

    nfeatures: int = 5000
    scale_factor: float = 1.2
    nlevels: int = 8
    edge_threshold: int = 31
    first_level: int = 0
    wta_k: int = 2
    patch_size: int = 31
    fast_threshold: int = 20
    blur_for_descriptor: bool = False

    @classmethod
    def from_config(cls, im_args: Mapping, args: Mapping) -> "OrbParams":
        return cls(
            nfeatures=int(cfg_get(im_args, args, "nfeatures", 5000)),
            scale_factor=float(cfg_get(im_args, args, "scaleFactor", 1.2)),
            nlevels=int(cfg_get(im_args, args, "nlevels", 8)),
            edge_threshold=int(cfg_get(im_args, args, "edgeThreshold", 31)),
            first_level=int(cfg_get(im_args, args, "firstLevel", 0)),
            wta_k=int(cfg_get(im_args, args, "WTA_K", 2)),
            patch_size=int(cfg_get(im_args, args, "patchSize", 31)),
            fast_threshold=int(cfg_get(im_args, args, "fastThreshold", 20)),
            blur_for_descriptor=_as_bool(
                cfg_get(im_args, args, "blurForDescriptor", False)
            ),
        )


@dataclasses.dataclass(frozen=True)
class SurfParams:
    """SURF-class blob detector parameters (ref: features.cpp:34-44)."""

    hessian_threshold: float = 400.0
    n_octaves: int = 4
    n_octave_layers: int = 2
    extended: bool = False
    keypoints_ratio: float = 0.01
    upright: bool = False

    @classmethod
    def from_config(cls, im_args: Mapping, args: Mapping) -> "SurfParams":
        return cls(
            hessian_threshold=float(
                cfg_get(im_args, args, "hessianThreshold", 400)
            ),
            n_octaves=int(cfg_get(im_args, args, "nOctaves", 4)),
            n_octave_layers=int(cfg_get(im_args, args, "nOctaveLayers", 2)),
            extended=_as_bool(cfg_get(im_args, args, "extended", False)),
            keypoints_ratio=float(
                cfg_get(im_args, args, "keypointsRatio", 0.01)
            ),
            upright=_as_bool(cfg_get(im_args, args, "upright", False)),
        )


@dataclasses.dataclass(frozen=True)
class MatchParams:
    """Feature matching / homography parameters
    (ref: features.cpp:109,133; docs/example.json:26-44)."""

    ratio: float = 0.8
    homo: int = 4  # 0 = all points, 4 = RANSAC, 8 = least-median
    ransac: float = 5.0
    min_matches: int = 11  # ref requires good.size() > 10 (features.cpp:130)
    max_zoom_deviation: float = 0.20  # sanity gate (features.cpp:134)

    @classmethod
    def from_config(cls, im_args: Mapping, args: Mapping) -> "MatchParams":
        return cls(
            ratio=float(cfg_get(im_args, args, "ratio", 0.8)),
            homo=int(cfg_get(im_args, args, "homo", 4)),
            ransac=float(cfg_get(im_args, args, "ransac", 5.0)),
        )


@dataclasses.dataclass
class JobConfig:
    """A fully-loaded job file: the global args dict plus typed views.

    The raw dicts are kept authoritative so unknown keys round-trip; typed
    accessors implement precedence.
    """

    args: dict

    @property
    def images(self) -> list:
        return self.args.get("images", [])

    @property
    def debug(self) -> bool:
        return _as_bool(self.args.get("debug", False))

    @property
    def style(self) -> int:
        return int(self.args.get("style", 1))

    def scale(self, im_args: Mapping) -> float:
        # ref: src/optflow.cpp:92 — global default 0.5
        return float(cfg_get(im_args, self.args, "scale", 0.5))

    def output_type(self, im_args: Mapping) -> str:
        # ref: src/optflow.cpp:160,409 — default "map"
        return str(cfg_get(im_args, self.args, "output_type", "map"))

    def npoints(self, im_args: Mapping) -> int:
        # ref: src/optflow.cpp:537 — default 25
        return int(cfg_get(im_args, self.args, "npoints", 25))

    def batch_size(self) -> int:
        # ref: src/optflow.cpp:163 — default 100
        return int(self.args.get("batch_size", 100))

    def output_path(self, im_args: Mapping) -> str:
        """Compose the per-pair output base path
        (ref: src/optflow.cpp:155-157): output_dir/output_name_<scale %0.2f>,
        unless the image overrides ``output`` directly."""
        if "output" in im_args:
            return str(im_args["output"])
        scale = self.scale(im_args)
        out_dir = str(self.args.get("output_dir", ""))
        name = str(im_args.get("output_name", ""))
        return f"{out_dir}/{name}_{scale:0.2f}"

    def tv_params(self, im_args: Mapping) -> TVL1Params:
        return TVL1Params.from_config(im_args, self.args)

    def features_enabled(self, im_args: Mapping) -> bool:
        return resolve_features(im_args, self.args)

    def detector_type(self, im_args: Mapping) -> int:
        return feature_type(im_args, self.args)

    @classmethod
    def from_file(cls, path: str) -> "JobConfig":
        return cls(args=load_job(path))
