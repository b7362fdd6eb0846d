"""Prefetching frame loader: overlap host decode with device compute.

The reference's pair loop decodes synchronously between GPU solves
(src/optflow.cpp:106-125); its only overlap is the LRU-of-2 frame swap.
Here the job's full image schedule is known up front, so a pool of threads
decodes ``lookahead`` upcoming frames in the background while the GPU works
on the current group. The decoder is the package's own (``core/imgio.py``:
``cv2`` or ``PIL``, both of which release the interpreter lock while they
decode and resize), so the threads do overlap.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from optflow_tpu_torch.core.config import JobConfig
from optflow_tpu_torch.core.imgio import decoder_name, read_gray, resize_scale


def _decode(path: str, scale: float) -> np.ndarray:
    """What ``runner.FrameCache`` decodes by default: grayscale, scaled,
    float32."""
    return resize_scale(read_gray(path), scale).astype(np.float32)


class PrefetchLoader:
    """Callable loader for ``runner.FrameCache`` with background lookahead
    and a decoded-frame LRU.

    The LRU matters because a pair graph with z-distance <= 3 reuses every
    frame in up to 6 pairs spread over about a dozen consecutive pairs while
    the engine's FrameCache holds only the current pair: without it every
    section is decoded several times, and every re-decode is a NEW ndarray,
    which defeats the identity-keyed device-upload cache. Returning the same
    array object for a cached (path, scale) restores both."""

    def __init__(
        self,
        schedule: List[Tuple[str, float]],
        lookahead: int = 8,
        n_threads: int = 4,
        cache_frames: int = 32,
    ):
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, n_threads), thread_name_prefix="optflow-decode"
        )
        # de-duplicated schedule in first-use order
        self._schedule: List[Tuple[str, float]] = list(dict.fromkeys(schedule))
        self._pos = 0
        self._lookahead = lookahead
        self._pending: Dict[Tuple[str, float], Future] = {}
        self._cache: Dict[Tuple[str, float], np.ndarray] = {}
        self._cache_cap = cache_frames
        self._fill()

    def _fill(self) -> None:
        while (
            len(self._pending) < self._lookahead
            and self._pos < len(self._schedule)
        ):
            key = self._schedule[self._pos]
            self._pos += 1
            if key not in self._pending:
                self._pending[key] = self._pool.submit(_decode, *key)

    def __call__(self, path: str, scale: float) -> np.ndarray:
        key = (path, scale)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache[key] = self._cache.pop(key)  # refresh LRU position
            return hit
        future = self._pending.pop(key, None)
        if future is None:
            future = self._pool.submit(_decode, path, scale)
        try:
            # raises what the decode raised (ImageReadError for a bad file)
            frame = future.result()
        finally:
            self._fill()
        self._cache[key] = frame
        while len(self._cache) > self._cache_cap:
            self._cache.pop(next(iter(self._cache)))
        return frame

    def close(self) -> None:
        """Drop what has not started, wait for what has, stop the threads."""
        for future in self._pending.values():
            future.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)


def make_prefetch_loader(args: dict) -> Optional[PrefetchLoader]:
    """Build a prefetch loader for a job dict, or None when the job lists no
    images or no image library is installed (callers then keep the default
    loader, which raises at the first decode)."""
    if decoder_name() is None:
        return None
    cfg = JobConfig(args)
    schedule: List[Tuple[str, float]] = []
    for im in cfg.images:
        scale = cfg.scale(im)
        schedule.append((str(im.get("p", "")), scale))
        schedule.append((str(im.get("q", "")), scale))
    if not schedule:
        return None
    # lookahead sized so decode stays ahead of a whole pipelined batch group;
    # overridable per job
    return PrefetchLoader(
        schedule,
        lookahead=int(args.get("prefetch_lookahead", 48)),
        n_threads=int(args.get("prefetch_threads", 8)),
        cache_frames=int(args.get("prefetch_cache_frames", 32)),
    )
