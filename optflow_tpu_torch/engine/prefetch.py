"""Prefetching frame loader: overlap host decode with device compute.

The reference's pair loop decodes synchronously between GPU solves
(src/optflow.cpp:106-125); its only overlap is the LRU-of-2 frame swap.
Here the job's full image schedule is known up front, so ``lookahead``
upcoming frames are decoded in the background while the GPU works on the
current group, by the first route this machine can run:

- ``"native"``: the native threaded loader (``native/loader.cpp``), whose
  frames are the JAX package's bit for bit;
- ``"native-resize"``, where the loader cannot be built for want of the
  image libraries: cv2 decodes and ``native/frame.cpp``, the loader's resize
  and TIFF luma without the image headers, reduces, on a pool of Python
  threads (``native/frame.py``); its frames are the loader's bit for bit;
- where there is no host compiler, or no cv2: the package's Python decoder
  (``core/imgio.py``: cv2 or PIL) on a pool of Python threads, as the JAX
  package then does too.

cv2, PIL and the ctypes calls all release the interpreter lock while they
decode and resize. Where the host compiler is there and the header-free
library does not build, building the prefetch loader raises with the
compiler's message.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from optflow_tpu_torch import native
from optflow_tpu_torch.core.config import JobConfig
from optflow_tpu_torch.core.imgio import (
    ImageReadError,
    decoder_name,
    read_gray_scaled,
)
from optflow_tpu_torch.native import frame


class _PoolDecoder:
    """A decode function on a thread pool, behind the native loader's
    submit / wait / close."""

    def __init__(self, decode: Callable[[str, float], np.ndarray],
                 n_threads: int):
        self._decode = decode
        self._pool = ThreadPoolExecutor(
            max_workers=n_threads, thread_name_prefix="optflow-decode"
        )

    def submit(self, path: str, scale: float) -> Future:
        return self._pool.submit(self._decode, path, scale)

    def wait(self, future: Future) -> np.ndarray:
        # raises what the decode raised (ImageReadError for a bad file)
        return future.result()

    def close(self) -> None:
        """Drop what has not started, wait for what has, stop the threads."""
        self._pool.shutdown(wait=True, cancel_futures=True)


class PrefetchLoader:
    """Callable loader for ``runner.FrameCache`` with background lookahead
    and a decoded-frame LRU.

    The LRU matters because a pair graph with z-distance <= 3 reuses every
    frame in up to 6 pairs spread over about a dozen consecutive pairs while
    the engine's FrameCache holds only the current pair: without it every
    section is decoded several times, and every re-decode is a NEW ndarray,
    which defeats the identity-keyed device-upload cache. Returning the same
    array object for a cached (path, scale) restores both.

    ``decoder`` names the route that decodes: ``"native"``,
    ``"native-resize"``, or the Python decoder's name."""

    def __init__(
        self,
        schedule: List[Tuple[str, float]],
        lookahead: int = 8,
        n_threads: int = 4,
        cache_frames: int = 32,
    ):
        n_threads = max(1, n_threads)
        if native.available():
            self._decoder = native.NativeLoader(n_threads)
            self.decoder = "native"
        elif frame.available():
            self._decoder = _PoolDecoder(frame.load, n_threads)
            self.decoder = "native-resize"
        else:
            self._decoder = _PoolDecoder(read_gray_scaled, n_threads)
            self.decoder = decoder_name()
        self.closed = False
        # de-duplicated schedule in first-use order
        self._schedule: List[Tuple[str, float]] = list(dict.fromkeys(schedule))
        self._pos = 0
        self._lookahead = lookahead
        self._pending: Dict[Tuple[str, float], object] = {}
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
                self._pending[key] = self._decoder.submit(*key)

    def _take(self, key: Tuple[str, float]) -> np.ndarray:
        handle = self._pending.pop(key, None)
        if handle is None:
            handle = self._decoder.submit(*key)
        try:
            return self._decoder.wait(handle)
        except ImageReadError:
            if self.decoder not in ("native", "native-resize"):
                raise
            # The native routes cover PNG, JPEG and TIFF; anything they
            # cannot parse is decoded again by the Python decoder, so a
            # format gap never skips a pair (the reference's cv::imread,
            # src/optflow.cpp:106, reads whatever OpenCV was built with). A
            # file that neither reads raises ImageReadError from here.
            return read_gray_scaled(*key)
        finally:
            self._fill()

    def __call__(self, path: str, scale: float) -> np.ndarray:
        key = (path, scale)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache[key] = self._cache.pop(key)  # refresh LRU position
            return hit
        frame = self._take(key)
        self._cache[key] = frame
        while len(self._cache) > self._cache_cap:
            self._cache.pop(next(iter(self._cache)))
        return frame

    def close(self) -> None:
        """Let what is pending finish or drop it, and stop the threads."""
        self._pending.clear()
        self._decoder.close()
        self.closed = True


def frame_decoder(loader) -> Optional[str]:
    """What decodes a runner's frames: the prefetch loader's ``decoder``;
    the Python decoder's name where the runner decodes by itself (no
    ``loader``); None for a caller's loader."""
    if loader is None:
        return decoder_name()
    return getattr(loader, "decoder", None)


def make_prefetch_loader(args: dict) -> Optional[PrefetchLoader]:
    """Build a prefetch loader for a job dict, or None when the job lists no
    images, or when the native loader cannot be built and no image library
    is installed (callers then keep the default loader, which raises at the
    first decode)."""
    if not native.available() and decoder_name() is None:
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
