"""ctypes bindings for the native threaded image loader.

``loader.cpp`` decodes PNG, JPEG and TIFF files to grayscale and resizes them
with the bilinear half-pixel rule on a pool of host threads, the arithmetic
of the JAX package's loader statement for statement. It is compiled by
``ops/_build.py`` (stem ``loader``) into the package's build directory at
first use, never at import. Callers check :func:`available` and keep the
Python decoder otherwise; :func:`build_error` says why it is not, and
:func:`missing_header` names the image library's header whose absence
stopped the build. A failed build is recorded beside the library's name, so
another process does not compile again until the source or the flags
change, or ``python -m optflow_tpu_torch.ops._build loader`` is run (after
the image libraries are installed).
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Optional

import numpy as np

from optflow_tpu_torch.core.imgio import ImageReadError

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built if it is not yet; None when it cannot be
    built or loaded (the reason stays in :func:`build_error`). A library on
    disk that does not load (one built on another machine) is built once
    more first (``_build.load_library``). A failure is not retried within
    the process, nor where a build of the same source and flags failed
    before."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        from optflow_tpu_torch.ops import _build

        failed = _build.error_path("loader")
        if failed.exists() and not _build.library_path("loader").exists():
            _error = failed.read_text()
            return None
        try:
            lib = _build.load_library("loader")
        except (RuntimeError, OSError) as e:
            _error = str(e)
            return None
        lib.ofl_create.restype = ctypes.c_void_p
        lib.ofl_create.argtypes = [ctypes.c_int]
        lib.ofl_submit.restype = ctypes.c_int
        lib.ofl_submit.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_float,
        ]
        lib.ofl_wait_meta.restype = ctypes.c_int
        lib.ofl_wait_meta.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ofl_fetch.restype = ctypes.c_int
        lib.ofl_fetch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.ofl_destroy.restype = None
        lib.ofl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the loader library builds and loads on this machine."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's (or the dynamic loader's) message when
    :func:`available` is False, else None."""
    _load()
    return _error


def missing_header() -> Optional[str]:
    """The header the compiler did not find when the loader failed to build
    (libpng's, libjpeg's or libtiff's development files not installed), from
    :func:`build_error`; None when it built or failed for another reason."""
    found = re.search(r"fatal error: ([\w./+-]+): No such file",
                      build_error() or "")
    return found.group(1) if found else None


class NativeLoader:
    """Threaded decode+resize with async submit/wait."""

    def __init__(self, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self._lib = lib
        self._h = lib.ofl_create(n_threads)
        self._next_id = 0
        self._lock = threading.Lock()

    def submit(self, path: str, scale: float) -> int:
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
        self._lib.ofl_submit(
            self._h, job_id, path.encode("utf-8"), float(scale)
        )
        return job_id

    def wait(self, job_id: int) -> np.ndarray:
        """Block for a submitted job; returns float32 (H, W) or raises
        ``ImageReadError`` when the file could not be read or decoded."""
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.ofl_wait_meta(
            self._h, job_id, ctypes.byref(h), ctypes.byref(w)
        )
        if rc != 0:
            raise ImageReadError(f"native decode failed (job {job_id})")
        out = np.empty((h.value, w.value), np.float32)
        rc = self._lib.ofl_fetch(
            self._h, job_id, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if rc != 0:  # pragma: no cover
            raise ImageReadError(f"native fetch failed (job {job_id})")
        return out

    def load(self, path: str, scale: float) -> np.ndarray:
        return self.wait(self.submit(path, scale))

    def close(self) -> None:
        """Finish what was submitted, then stop the threads."""
        if self._h:
            self._lib.ofl_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
