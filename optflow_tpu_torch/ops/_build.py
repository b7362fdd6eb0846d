"""Build and load the package's native sources.

Each ``csrc/<stem>.cu`` has a plain C interface and is compiled with ``nvcc``
for ``sm_90a`` into a shared library that ``ctypes`` loads. The host libraries
are compiled the same way with the host C++ compiler: the image loader,
``native/loader.cpp`` (stem ``loader``), which links the image libraries, and
the loader's resize and TIFF luma alone, ``native/frame.cpp`` (stem
``frame``), which needs no library and no image header. A library
is built at first use, never at import, into ``build/`` beside the package
and is named after a hash of the source, the headers beside it and the flags,
so an edit rebuilds and an unchanged source is reused; nothing is written
into the package directory. A failed build raises with the compiler's output
and leaves it beside the library's name (:func:`error_path`), where the image
loader reads it instead of compiling again; a successful build removes it.
:func:`build_libraries` compiles several sources at once, one compiler
process each. :func:`enqueued` reads what the loaded libraries have put on
the card's streams.

    python -m optflow_tpu_torch.ops._build [stem ...]

builds the named libraries, or all of them, and prints where each went (it
exits 1 when one failed, after printing the others): an installed package whose tree is read-only at run time (a container image) is
built this way when it is installed.

The wrappers are called from one thread per device (``dist/``): every build
and load, and each wrapper's first binding of its library, holds :data:`lock`;
:class:`counted_launches` keeps a wrapper's launch count under a lock and
what its last launch left per thread.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, Iterable, List, Tuple

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "optflow_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# host libraries: stem -> C++ source, compiled with the flags of
# optflow_tpu/native/Makefile, so that the loader's float arithmetic is the
# JAX package's
HOST_SOURCES = {"loader": PACKAGE_DIR / "native" / "loader.cpp",
                "frame": PACKAGE_DIR / "native" / "frame.cpp"}
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
# what a host library links: the image libraries are the loader's alone
HOST_LIBS = {"loader": ["-lpng", "-ljpeg", "-ltiff", "-lz", "-lpthread"]}

_loaded: Dict[str, ctypes.CDLL] = {}
# Held around every build and load, and by each wrapper while it binds its
# library: two threads' first calls would otherwise start two nvcc writing the
# same library. Reentrant: a wrapper's binding loads under it.
lock = threading.RLock()
# seconds the last real compilation of each stem took (absent when the
# library was already built)
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of optflow_tpu_torch are compiled "
        "at first use and need the CUDA toolkit"
    )


def find_cxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found: the image loader of optflow_tpu_torch and its "
        "resize are compiled at first use and need a host C++ compiler"
    )


def all_stems() -> List[str]:
    """Every library of the package: each ``csrc/*.cu`` and the host
    libraries."""
    return sorted(f.stem for f in CSRC_DIR.glob("*.cu")) + list(HOST_SOURCES)


def library_path(stem: str) -> pathlib.Path:
    host = HOST_SOURCES.get(stem)
    if host is not None:
        digest = hashlib.sha256(
            " ".join(CXX_FLAGS + HOST_LIBS.get(stem, [])).encode())
        digest.update(host.read_bytes())
    else:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        digest.update((CSRC_DIR / f"{stem}.cu").read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def error_path(stem: str) -> pathlib.Path:
    """Where the last failed build of ``stem``'s current source and flags
    left the compiler's output."""
    return library_path(stem).with_suffix(".err")


def compile_command(stem: str, out: pathlib.Path) -> List[str]:
    host = HOST_SOURCES.get(stem)
    if host is not None:
        return [find_cxx(), *CXX_FLAGS, "-o", str(out), str(host),
                *HOST_LIBS.get(stem, [])]
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC_DIR / f"{stem}.cu")]


def build_libraries(stems: Iterable[str]) -> None:
    """Compile every library of ``stems`` that is not built yet, all compiler
    processes started together. Raises ``RuntimeError`` with the compiler's
    output when a build fails, after writing it to :func:`error_path`."""
    with lock:
        started: List[Tuple[str, pathlib.Path, pathlib.Path, list,
                            subprocess.Popen]] = []
        t0 = time.perf_counter()
        for stem in stems:
            out = library_path(stem)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = compile_command(stem, tmp)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started.append((stem, out, tmp, cmd, proc))
        failures = []
        for stem, out, tmp, cmd, proc in started:
            log, _ = proc.communicate()
            err = out.with_suffix(".err")
            if proc.returncode != 0:
                failures.append(
                    f"{os.path.basename(cmd[0])} failed ({proc.returncode}): "
                    f"{' '.join(cmd)}\n{log}"
                )
                err.write_text(failures[-1])
                continue
            os.replace(tmp, out)
            err.unlink(missing_ok=True)
            build_seconds[stem] = time.perf_counter() - t0
            # registers / shared memory / spills of every kernel (nvcc) or
            # the warnings (g++), for the reader
            out.with_suffix(".log").write_text(log)
        if failures:
            raise RuntimeError("\n".join(failures))


def load_library(stem: str) -> ctypes.CDLL:
    """The shared library of ``stem``, compiled if it is not built yet.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    with lock:
        lib = _loaded.get(stem)
        if lib is None:
            build_libraries([stem])
            lib = _loaded[stem] = ctypes.CDLL(str(library_path(stem)))
    return lib


def enqueued() -> Tuple[int, int]:
    """(kernel launches, memsets and copies) that the TV-L1 libraries loaded
    so far have enqueued since they were loaded, as each tallies them on the
    host where it enqueues them (``tvl1_enqueued`` of ``csrc/tvl1_common.cuh``).
    The difference across a call is what that call put on the card; PyTorch's
    own operations are not in it."""
    kernels = memops = 0
    with lock:
        libs = list(_loaded.values())
    for lib in libs:
        fn = getattr(lib, "tvl1_enqueued", None)
        if fn is None:  # a library without the shared header
            continue
        out = (ctypes.c_longlong * 2)()
        fn(ctypes.c_void_p(ctypes.addressof(out)))
        kernels += out[0]
        memops += out[1]
    return kernels, memops


class counted_launches:
    """Decorator of a kernel wrapper. ``wrapper.launches`` counts the launches
    of every thread; the wrapper adds one with :meth:`count_launch` where it
    launches its kernel, under a lock (``launches = 0`` resets it).
    ``last_work`` and ``last_steps`` are what the calling thread's last launch
    left (``None`` before its first): one thread per device must not read
    another's."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._lock = threading.Lock()
        self._launches = 0
        self._last = threading.local()

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        with self._lock:
            return self._launches

    @launches.setter
    def launches(self, value: int) -> None:
        with self._lock:
            self._launches = value

    def count_launch(self, work=None, steps=None) -> None:
        with self._lock:
            self._launches += 1
        self._last.work = work
        self._last.steps = steps

    @property
    def last_work(self):
        return getattr(self._last, "work", None)

    @property
    def last_steps(self):
        return getattr(self._last, "steps", None)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Build the libraries of optflow_tpu_torch into "
        f"{BUILD_DIR} and print where each went.")
    parser.add_argument("stems", nargs="*", metavar="stem",
                        help="libraries to build (default: all of them: "
                        + ", ".join(all_stems()) + ")")
    ns = parser.parse_args(argv)
    stems = ns.stems or all_stems()
    unknown = sorted(set(stems) - set(all_stems()))
    if unknown:
        parser.error(f"unknown libraries {unknown}")
    try:
        build_libraries(stems)
    except RuntimeError as e:  # the others were built all the same
        print(e, file=sys.stderr)
    built = [stem for stem in stems if library_path(stem).exists()]
    for stem in built:
        print(f"{stem}: {library_path(stem)}")
    return 0 if len(built) == len(stems) else 1


if __name__ == "__main__":
    raise SystemExit(main())
