"""Build and load the package's CUDA sources.

Each ``csrc/<stem>.cu`` has a plain C interface and is compiled with ``nvcc``
for ``sm_90a`` into a shared library that ``ctypes`` loads. The library is
built at first use, never at import, into ``build/`` beside the package and
is named after a hash of the source, the headers beside it and the flags, so
an edit rebuilds and an unchanged source is reused. A failed build raises
with the compiler's output. :func:`build_libraries` compiles several sources
at once, one ``nvcc`` process each. :func:`enqueued` reads what the loaded
libraries have put on the card's streams.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Tuple

CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "optflow_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
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


def library_path(stem: str) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_libraries(stems: Iterable[str]) -> None:
    """Compile every library of ``stems`` that is not built yet, all ``nvcc``
    processes started together. Raises ``RuntimeError`` with nvcc's output
    when a build fails."""
    started: List[Tuple[str, pathlib.Path, pathlib.Path, list, subprocess.Popen]] = []
    t0 = time.perf_counter()
    for stem in stems:
        out = library_path(stem)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{stem}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started.append((stem, out, tmp, cmd, proc))
    failures = []
    for stem, out, tmp, cmd, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
            continue
        os.replace(tmp, out)
        build_seconds[stem] = time.perf_counter() - t0
        # registers / shared memory / spills of every kernel, for the reader
        out.with_suffix(".log").write_text(log)
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library(stem: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<stem>.cu``, compiled if it is not built
    yet. Raises ``RuntimeError`` with nvcc's output when the build fails."""
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
    for lib in _loaded.values():
        fn = getattr(lib, "tvl1_enqueued", None)
        if fn is None:  # a library without the shared header
            continue
        out = (ctypes.c_longlong * 2)()
        fn(ctypes.c_void_p(ctypes.addressof(out)))
        kernels += out[0]
        memops += out[1]
    return kernels, memops
