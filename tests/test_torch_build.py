"""The port's build cache on the CPU: a library on disk that the dynamic
loader refuses (one built on another machine and copied with the tree, or a
truncated file) is moved aside, built once more and loaded; a rebuilt library
that still does not load raises ``OSError`` naming the rebuild, which the host
libraries report as unavailable and the CUDA wrappers pass on, never handing
back a plain version; a rebuild that does not compile raises the compiler's
output as a first build does."""

import ctypes
import sys

import numpy as np
import pytest
import torch

from optflow_tpu_torch import native
from optflow_tpu_torch.native import frame
from optflow_tpu_torch.ops import _build, tvl1_cuda

torch.set_num_threads(1)

JUNK = b"not a shared library\n"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty build directory, nothing loaded and nothing rebuilt."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "rebuilds", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    for mod in (native, frame, tvl1_cuda):
        monkeypatch.setattr(mod, "_lib", None)
    for mod in (native, frame):
        monkeypatch.setattr(mod, "_error", None)
    monkeypatch.setattr(frame, "_no_compiler", False)
    return tmp_path / "build"


def _plant(stem):
    """An unloadable file where ``stem``'s current library belongs."""
    path = _build.library_path(stem)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(JUNK)
    with pytest.raises(OSError):
        ctypes.CDLL(str(path))
    return path


def _stale(path):
    return path.with_name(path.name + ".stale")


def _junk_compiler(monkeypatch):
    """Every build writes a file the dynamic loader refuses."""
    def command(stem, out):
        return [sys.executable, "-c",
                f"open({str(out)!r}, 'wb').write({JUNK!r})"]

    monkeypatch.setattr(_build, "compile_command", command)


def test_an_unloadable_frame_library_is_rebuilt_and_loads(cache):
    path = _plant("frame")
    lib = _build.load_library("frame")
    assert _stale(path).read_bytes() == JUNK  # moved aside
    assert path.read_bytes()[:4] == b"\x7fELF"  # built in its place
    assert "frame" in _build.rebuilds and "frame" in _build.build_seconds
    lib.ofr_scaled_size.restype = None
    lib.ofr_scaled_size.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    oh, ow = ctypes.c_int(), ctypes.c_int()
    lib.ofr_scaled_size(73, 75, 0.5, ctypes.byref(oh), ctypes.byref(ow))
    assert (oh.value, ow.value) == (37, 38)  # the loader's lround shape
    # the module's own binding takes the same library
    assert frame.available()
    assert frame.scaled_shape(1025, 2049, 0.5) == (513, 1025)


def test_an_unloadable_loader_library_is_rebuilt_and_loads(cache, tmp_path):
    from PIL import Image

    path = _plant("loader")
    lib = native._load()
    if lib is None and native.missing_header():
        pytest.skip(f"the native loader did not build: {native.build_error()}")
    assert lib is not None, native.build_error()
    assert _stale(path).read_bytes() == JUNK
    assert "loader" in _build.rebuilds and native.available()
    arr = (np.arange(37 * 53) % 251).reshape(37, 53).astype(np.uint8)
    png = str(tmp_path / "gray.png")
    Image.fromarray(arr).save(png)
    ldr = native.NativeLoader(1)
    try:
        got = ldr.load(png, 1.0)
    finally:
        ldr.close()
    assert got.dtype == np.float32
    assert np.array_equal(got, arr.astype(np.float32))


@pytest.mark.parametrize("stem", ["loader", "frame", "tvl1_level"])
def test_a_rebuild_that_still_does_not_load_raises(cache, monkeypatch, stem):
    """The rebuilt file is refused too: OSError with the dynamic loader's
    message and the rebuild named. The host libraries report it as their
    present contract says (the loader unavailable, the frame route raising
    where the compiler is); the CUDA wrapper passes it on, and nothing is
    loaded in the library's place."""
    path = _plant(stem)
    _junk_compiler(monkeypatch)
    with pytest.raises(OSError, match="built again") as err:
        _build.load_library(stem)
    assert str(path) in str(err.value)
    assert _stale(path).read_bytes() == JUNK
    assert stem not in _build._loaded and stem in _build.rebuilds
    if stem == "loader":
        assert native._load() is None and not native.available()
        assert "built again" in native.build_error()
        with pytest.raises(RuntimeError, match="native loader unavailable"):
            native.NativeLoader(1)
    elif stem == "frame":
        with pytest.raises(RuntimeError, match="built again"):
            frame.available()
    else:
        with pytest.raises(OSError, match="built again"):
            tvl1_cuda._library()
        assert tvl1_cuda._lib is None


def test_a_rebuild_that_does_not_compile_raises_the_compilers_output(
        cache, tmp_path, monkeypatch):
    broken = tmp_path / "frame.cpp"
    broken.write_text("int ofr_gray_u8() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "HOST_SOURCES",
                        {**_build.HOST_SOURCES, "frame": broken})
    path = _plant("frame")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _build.load_library("frame")
    assert _stale(path).read_bytes() == JUNK and not path.exists()
    assert "undeclared_name" in _build.error_path("frame").read_text()
    with pytest.raises(RuntimeError, match="undeclared_name"):
        frame.available()


def test_a_library_that_loads_is_not_rebuilt(cache, monkeypatch):
    _build.build_libraries(["frame"])
    path = _build.library_path("frame")
    before = path.stat().st_mtime_ns
    monkeypatch.setattr(_build.subprocess, "Popen", None)  # no compiler run
    assert _build.load_library("frame") is _build.load_library("frame")
    assert path.stat().st_mtime_ns == before
    assert not _stale(path).exists() and _build.rebuilds == {}
