"""The port's native image loader on the CPU: every case of the JAX package's
loader tests on the port's own copy; its output against the JAX package's
``NativeLoader`` bit for bit, with equal shapes, on every format and scale
the jobs meet; the prefetch loader's fallback to the Python decoder; and a
scale-0.5 job from PNG files through both packages' native prefetch."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from optflow_tpu import native as jax_native
from optflow_tpu_torch import native
from optflow_tpu_torch.core.imgio import (
    ImageReadError,
    read_float_tiff,
    read_gray,
    resize_scale,
)
from tests.conftest import make_fibsem_like

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _built():
    if not native.available():  # decided in a fixture, never at import
        pytest.skip(f"the native loader did not build: {native.build_error()}")


def _python(path, scale):
    """The port's Python decoder: what the prefetch loader falls back to."""
    return resize_scale(read_gray(path), scale).astype(np.float32)


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _write_jpeg(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path, quality=95)


@pytest.fixture(scope="module")
def loader():
    ldr = native.NativeLoader(n_threads=3)
    yield ldr
    ldr.close()


# --- the cases of tests/test_native.py, on the port's loader ----------------


def test_png_gray_parity(tmp_path, rng, loader):
    arr = rng.integers(0, 255, size=(40, 56), dtype=np.uint8)
    p = tmp_path / "g.png"
    _write_png(str(p), arr)
    out = loader.load(str(p), 1.0)
    assert out.shape == (40, 56)
    assert np.array_equal(out, arr.astype(np.float32))


def test_png_rgb_to_gray(tmp_path, rng, loader):
    rgb = rng.integers(0, 255, size=(24, 24, 3), dtype=np.uint8)
    p = tmp_path / "c.png"
    _write_png(str(p), rgb)
    out = loader.load(str(p), 1.0)
    ref = _python(str(p), 1.0)
    assert out.shape == ref.shape
    # BT.601 luma; implementations may round differently by ~1 level
    assert float(np.abs(out - ref).max()) <= 2.0


def test_jpeg_decode(tmp_path, rng, loader):
    arr = rng.integers(0, 255, size=(32, 32), dtype=np.uint8)
    p = tmp_path / "j.jpg"
    _write_jpeg(str(p), arr)
    out = loader.load(str(p), 1.0)
    assert out.shape == (32, 32)
    # lossy codec: coarse agreement
    assert float(np.abs(out - arr.astype(np.float32)).mean()) < 6.0


def test_resize_parity_with_cv2(tmp_path, rng, loader):
    arr = rng.integers(0, 255, size=(64, 80), dtype=np.uint8)
    p = tmp_path / "r.png"
    _write_png(str(p), arr)
    out = loader.load(str(p), 0.5)
    ref = _python(str(p), 0.5)  # cv2 INTER_LINEAR fixed-point
    assert out.shape == ref.shape == (32, 40)
    assert float(np.abs(out - ref).max()) <= 1.0


def test_missing_file_raises(loader):
    with pytest.raises(ImageReadError):
        loader.load("/nonexistent/nope.png", 1.0)


def test_corrupt_file_raises(tmp_path, loader):
    p = tmp_path / "bad.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\nnot really a png")
    with pytest.raises(ImageReadError):
        loader.load(str(p), 1.0)


def test_concurrent_submissions(tmp_path, rng, loader):
    paths = []
    arrays = []
    for i in range(12):
        arr = rng.integers(0, 255, size=(20 + i, 30), dtype=np.uint8)
        p = tmp_path / f"m{i}.png"
        _write_png(str(p), arr)
        paths.append(str(p))
        arrays.append(arr)
    jobs = [loader.submit(p, 1.0) for p in paths]
    for job, arr in zip(jobs, arrays):
        out = loader.wait(job)
        assert np.array_equal(out, arr.astype(np.float32))


def _shifted_pair(rng, h, w):
    im0 = make_fibsem_like(rng, h, w)
    ys, xs = np.mgrid[0:h, 0:w].astype(float)
    im1 = ndi.map_coordinates(im0, [ys, xs - 1.0], order=3, mode="nearest")
    return im0.astype(np.uint8), im1.astype(np.uint8)


def test_prefetch_loader_in_run_job(tmp_path, rng):
    """run_job with the native prefetch loader gives the outputs of the
    Python loader."""
    from optflow_tpu_torch.engine.runner import run_job

    im0, im1 = _shifted_pair(rng, 48, 64)
    _write_png(str(tmp_path / "a.png"), im0)
    _write_png(str(tmp_path / "b.png"), im1)

    def job(outdir, prefetch):
        return {
            "style": 1, "scale": 1.0, "output_type": "flow",
            "output_dir": str(outdir), "rois": {"top": 24},
            "prefetch": prefetch, "features": False,
            "nscales": 2, "warps": 2, "iterations": 25,
            "images": [{"p": str(tmp_path / "a.png"),
                        "q": str(tmp_path / "b.png"),
                        "output_name": "x"}],
        }

    d1 = tmp_path / "native"
    d2 = tmp_path / "python"
    s1 = run_job(job(d1, True), device="cpu")
    s2 = run_job(job(d2, False), device="cpu")
    assert (s1["decoder"], s2["decoder"]) == ("native", "cv2")
    f1 = read_float_tiff(str(d1 / "x_1.00_top_x.tiff"))
    f2 = read_float_tiff(str(d2 / "x_1.00_top_x.tiff"))
    assert np.allclose(f1, f2, atol=1e-4)


def test_tiff_gray_parity(tmp_path, rng, loader):
    """Native TIFF decode matches the Python decoder (the reference's
    cv::imread reads TIFF, src/optflow.cpp:106)."""
    from PIL import Image

    arr = rng.integers(0, 255, size=(36, 44), dtype=np.uint8)
    p = tmp_path / "t.tiff"
    Image.fromarray(arr).save(str(p))
    out = loader.load(str(p), 1.0)
    assert out.shape == (36, 44)
    assert np.array_equal(out, arr.astype(np.float32))


def test_tiff_16bit_decode(tmp_path, rng, loader):
    """16-bit TIFF is scaled to 8-bit grayscale like IMREAD_GRAYSCALE."""
    from PIL import Image

    arr16 = rng.integers(0, 65535, size=(20, 24), dtype=np.uint16)
    p = tmp_path / "t16.tiff"
    Image.fromarray(arr16).save(str(p))
    out = loader.load(str(p), 1.0)
    assert out.shape == (20, 24)
    # libtiff RGBA path truncates to the top 8 bits
    assert float(np.abs(out - (arr16 >> 8).astype(np.float32)).max()) <= 1.0


def test_prefetch_falls_back_to_python_decoder(tmp_path, rng, monkeypatch):
    """A frame the native loader rejects is decoded again by the Python
    decoder instead of skipping the pair."""
    from optflow_tpu_torch.engine.prefetch import PrefetchLoader

    arr = rng.integers(0, 255, size=(30, 40), dtype=np.uint8)
    p = tmp_path / "x.png"
    _write_png(str(p), arr)

    ldr = PrefetchLoader([(str(p), 1.0)], lookahead=2)
    assert ldr.decoder == "native"
    try:
        # sabotage the native result so the wait raises
        monkeypatch.setattr(
            native.NativeLoader,
            "wait",
            lambda self, job_id: (_ for _ in ()).throw(
                ImageReadError("forced native failure")
            ),
        )
        out = ldr(str(p), 1.0)
    finally:
        monkeypatch.undo()
        ldr.close()
    assert np.array_equal(out, arr.astype(np.float32))


def test_prefetch_tiff_job_with_prefetch_enabled(tmp_path, rng):
    """End to end: a TIFF-input job with prefetch on solves every pair (no
    silent skips)."""
    from PIL import Image

    from optflow_tpu_torch.engine.runner import run_job

    im0, im1 = _shifted_pair(rng, 40, 48)
    Image.fromarray(im0).save(str(tmp_path / "a.tiff"))
    Image.fromarray(im1).save(str(tmp_path / "b.tiff"))

    stats = run_job(
        {
            "style": 1, "scale": 1.0, "output_type": "flow",
            "output_dir": str(tmp_path / "out"), "rois": {"top": 20},
            "prefetch": True, "features": False,
            "nscales": 2, "warps": 2, "iterations": 10,
            "images": [{"p": str(tmp_path / "a.tiff"),
                        "q": str(tmp_path / "b.tiff"),
                        "output_name": "x"}],
        },
        device="cpu",
    )
    assert stats["pairs"] == 1
    assert stats["skipped"] == 0
    assert stats["decoder"] == "native"


# --- bit for bit with the JAX package's loader ------------------------------

# (h, w): a frame of the job tests, and two where h * 0.5 or w * 0.5 ends in
# .5, which the loader rounds half away from zero (std::lround) and cv2 to
# even: 73x75 -> (37, 38) here, (36, 38) through cv2
SIZES = ((64, 96), (73, 75), (1025, 2049))
FORMATS = ("png_gray", "png_rgb", "jpeg", "tiff8", "tiff16")


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """One file of every format and size, from one seed."""
    from PIL import Image

    folder = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(11)
    files = {}
    for h, w in SIZES:
        gray = ndi.gaussian_filter(rng.standard_normal((h, w)), 1.5)
        gray = (255 * (gray - gray.min()) / np.ptp(gray)).astype(np.uint8)
        rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        arr16 = rng.integers(0, 65536, size=(h, w), dtype=np.uint16)
        for fmt, arr, name, kw in (
                ("png_gray", gray, "g.png", {}),
                ("png_rgb", rgb, "c.png", {}),
                ("jpeg", gray, "j.jpg", {"quality": 95}),
                ("tiff8", gray, "t8.tiff", {}),
                ("tiff16", arr16, "t16.tiff", {})):
            path = str(folder / f"{h}x{w}_{name}")
            Image.fromarray(arr).save(path, **kw)
            files[fmt, (h, w)] = path
    return files


@pytest.fixture(scope="module")
def both_loaders():
    assert jax_native.available(), "the JAX package's loader did not build"
    port, ref = native.NativeLoader(2), jax_native.NativeLoader(2)
    yield port, ref
    port.close()
    ref.close()


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.37])
@pytest.mark.parametrize("fmt", FORMATS)
def test_frames_equal_the_jax_package_loader(image_files, both_loaders, fmt,
                                             scale):
    port, ref = both_loaders
    for h, w in SIZES:
        path = image_files[fmt, (h, w)]
        got, want = port.load(path, scale), ref.load(path, scale)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape, (h, w)
        # the lround rule, on the float32 product the library computes
        s = np.float32(scale)
        assert got.shape == (int(np.floor(np.float32(h) * s + 0.5)),
                             int(np.floor(np.float32(w) * s + 0.5)))
        assert float(np.abs(got - want).max()) == 0.0, (h, w)


def test_odd_sizes_round_half_up_where_cv2_rounds_to_even(image_files, loader):
    """The frames the solver gets from a 73x75 or 1025x2049 section at scale
    0.5 are the native loader's shape, not cv2's; at an even size the two
    differ by up to half a gray level (float averages against cv2's uint8
    rounding)."""
    for (h, w), native_shape, cv2_shape in (
            ((73, 75), (37, 38), (36, 38)),
            ((1025, 2049), (513, 1025), (512, 1024))):
        path = image_files["png_gray", (h, w)]
        assert loader.load(path, 0.5).shape == native_shape
        assert _python(path, 0.5).shape == cv2_shape
    path = image_files["png_gray", (64, 96)]
    diff = np.abs(loader.load(path, 0.5) - _python(path, 0.5))
    assert 0.0 < float(diff.max()) <= 0.5


# --- the prefetch loader's fallback, and a job through both packages --------


def test_prefetch_decodes_what_the_native_loader_rejects(tmp_path, rng):
    """A BMP frame is no format of the native loader: the prefetch loader
    decodes it with the Python decoder and still serves every frame; a file
    that no decoder reads raises ImageReadError (the runner skips its pair)."""
    import cv2

    from optflow_tpu_torch.engine.prefetch import PrefetchLoader

    arr = rng.integers(0, 255, size=(30, 40), dtype=np.uint8)
    bmp, png = str(tmp_path / "x.bmp"), str(tmp_path / "y.png")
    assert cv2.imwrite(bmp, arr) and cv2.imwrite(png, arr)
    with pytest.raises(ImageReadError):
        native.NativeLoader(1).load(bmp, 1.0)
    schedule = [(bmp, 0.5), (png, 0.5)]
    ldr = PrefetchLoader(schedule, lookahead=2, n_threads=2)
    try:
        assert ldr.decoder == "native"
        got = [ldr(*key) for key in schedule]
        assert np.array_equal(got[0], _python(bmp, 0.5))
        assert got[1].shape == (15, 20)
        with pytest.raises(ImageReadError):
            ldr(str(tmp_path / "missing.png"), 0.5)
    finally:
        ldr.close()
    assert ldr.closed


def test_scale_half_job_equals_the_jax_package(tmp_path, monkeypatch):
    """A 2-pair `flow` job at scale 0.5 from PNG files of an odd size,
    through the port's run_job and the JAX package's, each with its own
    native prefetch loader: the frames the solvers get are equal (0.0, equal
    shapes) and the fields are within the whole-pyramid tolerance of the
    engine tests (0.02 px)."""
    from optflow_tpu.engine import prefetch as jpf
    from optflow_tpu.engine.runner import run_job as jax_run_job
    from optflow_tpu_torch.engine import prefetch as tpf
    from optflow_tpu_torch.engine.runner import run_job

    rng = np.random.default_rng(3)
    h, w = 97, 131  # 48.5 x 65.5 at scale 0.5: the frames are 49 x 66
    tex = make_fibsem_like(rng, h, w + 8)
    paths = []
    for z in range(3):
        path = str(tmp_path / f"sec_{z}.png")
        _write_png(path, tex[:, 4 - z:4 - z + w].astype(np.uint8))
        paths.append(path)

    frames = {"port": [], "jax": []}
    for side, mod in (("port", tpf), ("jax", jpf)):
        real = mod.PrefetchLoader.__call__

        def spy(self, path, scale, real=real, seen=frames[side]):
            seen.append(real(self, path, scale))
            return seen[-1]

        monkeypatch.setattr(mod.PrefetchLoader, "__call__", spy)

    def job(side):
        return {
            "style": 1, "scale": 0.5, "output_type": "flow",
            "output_dir": str(tmp_path / side), "rois": {"custom": [0, 0, 66, 49]},
            "features": False, "nscales": 3, "warps": 2, "iterations": 30,
            "images": [{"p": paths[z], "q": paths[z + 1],
                        "output_name": f"s{z}"} for z in range(2)],
        }

    stats = run_job(job("port"), device="cpu")
    jax_run_job(job("jax"))
    assert stats["pairs"] == 2 and stats["decoder"] == "native"
    # the runners keep the frame two pairs share: three loads each
    assert len(frames["port"]) == len(frames["jax"]) == 3
    for a, b in zip(frames["port"], frames["jax"]):
        assert a.shape == b.shape == (49, 66)
        assert float(np.abs(a - b).max()) == 0.0
    for z in range(2):
        for c in "xy":
            got, want = (read_float_tiff(str(tmp_path / side /
                                             f"s{z}_0.50_{c}.tiff"))
                         for side in ("port", "jax"))
            assert got.shape == want.shape == (49, 66)
            assert float(np.abs(got - want).max()) <= 0.02


def test_python_pool_when_the_loader_cannot_build(tmp_path, rng, monkeypatch):
    """Without the native library and without the header-free route (no
    host compiler) the prefetch loader keeps the Python decoder on a thread
    pool, names it, and raises for an unreadable file (there is nothing to
    fall back to)."""
    import threading

    from optflow_tpu_torch.engine import prefetch
    from optflow_tpu_torch.native import frame

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(frame, "available", lambda: False)
    arr = rng.integers(0, 255, size=(30, 40), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    _write_png(p, arr)
    ldr = prefetch.make_prefetch_loader(
        {"scale": 0.5, "images": [{"p": p, "q": p}]})
    try:
        assert ldr.decoder == "cv2"
        assert np.array_equal(ldr(p, 0.5), _python(p, 0.5))
        with pytest.raises(ImageReadError):
            ldr(str(tmp_path / "missing.png"), 0.5)
    finally:
        ldr.close()
    assert ldr.closed
    assert not [t for t in threading.enumerate()
                if t.name.startswith("optflow-decode")]


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch,
                                                         capsys):
    """A loader source that does not compile: the build raises with g++'s
    message, which available() / build_error() then report, and the build
    command exits 1 with it; an unchanged source keeps its library."""
    from optflow_tpu_torch.ops import _build

    good = _build.library_path("loader")
    assert good.exists() and good.parent == _build.BUILD_DIR
    broken = tmp_path / "loader.cpp"
    broken.write_text("int ofl_create(int n) { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "HOST_SOURCES", {"loader": broken})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.library_path("loader").name != good.name  # keyed by source
    with pytest.raises(RuntimeError, match="undeclared_name") as err:
        _build.build_libraries(["loader"])
    assert "g++ failed" in str(err.value) and "-ltiff" in str(err.value)
    assert _build.main(["loader"]) == 1
    assert "undeclared_name" in capsys.readouterr().err
    # recorded beside the library's name: another process reads it there
    # and does not compile again
    assert _build.error_path("loader").read_text() == str(err.value)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(_build.subprocess, "Popen", None)  # no compiler run
    assert not native.available()
    assert "undeclared_name" in native.build_error()
    assert native.missing_header() is None  # a fault of the source
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native.NativeLoader(1)
    assert not (tmp_path / "build").exists() or not list(
        (tmp_path / "build").glob("*.so"))


def test_a_missing_header_is_named_and_a_later_build_clears_it(
        tmp_path, monkeypatch):
    """A machine without an image library's development files: the build
    fails at the #include, missing_header() names the header from the
    recorded failure, and once the source builds the record is gone."""
    from optflow_tpu_torch.ops import _build

    src = tmp_path / "loader.cpp"
    src.write_text("#include <no_such_image_lib.h>\n")
    monkeypatch.setattr(_build, "HOST_SOURCES", {"loader": src})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    assert native.missing_header() == "no_such_image_lib.h"
    assert _build.error_path("loader").exists()
    # the header installed: the explicit build compiles again and clears
    # the record (a new source is a new name; the old record stays unread)
    (tmp_path / "inc").mkdir()
    (tmp_path / "inc" / "no_such_image_lib.h").write_text("")
    monkeypatch.setattr(_build, "CXX_FLAGS",
                        [*_build.CXX_FLAGS, f"-I{tmp_path / 'inc'}"])
    assert not _build.error_path("loader").exists()  # flags in the name
    _build.error_path("loader").write_text("stale")
    _build.build_libraries(["loader"])
    assert _build.library_path("loader").exists()
    assert not _build.error_path("loader").exists()


def test_the_build_command_prints_what_built_when_another_failed(
        tmp_path, monkeypatch, capsys):
    from optflow_tpu_torch.ops import _build

    good = tmp_path / "good.cpp"
    good.write_text("extern \"C\" int ofl_one() { return 1; }\n")
    broken = tmp_path / "loader.cpp"
    broken.write_text("int ofl_create(int n) { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "HOST_SOURCES",
                        {"good": good, "loader": broken})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.main(["good", "loader"]) == 1
    out, err = capsys.readouterr()
    assert out == f"good: {_build.library_path('good')}\n"
    assert "undeclared_name" in err and "good.cpp" not in err


def test_the_build_command_names_every_library(capsys):
    from optflow_tpu_torch.ops import _build

    stems = _build.all_stems()
    assert stems == ["smem_cap", "tvl1_ablate", "tvl1_blocked", "tvl1_chunk",
                     "tvl1_level", "loader", "frame"]
    assert _build.main(["loader"]) == 0  # built already: nothing to compile
    assert capsys.readouterr().out == (
        f"loader: {_build.library_path('loader')}\n")
    with pytest.raises(SystemExit):
        _build.main(["no_such_library"])
