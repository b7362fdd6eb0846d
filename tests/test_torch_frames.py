"""The header-free native route on the CPU: cv2 decodes and
``native/frame.cpp``, the image loader's resize and TIFF luma without the
image libraries, reduces. Its frames and shapes against the JAX package's
``NativeLoader`` bit for bit on every PNG colour type, JPEG (an EXIF
orientation included) and gray and RGB TIFF of 8 and 16 bits, at three
scales and three sizes; its source against ``loader.cpp``'s text; its build
with every image header poisoned; the prefetch loader's choice of route with
the full loader made unavailable, and a scale-0.5 job through it against the
JAX package's native prefetch. Also the Python decoder's
``read_gray_scaled`` and the CLI's profile directory from the environment.

None of these needs the port's full loader: they run where its image headers
are missing (they need g++ and cv2, and the JAX package's loader for the
comparisons)."""

import pathlib
import re
import struct
import zlib

import numpy as np
import pytest
import torch

from optflow_tpu import native as jax_native
from optflow_tpu_torch import native
from optflow_tpu_torch.core.imgio import ImageReadError, read_float_tiff
from optflow_tpu_torch.native import frame
from tests.conftest import make_fibsem_like

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

SIZES = ((73, 75), (512, 1024), (1025, 2049))
SCALES = (1.0, 0.5, 0.37)


def write_png(path, samples, color, depth, palette=None, trns=None):
    """A PNG of ``samples`` (h, w) or (h, w, c), integers at ``depth`` bits
    (palette indices for colour type 3), written chunk by chunk so that
    every colour type, depth and tRNS chunk can be made."""
    a = np.asarray(samples)
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]

    def chunk(kind, data):
        crc = zlib.crc32(kind + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", crc)

    flat = a.reshape(h, w * c).astype(np.int64)
    if depth == 16:
        rows = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = flat.astype(np.uint8)
    else:  # pack 8 / depth samples a byte, the first in the high bits
        per = 8 // depth
        n = -(-w * c // per)
        packed = np.zeros((h, n * per), np.int64)
        packed[:, :w * c] = flat
        shifts = 8 - depth * np.arange(1, per + 1)
        rows = (packed.reshape(h, n, per) << shifts).sum(2).astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def _png_cases(rng, h, w):
    """name -> (samples, colour type, depth, palette, tRNS)."""
    tex = make_fibsem_like(rng, h, w).astype(np.int64)
    rgb = rng.integers(0, 256, (h, w, 3))
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 256, (h, w))
    gray16 = rng.integers(0, 65536, (h, w))
    return {
        "png_gray": (tex, 0, 8, None, None),
        "png_rgb": (rgb, 2, 8, None, None),
        "png_gray16": (gray16, 0, 16, None, None),
        "png_rgb16": (rng.integers(0, 65536, (h, w, 3)), 2, 16, None, None),
        "png_palette": (idx, 3, 8, pal, None),
        "png_palette4": (idx % 16, 3, 4, pal[:16], None),
        "png_gray_alpha": (np.dstack([tex, rng.integers(0, 256, (h, w))]),
                           4, 8, None, None),
        "png_rgba": (np.dstack([rgb, rng.integers(0, 256, (h, w))]), 6, 8,
                     None, None),
        "png_1bit": (tex > 127, 0, 1, None, None),
        "png_2bit": (tex >> 6, 0, 2, None, None),
        "png_4bit": (tex >> 4, 0, 4, None, None),
        # tRNS: the transparent gray, colour or palette alphas
        "png_gray_trns": (tex, 0, 8, None, struct.pack(">H", int(tex[0, 0]))),
        "png_gray16_trns": (gray16, 0, 16, None,
                            struct.pack(">H", int(gray16[0, 0]))),
        "png_2bit_trns": (tex >> 6, 0, 2, None, struct.pack(">H", 1)),
        "png_rgb_trns": (rgb, 2, 8, None,
                         struct.pack(">HHH", *map(int, rgb[0, 0]))),
        "png_palette_trns": (idx, 3, 8, pal,
                             rng.integers(0, 256, 100).astype(np.uint8)
                             .tobytes()),
    }


PNG_FORMATS = ("png_gray", "png_rgb", "png_gray16", "png_rgb16",
               "png_palette", "png_palette4", "png_gray_alpha", "png_rgba",
               "png_1bit", "png_2bit", "png_4bit", "png_gray_trns",
               "png_gray16_trns", "png_2bit_trns", "png_rgb_trns",
               "png_palette_trns")
FORMATS = (*PNG_FORMATS, "jpeg", "jpeg_exif", "tiff8", "tiff16", "tiff_rgb8",
           "tiff_rgb16")


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """One file of every format and size, from one seed."""
    import cv2
    from PIL import Image

    folder = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(23)
    files = {}
    for h, w in SIZES:
        cases = _png_cases(rng, h, w)
        assert tuple(cases) == PNG_FORMATS
        for name, args in cases.items():
            files[name, (h, w)] = path = str(folder / f"{h}x{w}_{name}.png")
            write_png(path, *args)
        gray = make_fibsem_like(rng, h, w).astype(np.uint8)
        bgr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        # EXIF orientation 6 (rotate 90 degrees): the loader ignores it
        exif = Image.Exif()
        exif[0x0112] = 6
        for name, save in (
                ("jpeg", lambda p: Image.fromarray(gray).save(p, quality=95)),
                ("jpeg_exif", lambda p: Image.fromarray(bgr).save(
                    p, quality=90, exif=exif.tobytes()))):
            files[name, (h, w)] = path = str(folder / f"{h}x{w}_{name}.jpg")
            save(path)
        for name, arr in (
                ("tiff8", gray),
                ("tiff16", rng.integers(0, 65536, (h, w), dtype=np.uint16)),
                ("tiff_rgb8", bgr),
                ("tiff_rgb16", rng.integers(0, 65536, (h, w, 3),
                                            dtype=np.uint16))):
            files[name, (h, w)] = path = str(folder / f"{h}x{w}_{name}.tiff")
            assert cv2.imwrite(path, arr)
    return files


@pytest.fixture(scope="module")
def reference():
    assert jax_native.available(), "the JAX package's loader did not build"
    ref = jax_native.NativeLoader(2)
    yield ref
    ref.close()


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_frames_equal_the_jax_package_loader(image_files, reference, fmt,
                                             scale):
    assert frame.available(), frame.build_error()
    for h, w in SIZES:
        path = image_files[fmt, (h, w)]
        got, want = frame.load(path, scale), reference.load(path, scale)
        assert got.dtype == want.dtype == np.float32
        # the lround rule, on the float32 product the library computes
        s = np.float32(scale)
        assert got.shape == want.shape == (
            int(np.floor(np.float32(h) * s + 0.5)),
            int(np.floor(np.float32(w) * s + 0.5))), (h, w)
        assert float(np.abs(got - want).max()) == 0.0, (h, w)


def test_odd_sizes_take_the_loaders_shapes(image_files):
    """1025x2049 and 73x75 at scale 0.5: the loader's lround shapes, where
    cv2's resize gives 512x1024 and 36x38."""
    from optflow_tpu_torch.core.imgio import read_gray_scaled

    for (h, w), shape, cv2_shape in (((73, 75), (37, 38), (36, 38)),
                                     ((1025, 2049), (513, 1025), (512, 1024))):
        path = image_files["png_gray", (h, w)]
        assert frame.load(path, 0.5).shape == shape
        assert frame.scaled_shape(h, w, 0.5) == shape
        assert read_gray_scaled(path, 0.5).shape == cv2_shape


def _block(text, first, last="\n}\n"):
    """The text from ``first`` to the next ``last``, a closing brace at the
    start of a line."""
    start = text.index(first)
    return text[start:text.index(last, start) + len(last)]


def test_the_resize_and_the_luma_are_the_loaders_statements():
    """frame.cpp holds loader.cpp's Image, resize_bilinear and decode_tiff's
    luma loop as the loader's text, and includes no image header."""
    src = pathlib.Path(native.__file__).parent
    ours = (src / "frame.cpp").read_text()
    loader = (src / "loader.cpp").read_text()
    for first, last in (("struct Image {", "\n};\n"),
                        ("// Bilinear with OpenCV's half-pixel convention",
                         "\n}\n")):
        assert _block(ours, first, last) == _block(loader, first, last)
    assert "void resize_bilinear(" in _block(ours, "// Bilinear")
    luma = re.compile(r"  for \(size_t i = 0; i < rgba\.size\(\); \+\+i\) "
                      r"\{\n.*?std::nearbyint\(.*?\n  \}\n", re.DOTALL)
    (theirs,) = luma.findall(loader)
    assert luma.findall(ours) == [theirs]
    # the macros the loop reads are libtiff's
    for name in ("TIFFGetR", "TIFFGetG", "TIFFGetB"):
        assert re.search(rf"#define {name}\(abgr\)", ours)
    includes = re.findall(r"#include <([\w./]+)>", ours)
    assert includes == ["cmath", "cstdint", "cstring", "vector"]


def test_the_library_builds_without_any_image_header(tmp_path):
    """Compiled with its own command and an include directory in front
    whose png.h, jpeglib.h and tiffio.h stop the compiler: it builds (the
    loader does not) and links no image library."""
    import subprocess

    from optflow_tpu_torch.ops import _build

    poison = tmp_path / "poison"
    poison.mkdir()
    for header in ("png.h", "pngconf.h", "jpeglib.h", "jconfig.h",
                   "tiffio.h", "tiff.h", "zlib.h"):
        (poison / header).write_text(f"#error {header} is not here\n")

    def build(stem):
        out = tmp_path / f"lib{stem}.so"
        cmd = _build.compile_command(stem, out)
        cmd.insert(1, f"-I{poison}")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        return proc, out

    proc, out = build("frame")
    assert proc.returncode == 0, proc.stderr
    assert not any(lib in proc.args for lib in ("-lpng", "-ljpeg", "-ltiff",
                                                "-lz"))
    binary = out.read_bytes()
    for name in (b"libpng", b"libjpeg", b"libtiff", b"libz"):
        assert name not in binary
    proc, _ = build("loader")  # the poison works
    assert proc.returncode != 0 and "png.h is not here" in proc.stderr


def test_read_gray_scaled_equals_the_jax_function(image_files):
    """The Python decoder's frame: the port's own copy of the JAX package's
    read_gray_scaled, on PNG, JPEG and TIFF at every scale."""
    from optflow_tpu.core.imgio import read_gray_scaled as jax_read
    from optflow_tpu_torch.core.imgio import read_gray_scaled

    for fmt in ("png_gray", "png_rgb", "jpeg", "tiff16"):
        path = image_files[fmt, (73, 75)]
        for scale in SCALES:
            got, want = read_gray_scaled(path, scale), jax_read(path, scale)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape
            assert np.array_equal(got, want)
    with pytest.raises(ImageReadError):
        read_gray_scaled("/nonexistent/nope.png", 1.0)


# --- the prefetch loader's route ---------------------------------------------


def test_the_prefetch_takes_the_header_free_route(image_files, reference,
                                                  monkeypatch):
    """With the full loader made unavailable the prefetch loader decodes
    through the header-free route, whose frames are the JAX loader's; a
    format it does not read goes to the Python decoder, a missing file
    raises."""
    import cv2

    from optflow_tpu_torch.engine.prefetch import PrefetchLoader
    from optflow_tpu_torch.core.imgio import read_gray_scaled

    monkeypatch.setattr(native, "available", lambda: False)
    keys = [(image_files[fmt, (73, 75)], scale)
            for fmt in ("png_gray", "jpeg", "tiff_rgb16", "png_palette_trns")
            for scale in (0.5, 0.37)]
    folder = pathlib.Path(keys[0][0]).parent
    bmp = str(folder / "x.bmp")
    assert cv2.imwrite(bmp, np.arange(30 * 40, dtype=np.uint8).reshape(30, 40))
    with pytest.raises(ImageReadError):
        frame.load(bmp, 0.5)
    ldr = PrefetchLoader([*keys, (bmp, 0.5)], lookahead=4, n_threads=3)
    try:
        assert ldr.decoder == "native-resize"
        for key in keys:
            assert np.array_equal(ldr(*key), reference.load(*key))
        assert np.array_equal(ldr(bmp, 0.5), read_gray_scaled(bmp, 0.5))
        with pytest.raises(ImageReadError):
            ldr(str(folder / "missing.png"), 0.5)
    finally:
        ldr.close()


def _reset_frame(monkeypatch):
    monkeypatch.setattr(frame, "_lib", None)
    monkeypatch.setattr(frame, "_error", None)
    monkeypatch.setattr(frame, "_no_compiler", False)


def test_a_failed_build_where_g_plus_plus_is_raises(tmp_path, monkeypatch):
    """No silent drop to cv2's resize: where the compiler is there and the
    library does not build, frame.available() and the prefetch loader raise
    with the compiler's message."""
    from optflow_tpu_torch.engine.prefetch import PrefetchLoader
    from optflow_tpu_torch.ops import _build

    broken = tmp_path / "frame.cpp"
    broken.write_text("int ofr_gray_u8() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "HOST_SOURCES",
                        {**_build.HOST_SOURCES, "frame": broken})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "available", lambda: False)
    _reset_frame(monkeypatch)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        frame.available()
    assert "g++ failed" in frame.build_error()
    with pytest.raises(RuntimeError, match="undeclared_name"):
        PrefetchLoader([("x.png", 0.5)])


def test_without_a_compiler_the_python_pool_decodes(tmp_path, monkeypatch):
    """No g++: the route is not there, and the prefetch loader keeps the
    Python decoder (cv2's resize), as the JAX package then does."""
    from optflow_tpu_torch.engine import prefetch
    from optflow_tpu_torch.core.imgio import read_gray_scaled
    from optflow_tpu_torch.ops import _build

    def no_compiler():
        raise RuntimeError("g++ not found: (test)")

    monkeypatch.setattr(_build, "find_cxx", no_compiler)
    monkeypatch.setattr(native, "available", lambda: False)
    _reset_frame(monkeypatch)
    assert not frame.available()
    assert "g++ not found" in frame.build_error()
    p = str(tmp_path / "x.png")
    write_png(p, np.arange(30 * 40).reshape(30, 40) % 256, 0, 8)
    ldr = prefetch.make_prefetch_loader(
        {"scale": 0.5, "images": [{"p": p, "q": p}]})
    try:
        assert ldr.decoder == "cv2"
        assert np.array_equal(ldr(p, 0.5), read_gray_scaled(p, 0.5))
    finally:
        ldr.close()


def test_scale_half_job_equals_the_jax_package(tmp_path, monkeypatch):
    """A 2-pair `flow` job at scale 0.5 from PNG files of an odd size,
    through the port's run_job with the full loader made unavailable (the
    header-free route) and the JAX package's with its native prefetch: the
    frames the solvers get are equal (0.0, equal shapes) and the fields are
    within the whole-pyramid tolerance of the engine tests (0.02 px)."""
    from optflow_tpu.engine import prefetch as jpf
    from optflow_tpu.engine.runner import run_job as jax_run_job
    from optflow_tpu_torch.engine import prefetch as tpf
    from optflow_tpu_torch.engine.runner import run_job

    assert jax_native.available(), "the JAX package's loader did not build"
    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(3)
    h, w = 97, 131  # 48.5 x 65.5 at scale 0.5: the frames are 49 x 66
    tex = make_fibsem_like(rng, h, w + 8)
    paths = []
    for z in range(3):
        path = str(tmp_path / f"sec_{z}.png")
        write_png(path, tex[:, 4 - z:4 - z + w].astype(np.uint8), 0, 8)
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
            "output_dir": str(tmp_path / side),
            "rois": {"custom": [0, 0, 66, 49]},
            "features": False, "nscales": 3, "warps": 2, "iterations": 30,
            "images": [{"p": paths[z], "q": paths[z + 1],
                        "output_name": f"s{z}"} for z in range(2)],
        }

    stats = run_job(job("port"), device="cpu")
    jax_run_job(job("jax"))
    assert stats["pairs"] == 2 and stats["decoder"] == "native-resize"
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


# --- the CLI -----------------------------------------------------------------


def test_the_profile_directory_defaults_to_the_environment(
        tmp_path, monkeypatch, capsys):
    """As the JAX CLI (optflow_tpu/cli/main.py:89): OPTFLOW_TPU_PROFILE_DIR
    is --profile-dir's default, and the flag wins over it."""
    import json

    from optflow_tpu_torch.cli.main import main

    rng = np.random.default_rng(5)
    tex = make_fibsem_like(rng, 32, 56).astype(np.uint8)
    paths = []
    for z in range(2):
        paths.append(str(tmp_path / f"s{z}.png"))
        write_png(paths[-1], tex[:, z:z + 48], 0, 8)
    job = str(tmp_path / "job.json")
    with open(job, "w") as f:
        json.dump({"style": 1, "scale": 1.0, "output_type": "random_points",
                   "npoints": 5, "match_sink": "null", "features": False,
                   "rois": {"top": 16}, "nscales": 2, "warps": 1,
                   "iterations": 5,
                   "images": [{"p": paths[0], "q": paths[1], "pId": "a",
                               "qId": "b", "pGroupId": "0.0",
                               "qGroupId": "1.0"}]}, f)
    env_dir, flag_dir = tmp_path / "env", tmp_path / "flag"
    monkeypatch.setenv("OPTFLOW_TPU_PROFILE_DIR", str(env_dir))
    assert main([job, "--device", "cpu"]) == 0
    assert f"profiler trace written to {env_dir}" in capsys.readouterr().out
    assert (env_dir / "trace.json").exists()
    assert main([job, "--device", "cpu", "--profile-dir", str(flag_dir)]) == 0
    assert f"profiler trace written to {flag_dir}" in capsys.readouterr().out
    assert (flag_dir / "trace.json").exists()
    monkeypatch.delenv("OPTFLOW_TPU_PROFILE_DIR")
    assert main([job, "--device", "cpu"]) == 0
    assert "profiler trace" not in capsys.readouterr().out
