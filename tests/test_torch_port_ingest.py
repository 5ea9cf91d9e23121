"""The port's host ingest against the JAX package's: the native C++ decoder
(bitwise, with and without scaled DCT decode), its routing, the
torchvision-exact host ten-crop and the image folder that yields it. Host
work, so every comparison is bit for bit."""

import contextlib
import importlib
import io
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from geoestimation_tpu.data import image_folder as jax_folder
from geoestimation_tpu.ingest import decode as jax_decode
from geoestimation_tpu_torch.data import image_folder as port_folder
from geoestimation_tpu_torch.ingest import decode as port_decode

port_native = importlib.import_module("geoestimation_tpu_torch.ingest.native")

JAX_CPP_DIR = os.path.join(os.path.dirname(__file__), "..",
                           "geoestimation_tpu", "ingest", "cpp")


def build_jax_native(directory):
    """The JAX package's native decoder, built by its own Makefile (as
    tests/test_native_ingest.py builds it) in a copy of its directory, so
    that no other test's build of the same file is raced. Returns the
    library's path."""
    for name in ("Makefile", "ingest.cpp"):
        shutil.copy(os.path.join(JAX_CPP_DIR, name), directory)
    build = subprocess.run(["make", "-C", str(directory), "libgeoingest.so"],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-2000:]
    return os.path.join(directory, "libgeoingest.so")


@contextlib.contextmanager
def jax_native_from(so_path):
    """The JAX package's `ingest.native` loading `so_path`, for the span of
    the block."""
    native = importlib.import_module("geoestimation_tpu.ingest.native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_SO_PATH", so_path)
        mp.setattr(native, "_TRIED", False)
        mp.setattr(native, "_LIB", None)
        assert native.available()
        yield native


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    with jax_native_from(build_jax_native(
            tmp_path_factory.mktemp("jax_ingest"))) as native:
        yield native


@pytest.fixture(scope="module")
def port_native_lib():
    assert port_native.available(), port_native.build_error()
    return port_native


def jpeg(seed, w, h, quality=90):
    rng = np.random.default_rng(seed)
    b = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        b, format="JPEG", quality=quality)
    return b.getvalue()


def smooth_jpeg(w, h):
    """Photo-like content, large enough that the scaled decode picks a DCT
    scale below 8/8."""
    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack([127 + 120 * np.sin(x / 120) * np.cos(y / 170),
                    127 + 120 * np.cos(x / 90 + 1) * np.sin(y / 210),
                    (x + y) % 256], -1).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="JPEG", quality=92)
    return b.getvalue()


def png(seed, w, h):
    b = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (h, w, 3), dtype=np.uint8)).save(b, format="PNG")
    return b.getvalue()


MIXED = [jpeg(0, 463, 317), jpeg(1, 317, 463), jpeg(2, 256, 256),
         jpeg(3, 100, 80), jpeg(4, 640, 300), smooth_jpeg(1400, 1000),
         smooth_jpeg(999, 1333), jpeg(5, 281, 1024, quality=75)]


@pytest.mark.parametrize("fast_scale", [False, True])
def test_native_decode_bitwise_equals_jax(jax_native, port_native_lib,
                                          fast_scale):
    ref, ref_ok = jax_native.decode_batch(MIXED, 256, 256,
                                          fast_scale=fast_scale)
    got, got_ok = port_native_lib.decode_batch(MIXED, 256, 256,
                                               fast_scale=fast_scale)
    assert ref_ok.all() and got_ok.all()
    np.testing.assert_array_equal(got, ref)
    # and the same through both packages' decode_batch on the native backend
    ref, _ = jax_decode.decode_batch(MIXED, backend="turbo",
                                     fast_scale=fast_scale)
    got, _ = port_decode.decode_batch(MIXED, backend="turbo",
                                      fast_scale=fast_scale)
    np.testing.assert_array_equal(got, ref)


def test_rotten_blobs_flagged_as_jax(jax_native, port_native_lib):
    blobs = [jpeg(0, 300, 200), b"", b"not a jpeg", jpeg(1, 64, 64)[:100]]
    ref, ref_ok = jax_decode.decode_batch(blobs, backend="turbo")
    got, got_ok = port_decode.decode_batch(blobs, backend="turbo")
    np.testing.assert_array_equal(got_ok, [True, False, False, False])
    np.testing.assert_array_equal(got_ok, ref_ok)
    np.testing.assert_array_equal(got, ref)
    assert not got[1:].any()


def test_png_is_routed_to_pil(jax_native, port_native_lib):
    blobs = [jpeg(7, 300, 260), png(8, 320, 240), jpeg(9, 260, 300)]
    got, got_ok = port_decode.decode_batch(blobs, backend="turbo")
    ref, ref_ok = jax_decode.decode_batch(blobs, backend="turbo")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_ok, ref_ok)
    assert got_ok.all()
    pil, _ = port_decode.decode_batch(blobs[1:2], backend="pil")
    np.testing.assert_array_equal(got[1], pil[0])
    native, _ = port_native_lib.decode_batch(blobs[::2])
    np.testing.assert_array_equal(got[::2], native)


def test_auto_backend_is_native_where_it_builds(jax_native, port_native_lib,
                                                monkeypatch):
    assert port_decode.auto_backend() == "turbo"
    assert port_native.build_error() is None
    blobs = MIXED[:3]
    auto, _ = port_decode.decode_batch(blobs)
    np.testing.assert_array_equal(
        auto, port_decode.decode_batch(blobs, backend="turbo")[0])
    monkeypatch.setattr(port_native, "available", lambda: False)
    assert port_decode.auto_backend() == "pil"
    np.testing.assert_array_equal(
        port_decode.decode_batch(blobs)[0],
        port_decode.decode_batch(blobs, backend="pil")[0])
    with pytest.raises(ValueError, match="unknown decode backend"):
        port_decode.decode_batch(blobs, backend="nvjpeg")


def test_turbo_raises_with_the_compilers_message(monkeypatch, tmp_path):
    """Where the library cannot be built, `auto` goes to PIL and `turbo`
    raises with what the compiler said."""
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_native, "LDFLAGS",
                        port_native.LDFLAGS + ("-lno_such_jpeg_library",))
    monkeypatch.setattr(port_native, "_TRIED", False)
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_ERROR", None)
    assert not port_native.available()
    assert "no_such_jpeg_library" in port_native.build_error()
    assert port_decode.auto_backend() == "pil"
    with pytest.raises(RuntimeError, match="no_such_jpeg_library"):
        port_decode.decode_batch([jpeg(0, 300, 200)], backend="turbo")
    out, ok = port_decode.decode_batch([jpeg(0, 300, 200)])
    assert ok.all() and out.any()
    assert not list(tmp_path.glob("*.so"))


def test_library_path_keys_source_and_flags(monkeypatch):
    path = port_native.library_path()
    assert path.parent == port_native.BUILD_DIR
    assert path == port_native.library_path()
    monkeypatch.setattr(port_native, "CXXFLAGS",
                        ("-O2",) + port_native.CXXFLAGS[1:])
    assert port_native.library_path() != path


@pytest.mark.parametrize("w, h", [(400, 300), (300, 400), (320, 320)],
                         ids=["landscape", "portrait", "square"])
def test_decode_batch_tencrop_bitwise_equals_jax(w, h):
    blobs = [jpeg(10 + i, w + 3 * i, h + 5 * i) for i in range(3)] + [
        b"junk"]
    ref, ref_ok = jax_decode.decode_batch_tencrop(blobs, crop=224)
    got, got_ok = port_decode.decode_batch_tencrop(blobs, crop=224)
    assert got.shape == (4, 10, 224, 224, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_ok, ref_ok)
    assert got_ok.tolist() == [True, True, True, False]
    # the last five crops are the first five, flipped left to right
    np.testing.assert_array_equal(got[:3, 5:], got[:3, :5, :, ::-1])


def test_iter_image_folder_tencrop_host_equals_jax(tmp_path):
    for i in range(5):
        (tmp_path / f"img_{i}.jpg").write_bytes(jpeg(20 + i, 90 + 7 * i,
                                                     70 + 11 * i))
    (tmp_path / "img_5.png").write_bytes(png(30, 80, 120))
    (tmp_path / "img_6.jpg").write_bytes(b"rotten")
    kw = dict(batch_size=4, tencrop_host=True, resize_to=64, crop=48)
    ref = list(jax_folder.iter_image_folder(str(tmp_path), **kw))
    got = list(port_folder.iter_image_folder(str(tmp_path), **kw))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.ids == r.ids
        assert g.images.shape == (4, 10, 48, 48, 3)
        np.testing.assert_array_equal(g.images, r.images)
        np.testing.assert_array_equal(g.valid, r.valid)
    assert [bool(v) for b in got for v in b.valid] == [True] * 6 + [False] * 2
