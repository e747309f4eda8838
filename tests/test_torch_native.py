"""The port's C++ resampler (ops/native.py, native/resample.cpp), its host
build (ops/_host_build.py) and the host geometry of ops/geometry.py on it,
held against the JAX package.

- `resize_linear`, `resize_nearest` and `resize_batch_linear` against
  JAX's ops/native.py on the same inputs: the same source and compiler
  flags, so within 1e-6 (bit for bit where the compilers agree); and
  against the port's numpy path within 5e-6 (JAX geometry.py:198-199).
- `_check_crop` refuses a bad crop before it reaches C++.
- The build: nothing compiles at import; the library lands in
  build/torch_native/ under a host-keyed name; concurrent loaders build
  once; a missing header makes the library unavailable, a compiler
  error raises with the compiler's output.
- The host forward and inverse (`resize_with_padding_np`,
  `invert_resize_padding_np`) on the resampler against JAX's, at
  degenerate 400×1, 1×37 and exact-target sizes: metas equal, values
  within 1e-6, label maps equal.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from image_segmentation_tpu.ops import geometry as JG
from image_segmentation_tpu.ops import native as JN
from image_segmentation_tpu_torch.ops import _host_build as HB
from image_segmentation_tpu_torch.ops import geometry as PG
from image_segmentation_tpu_torch.ops import native as PN

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def both_built():
    if not PN.available() or not JN.available():
        pytest.skip("no g++ on this host: neither resampler builds")


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, c)).astype(np.float32)


@pytest.mark.parametrize("hw,out,aa", [((375, 500), (168, 224), True),
                                       ((375, 500), (168, 224), False),
                                       ((17, 29), (64, 40), True),
                                       ((400, 1), (224, 1), True),
                                       ((224, 224), (224, 224), True)])
def test_linear_against_jax_and_numpy(hw, out, aa):
    img = _img(*hw)
    got = PN.resize_linear(img, out, antialias=aa)
    np.testing.assert_allclose(got, JN.resize_linear(img, out, antialias=aa), atol=1e-6)
    np.testing.assert_allclose(got, PG.resize_linear_np(img, out, antialias=aa,
                                                        dtype=np.float32), atol=5e-6)
    assert got.dtype == np.float32 and got.shape == out + (3,)


@pytest.mark.parametrize("exact", [True, False])
def test_nearest_and_crops_against_jax(exact):
    img = _img(60, 45, 4, seed=1)
    crop = (7, 3, 40, 31)
    for c in (None, crop):
        got = PN.resize_nearest(img, (97, 13), exact=exact, crop=c)
        np.testing.assert_array_equal(got, JN.resize_nearest(img, (97, 13), exact=exact,
                                                             crop=c))
    y0, x0, ch, cw = crop
    np.testing.assert_array_equal(
        PN.resize_nearest(img, (97, 13), exact=exact, crop=crop),
        PG.resize_nearest_np(img[y0:y0 + ch, x0:x0 + cw], (97, 13), exact=exact))
    got = PN.resize_linear(img, (80, 80), crop=crop)
    np.testing.assert_allclose(got, JN.resize_linear(img, (80, 80), crop=crop), atol=1e-6)
    np.testing.assert_allclose(got, PG.resize_linear_np(img[y0:y0 + ch, x0:x0 + cw], (80, 80),
                                                        dtype=np.float32), atol=5e-6)


def test_batch_against_jax_and_single():
    imgs = np.stack([_img(50, 70, seed=s) for s in range(5)])
    got = PN.resize_batch_linear(imgs, (33, 41), antialias=True)
    np.testing.assert_allclose(got, JN.resize_batch_linear(imgs, (33, 41), antialias=True),
                               atol=1e-6)
    for i in range(5):
        np.testing.assert_array_equal(got[i], PN.resize_linear(imgs[i], (33, 41),
                                                               antialias=True))


@pytest.mark.parametrize("crop", [(-1, 0, 5, 5), (0, -1, 5, 5), (0, 0, 0, 5), (0, 0, 5, 0),
                                  (6, 0, 5, 5), (0, 8, 5, 5), (0, 0, 11, 12)])
def test_check_crop_refuses_before_cpp(crop):
    img = _img(10, 12)
    for fn in (PN.resize_linear, PN.resize_nearest):
        with pytest.raises(ValueError, match="outside image"):
            fn(img, (4, 4), crop=crop)
    with pytest.raises(ValueError, match="outside image"):
        JN.resize_linear(img, (4, 4), crop=crop)


def test_host_geometry_takes_the_resampler():
    img = _img(375, 500)
    out, meta = PG.resize_with_padding_np(img, 256)
    nh, nw = meta["new_size"]
    pl, pt, _, _ = meta["pad"]
    np.testing.assert_array_equal(out[pt:pt + nh, pl:pl + nw],
                                  PN.resize_linear(img, (nh, nw), antialias=True))
    scores = _img(256, 256, 4, seed=3)
    np.testing.assert_array_equal(
        PG.invert_resize_padding_np(scores, meta),
        PN.resize_linear(scores, (375, 500), crop=(pt, pl, nh, nw)))


def test_nothing_builds_at_import_and_the_library_is_host_keyed():
    code = ("from image_segmentation_tpu_torch.ops import native, native_codec\n"
            "from image_segmentation_tpu_torch.data import native_pipeline, loader\n"
            "from image_segmentation_tpu_torch.ops import geometry\n"
            "for lib in (native.LIBRARY, native_codec.LIBRARY):\n"
            "    assert lib._lib is None and lib._error is None\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
    path = PN.LIBRARY.path
    assert os.path.dirname(path) == os.path.join(REPO, "build", "torch_native")
    assert os.path.basename(path) == f"libistpu_resample-{HB.host_key()}.so"
    assert os.path.isfile(path)


def test_concurrent_loaders_build_once(tmp_path, monkeypatch):
    """Eight loaders (each its own library object, so only the directory's
    fcntl lock orders them) at once: one compile, every load works."""
    monkeypatch.setattr(HB, "BUILD_DIR", str(tmp_path))
    compiles, errors = [], []
    libs = [HB.HostLibrary("resample", ["resample.cpp"], PN._declare) for _ in range(8)]
    for lib in libs:
        real = lib._compile
        lib._compile = lambda real=real: compiles.append(1) or real()

    def load(lib):
        try:
            lib.load()
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=load, args=(lib,)) for lib in libs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(compiles) == 1
    assert sorted(os.listdir(tmp_path)) == [".lock", os.path.basename(libs[0].path)]
    img = _img(20, 30)
    out = np.empty((10, 15, 3), np.float32)
    libs[3].load().resample_linear(PN._fp(img), 20, 30, 3, 0, 0, 20, 30, PN._fp(out), 10, 15, 1)
    np.testing.assert_array_equal(out, PN.resize_linear(img, (10, 15), antialias=True))


def test_missing_header_is_unavailable_and_a_compile_error_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(HB, "BUILD_DIR", str(tmp_path))
    lib = HB.HostLibrary("x", ["resample.cpp"], PN._declare,
                         headers=("no_such_header_for_istpu.h",))
    assert not lib.available()
    assert "no_such_header_for_istpu.h" in lib.unavailable_reason()
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    lib = HB.HostLibrary("bad", [str(bad)], lambda l: None)
    with pytest.raises(HB.HostBuildError, match="g\\+\\+ failed") as e:
        lib.available()
    assert "bad.cpp" in str(e.value)
    with pytest.raises(HB.HostBuildError):  # again, without a second compile
        lib.load()
    assert sorted(os.listdir(tmp_path)) == [".lock", "bad.cpp"]


@pytest.mark.parametrize("h,w,t", [(375, 500, 256), (400, 1, 224), (1, 37, 32), (224, 224, 224),
                                   (3, 192, 32), (333, 512, 224), (7, 5, 256)])
def test_host_forward_and_inverse_against_jax(h, w, t):
    """Both packages' host geometry on their resamplers, at degenerate,
    exact-target and upscaling sizes: the same metas, images within 1e-6,
    label maps and their inverses equal."""
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    lab = rng.integers(0, 4, (h, w, 1)).astype(np.float32)
    for x, method, exact in ((img, "linear", False), (lab, "nearest", True)):
        got, gmeta = PG.resize_with_padding_np(x, t, method)
        want, wmeta = JG.resize_with_padding_np(x, t, method)
        assert gmeta == wmeta and got.shape == (t, t, x.shape[2])
        np.testing.assert_allclose(got, want, atol=1e-6)
        back = PG.invert_resize_padding_np(got, gmeta, method)
        assert back.shape == x.shape
        np.testing.assert_allclose(back, JG.invert_resize_padding_np(want, wmeta, method),
                                   atol=1e-6)
        if exact:
            np.testing.assert_array_equal(got, want)
