"""The port's native JPEG decoder (``lss_carla_torch/native``) and its
dataset front end (``data/decode.py::NativeDecoder``) on the CPU.

* The four decode functions and ``jpeg_dims`` against the JAX package's
  (``lss_carla_tpu.native``) on the same bytes, flips and out-of-bounds
  crops included: bit-equal (the same C++ at the same g++ flags; the port
  links the libjpeg Pillow bundles, the JAX build the system's, and both
  give the same pixels here).
* Against PIL, as ``tests/test_native_fastimage.py`` holds JAX's: the
  crop-only path to 1e-5 normalised (and exact in uint8, one libjpeg), the
  resize path within one level in 255.
* The build: keyed by source, flags, libjpeg and CPU; a failed build
  raises with g++'s output, and so does a decoder asked for it.
* ``NativeDecoder``: ``use_native=False`` gives PIL's pixels; a rotation,
  a file that is not a JPEG and a file of another size go to PIL, equal
  to PIL's, and every decode is counted in ``stats``; the SimBEV dataset
  decodes natively by default, its items equal the JAX dataset's native
  ones.

The library builds once per process (``load``), and once per checkout on
disk."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from lss_carla_tpu import native as J
from lss_carla_tpu.configs import DataAugConf as JAug
from lss_carla_tpu.configs import GridConf as JGrid
from lss_carla_tpu.data import simbev as JS

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data import decode as D
from lss_carla_torch.data import fixtures as F
from lss_carla_torch.data import simbev as S
from lss_carla_torch.data.augment import img_transform, sample_augmentation
from lss_carla_torch.native import fastimage as P
from lss_carla_torch.ops.image import normalize_img


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both libraries, built (or loaded from disk) once per worker."""
    P.load()
    assert J.fastimage_available()


def _jpeg(rng, W=480, H=224, quality=90):
    arr = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _pil(data, resize_dims=None, crop=None, flip=False):
    img = Image.open(io.BytesIO(data))
    if resize_dims is not None:
        img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img.convert("RGB"))


# (function, its arguments after the bytes): the crop-only pair, and the
# resize pair with flips and crops that overhang the resized image
CASES = [
    ("decode_crop_u8", ((64, 96, 416, 224),)),
    ("decode_crop_normalize", ((0, 0, 480, 224),)),
    ("decode_crop_u8", ((13, 5, 101, 77), (480, 224))),
    ("decode_resize_crop_u8", ((352, 164), (0, 36, 352, 164), False)),
    ("decode_resize_crop_u8", ((336, 157), (-8, -3, 344, 154), True)),
    ("decode_resize_crop_normalize", ((408, 190), (28, 62, 380, 190), True)),
    ("decode_resize_crop_normalize", ((336, 157), (400, 200, 500, 250), False)),
    ("decode_resize_crop_u8", ((480, 224), (64, 96, 416, 224), True)),
]


@pytest.mark.parametrize("fn,args", CASES)
def test_decode_equals_the_jax_decoder(fn, args):
    data = _jpeg(np.random.default_rng(70))
    got = getattr(P, fn)(data, *args)
    want = getattr(J, fn)(data, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_jpeg_dims_and_refusals():
    rng = np.random.default_rng(71)
    data = _jpeg(rng)
    assert P.jpeg_dims(data) == J.jpeg_dims(data) == (480, 224)
    with pytest.raises(ValueError, match="invalid JPEG"):
        P.jpeg_dims(b"not a jpeg")
    with pytest.raises(ValueError):
        P.decode_crop_normalize(b"not a jpeg at all", (0, 0, 8, 8))
    with pytest.raises(ValueError):
        P.decode_crop_u8(data, (0, 0, 481, 224))  # one pixel too wide
    for bad in [(10, 10, 10, 50), (10, 10, 50, 10)]:  # zero area
        with pytest.raises(ValueError):
            P.decode_crop_u8(data, bad)
        with pytest.raises(ValueError):
            P.decode_resize_crop_u8(data, (480, 224), bad)
    big = _jpeg(rng, W=960, H=448)  # not the configured size: rc 3
    with pytest.raises(ValueError, match="rc=3"):
        P.decode_crop_u8(big, (64, 96, 416, 224), expected_dims=(480, 224))
    # a truncated body decodes (libjpeg pads it), as PIL's loader would
    out = P.decode_resize_crop_u8(data[: len(data) // 3], (400, 200),
                                  (0, 0, 100, 50))
    assert out.shape == (3, 50, 100)


def test_crop_only_path_matches_pil():
    """Normalised to 1e-5 (tests/test_native_fastimage.py's limit), and
    in uint8 bit for bit: both run one libjpeg's IDCT."""
    rng = np.random.default_rng(72)
    for crop in [(64, 96, 416, 224), (0, 0, 352, 128), (128, 10, 480, 138)]:
        data = _jpeg(rng)
        want = _pil(data, crop=crop)
        np.testing.assert_allclose(P.decode_crop_normalize(data, crop),
                                   normalize_img(want).transpose(2, 0, 1),
                                   atol=1e-5)
        np.testing.assert_array_equal(P.decode_crop_u8(data, crop),
                                      want.transpose(2, 0, 1))


@pytest.mark.parametrize("flip", [False, True])
def test_resize_path_within_one_level_of_pil(flip):
    """PIL-convention bicubic to within one level in 255, flips and
    out-of-bounds crops (PIL zero-pads them) included; normalised within
    that level's image."""
    data = _jpeg(np.random.default_rng(73))
    for dims, crop in [((352, 164), (0, 36, 352, 164)),
                       ((336, 157), (-8, -3, 344, 154)),
                       ((336, 157), (-16, 29, 336, 157)),
                       ((408, 190), (400, 200, 500, 250))]:
        want = _pil(data, dims, crop, flip)
        got = P.decode_resize_crop_u8(data, dims, crop, flip)
        assert np.abs(got.astype(int) - want.transpose(2, 0, 1)).max() <= 1
        np.testing.assert_allclose(
            P.decode_resize_crop_normalize(data, dims, crop, flip),
            normalize_img(want).transpose(2, 0, 1), atol=1.01 / 255 / 0.224)


def test_library_is_keyed_by_source_flags_libjpeg_and_cpu(monkeypatch):
    path = P.library_path()
    assert path.parent == P.BUILD_DIR and path.exists()
    monkeypatch.setattr(P, "cpu_model", lambda: "another CPU")
    assert P.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(P, "GXX_FLAGS", P.GXX_FLAGS + ("-g",))
    assert P.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(P, "pillow_libjpeg",
                        lambda: P.BUILD_DIR / "another" / "libjpeg.so.62")
    assert P.library_path() != path


def test_a_pillow_without_libjpeg_raises(monkeypatch):
    """The decoder links only the libjpeg Pillow bundles: without one the
    build raises, naming it, and a decoder asked for raises too."""
    monkeypatch.setattr(P, "pillow_libjpeg", lambda: None)
    with pytest.raises(RuntimeError, match="bundles no libjpeg"):
        P.library_path()
    monkeypatch.setattr(P, "_lib", None)
    with pytest.raises(RuntimeError, match="bundles no libjpeg"):
        D.NativeDecoder((480, 224), device_normalize=True)


def test_a_failed_build_raises_with_gxx_output(monkeypatch, tmp_path):
    """No fallback hides the decoder: a source that does not compile
    raises RuntimeError with g++'s message, and so does a NativeDecoder
    that asks for it; use_native=False decodes with PIL and builds
    nothing."""
    broken = tmp_path / "fastimage.cpp"
    broken.write_text("int decode_crop_u8( { this is not C++\n")
    monkeypatch.setattr(P, "SOURCE", broken)
    monkeypatch.setattr(P, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(P, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ fastimage.cpp failed") as e:
        P.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))  # no partial library
    with pytest.raises(RuntimeError, match="failed"):
        D.NativeDecoder((480, 224), device_normalize=True)
    dec = D.NativeDecoder((480, 224), device_normalize=True, use_native=False)
    assert dec.stats == {}
    monkeypatch.setattr(P, "find_gxx", lambda: (_ for _ in ()).throw(
        RuntimeError("cannot build the native JPEG decoder: g++ not found")))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        P.load()


def _files(tmp_path, rng):
    """A 480 x 224 JPEG, the same pixels as a PNG, a 960 x 448 JPEG."""
    arr = rng.integers(0, 256, size=(224, 480, 3), dtype=np.uint8)
    paths = {}
    for name, img, fmt in (("a.jpg", Image.fromarray(arr), "JPEG"),
                           ("a.png", Image.fromarray(arr), "PNG"),
                           ("big.jpeg", Image.fromarray(arr).resize((960, 448)),
                            "JPEG")):
        paths[name] = tmp_path / name
        img.save(paths[name], format=fmt)
    return paths


def _pil_path(path, aug, device_normalize):
    resize, dims, crop, flip, rotate = aug
    img, _, _ = img_transform(Image.open(path), resize, dims, crop, flip, rotate)
    rgb = np.asarray(img.convert("RGB"))
    return (rgb if device_normalize else normalize_img(rgb)).transpose(2, 0, 1)


@pytest.mark.parametrize("device_normalize", [True, False])
def test_decoder_paths_and_counts(tmp_path, device_normalize):
    """Which path each decode takes, what it gives and how it is counted:
    crop-only and resize natively (the crop-only one exact against PIL in
    uint8 and within 1e-5 normalised, the resize one within a level); a rotation, a PNG and a JPEG of
    another size through PIL, equal to PIL; ``use_native=False`` all
    PIL."""
    paths = _files(tmp_path, np.random.default_rng(74))
    crop_aug = (1.0, (480, 224), (64, 96, 416, 224), False, 0.0)
    resize_aug = (0.75, (360, 168), (4, 40, 356, 168), True, 0.0)
    rotate_aug = (0.75, (360, 168), (4, 40, 356, 168), False, 3.5)
    dec = D.NativeDecoder((480, 224), device_normalize)
    # normalised, the C++ multiplies by 1 / std where numpy divides
    exact = 0 if device_normalize else 1e-5
    level = 1 if device_normalize else 1.01 / 255 / 0.224
    cases = [(paths["a.jpg"], crop_aug, exact),
             (paths["a.jpg"], resize_aug, level),
             (paths["a.jpg"], rotate_aug, 0), (paths["a.png"], resize_aug, 0),
             (paths["big.jpeg"], crop_aug, 0)]
    for path, aug, tol in cases:
        got = dec.decode(path, aug)
        want = _pil_path(path, aug, device_normalize)
        assert got.dtype == want.dtype and got.flags.c_contiguous
        np.testing.assert_allclose(got.astype(np.float64), want, atol=tol,
                                   rtol=0)
    assert dec.stats == {"native_crop": 1, "native_resize": 1,
                         "pil_rotate": 1, "pil_not_jpeg": 1,
                         "pil_size_mismatch": 1}
    off = D.NativeDecoder((480, 224), device_normalize, use_native=False)
    for path, aug, _ in cases:
        np.testing.assert_array_equal(off.decode(path, aug),
                                      _pil_path(path, aug, device_normalize))
    assert off.stats == {"pil_off": len(cases)}


@pytest.fixture(scope="module")
def simbev_root(tmp_path_factory):
    return F.generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                              samples_per_scene=2, H=64, W=128, grid=16, seed=9)


@pytest.mark.parametrize("is_train", [True, False])
def test_simbev_items_equal_the_jax_native_items(simbev_root, is_train,
                                                 monkeypatch):
    """The SimBEV dataset decodes natively by default; with the
    augmentation fixed on both sides (a resize, a crop and a flip in
    training), its items equal the JAX dataset's native ones bit for bit,
    geometry included, and all its decodes are native."""
    aug = dict(H=64, W=128, final_dim=(32, 64), resize_lim=(0.6, 0.8),
               rand_flip=True)
    tds = S.SegmentationData(simbev_root, is_train, DataAugConf(**aug),
                             GridConf(), device_normalize=True, seed=3)
    assert tds.decoder.use_native and D.USE_NATIVE
    jds = JS.SegmentationData(simbev_root, is_train, JAug(**aug), JGrid(),
                              use_native=True, device_normalize=True)
    assert jds._native
    for index in range(len(tds)):
        cams, draw, _ = tds.draw()
        monkeypatch.setattr(JS, "sample_augmentation", lambda *a: draw)
        got = (*tds.get_image_data(tds.samples[index], cams, draw),
               tds.get_binimg(tds.samples[index]))
        want = (*jds.get_image_data(jds.samples[index], cams),
                jds.get_binimg(jds.samples[index]))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert set(tds.decoder.stats) == {"native_resize"}
    assert sum(tds.decoder.stats.values()) == 6 * len(tds)


def test_train_aug_draws_the_resize_path():
    """bench.py's default augmentation takes the crop-only kernel, the fast
    recipe's resize_lim the resize kernel (the two configs phase 20 of
    chip_smoke.py times)."""
    g = torch.Generator().manual_seed(0)
    r, dims, _, flip, rot = sample_augmentation(DataAugConf(), True, g)
    assert (r, dims, flip, rot) == (1.0, (480, 224), False, 0.0)
    r, dims, _, flip, _ = sample_augmentation(
        DataAugConf(resize_lim=(0.70, 0.85)), True, g)
    assert 0.70 <= r <= 0.85 and dims != (480, 224) and not flip
