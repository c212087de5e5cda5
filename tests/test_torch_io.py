"""The port's own host I/O against what the JAX package uses: its image codec
against OpenCV, its YAML reader against PyYAML, its catalog CSV, id check
and score reports against the JAX package's (pandas-based) ones."""

import io
import json
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
import yaml

from multimodal_biometric_fingerprints_palms_tpu.catalog import (
    catalog as jcat, verify as jverify)
from multimodal_biometric_fingerprints_palms_tpu.evaluation import (
    metrics as jmetrics)
from multimodal_biometric_fingerprints_palms_tpu_torch.catalog import (
    catalog as tcat, verify as tverify)
from multimodal_biometric_fingerprints_palms_tpu_torch.config import loader
from multimodal_biometric_fingerprints_palms_tpu_torch.evaluation import (
    metrics as tmetrics)
from multimodal_biometric_fingerprints_palms_tpu_torch.features.runner import (
    _overlay)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
    image_codec as C, io as tio, native_loader)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints, spiral_mask)

torch.set_num_threads(1)

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _print(h=240, w=320, seed=3):
    return np.round(blob_prints([seed], None, h, w)[0] * 255).astype(np.uint8)


def _random(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w), dtype=np.uint8)


def _image(h, w):
    """A blob print where the frame holds one, else noise."""
    return _print(h, w) if h >= 100 and w >= 100 else _random(h, w)


# --- JPEG decode -------------------------------------------------------------

JPEG_KINDS = {
    "grey": [],
    "colour 4:2:0": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
    "colour 4:4:4": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "grey, restart interval 3": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "colour 4:2:0, restart interval 2": [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
}


@pytest.mark.parametrize("size", [(1, 1), (5, 37), (240, 320)])
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("kind", sorted(JPEG_KINDS))
def test_jpeg_decode_equals_opencv(kind, quality, size):
    """cv2-written baseline JPEGs decode bit for bit to
    ``cv2.imread(..., IMREAD_GRAYSCALE)``: libjpeg's integer IDCT, the luma
    plane of a colour file."""
    grey = _image(*size)
    img = (np.stack([grey, np.roll(grey, 5, axis=1), 255 - grey], -1)
           if kind.startswith("colour") else grey)
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality]
                        + JPEG_KINDS[kind])[1].tobytes()
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    got = C.decode_gray(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- JPEG encode -------------------------------------------------------------

def _cv2_gray(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


@pytest.mark.parametrize("size", [(1, 1), (5, 37), (320, 240)])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("channels", [1, 3])
def test_jpeg_encode_is_byte_equal_to_opencv(channels, quality, size):
    """The port's JPEG files are OpenCV's, byte for byte: libjpeg's integer
    forward DCT, quantization and colour conversion, the standard tables
    (colour at 4:4:4, which the port writes); so OpenCV and the port decode
    them alike."""
    grey = _image(*size)
    img = grey if channels == 1 else np.stack(
        [grey, np.roll(grey, 3, axis=0), 255 - grey], -1)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if channels == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    data = C.encode_jpeg(img, quality)
    assert data == cv2.imencode(".jpg", img, params)[1].tobytes()
    np.testing.assert_array_equal(C.decode_gray(data), _cv2_gray(data))


def _main_path_skeleton():
    """One blob print's skeleton through the port's enhance chain (CPU)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint)
    x = torch.from_numpy(blob_prints([7], None, 320, 256))
    return preprocess_fingerprint(x).skeleton[0].numpy()[:, :240]


SKELETONS = {
    "main path": _main_path_skeleton,
    "spiral": lambda: spiral_mask(240, 320),
    "diagonals": lambda: (np.add.outer(np.arange(240), np.arange(320)) % 9 == 0)
    | (np.subtract.outer(np.arange(240), np.arange(320)) % 13 == 0),
}


@pytest.mark.parametrize("name", sorted(SKELETONS))
def test_skeletons_survive_jpeg_and_threshold(name):
    """One-pixel skeletons written as JPEG (quality 95) and read back through
    ``> 127`` are the same skeletons, through the port's decoder and
    OpenCV's."""
    sk = SKELETONS[name]().astype(bool)
    assert sk.sum() > 500
    data = C.encode_jpeg(sk.astype(np.uint8) * 255)
    np.testing.assert_array_equal(C.decode_gray(data) > 127, sk)
    np.testing.assert_array_equal(_cv2_gray(data) > 127, sk)


def test_overlay_channel_order_equals_opencv():
    """The minutiae overlay is written in OpenCV's BGR order: what OpenCV
    reads back from the port's file is what it reads back from its own."""
    sk = spiral_mask(240, 320)
    records = [{"x": 60, "y": 60, "type": "ending"},
               {"x": 150, "y": 120, "type": "bifurcation"}]
    vis = _overlay(sk, records)
    ours = cv2.imdecode(np.frombuffer(C.encode_jpeg(vis), np.uint8),
                        cv2.IMREAD_COLOR)
    theirs = cv2.imdecode(cv2.imencode(".jpg", vis)[1], cv2.IMREAD_COLOR)
    for r in records:
        y, x = r["y"], r["x"]
        assert np.argmax(ours[y, x]) == np.argmax(theirs[y, x]) == (
            0 if r["type"] == "ending" else 1)
    assert np.abs(ours.astype(int) - theirs).mean() < 3.0


# --- PNG and BMP -------------------------------------------------------------

def _refilter(img: np.ndarray, ftype: int) -> bytes:
    """A PNG of a grey or RGB array with every row under filter ``ftype``
    (PNG spec, 9.2), written here independently of the codec."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.r_[np.zeros(bpp, np.int64), cur[:-bpp]]
        ul = np.r_[np.zeros(bpp, np.int64), up[:-bpp]]
        if ftype == 3:
            pred = (left + up) // 2
        elif ftype == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [0, left, up][ftype]
        out.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    ctype = 0 if img.ndim == 2 else 2
    w = img.shape[1]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


def _pil_png(img, mode):
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, "PNG")
    return bio.getvalue()


def _colour(h=40, w=53):
    g = np.random.default_rng(4)
    img = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[: h // 2, : w // 3] = img[: h // 2, : w // 3, :1]   # grey pixels
    return img


PNG_FILES = {
    **{f"grey, filter {f}": (lambda f=f: _refilter(_random(33, 47), f))
       for f in range(5)},
    **{f"RGB, filter {f}": (lambda f=f: _refilter(_colour()[..., ::-1], f))
       for f in range(5)},
    "cv2 grey": lambda: cv2.imencode(".png", _random(40, 53))[1].tobytes(),
    "cv2 colour": lambda: cv2.imencode(".png", _colour())[1].tobytes(),
    "cv2 BGRA": lambda: cv2.imencode(".png", np.concatenate(
        [_colour(), _random(40, 53)[..., None]], -1))[1].tobytes(),
    "PIL RGB": lambda: _pil_png(_colour(64, 80), "RGB"),
    "PIL grey + alpha": lambda: _pil_png(_colour(64, 80)[..., :2], "LA"),
}


@pytest.mark.parametrize("name", sorted(PNG_FILES))
def test_png_decode_equals_opencv(name):
    """8-bit grey, grey + alpha, RGB and RGBA PNGs under every filter read
    to OpenCV's ``IMREAD_GRAYSCALE`` (libpng's truncating weights)."""
    data = PNG_FILES[name]()
    np.testing.assert_array_equal(C.decode_gray(data), _cv2_gray(data))


BMP_FILES = {
    "cv2 8-bit grey": lambda: cv2.imencode(".bmp", _random(31, 45))[1].tobytes(),
    "cv2 24-bit": lambda: cv2.imencode(".bmp", _colour(31, 45))[1].tobytes(),
    "cv2 8-bit 1x1": lambda: cv2.imencode(".bmp", _random(1, 1))[1].tobytes(),
}


@pytest.mark.parametrize("name", sorted(BMP_FILES))
def test_bmp_decode_equals_opencv(name):
    data = BMP_FILES[name]()
    np.testing.assert_array_equal(C.decode_gray(data), _cv2_gray(data))


@pytest.mark.parametrize("size", [(1, 1), (5, 37), (240, 320)])
@pytest.mark.parametrize("fmt", ["png grey", "png colour", "bmp grey"])
def test_png_and_bmp_round_trips_are_exact(fmt, size):
    """The port's PNG and BMP files read back exactly, by the port and by
    OpenCV (``IMREAD_UNCHANGED``: the colour PNG in BGR order)."""
    grey = _random(*size, seed=sum(size))
    img = grey if "grey" in fmt else np.stack(
        [grey, grey[::-1], 255 - grey], -1)
    data = (C.encode_png if fmt.startswith("png") else C.encode_bmp)(img)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, img)
    if img.ndim == 2:
        np.testing.assert_array_equal(C.decode_gray(data), img)


# --- refusals ----------------------------------------------------------------

DECODED = {
    "progressive JPEG": (".jpg", lambda: cv2.imencode(
        ".jpg", _print(), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()),
    "TIFF": (".tif", lambda: cv2.imencode(".tiff", _print())[1].tobytes()),
    "16 bits": (".png", lambda: cv2.imencode(
        ".png", _random(8, 8).astype(np.uint16) * 257)[1].tobytes()),
}


@pytest.mark.parametrize("what", sorted(DECODED))
def test_formats_once_refused_now_decode_like_opencv(what, tmp_path):
    """Progressive JPEG, TIFF and 16-bit PNG, which the codec refused
    before, read as OpenCV reads them (``tests/test_torch_formats.py``
    holds every variant)."""
    suffix, make = DECODED[what]
    path = tmp_path / f"S0001_1{suffix}"
    path.write_bytes(make())
    np.testing.assert_array_equal(tio.read_image_grayscale(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def _arithmetic_jpeg() -> bytes:
    data = bytearray(cv2.imencode(".jpg", _random(16, 16))[1].tobytes())
    i = data.find(b"\xff\xc0")
    data[i + 1] = 0xC9                 # SOF9: arithmetic-coded sequential
    return bytes(data)


REFUSED = {
    "unknown image format": (".jpg", lambda: b"GIF89a" + bytes(32)),
    "arithmetic-coded JPEG": (".jpg", _arithmetic_jpeg),
    "TIFF without a valid first directory": (
        ".tif", lambda: b"II*\x00" + bytes(64)),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_unsupported_files_raise_naming_file_and_format(what, tmp_path):
    suffix, make = REFUSED[what]
    path = tmp_path / f"S0001_1{suffix}"
    path.write_bytes(make())
    with pytest.raises(C.ImageFormatError) as e:
        tio.read_image_grayscale(path)
    assert str(path) in str(e.value)
    assert what.lower() in str(e.value).lower()


def test_write_image_keeps_the_float_rule(tmp_path):
    """A float image in [0, 1] is scaled by 255 and truncated, as the JAX
    package's ``write_image`` does; the suffix picks the format."""
    x = np.linspace(0.0, 1.0, 48 * 64, dtype=np.float32).reshape(48, 64)
    tio.write_image(tmp_path / "a" / "f.png", x)
    want = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(
        tio.read_image_grayscale(tmp_path / "a" / "f.png"), want)
    with pytest.raises(C.ImageFormatError):
        tio.write_image(tmp_path / "f.gif", want)


# --- the native loader ---------------------------------------------------------

@pytest.mark.parametrize("ext", [".jpg", ".bmp"])
def test_native_loader_equals_image_codec(ext, tmp_path):
    """Where the repository's native loader builds (it needs libjpeg), its
    pixels equal the codec's."""
    if not native_loader.native_available():
        pytest.skip("native loader unavailable: no libjpeg or g++ here")
    imgs = [_print(240, 320, seed=s) for s in range(3)] + [_random(37, 5)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(tmp_path / f"{i}{ext}")
        cv2.imwrite(str(paths[-1]), img)
    batch, status, ws, hs = native_loader.batch_load_u8(paths, 256, 320)
    assert (status == 0).all()
    for j, p in enumerate(paths):
        np.testing.assert_array_equal(batch[j, :hs[j], :ws[j]],
                                      tio.read_image_grayscale(p))


# --- YAML --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["config_classifier.yml",
                                  "config_fingerprint.yml",
                                  "config_matching.yml",
                                  "config_segmentation.yml"])
def test_yaml_reader_equals_safe_load_on_the_configs(name):
    text = (ROOT / "configs" / name).read_text()
    assert loader.parse_yaml_subset(text, name) == yaml.safe_load(text)


SCALARS = ["1", "-7", "+3", "0", "1_000", "0.5", "1.0e-5", "-2.5E+3", ".5",
           "1e5", "1.", "true", "False", "yes", "Off", "~", "null", "",
           ".inf", "-.Inf", "effnetv2_s", "./dataset", "logs/roc.png",
           "'quoted: # not a comment'", "'it''s'", '"double"',
           "[64, 128, 1.5, a, 'b c', true]", "[]", "value  # comment"]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_resolve_as_safe_load(text):
    doc = f"a:\n  key: {text}\n"
    assert loader.parse_yaml_subset(doc) == yaml.safe_load(doc)


UNSUPPORTED = ["a:\n  - 1\n  - 2\n", "a: {b: 1}\n", "a: |\n  text\n",
               "a: &x 1\nb: *x\n", "a: !!str 1\n", "---\na: 1\n",
               "a: 1\na: 2\n", "a: 0x1F\n", "a: 012\n", "a: 2001-12-14\n",
               "a: 1:30\n", "a:\n\tb: 1\n", "a: [1, [2]]\n", "a: \"x\\ty\"\n",
               "a: 1\n  b: 2\n", "1: a\n"]


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_yaml_reader_refuses_what_it_does_not_parse(text):
    with pytest.raises(loader.YamlSubsetError):
        loader.parse_yaml_subset(text)


def test_configs_load_with_live_nested_keys():
    cfg = loader.load_matching_config()
    assert cfg.get("ransac.max_iterations") == 300
    assert cfg.evaluation.frr.max_distance == 30.0
    assert loader.load_fingerprint_config().get(
        "preprocessing.gabor.enabled") is False
    assert loader.load_classifier_config().paths.dataset_dir.endswith("dataset")
    assert loader.load_segmentation_config().get("model.filters")[-1] == 1024


# --- catalog, id check, reports ----------------------------------------------

def test_catalog_csv_is_byte_equal_to_the_jax_package(tmp_path, monkeypatch):
    """PolyU, NIST and S-named files in two clusters (plus an unrecognized
    name and an unreadable file, both skipped): the same CSV bytes."""
    monkeypatch.chdir(tmp_path)
    base = tmp_path / "sorted"
    files = {"cluster_1/12_3_2.jpg": (24, 30), "cluster_1/12_3_1.jpg": (24, 30),
             "cluster_1/3_1_1.png": (20, 16), "cluster_0/F0009_2.bmp": (17, 21),
             "cluster_0/F0009_1.bmp": (17, 21), "cluster_0/S0002_1.jpg": (9, 9),
             "cluster_0/10_1_1.JPG": (12, 8), "cluster_0/notes_1.jpg": (8, 8),
             "cluster_10/2_2_2.jpg": (8, 8)}
    for rel, size in files.items():
        (base / rel).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(base / rel), _random(*size))
    (base / "cluster_0" / "7_1_1.jpg").write_bytes(b"\xff\xd8 broken")
    jcat.save_catalog(jcat.scan_dataset(base), tmp_path / "jax.csv")
    records = tcat.scan_dataset(base)
    tcat.save_catalog(records, tmp_path / "port.csv")
    assert len(records) == 8
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "jax.csv").read_bytes()


ID_CSVS = {
    "consistent": "filename,global_id\n1_1_1.jpg,0\n1_2_1.jpg,0\n2_1_1.jpg,3\n",
    "violations": ("filename,global_id\n1_1_1.jpg,0\n1_2_1.jpg,2\n"
                   "1_3_1.jpg,0\n10_1_1.jpg,5\n10_1_2.jpg,4\n2_1_1.jpg,1\n"),
    "string ids": "filename,global_id\n1_1_1.jpg,a\n1_2_1.jpg,b\n",
}


@pytest.mark.parametrize("case", sorted(ID_CSVS))
def test_check_id_consistency_equals_the_jax_package(case, tmp_path):
    path = tmp_path / "id_clusters.csv"
    path.write_text(ID_CSVS[case])
    assert tverify.check_id_consistency(path) == jverify.check_id_consistency(path)


def test_score_reports_equal_the_jax_package(tmp_path, capsys):
    g = np.random.default_rng(8)
    scores = g.random(37)
    assert tmetrics.report_scores("S", scores) == jmetrics.report_scores(
        "S", scores)
    assert tmetrics.report_scores("E", []) == jmetrics.report_scores("E", [])
    out = capsys.readouterr().out.split("\n=== E ===")[0]
    assert out.count("=== S ===") == 2
    ds = {"1": [g.random((5, 7)) * 100, np.zeros((0, 7))],
          "2": [g.random((9, 7)) * 100]}
    tmetrics.compute_minutiae_statistics(ds, tmp_path / "t" / "stats.csv")
    jmetrics.compute_minutiae_statistics(ds, tmp_path / "j" / "stats.csv")
    assert (tmp_path / "t" / "stats.csv").read_bytes() == (
        tmp_path / "j" / "stats.csv").read_bytes()


def test_roc_png_is_a_readable_raster(tmp_path):
    from multimodal_biometric_fingerprints_palms_tpu_torch.evaluation import (
        plot_roc)
    thr = np.linspace(0, 1, 50)
    out = plot_roc(1 - thr ** 0.5, thr ** 2, tmp_path / "logs" / "roc.png")
    img = cv2.imread(str(out), cv2.IMREAD_COLOR)
    assert img.shape == (480, 480, 3)
    assert (img != 255).any(axis=-1).sum() > 1000   # frame, grid, curve
    np.testing.assert_array_equal(tio.read_image_grayscale(out),
                                  cv2.imread(str(out), cv2.IMREAD_GRAYSCALE))


# --- the small utilities the runners carry -----------------------------------

def test_padding_helpers_equal_the_jax_package():
    from multimodal_biometric_fingerprints_palms_tpu.utils import padding as jp
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
        padding as tp)
    imgs = [_random(5, 37), _random(17, 3, seed=1)]
    for x in (imgs[0], np.stack([imgs[0]] * 2)):
        np.testing.assert_array_equal(tp.pad_to_multiple(x, 8, 3.0),
                                      jp.pad_to_multiple(x, 8, 3.0))
    shapes = [i.shape for i in imgs]
    assert tp.canonical_shape(shapes, 32) == jp.canonical_shape(shapes, 32)
    for a, b in zip(tp.pad_image_batch(imgs, (24, 40)),
                    jp.pad_image_batch(imgs, (24, 40))):
        np.testing.assert_array_equal(a, b)


def test_device_trace_writes_a_trace(tmp_path):
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.profiling import (
        count, device_trace, span)
    with device_trace(tmp_path / "trace"):
        with span("io.sum"):
            count("io.sums")
            torch.ones(4).sum()
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"io.sum"' in trace
    counted = json.loads((tmp_path / "trace" / "counters.json").read_text())
    assert counted["io.sums"] == 1
