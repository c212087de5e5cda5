"""The port's codec against OpenCV on every kind of image file the JAX
package reads through ``cv2.imread``: EXIF orientation in JPEG, PNG and
TIFF; progressive and colour JPEG at every sampling layout; PNG of every
bit depth, palette and Adam7; BMP of 1 to 32 bits, bit fields and RLE;
TIFF in every compression the port reads, both predictors, strips and
tiles, 1, 8 and 16 bits and both byte orders; and TIFF written.

The files are ``tests/fixtures/formats/`` (``tools/format_fixtures.py``
writes them). Each decodes, grey and RGB, to exactly what
``cv2.imdecode`` gives: shape and every pixel. ``expected.json`` (the
digests the card's formats phase checks, without OpenCV) is derived again
here from OpenCV.
"""

import io
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
    image_codec as C, io as tio)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.tiff import (
    encode_tiff)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "formats"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
sys.path.insert(0, str(ROOT / "tools"))
import format_fixtures as FF  # noqa: E402

NAMES = sorted(EXPECTED)


def _cv2(data: bytes):
    return FF.cv2_decode(data)


@pytest.mark.parametrize("name", NAMES)
def test_expected_digests_are_opencvs(name):
    """The committed digests are OpenCV's decode of the committed file."""
    g, c = _cv2((FIXTURES / name).read_bytes())
    assert EXPECTED[name] == {"gray": FF.digest(g), "rgb": FF.digest(c)}


@pytest.mark.parametrize("name", NAMES)
def test_port_decodes_like_opencv(name):
    """Grey (``IMREAD_GRAYSCALE``) and RGB (``IMREAD_COLOR`` then
    ``COLOR_BGR2RGB``): equal shape, equal pixels."""
    data = (FIXTURES / name).read_bytes()
    g, c = _cv2(data)
    assert g is not None and c is not None, "every fixture is readable"
    np.testing.assert_array_equal(C.decode_gray(data, name), g)
    np.testing.assert_array_equal(C.decode_rgb(data, name), c)


@pytest.mark.parametrize("fmt", ["jpeg_exif_II", "jpeg_exif_MM", "png_exif",
                                 "tiff_orientation"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_every_orientation_turns_as_exif_says(fmt, orientation):
    """Each of the eight values, in each format, is the EXIF turn of the
    untagged image (5 to 8 swap the sides)."""
    ext = {"jpeg": "jpg", "png": "png", "tiff": "tif"}[fmt.split("_")[0]]
    data = (FIXTURES / f"{fmt}_o{orientation}.{ext}").read_bytes()
    plain = C.decode_gray((FIXTURES / f"{fmt}_o1.{ext}").read_bytes())
    want = {1: plain, 2: plain[:, ::-1], 3: plain[::-1, ::-1],
            4: plain[::-1], 5: plain.T, 6: np.rot90(plain, -1),
            7: plain[::-1, ::-1].T, 8: np.rot90(plain, 1)}[orientation]
    np.testing.assert_array_equal(C.decode_gray(data), want)


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
@pytest.mark.parametrize("rst", ["", "_rst"])
def test_progressive_equals_its_baseline_twin(sampling, rst):
    """A complete progressive file holds the coefficients of the baseline
    file OpenCV writes at the same quality: equal pixels, grey and RGB."""
    prog = (FIXTURES / f"jpeg_progressive_{sampling}{rst}.jpg").read_bytes()
    base = (FIXTURES / f"jpeg_baseline_{sampling}{rst}.jpg").read_bytes()
    np.testing.assert_array_equal(C.decode_rgb(prog), C.decode_rgb(base))
    np.testing.assert_array_equal(C.decode_gray(prog), C.decode_gray(base))


@pytest.mark.parametrize("kind", ["progressive", "progressive_colour"])
def test_print_fixtures_equal_their_twins(kind):
    """The card's formats phase relies on this: each progressive print
    decodes to its baseline twin's pixels."""
    a = C.decode_gray((FIXTURES / "prints" / f"{kind}.jpg").read_bytes())
    b = C.decode_gray((FIXTURES / "prints" / f"base_{kind}.jpg").read_bytes())
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,kind", [(0, "progressive"),
                                    (1, "progressive_colour")])
def test_print_twins_are_the_trees_own_files(k, kind):
    """The baseline twins are the JPEGs ``tools/polyu_set.py`` writes for
    those slots of the card's tree (the port's encoder, byte-equal to
    OpenCV's), so the format prints are genuine impressions of their
    subjects."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_jpeg)
    x = FF.print_pixels(FF.FORMAT_SUBJECTS[k % 4], k // 4)
    assert encode_jpeg(x) == (FIXTURES / "prints" / f"base_{kind}.jpg"
                              ).read_bytes()


def _scans(data: bytes) -> list[int]:
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0xDA]


@pytest.mark.parametrize("cut", ["after two scans", "inside the third scan"])
def test_incomplete_progressive_is_refused_where_libjpeg_smooths(cut):
    """A recorded deviation (ROADMAP.md queue 3): libjpeg shows a
    progressive file whose scans stop early with the missing coefficients
    smoothed across blocks (``jdcoefct.c``, ``decompress_smooth_data``);
    the port raises ``ImageFormatError`` instead."""
    prog = (FIXTURES / "jpeg_progressive_grey.jpg").read_bytes()
    s = _scans(prog)
    end = s[2] if cut == "after two scans" else (s[2] + s[3]) // 2
    data = prog[:end] + b"\xff\xd9"
    assert _cv2(data)[0] is not None
    with pytest.raises(C.ImageFormatError, match="progressive"):
        C.decode_gray(data)


def _bytes_of(kind: str) -> bytes:
    grey = FF.source()
    jpg = FF._cv(".jpg", grey)
    png = FF._cv(".png", grey)
    bmp = FF.bmp(grey, 8, np.repeat(np.arange(256)[:, None], 3, 1))
    tif = FF.tiff(grey, compression=5, predictor=2)
    os2 = FF.bmp(grey, 8, np.repeat(np.arange(256)[:, None], 3, 1), os2=True)
    return {
        "corrupt TIFF": b"II*\x00" + bytes(64),
        "empty": b"",
        "GIF": b"GIF89a" + bytes(32),
        "noise": np.random.default_rng(0).integers(
            0, 256, 200, dtype=np.uint8).tobytes(),
        "JPEG start only": b"\xff\xd8",
        "JPEG headers only": jpg[:jpg.find(b"\xff\xda")],
        "JPEG without end": jpg[:-2],
        "JPEG cut in half": jpg[:len(jpg) // 2],
        "PNG signature only": png[:8],
        "PNG without IDAT": png[:33] + FF._chunk(b"IEND", b""),
        "PNG cut in half": png[:len(png) // 2],
        "BMP header only": bmp[:54],
        "BMP cut in half": bmp[:len(bmp) // 2],
        "BMP of 7 bits": bmp[:28] + struct.pack("<H", 7) + bmp[30:],
        "BMP header of 20 bytes": bmp[:14] + struct.pack("<I", 20) + bmp[18:],
        "OS/2 BMP": os2,
        "OS/2 BMP header only": os2[:26],
        "OS/2 BMP of 16 bits": FF.bmp(grey.astype(np.int64) * 0x421, 16,
                                      os2=True),
        "TIFF cut in half": tif[:len(tif) // 2],
        "TIFF directory past the end": tif[:4] + struct.pack("<I", 10 ** 6)
        + tif[8:],
        "baseline JPEG": jpg, "PNG": png, "BMP": bmp, "TIFF": tif,
    }[kind]


@pytest.mark.parametrize("kind", [
    "corrupt TIFF", "empty", "GIF", "noise", "JPEG start only",
    "JPEG headers only", "JPEG without end", "JPEG cut in half",
    "PNG signature only", "PNG without IDAT", "PNG cut in half",
    "BMP header only", "BMP cut in half", "BMP of 7 bits",
    "BMP header of 20 bytes", "OS/2 BMP", "OS/2 BMP header only",
    "OS/2 BMP of 16 bits", "TIFF cut in half",
    "TIFF directory past the end", "baseline JPEG", "PNG", "BMP", "TIFF"])
def test_port_refuses_exactly_what_opencv_refuses(kind):
    """Among broken and whole files: the port raises ``ImageFormatError``
    where ``cv2.imdecode`` returns None, and reads where OpenCV reads."""
    data = _bytes_of(kind)
    cv_reads = bool(data) and _cv2(data)[0] is not None
    try:
        C.decode_gray(data, kind)
        port_reads = True
    except C.ImageFormatError:
        port_reads = False
    assert port_reads == cv_reads


def _patched_sof(marker: int) -> bytes:
    jpg = bytearray(FF._cv(".jpg", FF.source()))
    i = jpg.find(b"\xff\xc0")
    jpg[i + 1] = marker
    return bytes(jpg)


def _tiff_with(tag: int, value: int) -> bytes:
    data = bytearray(FF.tiff(FF.source(), compression=1))
    at = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[at:at + 2])[0]
    for k in range(n):
        e = at + 2 + 12 * k
        if struct.unpack("<H", data[e:e + 2])[0] == tag:
            data[e + 8:e + 10] = struct.pack("<H", value)
            return bytes(data)
    raise AssertionError(tag)


@pytest.mark.parametrize("what,make", [
    ("arithmetic-coded JPEG", lambda: _patched_sof(0xC9)),
    ("lossless JPEG", lambda: _patched_sof(0xC3)),
    ("hierarchical JPEG", lambda: _patched_sof(0xC5)),
    ("12-bit JPEG", lambda: (lambda d: d[:d.find(b"\xff\xc0") + 4] + b"\x0c"
                             + d[d.find(b"\xff\xc0") + 5:])(
        FF._cv(".jpg", FF.source()))),
    ("4-component (CMYK or YCCK) JPEG", lambda: FF._pil(
        __import__("PIL.Image", fromlist=["Image"]).fromarray(
            FF.source(channels=3)).convert("CMYK"), "JPEG")),
    ("TIFF with JPEG compression", lambda: _tiff_with(259, 7)),
    ("TIFF with CCITT Group 4 compression", lambda: _tiff_with(259, 4)),
    ("TIFF with float or signed samples", lambda: _float_tiff()),
])
def test_formats_left_out_are_refused_by_name(what, make):
    with pytest.raises(C.ImageFormatError) as e:
        C.decode_gray(make(), "f")
    assert what.lower() in str(e.value).lower()


def _float_tiff() -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(FF.source().astype(np.float32)).save(buf, "TIFF")
    return buf.getvalue()


@pytest.mark.parametrize("shape", [(1, 1), (29, 35), (320, 240), (5, 2000),
                                   (29, 35, 3), (64, 64, 3), (33, 7)])
def test_tiff_written_reads_back_in_opencv_and_equals_its_file(shape):
    """The port's TIFF (LZW, horizontal predictor, OpenCV's strip height)
    reads back through OpenCV to the same pixels, and is byte for byte
    the file ``cv2.imwrite`` writes."""
    rng = np.random.default_rng(sum(shape))
    img = (FF.source(shape[0], shape[1], seed=3) if len(shape) == 2
           else FF.source(shape[0], shape[1], seed=3, channels=3))
    img = np.where(rng.random(img.shape) < 0.1, 255, img).astype(np.uint8)
    data = encode_tiff(img)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, img)
    assert data == cv2.imencode(".tif", img)[1].tobytes()
    want = img if img.ndim == 2 else img[..., ::-1]
    got = C.decode_gray(data) if img.ndim == 2 else C.decode_rgb(data)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", [".tif", ".tiff"])
def test_write_image_writes_tiff_masks(suffix, tmp_path):
    """A 0/255 mask under a TIFF name, as the runner's debug output writes
    it, reads back through OpenCV and the port."""
    mask = (FF.print_pixels(5, 0) > 128).astype(np.uint8) * 255
    path = tmp_path / f"S0002_1{suffix}"
    tio.write_image(path, mask)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                                  mask)
    np.testing.assert_array_equal(tio.read_image_grayscale(path), mask)


def test_fixture_digests_match_the_files_on_disk():
    """Every file under the fixture directory has its entry and no entry
    lacks a file: the card checks all of them."""
    on_disk = sorted(str(p.relative_to(FIXTURES)) for p in FIXTURES.rglob("*")
                     if p.is_file() and p.name != "expected.json")
    assert on_disk == NAMES
    total = sum((FIXTURES / n).stat().st_size for n in NAMES)
    assert total < 1_500_000


def test_runners_read_and_skip_the_same_files(tmp_path, monkeypatch):
    """The JAX package's preprocessing runner reading through OpenCV (its
    native loader off: that one skips every file its C++ decoder cannot
    read) and the port's (its codec, on the CPU) over one directory of
    mixed formats with orientation tags: the same files read, the corrupt
    TIFF skipped by both, and the debug masks under the same names and
    suffixes. One difference is kept in view: a TIFF whose orientation
    swaps its sides (here 6), which OpenCV 5.0's ``imread`` refuses and its
    ``imdecode`` reads (ROADMAP.md queue 3), is skipped by the JAX runner
    and read by the port's."""
    import shutil
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.runner import (
        run_preprocessing as t_run)
    src = tmp_path / "in" / "cluster_0"
    src.mkdir(parents=True)
    for name in ("jpeg_exif_II_o6.jpg", "png_exif_o5.png",
                 "tiff_orientation_o3.tif", "png_grey16.png", "bmp_rle8.bmp",
                 "tiff_cv2_lzw_grey.tif", "jpeg_progressive_420.jpg",
                 "bmp32.bmp", "bmp_os2_8.bmp", "tiff_orientation_o6.tif"):
        shutil.copy(FIXTURES / name, src / name)
    sideways = "tiff_orientation_o6"
    (src / "S0002_1.tif").write_bytes(b"II*\x00" + bytes(64))
    monkeypatch.chdir(tmp_path)
    from multimodal_biometric_fingerprints_palms_tpu.preprocessing.runner import (
        run_preprocessing as j_run)
    j = j_run(tmp_path / "in", tmp_path / "jax", batch_size=16,
              use_native_loader=False)
    t = t_run(tmp_path / "in", tmp_path / "port", batch_size=16,
              use_native_loader=False, device="cpu")
    assert t["num_images"] == 10
    assert j["num_images"] == t["num_images"] - 1

    def listing(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file())
    port = listing(tmp_path / "port")
    assert any(sideways in p for p in port)
    assert listing(tmp_path / "jax") == [p for p in port if sideways not in p]
    masks = listing(tmp_path / "port" / "debug" / "cluster_0" / "mask")
    assert masks == sorted(n for n in (p.name for p in src.iterdir())
                           if n != "S0002_1.tif")
    for name in masks:
        mask = (tmp_path / "port" / "debug" / "cluster_0" / "mask" / name)
        assert cv2.imread(str(mask), cv2.IMREAD_GRAYSCALE) is not None


@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_tiff_turned_sideways_reads_as_imdecode_reads_it(orientation,
                                                          tmp_path):
    """A recorded deviation (ROADMAP.md queue 3): OpenCV 5.0's ``imread``
    of a TIFF whose orientation swaps the sides fails its own check
    (``original_ptr == real_mat.data``) and returns None, while
    ``imdecode`` of the same bytes reads it. The port reads it, from a
    path or from bytes, as ``imdecode`` does; the JAX runner, which calls
    ``imread``, skips such a file."""
    name = f"tiff_orientation_o{orientation}.tif"
    path = tmp_path / name
    path.write_bytes((FIXTURES / name).read_bytes())
    assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is None
    want = _cv2(path.read_bytes())[0]
    np.testing.assert_array_equal(tio.read_image_grayscale(path), want)
