"""The port's readers for a machine without ``imageio``, ``cv2`` or ``yaml``:
the numpy + ``zlib`` PNG codec of ``utils/io.py`` against ``imageio`` (each
decodes what the other writes, every row filter), and the camera-info YAML
parser of ``utils/calib.py`` against ``yaml``.  The fallbacks are also run
end to end in a fresh interpreter where those packages cannot be imported.
Exact throughout."""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal
from ros_gpu_stereo_processor_tpu_torch.utils import io as tio

from tests.test_torch_serve import write_calib

iio = pytest.importorskip("imageio.v3")
ROOT = Path(__file__).resolve().parent.parent


def _image(shape, dtype, seed=0):
    """Smooth ramps plus noise, so an encoder's adaptive filter choice varies
    by row."""
    rng = np.random.default_rng(seed)
    hi = 65536 if dtype == np.uint16 else 256
    ramp = np.add.outer(np.arange(shape[0]) * 7, np.arange(shape[1]) * 3)
    ramp = ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
    a = (ramp * (hi // 256) + rng.integers(0, 40, shape)) % hi
    a[shape[0] // 3: shape[0] // 2] = rng.integers(0, hi, a[shape[0] // 3: shape[0] // 2].shape)
    return a.astype(dtype)


def _row_filters(png: bytes):
    """The filter byte of each row of a PNG (one IDAT stream)."""
    pos, idat = 8, b""
    while pos < len(png):
        length, ctype = struct.unpack(">I4s", png[pos:pos + 8])
        if ctype == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", png[pos + 8:pos + 18])
        if ctype == b"IDAT":
            idat += png[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[color] * depth // 8
    return {raw[y * (stride + 1)] for y in range(h)}


CASES = {
    "grey8": ((23, 31), np.uint8),
    "grey16": ((23, 31), np.uint16),
    "rgb8": ((23, 31, 3), np.uint8),
    "rgba8": ((23, 31, 4), np.uint8),
    "grey_alpha8": ((23, 31, 2), np.uint8),
}


@pytest.mark.parametrize("case", [c for c in CASES if c != "grey_alpha8"])
def test_decodes_what_imageio_writes(case):
    shape, dtype = CASES[case]
    img = _image(shape, dtype)
    png = iio.imwrite("<bytes>", img, extension=".png")
    assert len(_row_filters(png)) > 1, "want several row filters in the file"
    got = tio.png_decode(png)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("case", list(CASES))
def test_imageio_decodes_what_the_port_writes(case):
    shape, dtype = CASES[case]
    img = _image(shape, dtype, seed=1)
    png = tio.png_encode(img)
    back = np.asarray(iio.imread(png, extension=".png"))
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    np.testing.assert_array_equal(tio.png_decode(png), img)


def _encode_with_filters(img: np.ndarray, filters) -> bytes:
    """A PNG whose row y uses ``filters[y % len(filters)]``, filtered by the
    PNG specification's formulas (a reference encoder for the decoder's
    test)."""
    a = img if img.ndim == 3 else img[..., None]
    h, w, c = a.shape
    depth = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int64)
    bpp = c * depth // 8
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 0:
            line = cur
        elif f == 1:
            line = cur - left
        elif f == 2:
            line = cur - prior
        elif f == 3:
            line = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
            line = cur - pred
        out.append(f)
        out += (line & 0xFF).astype(np.uint8).tobytes()
        prior = cur

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                              color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["grey8", "grey16", "rgb8", "rgba8"])
def test_every_row_filter(case):
    """All five filters (Average included, which imageio's encoder does not
    pick), each checked by imageio's decoder first."""
    shape, dtype = CASES[case]
    img = _image(shape, dtype, seed=2)
    png = _encode_with_filters(img, [0, 1, 2, 3, 4])
    assert _row_filters(png) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(np.asarray(iio.imread(png, extension=".png"))
                                  .reshape(img.shape), img)
    np.testing.assert_array_equal(tio.png_decode(png), img)


def test_decodes_cv2_rgb16():
    cv2 = pytest.importorskip("cv2")
    img = _image((17, 19, 3), np.uint16, seed=3)
    ok, enc = cv2.imencode(".png", img)
    assert ok
    # cv2 takes BGR and stores RGB
    np.testing.assert_array_equal(tio.png_decode(enc.tobytes()), img[..., ::-1])


def test_rejects_what_it_cannot_read():
    png = tio.png_encode(_image((8, 8), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        tio.png_decode(b"GIF89a" + png[6:])
    with pytest.raises(ValueError, match="truncated|IEND"):
        tio.png_decode(png[:-20])
    bad = bytearray(png)
    bad[40] ^= 0xFF
    with pytest.raises(ValueError):
        tio.png_decode(bytes(bad))
    palette = iio.imwrite("<bytes>", _image((8, 8, 3), np.uint8), extension=".png",
                          mode="P")
    with pytest.raises(ValueError, match="unsupported"):
        tio.png_decode(palette)
    with pytest.raises(ValueError):
        tio.png_encode(np.zeros((4, 4), np.float32))


EUROC_CALIB = """# cam0 of a EuRoC-style rig, in the camera_calibration_parsers layout
image_width: 752
image_height: 480
camera_name: "cam0"
camera_matrix:
  rows: 3
  cols: 3
  data: [ 4.5816e+02, 0., 3.6721e+02,
      0., 4.5731e+02, 2.4837e+02,
      0., 0., 1. ]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
rectification_matrix:
  rows: 3
  cols: 3
  data: [0.999966, -0.0049, 0.0066, 0.0049, 0.999988, 0.0005,
         -0.0066, -0.0005, 0.999978]
projection_matrix:
  rows: 3
  cols: 4
  data: [435.2, 0, 367.4, -47.9, 0, 435.2, 252.2, 0, 0, 0, 1, 0]
"""


def _calib_files(tmp_path):
    a, b = str(tmp_path / "test_serve.yaml"), str(tmp_path / "euroc.yaml")
    write_calib(a, "right", tx=-8.0)
    with open(b, "w") as f:
        f.write(EUROC_CALIB)
    return a, b


def _same_calib(x: tcal.CameraCalib, y: tcal.CameraCalib):
    assert (x.width, x.height, x.name, x.distortion_model) == \
        (y.width, y.height, y.name, y.distortion_model)
    for f in ("K", "D", "R", "P"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_camera_info_parser_matches_yaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    for path in _calib_files(tmp_path):
        text = Path(path).read_text()
        assert tcal.parse_camera_info_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        tcal.parse_camera_info_yaml("a:\n  b:\n    c: 1\n")
    with pytest.raises(ValueError):
        tcal.parse_camera_info_yaml("data:\n  - 1\n  - 2\n")


_BLOCKED = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('imageio', 'cv2', 'yaml', 'PIL'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "for k in [k for k in sys.modules if k.split('.')[0] in ('imageio', 'cv2', 'yaml', 'PIL')]:\n"
    "    del sys.modules[k]\n"
    "sys.meta_path.insert(0, Block())\n"
)


def test_fallbacks_without_imageio_cv2_yaml(tmp_path):
    """In an interpreter where imageio, cv2 and yaml cannot be imported:
    ``load_camera_calib`` parses both calibration files to what yaml gives
    here, ``write_image`` writes a PNG that imageio reads back here,
    ``load_image`` reads imageio's PNG, and a non-PNG path raises."""
    a, b = _calib_files(tmp_path)
    img = _image((21, 29, 3), np.uint8, seed=4)
    theirs = str(tmp_path / "theirs.png")
    iio.imwrite(theirs, img)
    code = _BLOCKED + (
        "import numpy as np\n"
        "from ros_gpu_stereo_processor_tpu_torch.utils import calib, io\n"
        f"for i, p in enumerate([{a!r}, {b!r}]):\n"
        "    c = calib.load_camera_calib(p)\n"
        f"    np.savez({str(tmp_path)!r} + f'/calib{{i}}.npz', K=c.K, D=c.D, R=c.R, P=c.P,\n"
        "             meta=np.array([c.width, c.height]), name=np.array(c.name))\n"
        f"img = io.load_image({theirs!r})\n"
        f"io.write_image({str(tmp_path / 'ours.png')!r}, img)\n"
        "try:\n"
        f"    io.write_image({str(tmp_path / 'x.jpg')!r}, img)\n"
        "except ImportError as e:\n"
        "    print('raised', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "raised" in out.stdout and "PNG files only" in out.stdout
    np.testing.assert_array_equal(np.asarray(iio.imread(tmp_path / "ours.png")), img)
    for i, p in enumerate((a, b)):
        got = np.load(tmp_path / f"calib{i}.npz")
        want = tcal.load_camera_calib(p)            # with yaml, in this process
        _same_calib(tcal.CameraCalib(int(got["meta"][0]), int(got["meta"][1]), got["K"],
                                     got["D"], got["R"], got["P"], str(got["name"])), want)
