"""The port's PNG decoder and 16-bit writer (cofusion_tpu_torch/io/png.py)
against OpenCV, and the image-directory reader built on them against the
JAX package's, with OpenCV made unimportable for the port's side.

Bars: every decoded image bit-equal to `cv2.imread` with the matching flag
(colour compared after turning the port's RGB into cv2's BGR; cv2 gives
gray + alpha as four channels); files written by `write_png` byte-equal
to `cv2.imwrite`'s; frames read by the two readers equal; refused formats
raise IOError.  Images are random (hypothesis, derandomized so every
worker collects and draws alike) over colour types 0, 2, 4 and 6, bit
depths 8 and 16 and odd sizes, written by cv2 (the Sub filter), by PIL
(a filter chosen per row) and by an encoder in this file that draws each
row's filter at random (every filter, every colour type and depth).
"""

import contextlib
import io
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from cofusion_tpu.io import readers as jreaders
from cofusion_tpu_torch.io import png
from cofusion_tpu_torch.io import readers as treaders

FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "anydepth": cv2.IMREAD_ANYDEPTH, "grayscale": cv2.IMREAD_GRAYSCALE}
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
SETTINGS = settings(max_examples=12, deadline=None, derandomize=True)
sizes = st.tuples(st.integers(1, 37), st.integers(1, 41))


def _random_image(seed, shape, ctype, depth):
    rng = np.random.default_rng(seed)
    ch = CHANNELS[ctype]
    shape = tuple(shape) + ((ch,) if ch > 1 else ())
    img = rng.integers(0, 1 << depth, shape, dtype=np.uint16 if depth == 16 else np.uint8)
    # runs of equal samples too, so the filters' predictions hit zero
    img[::3] = img[:1]
    return img


def _as_cv2(img: np.ndarray, mode: str) -> np.ndarray:
    """The port's decoded image in cv2's layout for `mode`."""
    if img.ndim == 3 and mode == "unchanged" and img.shape[2] == 2:
        return np.stack([img[..., 0]] * 3 + [img[..., 1]], axis=-1)
    if img.ndim == 3:
        return np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    return img


def _assert_decodes_like_cv2(path: str, stored: np.ndarray):
    """Every mode against cv2.imread; a colour image read as gray must
    raise.  `stored` is the image as written (RGB order)."""
    np.testing.assert_array_equal(png.read_png(path), stored)
    for mode, flag in FLAGS.items():
        ref = cv2.imread(path, flag)
        if mode in ("anydepth", "grayscale") and stored.ndim == 3 and stored.shape[2] in (3, 4):
            with pytest.raises(IOError, match="colour PNG"):
                png.imread(path, mode)
            continue
        got = _as_cv2(png.imread(path, mode), mode)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (mode, got.shape, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=mode)


def _encode(path, img, depth, ctype, seed, interlace=0):
    """A PNG whose rows each take a filter drawn at random, its data split
    over IDAT chunks of 37 bytes."""
    rng = np.random.default_rng(seed)
    h, w = img.shape[:2]
    bpp = CHANNELS[ctype] * depth // 8
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img).reshape(h, w * bpp).astype(np.int64)
    out, prev = [], np.zeros(w * bpp, np.int64)
    for r in rows:
        kind = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 3:
            pred = (left + prev) >> 1
        elif kind == 4:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = (0, left, prev)[kind]
        out.append(bytes([kind]) + ((r - pred) % 256).astype(np.uint8).tobytes())
        prev = r
    z = zlib.compress(b"".join(out))

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
        for i in range(0, len(z), 37):
            f.write(chunk(b"IDAT", z[i:i + 37]))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,depth", [(0, 8), (0, 16), (2, 8), (2, 16), (6, 8), (6, 16)])
@SETTINGS
@given(size=sizes, seed=st.integers(0, 2 ** 16))
def test_decodes_cv2_written_files(tmp_path_factory, ctype, depth, size, seed):
    path = str(tmp_path_factory.mktemp("cv2") / "img.png")
    img = _random_image(seed, size, ctype, depth)
    assert cv2.imwrite(path, _as_cv2(img, "color"))
    _assert_decodes_like_cv2(path, img)


@pytest.mark.parametrize("ctype,depth", [(0, 8), (0, 16), (2, 8), (4, 8), (6, 8)])
@SETTINGS
@given(size=sizes, seed=st.integers(0, 2 ** 16))
def test_decodes_pil_written_files(tmp_path_factory, ctype, depth, size, seed):
    path = str(tmp_path_factory.mktemp("pil") / "img.png")
    img = _random_image(seed, size, ctype, depth)
    Image.fromarray(img).save(path)
    _assert_decodes_like_cv2(path, img)


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
@pytest.mark.parametrize("depth", [8, 16])
@SETTINGS
@given(size=sizes, seed=st.integers(0, 2 ** 16))
def test_decodes_every_row_filter(tmp_path_factory, ctype, depth, size, seed):
    path = str(tmp_path_factory.mktemp("filters") / "img.png")
    img = _random_image(seed, size, ctype, depth)
    _encode(path, img, depth, ctype, seed)
    _assert_decodes_like_cv2(path, img)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
@SETTINGS
@given(size=st.tuples(st.integers(1, 150), st.integers(1, 170)), seed=st.integers(0, 2 ** 16))
def test_writes_what_cv2_imwrite_writes(tmp_path_factory, kind, size, seed):
    """Byte-equal to cv2.imwrite, over sizes on both sides of libpng's
    small-image window (16 KiB of filtered rows)."""
    d = tmp_path_factory.mktemp("write")
    img = _random_image(seed, size, 2 if kind == "rgb8" else 0, 16 if kind == "gray16" else 8)
    png.write_png(str(d / "port.png"), img)
    cv2.imwrite(str(d / "cv2.png"), _as_cv2(img, "color"))
    assert (d / "port.png").read_bytes() == (d / "cv2.png").read_bytes()


def test_writes_a_full_size_depth_frame_as_cv2(tmp_path):
    depth = np.random.default_rng(3).uniform(0.4, 4.5, (480, 640))
    mm = np.round(depth * 1000).astype(np.uint16)
    png.write_png(str(tmp_path / "port.png"), mm)
    cv2.imwrite(str(tmp_path / "cv2.png"), mm)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "cv2.png").read_bytes()
    np.testing.assert_array_equal(png.imread(str(tmp_path / "port.png"), "anydepth"), mm)


def _palette(path):
    Image.fromarray(np.arange(12, dtype=np.uint8).reshape(3, 4)).convert("P").save(path)


def _one_bit(path):
    Image.fromarray(np.eye(5, dtype=bool)).save(path)


def _interlaced(path):
    _encode(path, np.zeros((4, 4), np.uint8), 8, 0, 0, interlace=1)


def _bad_crc(path):
    _encode(path, np.zeros((4, 4), np.uint8), 8, 0, 0)
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 1  # inside the last IDAT's body
    open(path, "wb").write(bytes(data))


def _not_png(path):
    cv2.imwrite(path[:-4] + ".bmp", np.zeros((4, 4), np.uint8))
    os.replace(path[:-4] + ".bmp", path)


def _rgb(path):
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("write,mode,match", [
    (_palette, "unchanged", "palette"),
    (_one_bit, "unchanged", "bit depth 1"),
    (_interlaced, "unchanged", "Adam7"),
    (_bad_crc, "unchanged", "CRC"),
    (_not_png, "color", "not a PNG"),
    (_rgb, "anydepth", "colour PNG"),
    (_rgb, "grayscale", "colour PNG"),
])
def test_refused_formats_raise(tmp_path, write, mode, match):
    path = str(tmp_path / "img.png")
    write(path)
    with pytest.raises(IOError, match=match) as e:
        png.imread(path, mode)
    assert path in str(e.value)


def test_image_reader_equals_jax_without_cv2(tmp_path, monkeypatch):
    """One dataset (8-bit colour, 16-bit depth, 8-bit masks, cv2-written)
    through both packages' ImageLogReader: the port's with cv2
    unimportable, frame for frame equal."""
    rng = np.random.default_rng(5)
    for i in range(4):
        cv2.imwrite(str(tmp_path / f"Color{i:04d}.png"), rng.integers(0, 256, (24, 33, 3), dtype=np.uint8))
        cv2.imwrite(str(tmp_path / f"Depth{i:04d}.png"), rng.integers(0, 5000, (24, 33), dtype=np.uint16))
        cv2.imwrite(str(tmp_path / f"Mask{i:04d}.png"), rng.integers(0, 4, (24, 33), dtype=np.uint8))
    kw = dict(mask_directory=str(tmp_path), png_depth_scale=0.001)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        out = treaders.ImageLogReader(str(tmp_path), **kw)
        port = [out.get_next() for _ in range(out.num_frames())]
        out.close()
    ref = jreaders.ImageLogReader(str(tmp_path), **kw)
    jax = [ref.get_next() for _ in range(ref.num_frames())]
    assert len(port) == len(jax) == 4
    for a, b in zip(port, jax):
        for key in ("rgb", "depth", "mask"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["timestamp"] == b["timestamp"]


def test_image_reader_without_cv2_names_what_needs_it(tmp_path, monkeypatch):
    """A JPEG dataset without OpenCV: the reader's caller gets the IOError
    (raised in the prefetch thread, re-raised by get_next)."""
    cv2.imwrite(str(tmp_path / "Color0000.jpg"), np.zeros((8, 8, 3), np.uint8))
    cv2.imwrite(str(tmp_path / "Depth0000.png"), np.zeros((8, 8), np.uint16))
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = treaders.ImageLogReader(str(tmp_path))
    with pytest.raises(IOError, match="needs OpenCV"):
        reader.get_next()
    reader.close()


def test_cli_runs_a_png_dataset_without_cv2(tmp_path, monkeypatch, small_cam):
    """`cofusion_tpu_torch.cli.run(["-dir", ..., "-device", "cpu"])` over a
    PNG dataset written by the port's own encoder, and the port's
    evaluator over its exports, with cv2 unimportable."""
    from cofusion_tpu.io.synthetic import make_sequence
    from cofusion_tpu_torch import cli
    from cofusion_tpu_torch.tools import evaluate

    frames, gt, _ = make_sequence(small_cam, 4, kind="orbit")
    data = tmp_path / "seq"
    data.mkdir()
    for i, f in enumerate(frames):
        png.write_png(str(data / f"Color{i:04d}.png"), f["rgb"])
        png.write_png(str(data / f"Depth{i:04d}.png"), np.round(f["depth"] * 1000).astype(np.uint16))
    c = small_cam
    (data / "calibration.txt").write_text(f"{c.fx} {c.fy} {c.cx} {c.cy} {c.width} {c.height}\n")
    np.save(tmp_path / "gt.npy", np.stack(gt))
    out = tmp_path / "out"
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert cli.run(["-dir", str(data), "-pngScale", "0.001", "-static", "-run", "-q", "-d", "4.5",
                    "-ns", str(1 << 16), "-ep", "-device", "cpu", "-exportdir", str(out)]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert evaluate.main(["--export", str(out), "--gt-poses", str(tmp_path / "gt.npy"), "--no-align"]) == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["traj_frames"] == 4 and res["ate_rmse_m"] < 0.005, res
