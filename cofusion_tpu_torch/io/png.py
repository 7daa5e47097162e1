"""PNG files without OpenCV: a decoder and a writer of the port's own, on
zlib and numpy.

`imread(path, mode)` decodes what the image-directory datasets hold and
returns what `cv2.imread` returns with the matching flag, except that
colour comes back in RGB order (cv2's is BGR):

  * "unchanged" (IMREAD_UNCHANGED): the image as stored, (H, W) gray,
    (H, W, 2) gray + alpha, (H, W, 3) RGB or (H, W, 4) RGBA, uint8 or
    uint16 (cv2 gives gray + alpha as four channels, the gray repeated);
  * "color" (IMREAD_COLOR): (H, W, 3) uint8 RGB: gray repeated, alpha
    dropped, 16-bit samples cut to their high byte;
  * "anydepth" (IMREAD_ANYDEPTH): a gray image at its own depth, alpha
    dropped (the depth frames: 16-bit millimetres);
  * "grayscale" (IMREAD_GRAYSCALE): a gray image as uint8, alpha dropped,
    16-bit samples cut to their high byte (the masks).

For a colour image, "anydepth" and "grayscale" raise IOError: cv2 would
turn it into BT.601 luma in libpng's fixed-point arithmetic, and no
dataset of depth frames or masks holds colour; such a file is refused, not
guessed at.  The decoder reads colour types 0, 2, 4 and 6 at bit depths 8
and 16 (big-endian samples), all five row filters and any number of IDAT
chunks, and checks every chunk's CRC.  Palette images (type 3), Adam7
interlace and other bit depths raise IOError naming the file and what is
unsupported.  Ancillary chunks (gamma, transparency, text) are skipped,
as cv2 skips them.

`write_png` encodes 8-bit gray or RGB and 16-bit gray exactly as
`cv2.imwrite` does by default (libpng's settings there), so the files are
byte-equal to cv2's: the segmentation and label exports, and depth frames
for datasets written by the tests and the smoke run.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
MODES = ("unchanged", "color", "anydepth", "grayscale")


def _chunks(path: str, data: bytes):
    """(type, body) of every chunk up to IEND, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise IOError(f"{path}: not a PNG file")
    i = 8
    while i + 12 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind = data[i + 4:i + 8]
        body = data[i + 8:i + 8 + n]
        if len(body) != n or i + 12 + n > len(data):
            raise IOError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise IOError(f"{path}: CRC error in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        i += 12 + n
    raise IOError(f"{path}: no IEND chunk")


def _unfilter_average(row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Filter 3: each byte plus the floor mean of its left and upper
    neighbours (left of the first pixel is 0).  Sequential in the row."""
    r, p = row.tolist(), prev.tolist()
    out = r[:]
    for i in range(bpp):
        out[i] = (r[i] + (p[i] >> 1)) & 0xFF
    for i in range(bpp, len(r)):
        out[i] = (r[i] + ((out[i - bpp] + p[i]) >> 1)) & 0xFF
    return np.array(out, np.uint8)


def _unfilter_paeth(row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Filter 4: each byte plus the Paeth predictor of its left, upper and
    upper-left neighbours.  Sequential in the row."""
    r, p = row.tolist(), prev.tolist()
    out = r[:]
    for i in range(bpp):  # no left neighbour: the predictor is the upper byte
        out[i] = (r[i] + p[i]) & 0xFF
    for i in range(bpp, len(r)):
        a, b, c = out[i - bpp], p[i], p[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (r[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def read_png(path: str) -> np.ndarray:
    """The image as stored (the "unchanged" form of the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise IOError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in _CHANNELS:
        what = "palette (colour type 3)" if ctype == 3 else f"colour type {ctype}"
        raise IOError(f"{path}: unsupported PNG: {what}")
    if depth not in (8, 16):
        raise IOError(f"{path}: unsupported PNG: bit depth {depth}")
    if interlace != 0:
        raise IOError(f"{path}: unsupported PNG: Adam7 interlace")
    if compression != 0 or filtering != 0 or w == 0 or h == 0:
        raise IOError(f"{path}: invalid PNG header {header}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"{path}: corrupt image data ({e})") from None
    if len(raw) < h * (stride + 1):
        raise IOError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise IOError(f"{path}: invalid row filter {int(kinds.max())}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row, k = rows[y, 1:], kinds[y]
        if k == 0:
            out[y] = row
        elif k == 1:  # Sub: a running sum per byte lane, mod 256
            out[y] = np.cumsum(row.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif k == 2:  # Up
            out[y] = row + prev
        elif k == 3:
            out[y] = _unfilter_average(row, prev, bpp)
        else:
            out[y] = _unfilter_paeth(row, prev, bpp)
        prev = out[y]
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def imread(path: str, mode: str = "unchanged") -> np.ndarray:
    """Decode a PNG file as `cv2.imread` with the flag named by `mode`
    (module docstring), colour in RGB order."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    img = read_png(path)
    if mode == "unchanged":
        return img
    if mode == "color":
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        elif img.shape[2] == 2:
            img = np.repeat(img[..., :1], 3, axis=2)
        else:
            img = img[..., :3]
        return np.ascontiguousarray(img >> 8 if img.dtype == np.uint16 else img).astype(np.uint8)
    if img.ndim == 3:
        if img.shape[2] != 2:
            raise IOError(f"{path}: a colour PNG where a gray one is read ({mode}); "
                          "convert it to gray first")
        img = np.ascontiguousarray(img[..., 0])
    if mode == "grayscale" and img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit gray (H, W) or RGB (H, W, 3) image, or a 16-bit gray (H, W)
    one, as a PNG file encoded as cv2.imwrite encodes it by default: the
    Sub filter on every row (None for a one-pixel-wide image), deflate at
    level 1 with the run-length strategy, libpng's window for small
    images, IDAT chunks of 8192 bytes.  Colour is given in RGB order."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, rows = 16, np.ascontiguousarray(img, ">u2").view(np.uint8)
    elif img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3):
        depth, rows = 8, np.ascontiguousarray(img, np.uint8)
    else:
        raise ValueError(f"write_png takes 8-bit gray or RGB or 16-bit gray, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    colour = img.ndim == 3
    bpp = (3 if colour else 1) * depth // 8
    rows = rows.reshape(h, w * bpp)
    sub = rows.copy()
    sub[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]  # uint8 wraps: mod 256
    # libpng drops Sub for a one-pixel-wide image (filter None)
    kind = np.full((h, 1), 1 if w > 1 else 0, np.uint8)
    raw = np.concatenate([kind, sub], axis=1).tobytes()
    # libpng narrows the deflate window while the image fits in half of it
    # (png_deflate_claim), then names the smallest window the data fits in
    # in the stream's header (optimize_cmf)
    wbits = 15
    if len(raw) <= 16384:
        while len(raw) + 262 <= 1 << (wbits - 1):
            wbits -= 1
    z = zlib.compressobj(1, zlib.DEFLATED, max(wbits, 9), 8, zlib.Z_RLE)
    idat = bytearray(z.compress(raw) + z.flush())
    if len(raw) <= 16384:
        cinfo = idat[0] >> 4
        while cinfo > 0 and len(raw) <= 1 << (cinfo + 7):
            cinfo -= 1
        idat[0] = (idat[0] & 0x0F) | (cinfo << 4)
        flg = idat[1] & 0xE0
        idat[1] = flg + 0x1F - ((idat[0] << 8) + flg) % 0x1F
    idat = bytes(idat)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2 if colour else 0, 0, 0, 0)))
        for i in range(0, len(idat), 8192):
            f.write(chunk(b"IDAT", idat[i:i + 8192]))
        f.write(chunk(b"IEND", b""))
