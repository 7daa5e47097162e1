"""Frame readers of the CLI: .klg logs and image directories, as numpy.

The port's own copy of the readers the `-static` CLI needs (the reference's
LogReader family, GUI/Tools/LogReader.h:31-85), equal frame for frame to the
JAX package's `cofusion_tpu/io/readers.py` (`tests/test_torch_io.py`):

  * KlgLogReader — .klg binary logs through the native C++ decoder
    (`native/libklgio.so`: zlib + libjpeg), or a pure-Python decoder where
    that library cannot be loaded (GUI/Tools/KlgLogReader.cpp:41-128);
  * ImageLogReader — Color####.png + Depth####.exr/png [+ Mask####.png]
    directories with prefix/extension autodetection, `calibration.txt`
    discovery and a background prefetch thread
    (GUI/Tools/ImageLogReader.{h,cpp}, buffering loop :179-217);
  * load_calibration, write_klg.

Both readers step backward (`get_previous`) and restart (`rewind`) for the
'-r' ping-pong playback (MainController.cpp:352-363).

Frames are dicts {rgb uint8 (H,W,3) RGB-order, depth float32 meters,
mask uint8 | None, timestamp int} (Core/FrameData.h:25-42).  PNG images
are decoded by the port's own decoder (`io/png.py`: numpy and zlib);
OpenCV is imported only where an EXR, JPEG or TIFF image is decoded (a
JPEG-compressed .klg frame without `native/libklgio.so` included).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import queue
import re
import struct
import subprocess
import threading
import zlib

import numpy as np

from cofusion_tpu_torch.io import png

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native")


@functools.lru_cache(maxsize=1)
def _load_native():
    """The native klg codec, built with `make` if missing; None where it
    cannot be built or loaded (the readers then decode in Python)."""
    path = os.path.join(_NATIVE_DIR, "libklgio.so")
    if not os.path.exists(path):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.klg_open.restype = ctypes.c_void_p
    lib.klg_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.klg_num_frames.argtypes = [ctypes.c_void_p]
    lib.klg_next.restype = ctypes.c_int
    lib.klg_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.klg_skip.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.klg_seek.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.klg_close.argtypes = [ctypes.c_void_p]
    lib.klg_write.restype = ctypes.c_int
    lib.klg_write.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
    ]
    return lib


def write_klg(path: str, frames: list[dict], width: int, height: int, compress: bool = True):
    """Encode frames into a .klg log (depth as uint16 millimetres, zlib if
    `compress`; rgb raw)."""
    lib = _load_native()
    n = len(frames)
    ts = np.asarray([f.get("timestamp", i) for i, f in enumerate(frames)], np.int64)
    depths = np.ascontiguousarray(
        np.stack([np.round(f["depth"] * 1000.0).astype(np.uint16) for f in frames])
    )
    rgbs = np.ascontiguousarray(np.stack([f["rgb"].astype(np.uint8) for f in frames]))
    if lib is not None:
        rc = lib.klg_write(
            path.encode(), n, width, height,
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            depths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            rgbs.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            1 if compress else 0,
        )
        if rc != 0:
            raise IOError(f"klg_write failed: {rc}")
        return
    with open(path, "wb") as f:
        f.write(struct.pack("<i", n))
        for i in range(n):
            d = depths[i].tobytes()
            if compress:
                d = zlib.compress(d)
            r = rgbs[i].tobytes()
            f.write(struct.pack("<qii", int(ts[i]), len(d), len(r)))
            f.write(d)
            f.write(r)


class LogReader:
    """Reader interface (GUI/Tools/LogReader.h:31-85)."""

    def __init__(self):
        self.current_frame = 0
        self.flip_colors = False

    def get_next(self) -> dict:
        raise NotImplementedError

    def get_previous(self) -> dict:
        """Step one frame back and return it ('-r', LogReader::getPrevious)."""
        raise NotImplementedError

    def rewind(self) -> None:
        """Back to the first frame."""
        raise NotImplementedError

    def has_more(self) -> bool:
        return self.current_frame < self.num_frames()

    def num_frames(self) -> int:
        raise NotImplementedError

    def fast_forward(self, frame: int) -> None:
        while self.current_frame < frame and self.has_more():
            self.get_next()

    def calibration_file(self) -> str | None:
        return None


class KlgLogReader(LogReader):
    def __init__(self, path: str, width: int = 640, height: int = 480):
        super().__init__()
        self.path = path
        self.width = width
        self.height = height
        self._lib = _load_native()
        self._h = None
        # frame start offsets of the Python decoder, for get_previous (the
        # reference's file-pointer stack, KlgLogReader.cpp:41-128)
        self._offsets: list[int] = []
        if self._lib is not None:
            self._h = self._lib.klg_open(path.encode(), width, height)
            if not self._h:
                raise IOError(f"cannot open klg: {path}")
            self._n = self._lib.klg_num_frames(self._h)
        else:
            self._fp = open(path, "rb")
            self._n = struct.unpack("<i", self._fp.read(4))[0]

    def num_frames(self) -> int:
        return self._n

    def get_next(self) -> dict:
        if self._lib is None:
            return self._get_next_python()
        depth = np.empty((self.height, self.width), np.float32)
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        ts = ctypes.c_int64(0)
        rc = self._lib.klg_next(
            self._h,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.byref(ts),
        )
        if rc != 0:
            raise IOError(f"klg_next failed: {rc}")
        self.current_frame += 1
        if self.flip_colors:
            rgb = rgb[..., ::-1]
        return {"rgb": rgb, "depth": depth, "mask": None, "timestamp": int(ts.value)}

    def get_previous(self) -> dict:
        i = max(self.current_frame - 2, 0)
        if self._lib is not None:
            self._lib.klg_seek(self._h, i)
            self.current_frame = i
            return self.get_next()
        # frames are read forward only, so the stack holds every frame start
        # up to current_frame
        del self._offsets[i + 1:]
        self._fp.seek(self._offsets[i] if self._offsets else 4)
        self.current_frame = i
        return self._get_next_python()

    def rewind(self) -> None:
        if self._lib is not None:
            self._lib.klg_seek(self._h, 0)
        else:
            self._fp.seek(4)
        self.current_frame = 0

    def _get_next_python(self) -> dict:
        npix = self.width * self.height
        if len(self._offsets) <= self.current_frame:
            self._offsets.append(self._fp.tell())
        ts, dsize, rsize = struct.unpack("<qii", self._fp.read(16))
        dbuf = self._fp.read(dsize)
        rbuf = self._fp.read(rsize) if rsize > 0 else b""
        if dsize != npix * 2:
            dbuf = zlib.decompress(dbuf)
        depth = (
            np.frombuffer(dbuf, np.uint16).reshape(self.height, self.width).astype(np.float32)
            * 0.001
        )
        if rsize == 0:
            rgb = np.zeros((self.height, self.width, 3), np.uint8)
        elif rsize == npix * 3:
            rgb = np.frombuffer(rbuf, np.uint8).reshape(self.height, self.width, 3)
        else:
            import cv2

            bgr = cv2.imdecode(np.frombuffer(rbuf, np.uint8), cv2.IMREAD_COLOR)
            rgb = bgr[..., ::-1].copy()
        self.current_frame += 1
        if self.flip_colors:
            rgb = rgb[..., ::-1]
        return {"rgb": rgb, "depth": depth, "mask": None, "timestamp": int(ts)}

    def fast_forward(self, frame: int) -> None:
        if self._lib is None:
            super().fast_forward(frame)
        elif frame > self.current_frame:
            self.current_frame = self._lib.klg_skip(self._h, frame - self.current_frame)

    def close(self):
        if self._h:
            self._lib.klg_close(self._h)
            self._h = None
        elif self._lib is None:
            self._fp.close()


_NUM_RE = re.compile(r"(\d+)\.(\w+)$")


def _imread(path: str, mode: str):
    """An image file as `cv2.imread` with the flag `mode` reads it, colour
    in RGB order: PNG through the port's own decoder (`io/png.py`); EXR,
    JPEG and TIFF through OpenCV, which only those need."""
    if path.lower().endswith(".png"):
        return png.imread(path, mode)
    try:
        import cv2
    except ImportError:
        raise IOError(f"{path}: reading {os.path.splitext(path)[1]} images needs OpenCV (cv2), "
                      "which is not installed; PNG datasets need nothing beyond numpy") from None
    flags = {"color": cv2.IMREAD_COLOR, "anydepth": cv2.IMREAD_ANYDEPTH,
             "grayscale": cv2.IMREAD_GRAYSCALE,
             "anycolor_anydepth": cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH}[mode]
    img = cv2.imread(path, flags)
    if img is None:
        raise IOError(f"cannot read {path}" + (" (EXR support?)" if path.endswith(".exr") else ""))
    return img[..., ::-1].copy() if mode == "color" else img


class ImageLogReader(LogReader):
    """Directory dataset reader with background prefetching.

    Autodetects color/depth/mask filename prefixes and extensions
    (ImageLogReader.cpp:75-117) and `calibration.txt` next to the data
    (:146-148).  Depth: .exr (float meters) or 16-bit png scaled by
    `png_depth_scale` (default x0.0006, the reference's hard-coded scale for
    the car4/room4 datasets, ImageLogReader.cpp:260; CLI `-pngScale`).
    Timestamps synthesized at `rate_hz`."""

    def __init__(
        self,
        directory: str,
        mask_directory: str | None = None,
        depth_directory: str | None = None,
        color_prefix: str | None = None,
        depth_prefix: str | None = None,
        mask_prefix: str | None = None,
        rate_hz: float = 24.0,
        prefetch: int = 15,
        png_depth_scale: float = 0.0006,
        max_masks: int | None = None,
        index_width: int | None = None,
    ):
        """`depth_directory`: separate depth dir (-depthdir, the data dir if
        None).  `max_masks`: no masks from this frame index on (-nm N; 0
        ignores masks, ImageLogReader.h:69-70).  `index_width`: digits of the
        frame index (-indexW; autodetected if None)."""
        super().__init__()
        self.dir = directory
        self.rate_hz = rate_hz
        self.png_depth_scale = png_depth_scale
        self.max_masks = max_masks
        self.index_width = index_width

        self.color_files = self._detect(directory, color_prefix, ("Color", "color", "rgb", "Rgb"))
        self.depth_files = self._detect(
            depth_directory or directory, depth_prefix, ("Depth", "depth")
        )
        if len(self.color_files) != len(self.depth_files):
            raise IOError(
                f"color/depth count mismatch: {len(self.color_files)} vs {len(self.depth_files)}"
            )
        self.mask_files: list[str] | None = None
        if mask_directory and (max_masks is None or max_masks > 0):
            self.mask_files = self._detect(mask_directory, mask_prefix, ("Mask", "mask"))
            if len(self.mask_files) < len(self.color_files):
                raise IOError("fewer masks than frames")
        self._n = len(self.color_files)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._prefetch_loop, daemon=True)
        self._thread.start()

    def _detect(self, directory: str, prefix: str | None, candidates) -> list[str]:
        for p in ([prefix] if prefix else candidates):
            for ext in ("png", "jpg", "jpeg", "exr", "tiff"):
                files = sorted(glob.glob(os.path.join(directory, f"{p}*.{ext}")))
                if files and self.index_width:
                    files = [
                        f for f in files
                        if (m := _NUM_RE.search(f)) and len(m.group(1)) == self.index_width
                    ]
                if files:
                    return files
        raise IOError(f"no image files with prefixes {candidates} in {directory}")

    def calibration_file(self) -> str | None:
        cal = os.path.join(self.dir, "calibration.txt")
        return cal if os.path.exists(cal) else None

    def _load(self, i: int) -> dict:
        rgb = _imread(self.color_files[i], "color")
        dpath = self.depth_files[i]
        if dpath.endswith(".exr"):
            os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
            d = _imread(dpath, "anycolor_anydepth")
            if d.ndim == 3:
                d = d[..., 0]
            depth = d.astype(np.float32)
        else:
            depth = _imread(dpath, "anydepth").astype(np.float32) * self.png_depth_scale
        mask = None
        if self.mask_files and (self.max_masks is None or i < self.max_masks):
            mask = _imread(self.mask_files[i], "grayscale")
        return {
            "rgb": rgb,
            "depth": depth,
            "mask": mask,
            "timestamp": int(i * 1e6 / self.rate_hz),
        }

    def _prefetch_loop(self):
        for i in range(self._n):
            try:
                frame = self._load(i)
            except Exception as e:  # noqa: BLE001 - re-raised by get_next in the caller's thread
                frame = e
            while True:
                if self._stop.is_set():
                    return
                try:
                    self._queue.put((i, frame), timeout=0.25)
                    break
                except queue.Full:
                    continue
            if isinstance(frame, Exception):
                return

    def num_frames(self) -> int:
        return self._n

    def get_next(self) -> dict:
        i, frame = self._queue.get()
        if isinstance(frame, Exception):
            raise frame
        self.current_frame = i + 1
        return self._flipped(frame)

    def get_previous(self) -> dict:
        """Backward step read directly: the prefetch queue runs forward only
        (and has drained when playback turns at the log's end)."""
        i = max(self.current_frame - 2, 0)
        frame = self._load(i)
        self.current_frame = i + 1
        return self._flipped(frame)

    def _flipped(self, frame: dict) -> dict:
        return dict(frame, rgb=frame["rgb"][..., ::-1]) if self.flip_colors else frame

    def rewind(self) -> None:
        self.close()
        self._queue = queue.Queue(maxsize=self._queue.maxsize)
        self._stop = threading.Event()
        self.current_frame = 0
        self._thread = threading.Thread(target=self._prefetch_loop, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        self._thread.join()


def load_calibration(path: str) -> tuple[float, float, float, float, int | None, int | None]:
    """Parse `fx fy cx cy [w h]` (MainController::loadCalibration,
    GUI/MainController.cpp:293-312)."""
    with open(path) as f:
        parts = f.read().split()
    fx, fy, cx, cy = map(float, parts[:4])
    w = int(parts[4]) if len(parts) > 4 else None
    h = int(parts[5]) if len(parts) > 5 else None
    return fx, fy, cx, cy, w, h
