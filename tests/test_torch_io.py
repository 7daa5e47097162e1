"""cofusion_tpu_torch/io/readers.py against cofusion_tpu/io/readers.py.

The same .klg log and image directory, written here from seeded numpy
frames, read through both packages' readers: every frame (rgb, depth,
mask, timestamp) and the calibration must be equal bit for bit.  The klg
is read through the native decoder (`native/libklgio.so`) and through the
pure-Python fallback of each package.
"""

import filecmp

import numpy as np
import pytest

from cofusion_tpu.io import readers as jreaders
from cofusion_tpu_torch.io import readers as treaders

W, H, N = 40, 32, 4


def _frames(seed=3):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(N):
        depth = rng.integers(0, 5000, (H, W)).astype(np.float32) * 0.001
        depth[rng.random((H, W)) < 0.1] = 0.0
        rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        mask = (rng.random((H, W)) < 0.3).astype(np.uint8) * 255
        frames.append({"rgb": rgb, "depth": depth, "mask": mask, "timestamp": 1000 * i + 7})
    return frames


def _assert_frames_equal(a, b):
    assert a.keys() == b.keys()
    assert a["timestamp"] == b["timestamp"]
    for k in ("rgb", "depth"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if a["mask"] is None or b["mask"] is None:
        assert a["mask"] is None and b["mask"] is None
    else:
        np.testing.assert_array_equal(a["mask"], b["mask"])


def _read_all(reader):
    out = []
    while reader.has_more():
        out.append(reader.get_next())
    return out


@pytest.fixture
def python_decoders(monkeypatch):
    """Both packages without the native codec: the pure-Python paths."""
    monkeypatch.setattr(jreaders, "_NATIVE", False)
    monkeypatch.setattr(treaders, "_load_native", lambda: None)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("decoder", ["native", "python"])
def test_klg_frames_equal(tmp_path, request, decoder, compress):
    assert treaders._load_native() is not None, "the native klg codec did not load"
    path = str(tmp_path / "seq.klg")
    jreaders.write_klg(path, _frames(), W, H, compress=compress)
    if decoder == "python":
        request.getfixturevalue("python_decoders")
    ref = jreaders.KlgLogReader(path, W, H)
    out = treaders.KlgLogReader(path, W, H)
    assert out.num_frames() == ref.num_frames() == N
    a, b = _read_all(out), _read_all(ref)
    assert len(a) == len(b) == N
    for fa, fb in zip(a, b):
        _assert_frames_equal(fa, fb)
    out.close()
    ref.close()


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_klg_fast_forward_and_writer_equal(tmp_path, request, decoder):
    if decoder == "python":
        request.getfixturevalue("python_decoders")
    frames = _frames(seed=5)
    jpath, tpath = str(tmp_path / "j.klg"), str(tmp_path / "t.klg")
    jreaders.write_klg(jpath, frames, W, H)
    treaders.write_klg(tpath, frames, W, H)
    assert filecmp.cmp(jpath, tpath, shallow=False)
    ref = jreaders.KlgLogReader(jpath, W, H)
    out = treaders.KlgLogReader(tpath, W, H)
    ref.fast_forward(2)
    out.fast_forward(2)
    assert out.current_frame == ref.current_frame == 2
    _assert_frames_equal(out.get_next(), ref.get_next())
    out.close()
    ref.close()


def test_image_dir_and_calibration_equal(tmp_path):
    import cv2

    frames = _frames(seed=9)
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"Color{i:04d}.png"), f["rgb"][..., ::-1])
        cv2.imwrite(str(tmp_path / f"Depth{i:04d}.png"), np.round(f["depth"] * 1000).astype(np.uint16))
        cv2.imwrite(str(tmp_path / f"Mask{i:04d}.png"), f["mask"])
    (tmp_path / "calibration.txt").write_text("31.5 30.25 19.5 15.75 40 32\n")
    kw = dict(mask_directory=str(tmp_path), png_depth_scale=0.001, max_masks=3)
    ref = jreaders.ImageLogReader(str(tmp_path), **kw)
    out = treaders.ImageLogReader(str(tmp_path), **kw)
    assert out.num_frames() == ref.num_frames() == N
    assert out.calibration_file() == ref.calibration_file() is not None
    assert treaders.load_calibration(out.calibration_file()) == jreaders.load_calibration(
        ref.calibration_file()
    )
    a, b = _read_all(out), _read_all(ref)
    for fa, fb in zip(a, b):
        _assert_frames_equal(fa, fb)
    assert a[-1]["mask"] is None and a[0]["mask"] is not None
    np.testing.assert_array_equal(a[0]["rgb"], frames[0]["rgb"])
    out.close()


@pytest.mark.parametrize("kind", ["segmentation", "labels"])
def test_mask_and_label_pngs_decode_like_jax_exports(tmp_path, kind):
    """The port's '-es' / '-el' PNGs (its own zlib encoder) decode to the
    pixels of the JAX exporter's cv2-written files: slot ids with the
    suppressed 255 zeroed, and the colour-table label image."""
    import cv2

    from cofusion_tpu.utils import export as jexport
    from cofusion_tpu_torch.utils import export as texport

    mask = np.random.default_rng(11).integers(0, 5, (H, W)).astype(np.uint8)
    mask[:3] = 255
    write = {"segmentation": "export_mask_png", "labels": "export_label_png"}[kind]
    getattr(texport, write)(str(tmp_path / "port.png"), mask)
    getattr(jexport, write)(str(tmp_path / "jax.png"), mask)
    port = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    ref = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    assert port.shape == ref.shape and port.dtype == np.uint8
    np.testing.assert_array_equal(port, ref)


def test_colorize_labels_matches():
    from cofusion_tpu.utils import export as jexport
    from cofusion_tpu_torch.utils import export as texport

    mask = np.concatenate([np.arange(40), [255]]).astype(np.uint8).reshape(1, -1)
    np.testing.assert_array_equal(texport.colorize_labels(mask), jexport.colorize_labels(mask))
