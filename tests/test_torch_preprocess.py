"""cofusion_tpu_torch/ops/preprocess.py (and the plain bilateral version in
ops/cuda_stencil.py) against cofusion_tpu/ops/preprocess.py on the CPU.

Tolerances:
  * bilateral: rtol=1e-5, atol=1e-6 — 169 float32 taps whose exp() differs
    by ~1 ulp between XLA and PyTorch, and XLA CPU contracts a*b+c into FMAs;
  * pyramids / vertex / normal maps: rtol=1e-5, atol=1e-6 — a handful of
    float32 ops, same order, FMA contraction on the XLA side only;
  * intensity and Sobel gradients are floor/trunc of short sums: exact
    against the compiled (jitted) JAX form the engine runs, whose
    multiply-adds XLA contracts into FMAs (the eager form rounds each
    product and differs at a few grey levels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CameraConfig
from cofusion_tpu.ops import preprocess as jpp
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.ops import cuda_stencil
from cofusion_tpu_torch.ops import preprocess as tpp

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
# jitted: the 169-tap XLA form dispatches ~1500 ops when run eagerly
_jax_bilateral = jax.jit(jpp.bilateral_filter)


def _depth(shape, seed=7):
    rng = np.random.default_rng(seed)
    H, W = shape
    return (rng.uniform(0.2, 4.0, (H, W)) * (rng.uniform(0, 1, (H, W)) > 0.1)).astype(np.float32)


@pytest.mark.parametrize("shape", [(128, 160), (48, 64), (37, 53)])
def test_bilateral_plain_matches_xla_form(shape):
    depth = _depth(shape)
    ref = np.asarray(_jax_bilateral(jnp.asarray(depth), 4.5))
    out = cuda_stencil.bilateral_filter_plain(torch.from_numpy(depth), 4.5).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(128, 160), (48, 64)])
def test_bilateral_plain_matches_pallas_interpret(shape, monkeypatch):
    """The Pallas kernel itself, in interpret mode (tests/test_pallas_stencil.py)."""
    from cofusion_tpu.ops import pallas_stencil as ps

    depth = _depth(shape, seed=11)
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))
    bh = 16 if shape[0] % 16 == 0 else 8
    ref = np.asarray(ps._bilateral_pallas.__wrapped__(jnp.asarray(depth), 4.5, bh))
    out = cuda_stencil.bilateral_filter_plain(torch.from_numpy(depth), 4.5).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_bilateral_filter_dispatches_plain_on_cpu():
    depth = _depth((32, 40))
    out = tpp.bilateral_filter(torch.from_numpy(depth), 3.0)
    np.testing.assert_array_equal(
        out.numpy(), cuda_stencil.bilateral_filter_plain(torch.from_numpy(depth), 3.0).numpy()
    )


def test_bilateral_cuda_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_stencil.bilateral_filter_cuda(torch.zeros((8, 8)), 3.0)


def test_rgb_to_intensity_exact():
    """Every uint8 triple (grey ones sum to within an ulp of an integer),
    and near-grey float colours like the splat's rendered ones."""
    v = np.arange(256, dtype=np.float32)
    triples = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    rng = np.random.default_rng(1)
    grey = np.repeat(rng.integers(0, 256, (256, 256, 1)), 3, -1) + rng.normal(0, 1e-4, (256, 256, 3))
    for rgb in (triples, grey.astype(np.float32)):
        ref = np.asarray(jax.jit(jpp.rgb_to_intensity)(jnp.asarray(rgb)))
        np.testing.assert_array_equal(tpp.rgb_to_intensity(torch.from_numpy(rgb)).numpy(), ref)


@pytest.mark.parametrize("shape", [(128, 160), (64, 80)])
def test_pyr_down_gauss_matches(shape):
    img = _depth(shape, seed=3)
    ref = np.asarray(jax.jit(jpp.pyr_down_gauss)(jnp.asarray(img)))
    np.testing.assert_allclose(
        tpp.pyr_down_gauss(torch.from_numpy(img)).numpy(), ref, rtol=RTOL, atol=ATOL
    )


def test_vmap_nmap_match():
    """On a smooth surface with holes: normals are cross products of
    neighbour differences, ill-conditioned on white-noise depth."""
    cam = CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    yy, xx = np.mgrid[0:128, 0:160].astype(np.float32)
    holes = np.random.default_rng(4).random((128, 160)) < 0.1
    depth = np.where(holes, 0.0, 2.0 + 0.3 * np.sin(xx / 17.0) * np.cos(yy / 11.0)).astype(np.float32)
    jv, jok = jpp.compute_vmap(jnp.asarray(depth), cam, 3.5)
    jn, jnok = jpp.compute_nmap(jv, jok)
    tcam = tcfg.CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    tv, tok = tpp.compute_vmap(torch.from_numpy(depth), tcam, 3.5)
    tn, tnok = tpp.compute_nmap(tv, tok)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tnok.numpy(), np.asarray(jnok))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL, atol=ATOL)


def test_sobel_gradients_exact():
    """Integer images (level 0) and float ones (the coarser levels)."""
    rng = np.random.default_rng(5)
    for img in (np.floor(rng.uniform(0, 255, (512, 640))), rng.uniform(0, 255, (512, 640))):
        img = img.astype(np.float32)
        jx, jy = jax.jit(jpp.sobel_gradients)(jnp.asarray(img))
        tx, ty = tpp.sobel_gradients(torch.from_numpy(img))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("normalize", [False, True])
def test_resize_map_half_matches(normalize):
    rng = np.random.default_rng(6)
    m = rng.normal(size=(48, 64, 3)).astype(np.float32)
    ok = rng.random((48, 64)) < 0.7
    jm, jok = jpp.resize_map_half(jnp.asarray(m), jnp.asarray(ok), normalize=normalize)
    tm, tok = tpp.resize_map_half(torch.from_numpy(m), torch.from_numpy(ok), normalize=normalize)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dy,dx", [(0, 0), (2, -3), (-1, 1), (5, 0)])
def test_shifted_exact(dy, dx):
    x = np.random.default_rng(8).normal(size=(9, 11, 2)).astype(np.float32)
    ref = np.asarray(jpp._shifted(jnp.asarray(x), dy, dx, fill=-7.0))
    np.testing.assert_array_equal(tpp._shifted(torch.from_numpy(x), dy, dx, -7.0).numpy(), ref)


def test_vertices_to_depth_exact():
    rng = np.random.default_rng(9)
    v = rng.uniform(-1, 7, (16, 20, 3)).astype(np.float32)
    ok = rng.random((16, 20)) < 0.8
    ref = np.asarray(jpp.vertices_to_depth(jnp.asarray(v), jnp.asarray(ok), 6.0))
    np.testing.assert_array_equal(
        tpp.vertices_to_depth(torch.from_numpy(v), torch.from_numpy(ok), 6.0).numpy(), ref
    )

