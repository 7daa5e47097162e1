"""cofusion_tpu_torch/models/surfel_model.py against the JAX store on the CPU.

`compact`, `append` and `expel_split` are pure data movement (cumsum ranks,
inverse permutations, gathers), so the bar is exact equality of every field
and count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.models import surfel_model as jsm
from cofusion_tpu_torch.models import surfel_model as tsm

torch.set_num_threads(1)


def _random_store(rng, n, count):
    fields = {f: rng.normal(size=n).astype(np.float32) for f in tsm.DATA_FIELDS[:-1]}
    valid = np.arange(n) < count
    for f in fields:
        fields[f] = np.where(valid, fields[f], 0.0).astype(np.float32)
    return fields, valid


def _pair(fields, valid, count):
    j = jsm.SurfelStore(
        **{f: jnp.asarray(v) for f, v in fields.items()},
        valid=jnp.asarray(valid), count=jnp.int32(count),
    )
    t = tsm.SurfelStore(
        **{f: torch.from_numpy(v.copy()) for f, v in fields.items()},
        valid=torch.from_numpy(valid.copy()), count=torch.tensor(count, dtype=torch.int32),
    )
    return j, t


def _assert_same(t_store, j_store):
    for f in tsm.SurfelStore._fields:
        np.testing.assert_array_equal(
            getattr(t_store, f).numpy(), np.asarray(getattr(j_store, f)), err_msg=f
        )


def test_field_order_matches():
    assert tsm.SurfelStore._fields == jsm.SurfelStore._fields
    assert tsm.DATA_FIELDS == jsm.DATA_FIELDS


@pytest.mark.parametrize("keep_frac", [0.0, 0.3, 1.0])
def test_compact_exact(keep_frac):
    rng = np.random.default_rng(1)
    n, count = 4096, 3000
    fields, valid = _random_store(rng, n, count)
    keep = rng.random(n) < keep_frac
    j, t = _pair(fields, valid, count)
    _assert_same(tsm.compact(t, torch.from_numpy(keep)), jsm.compact(j, jnp.asarray(keep)))


@pytest.mark.parametrize("count,frac", [(100, 0.5), (4000, 0.5), (4096, 0.2)])
def test_append_exact(count, frac):
    """Includes overflow: appends beyond capacity are dropped."""
    rng = np.random.default_rng(2)
    n = 4096
    fields, valid = _random_store(rng, n, count)
    new_fields, _ = _random_store(rng, 1024, 1024)
    new_mask = rng.random(1024) < frac
    j, t = _pair(fields, valid, count)
    jn, tn = _pair(new_fields, np.ones(1024, bool), 1024)
    _assert_same(
        tsm.append(t, tn, torch.from_numpy(new_mask)),
        jsm.append(j, jn, jnp.asarray(new_mask)),
    )


@pytest.mark.parametrize("expel_frac", [0.0, 0.1, 0.6])
def test_expel_split_exact(expel_frac):
    """Includes a block smaller than the expel set (overflow stays active)."""
    rng = np.random.default_rng(3)
    n, count, block = 4096, 3500, 512
    fields, valid = _random_store(rng, n, count)
    keep = rng.random(n) < 0.9
    expel = rng.random(n) < expel_frac
    j, t = _pair(fields, valid, count)
    t_act, t_blk = tsm.expel_split(t, torch.from_numpy(keep), torch.from_numpy(expel), block)
    j_act, j_blk = jsm.expel_split(j, jnp.asarray(keep), jnp.asarray(expel), block)
    _assert_same(t_act, j_act)
    _assert_same(t_blk, j_blk)


def test_download_matches():
    rng = np.random.default_rng(4)
    fields, valid = _random_store(rng, 256, 100)
    j, t = _pair(fields, valid, 100)
    dj, dt = jsm.download(j), tsm.download(t)
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k])
    dj, dt = jsm.download_masked(j), tsm.download_masked(t)
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k])


@pytest.mark.parametrize("counts", [(3000, 1000), (0, 2000), (4096, 4096)])
def test_concat_stores_exact(counts):
    """The loop closure's whole-map view: the stable tier (a ring whose valid
    rows need not be a prefix) then the active tier, packed."""
    rng = np.random.default_rng(3)
    fa, va = _random_store(rng, 4096, counts[0])
    fb, vb = _random_store(rng, 4096, counts[1])
    va = va & (rng.random(4096) < 0.7)  # holes, as in the stable ring
    ja, ta = _pair(fa, va, counts[0])
    jb, tb = _pair(fb, vb, counts[1])
    _assert_same(tsm.concat_stores(ta, tb), jsm.concat_stores(ja, jb))


def test_with_pos_and_normal_exact():
    rng = np.random.default_rng(4)
    fields, valid = _random_store(rng, 512, 300)
    j, t = _pair(fields, valid, 300)
    pos = rng.normal(size=(512, 3)).astype(np.float32)
    nrm = rng.normal(size=(512, 3)).astype(np.float32)
    _assert_same(tsm.with_normal(tsm.with_pos(t, torch.from_numpy(pos)), torch.from_numpy(nrm)),
                 jsm.with_normal(jsm.with_pos(j, jnp.asarray(pos)), jnp.asarray(nrm)))
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
    np.testing.assert_array_equal(t.normal.numpy(), np.asarray(j.normal))
