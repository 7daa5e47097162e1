"""Fixed-capacity surfel map — PyTorch counterpart of
cofusion_tpu/models/surfel_model.py.

Same layout as the reference store: one (N,) tensor per attribute component
(struct of arrays), a bool `valid` mask and an int32 `count` of the valid
prefix (the store is kept compacted).  The port matches values, not layouts;
the scalar fields are kept because every pass of the engine works
coordinate-wise and the JAX state converts field for field (convert.py).

Scatters that JAX writes with `mode="drop"` (out-of-range rows are ignored)
write into one spare dump row past the end that is sliced off afterwards: a
CUDA scatter with an out-of-range index is a device-side assert.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_POS = ("px", "py", "pz")
_NRM = ("nx", "ny", "nz")
_COL = ("cr", "cg", "cb")
# every per-surfel (N,) leaf, in declaration order
DATA_FIELDS = _POS + _NRM + _COL + ("radius", "conf", "init_time", "last_time", "valid")
_FLOAT_FIELDS = DATA_FIELDS[:-1]


class SurfelStore(NamedTuple):
    """One model's surfel map (leading (M,) axis when batched over models)."""

    px: torch.Tensor         # (N,) world-frame position components
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor         # (N,) world-frame unit normal components
    ny: torch.Tensor
    nz: torch.Tensor
    cr: torch.Tensor         # (N,) rgb in [0, 255]
    cg: torch.Tensor
    cb: torch.Tensor
    radius: torch.Tensor     # (N,)
    conf: torch.Tensor       # (N,) accumulated confidence
    init_time: torch.Tensor  # (N,) tick when created
    last_time: torch.Tensor  # (N,) tick of last update
    valid: torch.Tensor      # (N,) bool
    count: torch.Tensor      # () int32 — number of valid surfels (prefix)

    @property
    def capacity(self) -> int:
        return self.px.shape[-1]

    # stacked (N, 3) views, for the loop closure's warps and the tests
    @property
    def pos(self) -> torch.Tensor:
        return torch.stack([self.px, self.py, self.pz], dim=-1)

    @property
    def normal(self) -> torch.Tensor:
        return torch.stack([self.nx, self.ny, self.nz], dim=-1)


def pack_store(pos, normal, color, radius, conf, init_time, last_time, valid, count) -> SurfelStore:
    """Build a store from stacked (N, 3) attribute arrays."""
    return SurfelStore(
        px=pos[..., 0], py=pos[..., 1], pz=pos[..., 2],
        nx=normal[..., 0], ny=normal[..., 1], nz=normal[..., 2],
        cr=color[..., 0], cg=color[..., 1], cb=color[..., 2],
        radius=radius, conf=conf, init_time=init_time, last_time=last_time,
        valid=valid, count=count,
    )


def with_pos(store: SurfelStore, pos: torch.Tensor) -> SurfelStore:
    return store._replace(px=pos[..., 0], py=pos[..., 1], pz=pos[..., 2])


def with_normal(store: SurfelStore, normal: torch.Tensor) -> SurfelStore:
    return store._replace(nx=normal[..., 0], ny=normal[..., 1], nz=normal[..., 2])


def empty_store(capacity: int, device: torch.device) -> SurfelStore:
    def z():
        return torch.zeros((capacity,), dtype=torch.float32, device=device)

    return SurfelStore(
        **{f: z() for f in _FLOAT_FIELDS},
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _inverse_permutation(dest: torch.Tensor, size: int) -> torch.Tensor:
    """src with src[dest[i]] = i for every dest[i] < size; rows never written
    hold 0.  `dest` entries == size land in the dump row (JAX mode="drop")."""
    iota = torch.arange(dest.shape[0], dtype=torch.int64, device=dest.device)
    src = torch.zeros((size + 1,), dtype=torch.int64, device=dest.device)
    return src.scatter_(0, dest, iota)[:size]


def compact(store: SurfelStore, keep: torch.Tensor) -> SurfelStore:
    """Stream compaction: keep the surfels where `keep & valid`, packed to the
    front, order-preserving (cumsum -> inverse permutation -> one gather per
    attribute)."""
    keep = keep & store.valid
    n = store.capacity
    keep_i = keep.to(torch.int64)
    dest = torch.cumsum(keep_i, 0) - 1
    new_count = keep_i.sum()
    dest = torch.where(keep, dest, n)
    src = _inverse_permutation(dest, n)
    has = torch.arange(n, device=keep.device) < new_count
    out = {
        f: torch.where(has, getattr(store, f).index_select(0, src), 0.0)
        for f in _FLOAT_FIELDS
    }
    return SurfelStore(count=new_count.to(torch.int32), valid=has, **out)


def append(store: SurfelStore, new: SurfelStore, new_mask: torch.Tensor) -> SurfelStore:
    """Append the surfels of `new` where `new_mask`, after the current prefix.
    Overflow beyond capacity is dropped."""
    n = store.capacity
    mask_i = new_mask.to(torch.int64)
    rank = torch.cumsum(mask_i, 0) - 1
    dest = store.count.to(torch.int64) + rank
    dest = torch.where(new_mask & (dest < n), dest, n)
    new_count = torch.clamp(store.count.to(torch.int64) + mask_i.sum(), max=n)

    def put(base, rows):
        pad = torch.zeros((1,), dtype=base.dtype, device=base.device)
        return torch.cat([base, pad]).scatter_(0, dest, rows)[:n]

    out = {f: put(getattr(store, f), getattr(new, f)) for f in _FLOAT_FIELDS}
    out["valid"] = torch.arange(n, device=dest.device) < new_count
    return SurfelStore(count=new_count.to(torch.int32), **out)


def concat_stores(a: SurfelStore, b: SurfelStore) -> SurfelStore:
    """`a` then `b` in one store of capacity a + b, the valid rows packed to
    the front in order: the whole two-tier map in (roughly) time order when
    `a` is the stable tier (the deformation graph samples its nodes from
    it)."""
    cat = SurfelStore(
        *(torch.cat([x, y]) for x, y in zip(a[:-1], b[:-1])),
        count=torch.zeros((), dtype=torch.int32, device=a.px.device),
    )
    return compact(cat, cat.valid)


def expel_split(
    store: SurfelStore, keep: torch.Tensor, expel: torch.Tensor, block: int
) -> tuple[SurfelStore, SurfelStore]:
    """Two-tier maintenance step: partition the kept surfels into the ones that
    STAY in the active tier and an expel block (capacity `block`, valid
    prefix) bound for the stable tier.  At most `block` surfels are expelled
    per frame; the overflow stays active one more frame and re-queues."""
    keep = keep & store.valid
    expel = expel & keep
    expel_i = expel.to(torch.int64)
    rank = torch.cumsum(expel_i, 0) - 1
    taken = expel & (rank < block)
    stay = keep & ~taken

    dest = torch.where(taken, rank, block)
    n_ex = torch.clamp(expel_i.sum(), max=block)
    src_b = _inverse_permutation(dest, block)
    has_b = torch.arange(block, device=keep.device) < n_ex
    out = {
        f: torch.where(has_b, getattr(store, f).index_select(0, src_b), 0.0)
        for f in _FLOAT_FIELDS
    }
    blk = SurfelStore(count=n_ex.to(torch.int32), valid=has_b, **out)
    return compact(store, stay), blk


def _download_fields(take) -> dict:
    return {
        "pos": np.stack([take("px"), take("py"), take("pz")], axis=-1),
        "normal": np.stack([take("nx"), take("ny"), take("nz")], axis=-1),
        "color": np.stack([take("cr"), take("cg"), take("cb")], axis=-1),
        "radius": take("radius"),
        "conf": take("conf"),
        "init_time": take("init_time"),
        "last_time": take("last_time"),
    }


def download(store: SurfelStore) -> dict:
    """Host-side export of the valid prefix (numpy; blocks on the device)."""
    n = int(store.count)
    return _download_fields(lambda f: getattr(store, f)[:n].cpu().numpy())


def download_masked(store: SurfelStore) -> dict:
    """Host-side export filtered by the explicit valid mask (the stable tier,
    whose mask — not the prefix — is authoritative)."""
    m = store.valid.cpu().numpy()
    return _download_fields(lambda f: getattr(store, f).cpu().numpy()[m])
