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

A store may also be a `ShardedStore`: its surfel axis split into contiguous
blocks, one per device of a mesh (cofusion_tpu_torch/parallel).  `compact`,
`expel_split` and `append` take either form and give the sharded one the
same rows, bit for bit: their only reductions over the surfel axis are
integer cumsums, which a shard's local cumsum plus the exclusive prefix of
the shards' totals reproduces exactly.  `concat_ranks` and `rows_of_rank`
read rows of `concat_stores`' result from sharded tiers without building
it.
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


class ShardedStore(NamedTuple):
    """A store split along its surfel axis: shard k holds the global rows
    [offsets[k], offsets[k] + its capacity) of every per-surfel leaf on its
    own device (its `count` is None); `count`, the valid-prefix count (the
    stable ring's cursor), stays whole on the first shard's device.  A
    slot's view of a sliced store (an object slot's active rows) keeps the
    shards that reach into the slice, the last one cut."""

    shards: tuple            # of SurfelStore
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self.shards)

    @property
    def offsets(self) -> tuple[int, ...]:
        sizes = [s.capacity for s in self.shards]
        return tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))


def to_device(x, dev: torch.device):
    """`x` on `dev` (a non-blocking copy, ordered against both devices'
    current streams; the tensor itself where it is already there); other
    values as they are."""
    return x.to(dev, non_blocking=True) if isinstance(x, torch.Tensor) else x


def shards_of(store) -> tuple[tuple[SurfelStore, ...], tuple[int, ...]]:
    """(shards, their global row offsets): a plain store is one shard at 0."""
    if isinstance(store, ShardedStore):
        return store.shards, store.offsets
    return (store,), (0,)


def per_shard(store, fn):
    """`fn` of every shard (a tuple), or of a plain store: per-surfel masks
    of a sharded store are tuples of per-shard masks."""
    if isinstance(store, ShardedStore):
        return tuple(fn(s) for s in store.shards)
    return fn(store)


def shard_store(store: SurfelStore, devices) -> ShardedStore:
    """Split every per-surfel leaf (..., N) into len(devices) equal
    contiguous blocks along N, block k copied to devices[k]; `count` is
    copied to devices[0].  A capacity the device count does not divide is
    refused."""
    n, cap = len(devices), store.capacity
    if cap % n:
        raise ValueError(f"surfel capacity {cap} is not divisible by {n} shards")
    b = cap // n
    shards = tuple(
        SurfelStore(
            *(getattr(store, f)[..., k * b:(k + 1) * b].to(dev, copy=True).contiguous()
              for f in DATA_FIELDS),
            count=None,
        )
        for k, dev in enumerate(devices)
    )
    return ShardedStore(shards, store.count.to(devices[0], copy=True))


def gathered(store) -> SurfelStore:
    """The whole store on the count's device (a plain store as it is)."""
    if not isinstance(store, ShardedStore):
        return store
    dev = store.count.device
    return SurfelStore(
        *(torch.cat([to_device(getattr(s, f), dev) for s in store.shards], dim=-1)
          for f in DATA_FIELDS),
        count=store.count,
    )


def gather_rows(parts, offsets, idx: torch.Tensor) -> list[torch.Tensor]:
    """Rows `idx` (global, int64, in range) of per-shard columns: parts[k]
    holds shard k's (n_k,) columns (one dtype), offsets[k] its first global
    row.  Each shard gathers at its clamped local rows; on `idx`'s device
    the shard that owns a row overrides the earlier ones."""
    if len(parts) == 1:
        return [c.index_select(0, idx) for c in parts[0]]
    dev = idx.device
    out = None
    for cols, off in zip(parts, offsets):
        dk = cols[0].device
        local = torch.clamp(to_device(idx, dk) - off, 0, cols[0].shape[0] - 1)
        g = to_device(torch.stack([c.index_select(0, local) for c in cols]), dev)
        out = g if out is None else torch.where((idx >= off)[None], g, out)
    return list(out.unbind(0))


def take_rows(store, idx: torch.Tensor, fields) -> list[torch.Tensor]:
    """`fields` of the surfels at global rows `idx`, on `idx`'s device."""
    shards, offsets = shards_of(store)
    return gather_rows([[getattr(s, f) for f in fields] for s in shards], offsets, idx)


def select(cond: torch.Tensor, a, b):
    """Leaf-wise torch.where(cond, a, b) of two stores of one layout."""
    if not isinstance(a, ShardedStore):
        return SurfelStore(*(torch.where(cond, x, y) for x, y in zip(a, b)))
    shards = tuple(
        SurfelStore(
            *(torch.where(to_device(cond, sa.px.device), getattr(sa, f), getattr(sb, f))
              for f in DATA_FIELDS),
            count=None,
        )
        for sa, sb in zip(a.shards, b.shards)
    )
    return ShardedStore(shards, torch.where(cond, a.count, b.count))


def _global_ranks(flags):
    """Per-shard global inclusive ranks minus one (int64, on each shard's
    device) of the rows where `flags` hold, and their total (on the first
    shard's device): each shard's cumsum plus the exclusive prefix of the
    shards' totals."""
    csum = [torch.cumsum(f.to(torch.int64), 0) for f in flags]
    dev = csum[0].device
    totals = torch.stack([to_device(c[-1], dev) for c in csum])
    prefix = torch.cumsum(totals, 0) - totals
    ranks = [c - 1 + to_device(prefix[k], c.device) for k, c in enumerate(csum)]
    return ranks, totals.sum()


def _row_arange(off: int, n: int, dev, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(off, off + n, dtype=dtype, device=dev)


def _compact_sharded(store: ShardedStore, keep) -> ShardedStore:
    """`compact` of a sharded store.  Rows only move down (a row's
    destination is the count of kept rows before it), so destination shard
    d takes rows from shards s >= d: each (s, d) pair scatters shard s's
    local source rows into d's block (`_inverse_permutation`, dump row
    past the block), gathers them on s and hands them to d, where the
    rows s wrote override."""
    keep = [k & s.valid for k, s in zip(keep, store.shards)]
    dest, new_count = _global_ranks(keep)
    offsets = store.offsets
    shards = []
    for d, (sd, off_d) in enumerate(zip(store.shards, offsets)):
        n_d, dev_d = sd.capacity, sd.px.device
        acc = None
        for s in range(d, len(store.shards)):
            ss, dk = store.shards[s], keep[s].device
            mine = keep[s] & (dest[s] >= off_d) & (dest[s] < off_d + n_d)
            ld = torch.where(mine, dest[s] - off_d, n_d)
            src = _inverse_permutation(ld, n_d)
            hit = torch.zeros((n_d + 1,), dtype=torch.bool, device=dk).index_fill_(0, ld, True)[:n_d]
            g = to_device(torch.stack([getattr(ss, f).index_select(0, src) for f in _FLOAT_FIELDS]), dev_d)
            acc = g if acc is None else torch.where(to_device(hit, dev_d)[None], g, acc)
        has = _row_arange(off_d, n_d, dev_d) < to_device(new_count, dev_d)
        out = {f: torch.where(has, acc[i], 0.0) for i, f in enumerate(_FLOAT_FIELDS)}
        shards.append(SurfelStore(valid=has, count=None, **out))
    return ShardedStore(tuple(shards), new_count.to(torch.int32))


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
    attribute).  A sharded store takes a tuple of per-shard masks."""
    if isinstance(store, ShardedStore):
        return _compact_sharded(store, keep)
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
    Overflow beyond capacity is dropped.  Into a sharded store (`new` whole
    on its count's device) each shard writes the destination rows in its
    own range and sends the others to its dump row."""
    n = store.capacity
    mask_i = new_mask.to(torch.int64)
    rank = torch.cumsum(mask_i, 0) - 1
    dest = store.count.to(torch.int64) + rank
    dest = torch.where(new_mask & (dest < n), dest, n)
    new_count = torch.clamp(store.count.to(torch.int64) + mask_i.sum(), max=n)

    shards, offsets = shards_of(store)
    out_shards = []
    for sh, off in zip(shards, offsets):
        n_k, dk = sh.capacity, sh.px.device
        at = to_device(dest, dk)
        if isinstance(store, ShardedStore):
            at = torch.where((at >= off) & (at < off + n_k), at - off, n_k)

        def put(base, rows):
            pad = torch.zeros((1,), dtype=base.dtype, device=base.device)
            return torch.cat([base, pad]).scatter_(0, at, to_device(rows, dk))[:n_k]

        out = {f: put(getattr(sh, f), getattr(new, f)) for f in _FLOAT_FIELDS}
        out["valid"] = _row_arange(off, n_k, dk) < to_device(new_count, dk)
        out_shards.append(out)
    if not isinstance(store, ShardedStore):
        return SurfelStore(count=new_count.to(torch.int32), **out_shards[0])
    return ShardedStore(tuple(SurfelStore(count=None, **o) for o in out_shards),
                        new_count.to(torch.int32))


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


def concat_ranks(a, b):
    """The shards of `a` then `b` (their row order in `concat_stores(a,
    b)`), each shard's valid rows' global ranks in that order
    (`_global_ranks`), and the total count of valid rows."""
    shards = shards_of(a)[0] + shards_of(b)[0]
    ranks, total = _global_ranks([s.valid for s in shards])
    return shards, ranks, total


def rows_of_rank(shards, ranks, want: torch.Tensor, fields) -> list[torch.Tensor]:
    """`fields` of the valid rows of global rank `want` (`concat_ranks`;
    int64, on the first shard's device), which are rows `want` of
    `concat_stores`' result, without building it; zeros where no row has
    that rank.  Each shard binary-searches its nondecreasing ranks for the
    first row reaching the wanted rank: the shard owns the rank where that
    row is valid and has it, and the owner's values are kept."""
    dev = want.device
    out = torch.zeros((len(fields),) + want.shape, dtype=torch.float32, device=dev)
    for sh, r in zip(shards, ranks):
        dk = r.device
        t = to_device(want, dk)
        local = torch.clamp(torch.searchsorted(r, t), max=sh.capacity - 1)
        owns = sh.valid.index_select(0, local) & (r.index_select(0, local) == t)
        g = torch.stack([getattr(sh, f).index_select(0, local) for f in fields])
        out = torch.where(to_device(owns, dev)[None], to_device(g, dev), out)
    return list(out.unbind(0))


def expel_split(
    store: SurfelStore, keep: torch.Tensor, expel: torch.Tensor, block: int
) -> tuple[SurfelStore, SurfelStore]:
    """Two-tier maintenance step: partition the kept surfels into the ones that
    STAY in the active tier and an expel block (capacity `block`, valid
    prefix) bound for the stable tier.  At most `block` surfels are expelled
    per frame; the overflow stays active one more frame and re-queues.
    From a sharded store (per-shard masks) the block is whole, on the
    count's device: each shard gathers its taken rows at their global
    ranks and the shard that took a row overrides."""
    if isinstance(store, ShardedStore):
        return _expel_split_sharded(store, keep, expel, block)
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


def _expel_split_sharded(store: ShardedStore, keep, expel, block: int):
    keep = [k & s.valid for k, s in zip(keep, store.shards)]
    expel = [e & k for e, k in zip(expel, keep)]
    rank, total = _global_ranks(expel)
    taken = [e & (r < block) for e, r in zip(expel, rank)]
    stay = tuple(k & ~t for k, t in zip(keep, taken))
    dev = store.count.device
    acc = None
    for sh, t, r in zip(store.shards, taken, rank):
        dest = torch.where(t, r, block)
        src = _inverse_permutation(dest, block)
        hit = torch.zeros((block + 1,), dtype=torch.bool, device=dest.device).index_fill_(0, dest, True)
        g = to_device(torch.stack([getattr(sh, f).index_select(0, src) for f in _FLOAT_FIELDS]), dev)
        acc = g if acc is None else torch.where(to_device(hit[:block], dev)[None], g, acc)
    n_ex = torch.clamp(total, max=block)
    has_b = torch.arange(block, device=dev) < n_ex
    out = {f: torch.where(has_b, acc[i], 0.0) for i, f in enumerate(_FLOAT_FIELDS)}
    blk = SurfelStore(count=n_ex.to(torch.int32), valid=has_b, **out)
    return _compact_sharded(store, stay), blk


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
