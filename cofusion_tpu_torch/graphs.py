"""Step stages replayed as CUDA graphs: one cache per engine (`StepGraphs`).

A stage hands the cache a function of its inputs (`fn(inputs)`), the inputs
(a pytree of tensors and other values), the settings a capture bakes in,
the tensors the stage reads and writes at their own addresses and, where
one family of graphs holds several, the variant to replay.  The cache knows
nothing about any stage: tracking (`odometry.track_models`) and each
slot's fuse/clean pass (`engine._fuse_clean_all`) call it the same way.
"""

from collections import OrderedDict, defaultdict

import torch
import torch.utils._pytree as pytree


def _sig(x):
    """A tensor's shape, dtype and strides; any other value as it is."""
    return (tuple(x.shape), x.dtype, x.stride()) if isinstance(x, torch.Tensor) else x


def key(stage: str, leaves: list, spec, statics: tuple, in_place=()) -> tuple:
    """What a captured graph bakes in: the stage, the device, the inputs'
    structure (`spec`, None fields included), each input tensor's shape,
    dtype and strides and every other input's value (`leaves`), `statics`,
    the address, shape, dtype and strides of every tensor of `in_place`,
    and the matmuls' TF32 switch."""
    return (stage, _device(leaves), spec, tuple(_sig(t) for t in leaves), statics,
            tuple((t.data_ptr(),) + _sig(t) for t in pytree.tree_leaves(in_place)),
            torch.backends.cuda.matmul.allow_tf32)


def _device(leaves: list) -> torch.device:
    return next(t.device for t in leaves if isinstance(t, torch.Tensor))


class _Family:
    """One key's graphs by variant.  The variants share the copies of the
    input tensors, which a replay fills, and the output buffers, which each
    graph writes last: no two variants of a family replay in one call."""

    def __init__(self, outputs):
        leaves, self.out_spec = pytree.tree_flatten(outputs)
        # the output buffers' shapes and dtypes, from the eager call (no
        # shape: a value that is not a tensor)
        self.out_meta = [(t.shape, t.dtype) if isinstance(t, torch.Tensor) else (None, t)
                         for t in leaves]
        self.graphs: dict = {}
        self.inputs = self.outputs = None


class StepGraphs:
    """Step stages as CUDA graphs, one family per `key` and a graph per
    variant in it; each engine holds its own.

    A family's first call runs eagerly: it creates the libraries' handles
    and workspaces, which a capture may not, and gives the shapes of the
    outputs.  The first later call of each variant captures it on the
    cache's side stream (no device sync; thread-local, as the readers'
    prefetch threads run), and every call after that copies its input
    tensors into the family's and replays.  CPU calls, and calls made with
    `capture=False` (a sharded store's passes), run eagerly.

    Every graph writes its outputs last into buffers allocated outside the
    graphs' memory pool, and its input copies are allocated outside it too,
    so nothing a replay leaves in the pool is read after it: all graphs
    share one private pool, captured on one side stream (the allocator
    reuses a freed block only on the stream it was allocated on), and
    replay in any order.  A capture with no graph held takes a new pool,
    as the allocator releases a pool no graph holds.  `run` returns the
    family's output buffers, which its next call overwrites: a caller that
    keeps a result past that clones it.

    At most `held` = 2 x (slots + 3) families are held, the least recently
    used evicted: a frame uses one fuse/clean family a slot and up to three
    tracking keys (the step's, relocalisation's and the local loop's under
    '-rl -cl'), and twice that keeps a frame's families and those of one
    change of settings.  `counts(stage)` reads host counters only."""

    def __init__(self, slots: int):
        self.held = 2 * (slots + 3)
        self._families: OrderedDict = OrderedDict()  # key -> _Family
        self._pool = self._stream = None
        self._counts = defaultdict(lambda: dict(captures=0, replays=0, eager=0, evictions=0))

    def counts(self, stage: str) -> dict[str, int]:
        return dict(self._counts[stage])

    def run(self, stage: str, fn, inputs, statics: tuple, *, in_place=(), variant=None,
            capture: bool = True):
        """`fn(inputs)`, replayed from the graph of `key(stage, ...)` and
        `variant` where there is one."""
        leaves, spec = pytree.tree_flatten(inputs)
        dev = _device(leaves)
        if dev.type != "cuda" or not capture:
            self._counts[stage]["eager"] += 1
            return fn(inputs)
        k = key(stage, leaves, spec, statics, in_place)
        fam = self.family(k)
        if fam is None:
            self._counts[stage]["eager"] += 1
            out = fn(inputs)
            self.admit(k, out)
            return out
        g = fam.graphs.get(variant)
        if g is None:
            g = fam.graphs[variant] = self._capture(fam, fn, leaves, spec, dev)
            self._counts[stage]["captures"] += 1
        self._counts[stage]["replays"] += 1
        for dst, src in zip(fam.inputs, leaves):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        g.replay()
        return fam.outputs

    def family(self, k) -> _Family | None:
        """The key's family, made the most recent; None for a key not held."""
        fam = self._families.get(k)
        if fam is not None:
            self._families.move_to_end(k)
        return fam

    def admit(self, k, outputs) -> None:
        """Enter a new key's family (`outputs`: its eager call's) as the most
        recent, evicting the least recent past `held`; a key's first item
        is its stage."""
        self._families[k] = _Family(outputs)
        if len(self._families) > self.held:
            old, _ = self._families.popitem(last=False)
            self._counts[old[0]]["evictions"] += 1

    def _capture(self, fam: _Family, fn, leaves: list, spec, dev) -> torch.cuda.CUDAGraph:
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if not any(f.graphs for f in self._families.values()):
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev):
            if fam.inputs is None:
                fam.inputs = [t.clone() if isinstance(t, torch.Tensor) else t for t in leaves]
                fam.outputs = pytree.tree_unflatten(
                    [v if shape is None else torch.empty(shape, dtype=v, device=dev)
                     for shape, v in fam.out_meta], fam.out_spec)
            graph = torch.cuda.CUDAGraph()
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    res = pytree.tree_leaves(fn(pytree.tree_unflatten(fam.inputs, spec)))
                    for dst, src in zip(pytree.tree_leaves(fam.outputs), res):
                        if isinstance(dst, torch.Tensor):
                            dst.copy_(src)
                finally:
                    graph.capture_end()
        return graph
