"""The check that the run loaded nothing of the JAX package or JAX: each
module's top-level name (the part before the first dot) compared whole, so
that `cofusion_tpu_torch` passes where `cofusion_tpu` does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cofusion_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)
