"""cofusion_tpu_torch — PyTorch + hand-written CUDA port of cofusion_tpu.

The JAX package (`cofusion_tpu/`) stays the reference; this package runs the
same engine on an NVIDIA GPU (or on the CPU, through the kernels' plain
PyTorch versions).  It imports `torch` and never `jax`, and no module of
it imports anything of the JAX package: `config.py`, `io/synthetic.py`,
`io/readers.py` (.klg logs and image directories) and `utils/stopwatch.py`
are the port's own, with the reference's names and defaults.

Ported: the `-static` (single global model, ElasticFusion mode) frame path
and the multi-model path (object models segmented by ground-truth masks or by
the motion-cue CRF, masked batched tracking, the model lifecycle) — bilateral
filter (CUDA kernel), tracking, segmentation, fuse/clean and the window
splat (CUDA kernel); and the step on an engine state whose surfel axis is
sharded over a device mesh (`parallel/`).  See README.md and ROADMAP.md
for what is still to come.
"""

__version__ = "0.1.0"

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig  # noqa: F401
