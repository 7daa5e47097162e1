"""Multi-device operation: a mesh of devices and the engine state's
surfel-axis sharding over it — the counterpart of cofusion_tpu/parallel/.

    mesh = make_mesh(4, "cuda")                    # cuda:0..3; virtual=True
    engine.process_frame(first_frame)              # to place 4 shards on
    engine.state = shard_engine_state(engine.state, mesh)   # fewer cards
    engine.process_frame(frame)                    # the sharded step
    engine.stats(); engine.download_model(0)       # read as before
"""

from cofusion_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, shard_engine_state, shard_frame, unshard_engine_state,
)
