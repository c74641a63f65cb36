"""Multi-device scaling: shard the stream axis over a list of devices."""

from .mesh import make_mesh, shard_batch, sharded_process_frames  # noqa: F401
