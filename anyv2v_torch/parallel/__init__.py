from .mesh import (
    frames_sharding,
    make_mesh,
    replicated,
    shard_params,
    video_sharding,
)

__all__ = [
    "frames_sharding",
    "make_mesh",
    "replicated",
    "shard_params",
    "video_sharding",
]
