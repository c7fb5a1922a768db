from .shard import (  # noqa: F401
    make_mesh,
    ring_shape,
    ring_topk,
    shard_tracks,
    sharded_topk,
)
