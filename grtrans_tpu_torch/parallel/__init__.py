"""Several devices over torch.distributed.  Importing starts no process
group: pixel_mesh does."""

from grtrans_tpu_torch.parallel.sharding import (  # noqa: F401
    pixel_mesh, render_sharded, shard_pixels)
