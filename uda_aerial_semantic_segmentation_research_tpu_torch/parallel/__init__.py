"""Data parallelism across processes, one per GPU.

Counterpart of the JAX package's ``parallel`` package.  There the train
steps are written once for the global batch and XLA's partitioner inserts
the gradient ``psum`` and the cross-replica BatchNorm sums over one global
mesh.  PyTorch's counterpart is one process per GPU, each holding a copy of
the state and feeding its rows of the global batch: ``distributed`` owns the
process group and the collectives that the port places itself (BatchNorm
sums, gradient average, global metrics); ``mesh`` is the 1-D data axis over
the processes and its placement helpers; ``spatial`` is the height-sharded
eval forward (``spatial_mesh``, ``spatial_image_sharding``,
``spatial_forward``): a tile split by rows over the processes, each layer
fetching its neighbours' boundary rows.
"""

from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    default_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.spatial import (
    spatial_forward,
    spatial_image_sharding,
    spatial_mesh,
)

__all__ = [
    "create_mesh",
    "default_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "spatial_mesh",
    "spatial_image_sharding",
    "spatial_forward",
    "distributed",
]
