"""Multi-GPU parallelism: one process per GPU under ``torch.distributed``.

``distributed`` starts the process group (torchrun's environment),
``mesh`` lays the ranks out as the JAX package's ``(data, model)`` mesh and
holds the collectives, and ``pipeline`` is GPipe over the model axis.
"""
from . import distributed  # noqa: F401
from .mesh import (  # noqa: F401
    MeshSpec,
    build_mesh,
    shard_batch,
    shard_params,
    param_partition_spec,
)
