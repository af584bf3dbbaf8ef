"""Data parallelism: the process group, each rank's rows, the collectives
of the train and eval steps (``mesh``)."""

from shape_based_object_detection_torch.parallel.mesh import (
    Mesh,
    initialize_multihost,
    make_mesh,
    make_mesh_for_batch,
    shutdown,
    single_process,
    spatial_image_sharding,
)
