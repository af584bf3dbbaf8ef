"""Data parallelism and the model axis: the process group, each rank's
rows, the collectives of the train and eval steps (``mesh``), and the image
rows split across the ranks of a model group (``spatial``)."""

from shape_based_object_detection_torch.parallel.mesh import (
    Mesh,
    initialize_multihost,
    make_mesh,
    make_mesh_for_batch,
    shutdown,
    single_process,
    spatial_image_sharding,
)
from shape_based_object_detection_torch.parallel.spatial import (
    RowConv2d,
    RowShard,
    gather_rows,
    halo_exchange,
    row_conv2d,
    row_max_pool2d,
    row_upsample_nearest,
    set_row_shard,
)
