"""Box, anchor, NMS and matching ops; ``nms_cuda`` and ``matching_cuda``
hold the CUDA kernels' wrappers."""
