"""Box, anchor and NMS ops; ``nms_cuda`` holds the CUDA kernel's wrapper."""
