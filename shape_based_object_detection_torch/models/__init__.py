"""RetinaNet: ResNet backbone, FPN neck, shared heads, and the builder."""
