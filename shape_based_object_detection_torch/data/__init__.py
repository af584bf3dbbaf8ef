"""Training data on the device: ``augment`` (the train-time augmentation)."""
