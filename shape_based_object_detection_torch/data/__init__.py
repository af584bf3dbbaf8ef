"""Input pipeline: host decode and batching (``synthetic``, ``voc``,
``coco``, ``pipeline``), and the train-time augmentation on the device
(``augment``)."""
