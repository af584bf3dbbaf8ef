"""The port's examples, counterparts of the repository's ``examples/``:

    python -m shape_based_object_detection_torch.examples.demo [--device cpu]
    python -m shape_based_object_detection_torch.examples.serving_quickstart [--device cpu]

Each runs on the card unless given ``--device cpu``."""
