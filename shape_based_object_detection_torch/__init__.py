"""PyTorch/CUDA port of the shape-based object detector, for NVIDIA Hopper.

The JAX package ``shape_based_object_detection_tpu`` is the reference; this
package mirrors its module names and imports nothing of it. Importing it is
light: the models, the kernels and their build load only where used.

Entry points run on the card unless the caller passes ``device="cpu"``:
  - ``models.factory.build_model(cfg)`` -> (module, anchors)
  - ``detection.make_detect_fn(module, anchors, cfg)`` -> detect(images)
  - ``serving.Predictor(cfg)`` -> predict(list of images)
  - ``train.create_train_state(module, cfg)`` and
    ``train.make_train_step(module, anchors, cfg)`` -> step(state, batch),
    with the module from ``build_model(cfg.model, train=True)``
"""

__version__ = "0.1.0"
