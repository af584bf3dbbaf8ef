"""Serving quickstart: the three inference surfaces (the port's counterpart
of ``examples/serving_quickstart.py``).

1. ``Predictor``: in-process fixed-batch serving with submit/poll overlap.
2. The int8 weight-only Predictor, and the full int8 one.
3. Export -> ``.sbdx`` artifact (``torch.export``) -> load and run with no
   model code.

Runs on the card unless given ``--device cpu``, with a tiny model:

    python -m shape_based_object_detection_torch.examples.serving_quickstart
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch import export as export_lib
    from shape_based_object_detection_torch.serving import Predictor

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    cfg = config_lib.get_config("tiny_retinanet")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (240, 320, 3)).astype(np.uint8) for _ in range(3)]

    # 1. plain Predictor: pads to the batch, returns per-image detections in
    #    original pixel coordinates
    pred = Predictor(cfg, batch_size=4, min_score=0.0, device=args.device)
    for i, det in enumerate(pred.predict(images)):
        print(f"predictor  image {i}: {len(det.scores)} detections")

    # submit/poll overlap: the device runs batch N while the host prepares N+1
    pred.submit(images)
    # ... host-side work here ...
    results = pred.poll()
    print(f"submit/poll: {sum(len(r.scores) for r in results)} detections")

    # 2. the same surface with int8 weight-only quantized weights, and the
    #    full int8 tier (int8 activations as well)
    qpred = Predictor(cfg, batch_size=4, min_score=0.0, quantize=True, device=args.device)
    qdet = qpred.predict(images)
    print(f"quantized  : {sum(len(r.scores) for r in qdet)} detections")
    fpred = Predictor(cfg, batch_size=4, min_score=0.0, quantize="full", device=args.device)
    fdet = fpred.predict(images)
    print(f"full-int8  : {sum(len(r.scores) for r in fdet)} detections")

    # 3. export: a self-contained .sbdx blob (weights and the whole detect
    #    program); loading needs no config or model code
    blob = export_lib.export_from_config(cfg, batch_size=2, quantize=True, device=args.device)
    with tempfile.TemporaryDirectory() as folder:
        path = os.path.join(folder, "tiny.sbdx")
        export_lib.save_artifact(blob, path)
        loaded = export_lib.load_artifact(path, device=args.device)
        size = loaded.header["image_size"]
        batch = np.stack([np.zeros((size, size, 3), np.uint8)] * 2)
        det = loaded(batch)
        print(f"artifact   : {path} ({len(blob) / 1e6:.1f} MB, "
              f"quantized={loaded.header['quantized']}), "
              f"output boxes {tuple(det.boxes.shape)}")


if __name__ == "__main__":
    main()
