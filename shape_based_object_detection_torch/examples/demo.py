"""End-to-end demo: train a tiny detector on synthetic data, evaluate mAP,
run detect, and save a visualization with drawn boxes (the port's
counterpart of ``examples/demo.py``).

    python -m shape_based_object_detection_torch.examples.demo --steps 150 --out demo_out

Runs on the card unless given ``--device cpu``: the train step there runs
the matching kernel, the eval step the NMS kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def main(argv=None):
    from PIL import Image, ImageDraw

    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection
    from shape_based_object_detection_torch.eval import Evaluator
    from shape_based_object_detection_torch.models.factory import build_model

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--out", default="sbd_demo")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cfg = config_lib.get_config("tiny_retinanet")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, batch_size=2, photometric=False,
                                 expand=False, random_crop=False, hflip=False),
        train=dataclasses.replace(cfg.train, base_lr=0.02, warmup_steps=10),
        model=dataclasses.replace(
            cfg.model,
            detect=dataclasses.replace(cfg.model.detect, score_threshold=0.3,
                                       max_detections=20)),
    )
    module, anchors = build_model(cfg.model, args.device, train=True)
    state = train_lib.create_train_state(module, cfg, device=args.device)
    step_fn = train_lib.make_train_step(module, anchors, cfg, augment=False,
                                        device=args.device)

    ds = SyntheticDetection(size=cfg.model.image_size, num_images=2,
                            num_classes=cfg.model.num_classes, max_objects=2)
    loader = Loader(ds, 2, cfg.data.max_boxes, shuffle=False)
    batch = next(iter(loader.batches()))._asdict()

    print(f"overfitting {args.steps} steps on 2 synthetic images...")
    for i in range(args.steps):
        state, metrics = step_fn(state, batch)
        if i % 25 == 0:
            print(f"  step {i}: loss {float(metrics['loss']):.4f}")

    eval_fn = train_lib.make_eval_step(module, anchors, cfg, device=args.device)
    det = eval_fn(state, batch["images"])
    ev = Evaluator()
    ev.add_batch(det, batch["boxes"], batch["labels"] - 1, batch["valid"])
    print("voc mAP@0.5:", round(ev.voc()["mAP"], 4))

    s = cfg.model.image_size
    boxes, scores, labels, valid = (t.cpu().numpy() for t in det)
    for b in range(2):
        img = Image.fromarray(batch["images"][b])
        draw = ImageDraw.Draw(img)
        for box, score, label, ok in zip(boxes[b], scores[b], labels[b], valid[b]):
            if not ok:
                continue
            x0, y0, x1, y1 = (box * s).tolist()
            draw.rectangle([x0, y0, x1, y1], outline=(255, 255, 255), width=2)
            draw.text((x0 + 2, y0 + 2), f"{int(label)}:{score:.2f}", fill=(255, 255, 255))
        path = os.path.join(args.out, f"demo_{b}.png")
        img.save(path)
        print("wrote", path)


if __name__ == "__main__":
    main()
