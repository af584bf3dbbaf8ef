"""The benchmark's frozen arithmetic: the FLOP counts against a count of
the program's convolutions, the kernel bounds against chip_smoke.py's
constants."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from benchmark.harness import flops, roofline
from benchmark.tests.tiny import BENCH, tiny_experiment


def conv_macs_by_hooks(model_cfg) -> int:
    """Multiply-adds of every convolution of the program's module, from
    forward hooks on the meta device (shapes only)."""
    from shape_based_object_detection_torch.models.factory import build_module

    total = [0]

    def hook(mod, args, out):
        w = mod.weight
        total[0] += out.shape[2] * out.shape[3] * out.shape[1] * w.shape[1] * w.shape[2] * w.shape[3]

    with torch.device("meta"):
        module = build_module(model_cfg)
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.register_forward_hook(hook)
        module(torch.empty(1, 3, model_cfg.image_size, model_cfg.image_size))
    return total[0]


@pytest.mark.parametrize("config", ["retinanet_r50_fpn_512_bf16", "ssd512_vgg16_voc_fp32"])
@pytest.mark.parametrize("tiny", [False, True])
def test_flops_equal_a_count_of_the_program_convolutions(config, tiny):
    from shape_based_object_detection_torch.config import config_from_dict

    exp = json.loads((BENCH / "configs" / f"{config}.json").read_text())["experiment"]
    if tiny:
        exp = tiny_experiment(exp, 2)
    model = dataclasses.replace(config_from_dict(exp).model, dtype="float32")  # shapes only
    macs = conv_macs_by_hooks(model)
    assert flops.forward_flops(exp["model"]) == 2 * macs
    assert flops.train_flops(exp["model"]) == 6 * macs


def test_full_size_flops_per_image():
    """R50-FPN-512: 61.0 G multiply-adds; SSD-512: 90.2 G."""
    for config, gflop in (("retinanet_r50_fpn_512_bf16", 122.046), ("ssd512_vgg16_voc_fp32", 180.416)):
        exp = json.loads((BENCH / "configs" / f"{config}.json").read_text())["experiment"]
        assert flops.forward_flops(exp["model"]) / 1e9 == pytest.approx(gflop, abs=1e-3)


def test_kernel_bounds_keep_chip_smoke_constants():
    import chip_smoke

    for name in ("HBM_BYTES_PER_S", "FP32_FLOPS", "NMS_OPS_PER_ELEMENT", "MATCH_OPS_PER_PAIR",
                 "MATCH_SHAPE_OPS_PER_PAIR", "MATCH_SHAPE_OPS_PER_BOX"):
        assert getattr(roofline, name) == getattr(chip_smoke, name), name
    # K1 at the serving shape, 100 kept per image: operations bound it
    b, n, m = 16, 1000, 100
    ops = 16 * 100 * n * 15
    assert roofline.nms_bound_s(b, n, m, [100] * b) == pytest.approx(ops / 67e12)
    # fewer kept: one more step per image, the one that finds none
    assert roofline.nms_bound_s(1, n, m, [40]) == pytest.approx(41 * n * 15 / 67e12)
    # K2 at SSD-512's shape with the shape term: chip_smoke's timing row, 0.01454 ms
    assert roofline.match_bound_s(32, 24564, 100, 1469, 0.3) * 1e3 == pytest.approx(0.01454, abs=1e-5)
    # and at R50's (16, 49104, 64), w = 0: bytes bound it, 0.00681 ms
    assert roofline.match_bound_s(16, 49104, 64, 100, 0.0) * 1e3 == pytest.approx(0.00681, abs=1e-5)


def test_peaks_follow_the_configuration_precision():
    assert roofline.peak_flops({"dtype": "bfloat16", "precision": "default"}) == 989e12
    assert roofline.peak_flops({"dtype": "float32", "precision": "default"}) == 495e12
    assert roofline.peak_flops({"dtype": "float32", "precision": "highest"}) == 67e12
