"""The port's SSD family against the JAX package's, on the tiny preset with
the same weights (converted by the port's state_dict_from_jax_variables,
loaded strictly): forward, detect at both candidate-selection strategies,
the fresh initialisation, and the bf16 serving model's float32 L2Norm."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu import detection as jax_det
from shape_based_object_detection_tpu.ops import anchors as jax_anchors
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch import detection as torch_det
from shape_based_object_detection_torch.models.factory import (
    build_model, head_output_count,
)
from shape_based_object_detection_torch.models.vgg import L2Norm
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)
from tests.torch_parity import assert_matched, jax_variables, nhwc_to_torch, port_model


@pytest.fixture(scope="module")
def models():
    module, variables = jax_variables(jax_config.tiny_test_model("ssd"), seed=2)
    port, anchors = port_model(torch_config.tiny_test_model("ssd"), variables)
    return module, variables, port, anchors


@pytest.mark.parametrize("height,width", [(300, 300), (304, 284)])
def test_forward_parity(models, height, width):
    """atol 2e-4, rtol 1e-3, float32 with precision "highest" on both
    sides. At 300 px conv3's map is 75 x 75, odd in both dimensions, so
    the ceil-mode pool3 pads both; at 304 x 284 it is 76 x 71, even in one
    dimension and odd in the other."""
    module, variables, port, _ = models
    rng = np.random.default_rng(height + width)
    img = rng.uniform(-1, 1, (2, height, width, 3)).astype(np.float32)
    cls_j, box_j = module.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        cls_t, box_t = port(nhwc_to_torch(img))
    assert cls_t.dtype == torch.float32 and box_t.dtype == torch.float32
    assert cls_t.shape == cls_j.shape and box_t.shape == box_j.shape
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(cls_j), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(box_t.numpy(), np.asarray(box_j), atol=2e-4, rtol=1e-3)


def test_pool3_ceil_mode_per_dimension():
    """The trunk's map sizes at odd and even sizes: 300 -> 38 (75 padded),
    304 -> 38 (76), and a ragged 300 x 284 -> 38 x 36 (75 and 71 padded)."""
    trunk = build_model(torch_config.tiny_test_model("ssd"), device="cpu")[0].vgg
    with torch.no_grad():
        for (h, w), want in (((300, 300), (38, 38)), ((304, 304), (38, 38)),
                             ((300, 284), (38, 36))):
            conv4_3, conv7 = trunk(torch.zeros(1, 3, h, w))
            assert conv4_3.shape[-2:] == want and conv7.shape[-2:] == (want[0] // 2,
                                                                       want[1] // 2)


@pytest.mark.parametrize("batch", [1, 4])
def test_detect_parity(models, batch):
    """End to end on the same uint8 images: every JAX detection has a port
    counterpart with the same label, box IoU >= 0.99 and |score difference|
    <= 1e-3. At 8732 x 4 pairs batch 1 takes the single-stage selection and
    batch 4 the two-stage one; SSD's softmax scores, threshold 0.01, 400
    candidates and 200 detections."""
    module, variables, port, port_anchors = models
    jcfg, tcfg = jax_config.tiny_test_model("ssd"), torch_config.tiny_test_model("ssd")
    anchors = jax_anchors.anchors_for_model(jcfg)
    jax_detect = jax_det.make_detect_fn(module, anchors, jcfg, use_pallas=False)
    detect = torch_det.make_detect_fn(port, port_anchors, tcfg, device="cpu")
    rng = np.random.default_rng(batch)
    images = rng.integers(0, 256, (batch, 300, 300, 3), dtype=np.uint8)
    want, got = jax_detect(variables, jnp.asarray(images)), detect(images)

    def lists(det):
        return [tuple(np.asarray(t[i])[np.asarray(det.valid[i])]
                      for t in (det.boxes, det.scores, det.labels))
                for i in range(batch)]

    assert int(got.valid.sum()) >= 50 * batch  # NMS had separated scores to work on
    assert_matched(lists(got), lists(want), [1.0] * batch)


@pytest.mark.parametrize("batch", [1, 4])
def test_postprocess_same_logits(batch):
    """The same numpy logits through both postprocess functions at SSD-300's
    80 classes: 698,560 pairs take the single-stage selection at batch 1,
    the two-stage one at batch 4. Labels and valid equal, boxes and scores
    within 1e-6 (exp and softmax may differ in the last bit)."""
    jcfg = dataclasses.replace(jax_config.SSD300, precision="highest")
    tcfg = dataclasses.replace(torch_config.SSD300, precision="highest")
    anchors = np.asarray(jax_anchors.anchors_for_model(jcfg))
    rng = np.random.default_rng(10 + batch)
    a, c = anchors.shape[0], jcfg.num_classes + 1
    logits = rng.normal(0.0, 2.0, (batch, a, c)).astype(np.float32)
    offsets = rng.normal(0.0, 0.5, (batch, a, 4)).astype(np.float32)
    want = jax_det.postprocess(jnp.asarray(logits), jnp.asarray(offsets),
                               jnp.asarray(anchors), jcfg, use_pallas=False)
    got = torch_det.postprocess(torch.from_numpy(logits), torch.from_numpy(offsets),
                                torch.from_numpy(anchors.copy()), tcfg)
    assert int(got.valid.sum()) > 100 * batch
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)


def test_converted_variables_load_strictly(models):
    """Every flax leaf has its state_dict entry and back: the trunk, the
    L2Norm's 1-D scale, the extras (conv12 at 512 px) and every head."""
    _, variables, port, _ = models
    sd = state_dict_from_jax_variables(variables)
    assert set(sd) == set(port.state_dict())
    assert sd["l2norm.weight"].shape == (64,)
    np.testing.assert_array_equal(port.l2norm.weight.detach().numpy(),
                                  variables["params"]["l2norm"]["scale"])
    cfg = dataclasses.replace(jax_config.SSD512, width_mult=0.125, num_classes=20)
    _, big = jax_variables(cfg)
    module, _ = build_model(dataclasses.replace(torch_config.SSD512, width_mult=0.125,
                                                num_classes=20), device="cpu")
    module.load_state_dict(state_dict_from_jax_variables(big), strict=True)
    assert module.extras.conv12_2.kernel_size == (4, 4)


@pytest.mark.parametrize("name,count", [("ssd300", 8732),
                                        ("config3_ssd512_voc_train", 24564)])
def test_head_count_equals_anchors(name, count):
    """At full width: the head's output rows (a forward on the meta device)
    equal the priors."""
    cfg = torch_config.get_config(name).model
    module, anchors = build_model(cfg, device="cpu")
    assert anchors.shape == (count, 4) and head_output_count(cfg) == count
    assert module.cls_0.out_channels == 4 * (cfg.num_classes + 1)


def test_fresh_model_init():
    """lecun-normal kernels with zero biases on every convolution (the heads
    too), L2Norm at 20, the same weights for the same generator seed; a
    bf16 serving model computes in bf16 and keeps L2Norm in float32."""
    cfg = torch_config.tiny_test_model("ssd")
    module, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    again, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, a), b in zip(module.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(module.l2norm.weight, torch.full((64,), 20.0))
    convs = [m for m in module.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 15 + 8 + 12
    for conv in convs:
        assert not conv.bias.any()
        w = conv.weight
        assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1.0) < 0.15
    served, _ = build_model(dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    assert served.l2norm.weight.dtype == torch.float32
    assert served.vgg.conv1_1.weight.dtype == torch.bfloat16
    with torch.no_grad():
        cls_logits, box_offsets = served(torch.zeros(1, 3, 300, 300))
    assert cls_logits.dtype == torch.float32 and torch.isfinite(cls_logits).all()


def test_l2norm_keeps_bf16():
    """A bf16 input stays bf16 (norm and scale cast to it, as the
    reference); the result is x / ||x|| * scale per position."""
    norm = L2Norm(3)
    x = torch.tensor([[[[3.0]], [[0.0]], [[4.0]]]])
    np.testing.assert_allclose(norm(x).detach().numpy().ravel(), [12.0, 0.0, 16.0],
                               rtol=1e-6)
    assert norm(x.bfloat16()).dtype == torch.bfloat16
