"""The port's copy of config.py against the JAX package's."""

import pytest

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_torch import config as torch_config


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_presets_equal(name):
    assert (torch_config.config_to_dict(torch_config.get_config(name))
            == jax_config.config_to_dict(jax_config.get_config(name)))


def test_tiny_models_and_overrides_equal():
    assert sorted(torch_config.PRESETS) == sorted(jax_config.PRESETS)
    for family in ("ssd", "retinanet"):
        assert (torch_config.dataclasses.asdict(torch_config.tiny_test_model(family))
                == jax_config.dataclasses.asdict(jax_config.tiny_test_model(family)))
    overrides = ["model.image_size=640", "model.detect.score_threshold=0.0",
                 "train.lr_decay_steps=[100,200]"]
    got = torch_config.resolve_config("retinanet_r50_fpn", overrides)
    want = jax_config.resolve_config("retinanet_r50_fpn", overrides)
    assert torch_config.config_to_dict(got) == jax_config.config_to_dict(want)
