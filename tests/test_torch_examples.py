"""The port's examples on the CPU (``--device cpu``): the demo overfits the
tiny RetinaNet on two synthetic images, evaluates and writes its PNGs; the
serving quickstart runs the float, weight-only int8 and full int8
Predictors and an exported artifact. Without ``--device cpu`` both run on
the card, and raise where there is none."""

import contextlib
import io

import pytest
import torch
from PIL import Image

from shape_based_object_detection_torch.examples import demo, serving_quickstart
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def test_demo_trains_evaluates_and_draws(tmp_path):
    lines = _run(demo.main, ["--steps", "3", "--out", str(tmp_path), "--device", "cpu"])
    assert lines[0] == "overfitting 3 steps on 2 synthetic images..."
    loss = float(lines[1].split("loss ")[1])
    assert lines[1].startswith("  step 0: loss ") and loss == loss  # finite
    assert lines[2].startswith("voc mAP@0.5: ")
    assert 0.0 <= float(lines[2].split(": ")[1]) <= 1.0
    for b in range(2):
        path = tmp_path / f"demo_{b}.png"
        assert lines[3 + b] == f"wrote {path}"
        with Image.open(path) as img:
            assert img.size == (128, 128) and img.mode == "RGB"


def test_serving_quickstart_runs_every_surface():
    lines = _run(serving_quickstart.main, ["--device", "cpu"])
    want = ["predictor  image 0: ", "predictor  image 1: ", "predictor  image 2: ",
            "submit/poll: ", "quantized  : ", "full-int8  : ", "artifact   : "]
    assert len(lines) == len(want)
    for line, prefix in zip(lines, want):
        assert line.startswith(prefix), line
    assert "quantized=True" in lines[-1] and "output boxes (2, 100, 4)" in lines[-1]


@pytest.mark.parametrize("main", [demo.main, serving_quickstart.main],
                         ids=["demo", "serving_quickstart"])
def test_examples_default_to_the_card(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    argv = ["--out", str(tmp_path)] if main is demo.main else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
