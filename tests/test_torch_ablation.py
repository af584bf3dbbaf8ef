"""The port's accuracy tools on the CPU against the JAX package's, imported
from the repo's ``tools/`` by path: ``matching_analysis``'s table,
``ablate_matching``'s configuration, its scoring and its summary with the
``--arms-file`` resume, ``ablate_tta``'s modes and ``ablate_quantize``'s
tiers on the same weights, the label shift of the one scoring loop, and a
short ``--device cpu`` run of each tool.

The packages draw other initial weights from one seed (a PRNGKey is not a
``torch.Generator``), so trained mAPs agree only statistically: these tests
compare scoring on one set of weights, carried from the port to the JAX
package (a tiny RetinaNet trained 60 steps by ``ablate_tta``'s own loop, so
the scores mean something), and never training."""

import contextlib
import copy
import dataclasses
import io
import json
import math
import types

import jax
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import eval as ref_eval
from shape_based_object_detection_tpu import quantize as ref_quantize
from shape_based_object_detection_tpu.models import factory as ref_factory
from shape_based_object_detection_tpu.ops.anchors import anchors_for_model as ref_anchors
from shape_based_object_detection_tpu.utils import cache as ref_cache
from shape_based_object_detection_torch import quantize
from shape_based_object_detection_torch.models import factory
from shape_based_object_detection_torch.tools import (
    _ablation, ablate_matching, ablate_quantize, ablate_tta, matching_analysis,
)
from shape_based_object_detection_torch.utils.convert import state_dict_from_jax_variables
from tests.torch_parity import assert_matched, jax_variables, one_torch_thread  # noqa: F401
from tools import ablate_matching as ref_ablate_matching
from tools import ablate_quantize as ref_ablate_quantize
from tools import ablate_tta as ref_ablate_tta
from tools import matching_analysis as ref_matching_analysis

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = ["--device", "cpu"]
BATCH = ["--batch", "4"]
TRAINED_STEPS = 60


def _run(main, argv):
    """stdout and stderr of ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def _kept(monkeypatch, owner):
    """Every Evaluator that ``owner.Evaluator`` builds from here on."""
    made = []

    class Kept(owner.Evaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(owner, "Evaluator", Kept)
    return made


def _jax_variables_of(model_cfg, state_dict):
    """The flax module of ``model_cfg`` and its variables holding the port's
    ``state_dict`` (the inverse of ``state_dict_from_jax_variables``)."""
    module, shapes = jax_variables(model_cfg)

    def fill(path, _):
        collection, *mods, leaf = [p.key for p in path]
        name = ({"kernel": "weight", "bias": "bias", "scale": "weight"} if collection == "params"
                else {"mean": "running_mean", "var": "running_var"})[leaf]
        t = state_dict[".".join([*mods, name])].numpy()
        return np.ascontiguousarray(t.transpose(2, 3, 1, 0) if leaf == "kernel" else t)

    return module, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def trained():
    """A tiny RetinaNet trained 60 steps by ``ablate_tta``'s loop on the
    CPU: its config, the port's state dict and the JAX module and
    variables holding the same weights."""
    cfg = _ablation.preset_config("tiny_retinanet", 4, hflip=True)
    with contextlib.redirect_stdout(io.StringIO()):
        module, _ = _ablation.train_preset(cfg, TRAINED_STEPS, 16, "cpu", augment=True)
    sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
    jmodule, variables = _jax_variables_of(cfg.model, sd)
    back = state_dict_from_jax_variables(variables)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    return types.SimpleNamespace(cfg=cfg, sd=sd, jmodule=jmodule, variables=variables)


def _carry(monkeypatch, trained):
    """Both packages' ``build_model`` give the trained weights."""
    build = factory.build_model

    def port_build(cfg_model, device=None, **kw):
        module, anchors = build(cfg_model, device, **kw)
        module.load_state_dict(trained.sd, strict=True)
        return module, anchors

    def ref_build(cfg_model, rng=None):
        return trained.jmodule, trained.variables, ref_anchors(cfg_model)

    monkeypatch.setattr(factory, "build_model", port_build)
    monkeypatch.setattr(ref_factory, "build_model", ref_build)
    monkeypatch.setattr(ref_cache, "enable_compilation_cache", lambda *a, **k: "")


def _metrics_close(got, want, atol, keys=None):
    assert keys or set(got) == set(want)
    for key in keys or want:
        a, b = got[key], want[key]
        if isinstance(b, dict):
            _metrics_close(a, b, atol)
        elif b is None or (isinstance(b, float) and math.isnan(b)):
            assert a is None or math.isnan(a), key
        else:
            assert abs(a - b) <= atol, (key, a, b)


def _records(ev):
    return [(d.boxes, d.scores, d.labels) for d in ev.detections]


def _same_ground_truth(got, want):
    """The ground truth fed to two Evaluators equal element by element (the
    labels 0-based in both)."""
    assert got.area_scale == want.area_scale
    assert len(got.ground_truth) == len(want.ground_truth) > 0
    for g, w in zip(got.ground_truth, want.ground_truth):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.labels, w.labels)


def _same_evaluators(got, want):
    """The ground truth fed to two Evaluators equal, their detections
    matched at the repo's end-to-end bar."""
    _same_ground_truth(got, want)
    assert sum(len(d.scores) for d in want.detections) > 0
    assert_matched(_records(got), _records(want), [1.0] * len(want.detections))


# ---------------------------------------------------------------------------
# matching_analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["ssd300", "retinanet_r50_fpn"])
def test_matching_analysis_equals_jax(model):
    """The table on the model's anchors with 50 GTs, line for line, against
    the JAX tool, which runs the reference's single-image ``match_anchors``
    outside jit (the eager reference); the rows as numbers too."""
    argv = ["--model", model, "--num-gt", "50"]
    want, _ = _run(ref_matching_analysis.main, argv)
    got, _ = _run(matching_analysis.main, [*argv, *CPU])
    want_lines = want.strip().splitlines()
    got_lines = got.strip().splitlines()
    assert got_lines[:-1] == want_lines and len(want_lines) == 2 + 5
    assert json.loads(got_lines[-1]) == {"device": "cpu"}
    _, _, rows = matching_analysis.analysis_rows(model, 50, 0, "cpu")
    for (w, per_gt, covered, extreme), line in zip(rows, want_lines[2:]):
        cells = line.replace("%", "").split()
        assert [float(c) for c in cells] == [round(w, 1), round(per_gt, 2), round(covered, 1),
                                             round(extreme, 1)]


def test_matching_analysis_reproduces_the_recorded_ssd300_rows():
    """200 GTs on SSD-300's 8732 anchors: positives per GT 4.64 and 6.25
    and extreme-aspect coverage 23.4 % and 25.5 % at w = 0 and 0.3, the
    statistics the reference recorded beside its full-size ablation."""
    n, extreme, rows = matching_analysis.analysis_rows("ssd300", 200, 0, "cpu")
    by_w = {w: r for w, *r in rows}
    assert (n, extreme) == (8732, 47)
    assert [round(v, 2) for v in by_w[0.0][::2]] == [4.64, 23.40]
    assert [round(v, 2) for v in by_w[0.3][::2]] == [6.25, 25.53]


# ---------------------------------------------------------------------------
# ablate_matching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", [[], ["--model-preset", "ssd300", "--num-classes", "20",
                                       "--steps", "6000", "--batch", "16", "--lr", "1e-3",
                                       "--max-objects", "8"]],
                         ids=["tiny", "ssd300"])
@pytest.mark.parametrize("shape_weight", [0.0, 0.3])
def test_make_cfg_equals_jax(form, shape_weight):
    args = ablate_matching._parser().parse_args(form)
    ref_args = copy.deepcopy(args)
    got = ablate_matching._make_cfg(args, shape_weight)
    want = ref_ablate_matching._make_cfg(ref_args, shape_weight)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert args.family == ref_args.family


ARM = ["--steps", "0", "--train-images", "8", "--val-images", "8", "--aspect-std", "0", *BATCH]


def test_arm_scoring_equals_the_reference_loop(monkeypatch, trained):
    """``run_arm``'s scoring (no training steps) on the carried weights
    against the reference's ``run_arm`` loop: the ground truth each feeds
    its Evaluator equal (labels shifted to 0-based), every detection
    matched, and the mAP dict within 1e-6."""
    from shape_based_object_detection_tpu.eval import ap as ref_ap

    _carry(monkeypatch, trained)
    kept, ref_kept = _kept(monkeypatch, _ablation), _kept(monkeypatch, ref_ap)
    args = ablate_matching._parser().parse_args([*ARM, *CPU])
    ref_args = copy.deepcopy(args)
    with contextlib.redirect_stdout(io.StringIO()):
        got = ablate_matching.run_arm(args, 0.0, seed=7)
        want = ref_ablate_matching.run_arm(ref_args, 0.0, seed=7)
    (ev,), (ref_ev,) = kept, ref_kept
    _same_evaluators(ev, ref_ev)
    assert got["mAP"] > 0.01
    _metrics_close(got, want, 1e-6, ("mAP", "AP50", "AP75", "APsmall", "APmedium", "APlarge"))
    assert {k: got[k] for k in ("shape_weight", "seed", "class_aspect")} == {
        k: want[k] for k in ("shape_weight", "seed", "class_aspect")}
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"


@pytest.mark.parametrize("loader", [lambda val: val.batches_padded(), _ablation.whole],
                         ids=["padded", "whole"])
def test_scoring_shifts_the_labels(loader):
    """Oracle detections (each image's own ground truth, labels 0-based,
    score 1) score mAP 1 through the one scoring loop, and near 0 where
    the ground truth is not shifted to 0-based: a scorer that loses the
    shift fails here."""
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    ds = SyntheticDetection(size=64, num_images=10, max_objects=4, num_classes=3,
                            seed=2, aspect_std=1.2)
    val = Loader(ds, 4, 8, shuffle=False)
    batches = list(loader(val))

    def oracle():
        it = iter(batches)

        def detect(images):
            batch, _ = next(it)
            assert images is batch.images
            return types.SimpleNamespace(boxes=batch.boxes, scores=batch.valid.astype(np.float32),
                                         labels=batch.labels - 1, valid=batch.valid)
        return detect

    ev = _ablation.score(oracle(), batches, 64.0)
    assert len(ev.ground_truth) == (8 if loader is _ablation.whole else 10)
    assert ev.coco()["mAP"] == pytest.approx(1.0) and ev.voc()["mAP"] == pytest.approx(1.0)
    unshifted = _ablation.score(oracle(), [(types.SimpleNamespace(
        images=b.images, boxes=b.boxes, labels=b.labels + 1, valid=b.valid), n)
        for b, n in batches], 64.0)
    assert unshifted.coco()["mAP"] < 0.5


def _fake_arm(args, shape_weight, seed=7):
    """A deterministic arm result of the reference's keys."""
    base = 0.02 if args.lr < 0.001 else 0.5
    m = base + 0.01 * (seed - 7) + (0.003 if shape_weight else 0.0) * (1 + (seed % 2))
    return {"shape_weight": shape_weight, "seed": seed, "class_aspect": args.class_aspect,
            "mAP": m, "AP50": m + 0.1, "AP75": m - 0.1, "APsmall": m / 2, "APmedium": None,
            "APlarge": None, "final_loss": 1.0 + seed, "train_s": 1.5}


@pytest.mark.parametrize("lr", ["0.01", "0.0005"], ids=["resolving", "below_0.05"])
def test_main_summary_and_arms_file_resume(tmp_path, monkeypatch, lr):
    """Both packages' ``main`` over the same fake arms: the final JSON equal
    apart from "note" and "device", the table equal, the warning when both
    arms score under 0.05 in both; then a resume from an arms file holding
    two finished arms (and one of another ``class_aspect``) runs only the
    missing arms, in both."""
    calls = {"port": [], "ref": []}

    def fake(which):
        def run(args, w, seed=7):
            calls[which].append((seed, w))
            return _fake_arm(args, w, seed)
        return run

    monkeypatch.setattr(ablate_matching, "run_arm", fake("port"))
    monkeypatch.setattr(ref_ablate_matching, "run_arm", fake("ref"))
    argv = ["--seeds", "3", "--lr", lr]
    outs = {}
    for which, main, extra in (("port", ablate_matching.main, CPU),
                               ("ref", ref_ablate_matching.main, [])):
        arms = tmp_path / f"{which}.jsonl"
        outs[which] = _run(main, [*argv, "--arms-file", str(arms), *extra])
        assert len(arms.read_text().splitlines()) == 6
    (got, got_err), (want, want_err) = outs["port"], outs["ref"]
    got_json, want_json = json.loads(got.splitlines()[-1]), json.loads(want.splitlines()[-1])
    assert got_json.pop("device") == "cpu"
    got_json.pop("note"), want_json.pop("note")
    assert got_json == want_json and got_json["metric"] == "shape_matching_map_delta_synthetic"
    assert got.splitlines()[:-1] == want.splitlines()[:-1]
    assert ("WARNING" in got_err) == ("WARNING" in want_err) == (lr == "0.0005")
    assert calls["port"] == calls["ref"] == [(s, w) for s in (7, 8, 9) for w in (0.0, 0.3)]

    for which, main, extra in (("port", ablate_matching.main, CPU),
                               ("ref", ref_ablate_matching.main, [])):
        calls[which].clear()
        arms = tmp_path / f"resume_{which}.jsonl"
        args = types.SimpleNamespace(class_aspect=0.0, lr=float(lr))
        other = dict(_fake_arm(args, 0.3, 8), class_aspect=0.5, mAP=0.9)
        arms.write_text("".join(json.dumps(r) + "\n" for r in (
            _fake_arm(args, 0.0, 7), other, _fake_arm(args, 0.3, 8))))
        outs[which] = _run(main, [*argv, "--arms-file", str(arms), *extra])
        assert calls[which] == [(7, 0.3), (8, 0.0), (9, 0.0), (9, 0.3)]
        assert len(arms.read_text().splitlines()) == 3 + 4
    (got, _), (want, _) = outs["port"], outs["ref"]
    assert "resuming: 2 arm(s) loaded from" in got and got.count("(cached)") == 2
    got_json, want_json = json.loads(got.splitlines()[-1]), json.loads(want.splitlines()[-1])
    for j in (got_json, want_json):
        j.pop("note"), j.pop("device", None)
    assert got_json == want_json


# ---------------------------------------------------------------------------
# ablate_tta and ablate_quantize on carried weights
# ---------------------------------------------------------------------------

TOOL = ["--config", "tiny_retinanet", "--steps", "0", "--train-images", "8",
        "--eval-images", "8", *BATCH]


def _json_lines(text, key):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and key in json.loads(line)]


def test_tta_modes_equal_jax(monkeypatch, trained):
    """``ablate_tta`` (no training steps) on the carried weights: plain,
    hflip, multi-scale (128, 160) and multi-scale with hflip, each mode's
    ground truth equal to the JAX tool's, its detections matched and its
    COCO and VOC metrics within 1e-6; the printed rows as the JAX tool's."""
    _carry(monkeypatch, trained)
    kept, ref_kept = _kept(monkeypatch, _ablation), _kept(monkeypatch, ref_eval)
    want, _ = _run(ref_ablate_tta.main, TOOL)
    got, _ = _run(ablate_tta.main, [*TOOL, *CPU])
    assert len(kept) == len(ref_kept) == 4
    for ev, ref_ev in zip(kept, ref_kept):
        _same_evaluators(ev, ref_ev)
        _metrics_close(ev.coco(), ref_ev.coco(), 1e-6)
        _metrics_close(ev.voc(), ref_ev.voc(), 1e-6, ["mAP"])
    rows, ref_rows = _json_lines(got, "mode"), _json_lines(want, "mode")
    assert [r["mode"] for r in rows] == [r["mode"] for r in ref_rows] == [
        "plain", "hflip-tta", "ms-tta[128, 160]", "ms+hflip-tta"]
    assert rows[0]["coco_mAP"] > 0.01
    for r, w in zip(rows, ref_rows):
        for k in ablate_tta.SCORE_KEYS:
            assert abs(r[k] - w[k]) <= 1e-4 + 1e-9, (r, w)
    assert _json_lines(got, "device") == [{"device": "cpu"}]


# The full int8 tiers quantize every activation to 8 bits: an input that the
# jitted JAX forward computes one ulp away (XLA contracts multiply-adds into
# FMAs on the CPU) can land on the neighbouring int8 step, and that step
# moves its convolution's outputs by a whole quantum (ROADMAP.md §3). A
# detection's score then moves by far more than the float tiers' last bits
# and can reorder near-ties in the precision-recall sweep: on these weights
# the static tier's COCO mAP differs from the JAX tool's by 1.5e-5 (the
# dynamic tier's not at all). The full tiers' metrics are held within 1e-4,
# from that reading and under the gaps between tiers the tool reports; the
# float and weight-only tiers (no activation quantizer) within 1e-6.
FULL_TIER_MAP_ATOL = 1e-4


def _keep_scales(monkeypatch, owner, kept, which):
    """Record the scales that ``owner.calibrate_activation_scales`` returns."""
    calibrate = owner.calibrate_activation_scales

    def keep(*a, **k):
        kept[which] = calibrate(*a, **k)
        return kept[which]

    monkeypatch.setattr(owner, "calibrate_activation_scales", keep)


def test_quantize_tiers_equal_jax(monkeypatch, trained):
    """``ablate_quantize`` (no training steps) on the carried weights:
    the static scales calibrated on the same 2 batches equal the JAX
    tool's (keys equal, values within 1e-5 relative, as
    test_calibration_equals_jax holds them); float and weight-only within
    1e-6 of the JAX tool's COCO and VOC metrics with their detections
    matched, the full tiers' mAP within FULL_TIER_MAP_ATOL; the same
    ground truth in every tier; the full-static tier's detections not the
    full-dynamic tier's, in both packages, so a static tier that drops its
    scales fails."""
    cfg = trained.cfg
    _carry(monkeypatch, trained)
    kept, ref_kept = _kept(monkeypatch, _ablation), _kept(monkeypatch, ref_eval)
    scales = {}
    _keep_scales(monkeypatch, quantize, scales, "port")
    _keep_scales(monkeypatch, ref_quantize, scales, "ref")
    want, _ = _run(ref_ablate_quantize.main, TOOL)
    got, _ = _run(ablate_quantize.main, [*TOOL, *CPU])
    assert set(scales["port"]) == set(scales["ref"]) and len(scales["ref"]) > 5
    for key, value in scales["ref"].items():
        assert abs(scales["port"][key] - value) <= 1e-5 * abs(value), key
    assert len(kept) == len(ref_kept) == 4
    for (name, _, _), ev, ref_ev in zip(ablate_quantize.TIERS, kept, ref_kept):
        if name in ("float", "weights"):
            _same_evaluators(ev, ref_ev)
            _metrics_close(ev.coco(), ref_ev.coco(), 1e-6)
            _metrics_close(ev.voc(), ref_ev.voc(), 1e-6, ["mAP"])
        else:
            _same_ground_truth(ev, ref_ev)
            _metrics_close(ev.coco(), ref_ev.coco(), FULL_TIER_MAP_ATOL, ["mAP", "AP50"])
            _metrics_close(ev.voc(), ref_ev.voc(), FULL_TIER_MAP_ATOL, ["mAP"])
    for evs in (kept, ref_kept):
        dynamic, static = _records(evs[2]), _records(evs[3])
        assert any(len(a) != len(b) or not np.array_equal(a, b)
                   for u, v in zip(dynamic, static) for a, b in zip(u, v))
    rows, ref_rows = _json_lines(got, "tier"), _json_lines(want, "tier")
    assert [r["tier"] for r in rows] == [r["tier"] for r in ref_rows]
    assert rows[0]["coco_mAP"] > 0.01 and cfg.data.hflip
    assert "max |coco mAP drift| vs float: " in got


def test_float_tier_is_the_plain_mode(trained):
    """The float tier and ablate_tta's plain mode are one detect path: the
    same records, to the bit."""
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = trained.cfg
    module, _ = build_model(cfg.model, "cpu", train=True)
    module.load_state_dict(trained.sd, strict=True)
    serving, anchors = _ablation.serving_module(cfg.model, module, "cpu")
    _, loader = _ablation.eval_split(cfg, 8)
    plain = ablate_tta.score_mode(cfg, serving, anchors, loader, False, "cpu")
    tier = ablate_quantize.score_tier(cfg, serving, anchors, loader, "", None, "cpu")
    for a, b in zip(_records(plain), _records(tier)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    _metrics_close(plain.coco(), tier.coco(), 0.0)


# ---------------------------------------------------------------------------
# a short run of each tool
# ---------------------------------------------------------------------------


def _finite(values):
    return all(v is None or math.isfinite(v) for v in values)


@pytest.mark.parametrize("tool", ["matching_analysis", "ablate_matching", "ablate_tta",
                                  "ablate_quantize"])
def test_two_step_cpu_run_ends_with_finite_metrics(tool, tmp_path):
    if tool == "matching_analysis":
        rows = matching_analysis.main(["--model", "tiny_retinanet", "--num-gt", "20", *CPU])
        assert len(rows) == 5 and all(_finite(r) for r in rows)
        return
    common = ["--steps", "2", *BATCH, *CPU]
    if tool == "ablate_matching":
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            out = ablate_matching.main([*common, "--seeds", "1", "--train-images", "8",
                                        "--val-images", "8", "--loader", "device",
                                        "--cache-dir", str(tmp_path)])
        assert [(a["seed"], a["shape_weight"]) for a in out["arms"]] == [(7, 0.0), (7, 0.3)]
        assert all(_finite([a[k] for k in ("mAP", "AP50", "final_loss")]) for a in out["arms"])
        assert math.isfinite(out["value"]) and out["device"] == "cpu"
        return
    main = ablate_tta.main if tool == "ablate_tta" else ablate_quantize.main
    with contextlib.redirect_stdout(io.StringIO()):
        rows = main([*common, "--train-images", "8", "--eval-images", "8"])
    assert len(rows) == 4 and all(_finite(r.values()) for r in rows.values())
