"""Data parallelism in the port (``parallel/mesh.py`` and the train step,
eval and checkpoints under a process group), on a gloo group of two ranks
on the CPU, started once for the module (``torch.multiprocessing`` with a
``file://`` store under the test's directory) and returning every check's
numbers from that one start, against the reference's own checks
(``tests/test_parallel.py``):

- two steps of each case on two ranks of b/2 each equal the port's
  single-process steps on the global b (loss 1e-5 relative, grad_norm
  1e-4, as ``test_sharded_equals_single_device`` holds JAX; the other
  metrics 1e-5 and the parameters within 2e-5, ``test_torch_train.py``'s
  bound), and, augmentation off, the JAX package's ``train_step`` on the
  global batch at ``test_torch_train.py``'s tolerance (metrics 1e-5
  relative, parameters 2e-5; with ``train_bn`` BatchNorm's running
  statistics within ``test_torch_remat_bn.py``'s 1e-4). Cases: focal and
  multibox, ``train_bn`` on and off, augmentation on and off, remat;
- the parameters, buffers and augmentation generators after the steps are
  bit-identical across ranks, rank 1 having started from other weights, a
  reseeded generator and another step count (``broadcast_state``);
- a sharded eval of 18 images covers all 18 in the single process's order
  and gives both ranks its mAP;
- a checkpoint written by rank 0 restores alike on both ranks;
- the sharded int8 detect (weight-only and full) equals the unsharded one
  within ``test_quantized_detect_sharded_equals_single_device``'s bounds;
- ``make_mesh_for_batch`` raises on an indivisible batch and model axis,
  and a model axis over the two ranks lays them out as the reference's
  mesh (the model axis itself is held by ``tests/test_torch_spatial.py``).

The ranks import only torch and the port; JAX runs in the test process.
"""

import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests.torch_parity import one_torch_thread  # noqa: F401

# the single-process steps beside the ranks: one intra-op thread each, as
# the ranks take, so that they do not contend with the other test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLD = 2
GLOBAL_B = 4
STEPS = 2
EVAL_IMAGES = 18
RANK_TIMEOUT_S = 300

# name: (family, loss, augment, train_bn, remat, compared with JAX)
CASES = {
    "focal": ("retinanet", "focal", False, False, False, True),
    "focal_train_bn": ("retinanet", "focal", False, True, False, True),
    "focal_train_bn_remat_augment": ("retinanet", "focal", True, True, True, False),
    "multibox": ("ssd", "multibox", False, False, False, True),
    "multibox_augment": ("ssd", "multibox", True, False, False, False),
}


def _rank_main(rank, plan_path, out_dir):
    """One rank: every check of the module, its numbers to
    ``rank{rank}.pt``. Imports nothing of JAX."""
    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.checkpoint import CheckpointManager
    from shape_based_object_detection_torch.cli.train_cli import evaluate
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops.nms import Detections
    from shape_based_object_detection_torch.parallel import (
        make_mesh, make_mesh_for_batch, spatial_image_sharding,
    )
    from shape_based_object_detection_torch.parallel.mesh import (
        all_gather_rows, broadcast_state,
    )
    from shape_based_object_detection_torch.quantize import make_serving_detect

    torch.set_num_threads(1)
    plan = torch.load(plan_path, weights_only=False)
    dist.init_process_group("gloo", init_method="file://" + plan["store"], rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh("cpu")
        out = {"rows": mesh.rows(GLOBAL_B)}
        for name, case in plan["cases"].items():
            cfg = case["cfg"]
            module, anchors = build_model(cfg.model, "cpu", train=True)
            module.load_state_dict(case["weights"])
            state = train.create_train_state(module, cfg, device="cpu")
            if rank == 1:  # another start, which broadcast_state must undo
                with torch.no_grad():
                    for p in module.parameters():
                        p.add_(0.5)
                state.generator.manual_seed(999)
                state.step = 7
            state = broadcast_state(state, mesh)
            step = train.make_train_step(module, anchors, cfg, augment=case["augment"],
                                         device="cpu", mesh=mesh)
            metrics = []
            for batch in case["batches"]:
                state, m = step(state, {k: v[mesh.rows(GLOBAL_B)] for k, v in batch.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            out[name] = {"metrics": metrics, "step": state.step,
                         "state": {k: v.clone() for k, v in module.state_dict().items()},
                         "generator": state.generator.get_state()}
            if name == "focal":
                # rank 0 writes; every rank restores the same step alike
                ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"), mesh=mesh)
                ckpt.save(state)
                ckpt.close()
                fresh, _ = build_model(cfg.model, "cpu", train=True)
                restored = CheckpointManager(os.path.join(out_dir, "ckpt"), mesh=mesh) \
                    .restore_latest(train.create_train_state(fresh, cfg, device="cpu"))
                out["ckpt"] = {"step": restored.step,
                               "state": {k: v.clone() for k, v in fresh.state_dict().items()}}

        ecfg = plan["eval_cfg"]
        module, anchors = build_model(ecfg.model, "cpu")
        module.load_state_dict(plan["eval_weights"])
        eval_step = train.make_eval_step(module, anchors, ecfg, device="cpu", mesh=mesh)
        loader = Loader(SyntheticDetection(size=ecfg.model.image_size, num_images=EVAL_IMAGES,
                                           num_classes=ecfg.model.num_classes),
                        GLOBAL_B, ecfg.data.max_boxes, shuffle=False)
        ev = evaluate(eval_step, train.create_train_state(module, ecfg, device="cpu"),
                      loader, ecfg, torch.device("cpu"), mesh=mesh)
        out["eval"] = {"mAP": ev.voc()["mAP"], "records": ev.ground_truth,
                       "detections": ev.detections}

        images = torch.from_numpy(plan["int8_images"])
        out["int8"] = {}
        for mode in ("weights", "full"):
            module, anchors = build_model(ecfg.model, "cpu")
            module.load_state_dict(plan["eval_weights"])
            detect, _ = make_serving_detect(module, anchors, ecfg.model, ecfg.data, mode, "cpu")
            det = detect(images[mesh.rows(len(images))])
            out["int8"][mode] = Detections(*all_gather_rows(det, mesh))

        raised = {}
        for what, fn in (
                ("indivisible batch", lambda: make_mesh_for_batch(3, mesh)),
                ("model_parallelism=3", lambda: make_mesh_for_batch(
                    GLOBAL_B, mesh, config.MeshConfig(model_parallelism=3)))):
            try:
                fn()
                raised[what] = None
            except (ValueError, NotImplementedError) as e:
                raised[what] = (type(e).__name__, str(e))
        # the model axis over both ranks: one data index of two rows' ranks
        axis = config.MeshConfig(model_parallelism=2)
        spatial = make_mesh("cpu", axis)
        shard = spatial_image_sharding(spatial, axis)
        out["model_axis"] = {
            "per_index": make_mesh_for_batch(GLOBAL_B, mesh, axis),
            "layout": (spatial.data_index, spatial.model_index, spatial.data_size,
                       spatial.rows(GLOBAL_B), spatial.data_group is None),
            "shard": (shard.index, shard.size, shard.group is spatial.model_group),
        }
        out["raised"] = raised
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _configs(name):
    from tests.torch_parity import tiny_configs

    family, loss, augment, train_bn, remat, _ = CASES[name]
    match = (dict(pos_threshold=0.5, neg_threshold=0.5, shape_weight=0.3, shape_tau=1.0)
             if family == "ssd" else
             dict(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True))
    return tiny_configs(
        family, model=dict(train_bn=train_bn, remat=remat),
        data=dict(batch_size=GLOBAL_B, max_boxes=4),
        train=dict(base_lr=0.05, warmup_steps=1, weight_decay=1e-2, grad_clip_norm=0.5,
                   lr_decay_steps=(100,)),
        match=match, loss=dict(kind=loss, neg_pos_ratio=3.0))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The plan (configs, weights, batches) and both ranks' results."""
    from tests.torch_parity import focal_weights, gt_batch, jax_train_steps, tiny_configs

    root = tmp_path_factory.mktemp("dp")
    cases = {}
    for i, name in enumerate(CASES):
        j_cfg, t_cfg = _configs(name)
        variables, weights = focal_weights(j_cfg, seed=20 + i)
        size, classes = t_cfg.model.image_size, t_cfg.model.num_classes
        batches = [gt_batch(40 + 10 * i + s, GLOBAL_B, 4, size, classes) for s in range(STEPS)]
        cases[name] = {"cfg": t_cfg, "j_cfg": j_cfg, "variables": variables,
                       "weights": weights, "batches": batches, "augment": CASES[name][2]}
    j_eval, t_eval = tiny_configs("retinanet", data=dict(batch_size=GLOBAL_B, max_boxes=8))
    t_eval = dataclasses.replace(t_eval, model=dataclasses.replace(
        t_eval.model, detect=dataclasses.replace(t_eval.model.detect, score_threshold=0.0)))
    from shape_based_object_detection_torch.utils.convert import (
        state_dict_from_jax_variables,
    )
    from tests.torch_parity import jax_variables

    # widened classifier heads: scores spread away from the prior
    eval_weights = state_dict_from_jax_variables(jax_variables(j_eval.model, seed=30)[1])
    plan = {"store": str(root / "store"),
            "cases": {k: {kk: v for kk, v in c.items() if kk not in ("j_cfg", "variables")}
                      for k, c in cases.items()},
            "eval_cfg": t_eval, "eval_weights": eval_weights,
            "int8_images": np.random.default_rng(3).integers(
                0, 255, (8, 128, 128, 3), dtype=np.uint8)}
    plan_path = str(root / "plan.pt")
    torch.save(plan, plan_path)
    ctx = mp.start_processes(_rank_main, args=(plan_path, str(root)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        # the reference's steps, while the ranks run
        for name, case in cases.items():
            if CASES[name][-1]:
                case["jax"] = jax_train_steps(case)
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(str(root / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    plan["cases"] = cases
    return plan, ranks


def _single_process(case, order=None):
    """The port's steps on the global batch (its rows in ``order``) in one
    process: metrics, state dict and generator state."""
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = case["cfg"]
    module, anchors = build_model(cfg.model, "cpu", train=True)
    module.load_state_dict(case["weights"])
    state = train.create_train_state(module, cfg, device="cpu")
    step = train.make_train_step(module, anchors, cfg, augment=case["augment"], device="cpu")
    metrics = []
    for batch in case["batches"]:
        if order is not None:
            batch = {k: v[order] for k, v in batch.items()}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, module.state_dict(), state.generator.get_state()


def _bounds(name, case, metrics, state):
    """({metric: rtol}, parameter atol) of a comparison with the single
    process's steps: grad_norm 1e-4, the loss terms 1e-5, the parameters
    2e-5. With trainable BatchNorm the single process's own results move
    with the order of its sums (the batch statistics' sums and BatchNorm's
    backward, g - mean(g) - x_hat * mean(g * x_hat), cancel): there each
    bound is twice the largest move of the single process's steps on the
    same batch in two other row orders (the ranks' halves swapped, and the
    rows swapped in pairs), and never below the frozen cases'."""
    rtol = {k: 1e-4 if k == "grad_norm" else 1e-5 for k in metrics[0]}
    atol = 2e-5
    if not CASES[name][3]:
        return rtol, atol
    half = GLOBAL_B // 2
    for order in (list(range(half, GLOBAL_B)) + list(range(half)),
                  [i ^ 1 for i in range(GLOBAL_B)]):
        other, other_state, _ = _single_process(case, order)
        for k in rtol:
            rtol[k] = max([rtol[k]] + [2 * abs(o[k] - m[k]) / max(abs(m[k]), 1e-12)
                                       for o, m in zip(other, metrics)])
        atol = max([atol] + [2 * float((other_state[k] - v).abs().max())
                             for k, v in state.items()])
    return rtol, atol


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_equals_single_process_step(dp, name):
    plan, ranks = dp
    case = plan["cases"][name]
    metrics, state, generator = _single_process(case)
    rtol, param_atol = _bounds(name, case, metrics, state)
    got = ranks[0][name]
    assert got["step"] == STEPS
    for s, (g, w) in enumerate(zip(got["metrics"], metrics)):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol[key],
                                       err_msg=f"{key} step {s}")
    assert got["metrics"][-1]["num_pos"] > 0
    for k, w in state.items():
        np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), rtol=0,
                                   atol=param_atol, err_msg=k)
    moved = max(float((state[k] - case["weights"][k]).abs().max()) for k in case["weights"])
    assert moved > 1e-3
    # the ranks drew the global batch's augmentation: in step with a single
    # process's generator
    assert torch.equal(got["generator"], generator)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_end_bit_identical(dp, name):
    _, ranks = dp
    a, b = ranks[0][name], ranks[1][name]
    assert a["metrics"] == b["metrics"]
    assert a["step"] == b["step"]
    assert set(a["state"]) == set(b["state"])
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert torch.equal(a["generator"], b["generator"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[-1]])
def test_two_rank_step_equals_jax_global_step(dp, name):
    """Metrics at ``test_torch_train.py``'s 1e-5 and the parameters at its
    2e-5. With ``train_bn``, at ``test_torch_remat_bn.py``'s bound for the
    statistics, 1e-4, on the loss terms and the running statistics: the two
    packages' float32 sums through the backbone, taken in other orders,
    part beyond 1e-5 (the single-process port's loss is 5.8e-5 from the
    reference's on the first batch here), and the gradients move with the
    order of sums (see ``_bounds``)."""
    plan, ranks = dp
    case = plan["cases"][name]
    want_metrics, want = case["jax"]
    got = ranks[0][name]
    train_bn = CASES[name][3]
    keys = ("loss", "loss_cls", "loss_box", "num_pos") + (() if train_bn else ("grad_norm",))
    for s, w in enumerate(want_metrics):
        for key in keys:
            np.testing.assert_allclose(got["metrics"][s][key], w[key],
                                       rtol=1e-4 if train_bn else 1e-5,
                                       err_msg=f"{key} step {s}")
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        elif not train_bn:
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), rtol=0,
                                       atol=2e-5, err_msg=k)
    if train_bn:  # the running statistics moved
        assert any(not torch.equal(got["state"][k], case["weights"][k])
                   for k in want if k.endswith("running_mean"))


def test_sharded_eval_covers_the_split_with_the_single_process_map(dp):
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.cli.train_cli import evaluate
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection
    from shape_based_object_detection_torch.models.factory import build_model

    plan, ranks = dp
    cfg = plan["eval_cfg"]
    module, anchors = build_model(cfg.model, "cpu")
    module.load_state_dict(plan["eval_weights"])
    loader = Loader(SyntheticDetection(size=cfg.model.image_size, num_images=EVAL_IMAGES,
                                       num_classes=cfg.model.num_classes),
                    GLOBAL_B, cfg.data.max_boxes, shuffle=False)
    ev = evaluate(train.make_eval_step(module, anchors, cfg, device="cpu"),
                  train.create_train_state(module, cfg, device="cpu"), loader, cfg,
                  torch.device("cpu"))
    want = ev.voc()["mAP"]
    assert want > 0
    for r in ranks:
        got = r["eval"]
        assert len(got["records"]) == EVAL_IMAGES
        assert [g.image_id for g in got["records"]] == [g.image_id for g in ev.ground_truth]
        for g, w in zip(got["records"], ev.ground_truth):
            np.testing.assert_array_equal(g.boxes, w.boxes)
            np.testing.assert_array_equal(g.labels, w.labels)
        for g, w in zip(got["detections"], ev.detections):
            np.testing.assert_array_equal(g.labels, w.labels)
            np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(g.boxes, w.boxes, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["mAP"], want, rtol=1e-6)
    assert ranks[0]["eval"]["mAP"] == ranks[1]["eval"]["mAP"]


def test_rank0_checkpoint_restores_alike_on_both_ranks(dp):
    _, ranks = dp
    for r in ranks:
        assert r["ckpt"]["step"] == STEPS
        for k, v in r["focal"]["state"].items():
            assert torch.equal(r["ckpt"]["state"][k], v), k
    for k in ranks[0]["ckpt"]["state"]:
        assert torch.equal(ranks[0]["ckpt"]["state"][k], ranks[1]["ckpt"]["state"][k]), k


def test_sharded_int8_detect_equals_unsharded(dp):
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.quantize import make_serving_detect

    plan, ranks = dp
    cfg = plan["eval_cfg"]
    images = torch.from_numpy(plan["int8_images"])
    for mode in ("weights", "full"):
        module, anchors = build_model(cfg.model, "cpu")
        module.load_state_dict(plan["eval_weights"])
        detect, _ = make_serving_detect(module, anchors, cfg.model, cfg.data, mode, "cpu")
        ref = detect(images)
        for r in ranks:
            out = r["int8"][mode]
            assert out.valid.shape == ref.valid.shape
            if mode == "weights":
                np.testing.assert_allclose(out.boxes, ref.boxes, atol=1e-5)
                np.testing.assert_allclose(out.scores, ref.scores, atol=1e-5)
                np.testing.assert_array_equal(out.valid, ref.valid)
            else:
                np.testing.assert_allclose(out.boxes, ref.boxes, atol=2e-2)
                np.testing.assert_allclose(out.scores, ref.scores, atol=2e-2)
                assert (out.valid == ref.valid).float().mean() > 0.95


def test_mesh_for_batch_raises_and_the_model_axis_splits_the_rows(dp):
    """``make_mesh_for_batch`` raises on an indivisible batch and model
    axis; with ``model_parallelism=2`` over the two ranks it returns the
    per-data-index batch (the whole global batch: one data index), both
    ranks load the same rows, and ``spatial_image_sharding`` gives each its
    place on the model axis. A single process has no model axis to split."""
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.parallel import (
        Mesh, make_mesh, make_mesh_for_batch, single_process, spatial_image_sharding,
    )

    _, ranks = dp
    assert [r["rows"] for r in ranks] == [slice(0, 2), slice(2, 4)]
    for i, r in enumerate(ranks):
        raised = r["raised"]
        assert raised["indivisible batch"][0] == "ValueError"
        assert "not divisible by the data-axis size 2" in raised["indivisible batch"][1]
        assert raised["model_parallelism=3"][0] == "ValueError"
        assert r["model_axis"]["per_index"] == GLOBAL_B
        assert r["model_axis"]["layout"] == (0, i, 1, slice(0, GLOBAL_B), True)
        assert r["model_axis"]["shard"] == (i, 2, True)
    alone = single_process("cpu")
    assert make_mesh_for_batch(3, alone) == 3 and alone.rows(3) == slice(0, 3)
    with pytest.raises(ValueError, match="model_parallelism=3"):
        make_mesh_for_batch(4, alone, config.MeshConfig(model_parallelism=3))
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh_for_batch(5, Mesh(None, 1, 2, torch.device("cpu")))
    with pytest.raises(ValueError, match="model_parallelism=2"):
        make_mesh("cpu", config.MeshConfig(model_parallelism=2))
    shard = spatial_image_sharding(alone)
    assert (shard.index, shard.size) == (0, 1)
