"""The data-parallel step of a tiny ResNet-101 RetinaNet (3-4-23-3 blocks at
an eighth of the widths, 128 px, float32, remat and augmentation on, focal
loss) on a gloo group of two ranks on the CPU, started once for the module,
against the benchmark's plain reference worked out in row blocks
(``benchmark/reference/train_blocks.py``), and the spans and the counter
of its all-reduces:

- three steps of the two ranks, each feeding its rows of a global batch of
  4 through ``Loader``'s host sharding, equal the blocked reference on the
  global batch: the losses within 1e-5 relative, the momentum after the
  first step within 1e-4 of its largest element and the parameters' change
  after the third within 2e-5, as ``tests/test_torch_parallel.py`` holds the
  ranks against one process;
- the blocked reference with blocks of one row equals the reference's
  steps on the whole batch (``benchmark/reference/train.py``);
- under a profiler each step records one ``train.allreduce`` span inside
  ``train.update`` around one ``comm.all_reduce``, and
  ``comm.all_reduce_bytes`` rises by 4 bytes for each trained parameter and
  each of the 3 summed loss terms, and 4 for the loss's count of positives;
- a single process records neither span nor counter.
"""

import copy
import datetime
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
GLOBAL_B = 4
STEPS = 3
POOL = 12
MAX_BOXES = 8
SEED = 2 ** 33 + 19
RANK_TIMEOUT_S = 300
CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "retinanet_r101_fpn_1024_bf16.json"


def tiny_experiment() -> dict:
    """Config #5's experiment at CPU size: widths and image cut, float32 at
    the highest precision, a short warmup and a large rate so that three
    steps move the parameters."""
    exp = copy.deepcopy(json.loads(CONFIG.read_text())["experiment"])
    exp["model"].update(width_mult=0.125, image_size=128, dtype="float32", precision="highest")
    exp["data"].update(batch_size=GLOBAL_B, max_boxes=MAX_BOXES)
    exp["train"].update(base_lr=0.05, warmup_steps=1, weight_decay=1e-2, grad_clip_norm=0.5,
                        lr_decay_steps=[100])
    return exp


def _inputs(exp):
    from benchmark.harness.images import synthetic_pool
    from benchmark.harness.weights import make_weights
    from benchmark.reference.models import param_specs

    weights = make_weights(param_specs(exp), {}, SEED, "cpu")
    pool = synthetic_pool(SEED + 1, POOL, exp["model"]["image_size"], 4,
                          exp["model"]["num_classes"], "cpu")
    return weights, pool


def _profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _rank_main(rank, store, out_dir):
    """One rank's three steps under a profiler: losses, the momentum after
    step 1, the change after step 3, the tracer's spans and counters."""
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.config import config_from_dict
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.parallel.mesh import broadcast_state, make_mesh
    from shape_based_object_detection_torch.utils import metrics

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        exp = tiny_experiment()
        cfg = config_from_dict(exp)
        weights, pool = _inputs(exp)
        mesh = make_mesh("cpu")
        module, anchors = build_model(cfg.model, "cpu", train=True)
        module.load_state_dict(weights)
        state = train.create_train_state(
            module, cfg, "cpu", generator=torch.Generator().manual_seed(SEED + 2))
        state = broadcast_state(state, mesh)
        step = train.make_train_step(module, anchors, cfg, augment=True, device="cpu",
                                     mesh=mesh)
        loader = Loader(pool, GLOBAL_B // WORLD, MAX_BOXES, seed=SEED % 1000, shuffle=True,
                        host_id=mesh.data_index, num_hosts=mesh.data_size)
        names = [n for n, _ in module.named_parameters()]
        out = {"losses": [], "params": sum(p.numel() for p in module.parameters())}
        metrics.reset()
        with _profiled():
            for i, batch in enumerate(loader.batches(0)):
                state, m = step(state, batch._asdict())
                out["losses"].append(float(m["loss"]))
                if i == 0:
                    out["grad"] = {n: t.clone() for n, t in zip(names, state.opt_state.trace)}
        out["delta"] = {n: t.detach() - weights[n] for n, t in module.named_parameters()}
        snap = metrics.snapshot()
        out["spans"] = [(s.id, s.name, s.parent) for s in snap["spans"]]
        out["counters"] = snap["counters"]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both ranks' results, and the blocked reference on the global batches
    (worked out here while the ranks run)."""
    from benchmark.reference import train_blocks

    root = tmp_path_factory.mktemp("dp_r101")
    ctx = mp.start_processes(_rank_main, args=(str(root / "store"), str(root)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        torch.set_num_threads(1)
        exp = tiny_experiment()
        weights, pool = _inputs(exp)
        per_rank = GLOBAL_B // WORLD
        batches = [tuple(torch.from_numpy(a) for a in pool.padded(
            train_blocks.global_rows(POOL, SEED % 1000, WORLD, per_rank, k), MAX_BOXES))
            for k in range(STEPS)]
        ref = train_blocks.run_steps(weights, batches, SEED + 2, exp, "float32", "cpu",
                                     per_rank, per_rank)
        while not ctx.join(timeout=2):
            assert time.monotonic() < deadline, "the ranks did not finish in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(str(root / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return {"exp": exp, "weights": weights, "batches": batches, "ref": ref}, ranks


def _assert_steps_equal(got, want):
    """Losses within 1e-5 relative; the momentum after step 1 within 1e-4 of
    its largest element (the ranks' 1e-4 on the gradient's norm); the change
    after step 3 within 2e-5 (the ranks' bound on the parameters)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    top = max(float(t.abs().max()) for t in want["grad"].values())
    for key, atol in (("grad", 1e-4 * top), ("delta", 2e-5)):
        assert set(got[key]) == set(want[key])
        for n, w in want[key].items():
            np.testing.assert_allclose(got[key][n].numpy(), w.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{key} {n}")
    # the comparison sees the update
    assert max(float(t.abs().max()) for t in want["delta"].values()) > 1e-3


def test_data_parallel_steps_equal_the_blocked_reference(dp):
    plan, ranks = dp
    assert len(ranks[0]["losses"]) == STEPS
    _assert_steps_equal(ranks[0], plan["ref"])
    for n, t in ranks[0]["delta"].items():  # the ranks end alike
        assert torch.equal(t, ranks[1]["delta"][n]), n


def test_blocks_of_one_row_equal_the_whole_batch():
    from benchmark.reference import train, train_blocks

    exp = tiny_experiment()
    weights, pool = _inputs(exp)
    batches = [tuple(torch.from_numpy(a) for a in pool.padded(list(range(k, k + GLOBAL_B)),
                                                               MAX_BOXES))
               for k in range(0, STEPS * GLOBAL_B, GLOBAL_B)]
    whole = train.run_steps(weights, batches, SEED, exp, "float32", "cpu")
    blocked = train_blocks.run_steps(weights, batches, SEED, exp, "float32", "cpu", 1, GLOBAL_B)
    _assert_steps_equal(blocked, whole)
    for got, want in zip(blocked["heads"], whole["heads"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rank", range(WORLD))
def test_each_step_records_one_allreduce_and_its_bytes(dp, rank):
    _, ranks = dp
    got = ranks[rank]
    by_id = {i: (name, parent) for i, name, parent in got["spans"]}
    names = [name for name, _ in by_id.values()]
    assert names.count("train.allreduce") == STEPS
    assert names.count("comm.all_reduce") == STEPS
    for name, parent in by_id.values():
        if name == "train.allreduce":
            assert by_id[parent][0] == "train.update"
        if name == "comm.all_reduce":
            assert by_id[parent][0] == "train.allreduce"
    # the gradients and the 3 loss terms in one float32 buffer, and the count
    per_step = 4 * (got["params"] + 3) + 4
    assert got["counters"]["comm.all_reduce_bytes"] == STEPS * per_step


def test_a_single_process_records_neither():
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.config import config_from_dict
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.utils import metrics

    exp = tiny_experiment()
    exp["model"]["backbone"] = "resnet50"  # the path alone matters here
    cfg = config_from_dict(exp)
    pool = _inputs(exp)[1]
    module, anchors = build_model(cfg.model, "cpu", train=True)
    state = train.create_train_state(module, cfg, "cpu")
    step = train.make_train_step(module, anchors, cfg, augment=True, device="cpu")
    rows = pool.padded(list(range(GLOBAL_B)), MAX_BOXES)
    batch = dict(zip(("images", "boxes", "labels", "valid"), rows))
    metrics.reset()
    with _profiled():
        step(state, batch)
    snap = metrics.snapshot()
    names = {s.name for s in snap["spans"]}
    assert "train.update" in names  # the tracer recorded the step
    assert not names & {"train.allreduce", "comm.all_reduce"}
    assert "comm.all_reduce_bytes" not in snap["counters"]
