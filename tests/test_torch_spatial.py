"""The model axis in the port (``parallel/spatial.py``, the row-split
RetinaNet, and the train step, eval step and detect under a mesh with
``model_parallelism > 1``), on a gloo group of four ranks on the CPU,
started once for the module and returning every check's numbers from that
one start, against the reference's own checks of its spatial sharding
(``tests/test_parallel.py::test_spatial_sharding_equals_single_device`` and
``::test_spatial_sharded_detect_equals_single_device``):

- ``halo_exchange``, ``row_conv2d`` (7x7/2, 3x3/2, 3x3/1, 1x1/2) and
  ``row_max_pool2d`` on a rank's rows equal the unsplit op's rows, forward
  and gradient (the weight's gradient summed over the model group), within
  1e-6 of the largest value, over model groups of 2 (2 data x 2 model) and
  4 (1 x 4);
- the split forward of the tiny RetinaNet equals the JAX package's forward
  on the same images within 2e-4 (256 px on 2 x 2, 512 px on 1 x 4);
- two steps of each train case on the split mesh equal the port's
  single-process steps on the global batch (loss 1e-5 relative, grad_norm
  1e-4, the parameters within 2e-5, ``tests/test_torch_parallel.py``'s
  bounds) and, augmentation off, the JAX package's ``train_step`` on the
  global batch (``test_torch_parallel.py``'s tolerances, ``train_bn``
  included); cases: focal on 2 x 2, focal with ``train_bn`` and the
  whole-forward ``train.remat`` on 2 x 2, ``model.remat`` on 1 x 4, and
  the pipelined step (augmentation on) with ``train_bn`` and
  ``model.remat`` on 2 x 2;
- the split detect and eval step equal the unsplit port's detect at
  ``test_parallel.py:150-156``'s tolerances, and the JAX package's detect;
- an image size whose rows do not split, SSD, hflip TTA and the int8 tier
  raise under a model axis.

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

WORLD = 4
STEPS = 2
RANK_TIMEOUT_S = 300

# name: (model_parallelism, image size, global batch, train_bn, model.remat,
#        train.remat, augment, pipelined, compared with JAX)
CASES = {
    "focal_2x2": (2, 256, 4, False, False, False, False, False, True),
    "focal_train_bn_whole_remat_2x2": (2, 256, 4, True, False, True, False, False, True),
    "focal_remat_1x4": (4, 512, 2, False, True, False, False, False, False),
    "focal_pipelined_train_bn_remat_2x2": (2, 256, 4, True, True, False, True, True, False),
}
# name: (model_parallelism, image size, images)
DETECT = {"detect_2x2": (2, 256, 4), "detect_1x4": (4, 512, 2)}
OPS = {  # name: (kernel, stride, padding) of a convolution; "pool" the max-pool
    "conv7x7s2": (7, 2, 3), "conv3x3s2": (3, 2, 1), "conv3x3s1": (3, 1, 1),
    "conv1x1s2": (1, 2, 0), "pool": (3, 2, 1)}


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _ops_checks(mesh):
    """The largest |difference| of each op on this rank's rows from the
    unsplit op's rows, over the largest |value| of the latter: output,
    input gradient and weight gradient (summed over the model group); and
    of ``halo_exchange`` from zero padding, whose windows overlap, so each
    rank's input gradient sums every rank's window that holds its rows. In
    float64, so that the order of the sums (the weight's gradient is summed
    over the ranks) stays far below the bound."""
    from shape_based_object_detection_torch.parallel import (
        halo_exchange, row_conv2d, row_max_pool2d, spatial_image_sharding,
    )

    shard = spatial_image_sharding(mesh)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 3, 16 * mesh.model_parallelism, 12, generator=gen, dtype=torch.float64)
    out = {}
    for name, (k, s, p) in OPS.items():
        conv = torch.nn.Conv2d(3, 5, k, s, p, dtype=torch.float64)
        with torch.no_grad():
            for t in conv.parameters():
                t.copy_(torch.randn(t.shape, generator=gen, dtype=torch.float64))
        op = (lambda z, sh: row_max_pool2d(z, k, s, p, sh)) if name == "pool" else (
            lambda z, sh: row_conv2d(conv, z, sh))
        full = x.clone().requires_grad_()
        want = op(full, None)
        w = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        (want * w).sum().backward()
        w_grad = None if name == "pool" else conv.weight.grad.clone()
        conv.zero_grad()
        part = shard.split(x).clone().requires_grad_()
        got = op(part, shard)
        (got * shard.split(w)).sum().backward()
        errs = [_rel_err(got.detach(), shard.split(want.detach())),
                _rel_err(part.grad, shard.split(full.grad))]
        if name != "pool":
            g = conv.weight.grad.clone()
            dist.all_reduce(g, group=shard.group)
            errs.append(_rel_err(g, w_grad))
        out[name] = errs
    # the exchange alone: 2 rows above and 1 below from the neighbours
    top, bottom = 2, 1
    part = shard.split(x).clone().requires_grad_()
    got = halo_exchange(part, top, bottom, shard)
    full = x.clone().requires_grad_()
    padded = torch.nn.functional.pad(full, (0, 0, top, bottom))
    w = torch.randn(padded.shape, generator=gen, dtype=torch.float64)
    n = x.shape[2] // shard.size
    windows = [slice(m * n, (m + 1) * n + top + bottom) for m in range(shard.size)]
    mine = windows[shard.index]
    (got * w[:, :, mine]).sum().backward()
    sum(((padded * w)[:, :, win]).sum() for win in windows).backward()
    out["halo"] = [_rel_err(got.detach(), padded[:, :, mine].detach()),
                   _rel_err(part.grad, shard.split(full.grad))]
    return out


def _rank_main(rank, plan_path, out_dir):
    """One rank: every check of the module, its numbers to
    ``rank{rank}.pt``. Imports nothing of JAX."""
    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.parallel import make_mesh
    from shape_based_object_detection_torch.utils import image as image_lib

    torch.set_num_threads(1)
    plan = torch.load(plan_path, weights_only=False)
    dist.init_process_group("gloo", init_method="file://" + plan["store"], rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {m: make_mesh("cpu", config.MeshConfig(model_parallelism=m)) for m in (2, 4)}
        out = {"layout": {m: (mesh.data_index, mesh.model_index, mesh.data_size, mesh.rows(4))
                          for m, mesh in meshes.items()},
               "ops": {m: _ops_checks(mesh) for m, mesh in meshes.items()}}
        for name, case in plan["cases"].items():
            cfg = case["cfg"]
            mesh = meshes[cfg.mesh.model_parallelism]
            module, anchors = build_model(cfg.model, "cpu", train=True)
            module.load_state_dict(case["weights"])
            state = train.create_train_state(module, cfg, device="cpu")
            rows = mesh.rows(cfg.data.batch_size)
            batches = [{k: v[rows] for k, v in b.items()} for b in case["batches"]]
            metrics = []
            if case["pipelined"]:
                prime, step = train.make_train_step_pipelined(module, anchors, cfg,
                                                              device="cpu", mesh=mesh)
                state, carry = prime(state, batches[0])
                for nxt in batches[1:] + batches[-1:]:
                    state, carry, m = step(state, carry, nxt)
                    metrics.append({k: float(v) for k, v in m.items()})
            else:
                step = train.make_train_step(module, anchors, cfg, augment=case["augment"],
                                             device="cpu", mesh=mesh)
                for b in batches:
                    state, m = step(state, b)
                    metrics.append({k: float(v) for k, v in m.items()})
            out[name] = {"metrics": metrics, "step": state.step,
                         "exchanges": module.row_shard.exchanges,
                         "state": {k: v.clone() for k, v in module.state_dict().items()}}

        out["detect"] = {}
        for name, (m, size, _) in DETECT.items():
            cfg = plan["detect_cfgs"][name]
            mesh = meshes[m]
            module, anchors = build_model(cfg.model, "cpu")
            module.load_state_dict(plan["detect_weights"][name])
            images = plan["detect_images"][name]
            mine = images[mesh.rows(len(images))]
            det = make_detect_fn(module, anchors, cfg.model, cfg.data, "cpu", mesh)(mine)
            shard = module.row_shard
            with torch.no_grad():
                x = image_lib.normalize_images(torch.from_numpy(mine))
                forward = module(shard.split(x.permute(0, 3, 1, 2)))
            eval_det = train.make_eval_step(module, anchors, cfg, device="cpu", mesh=mesh)(
                train.create_train_state(module, cfg, device="cpu"), images[mesh.rows(len(images))])
            out["detect"][name] = {"rows": mesh.rows(len(images)), "det": det,
                                   "forward": forward, "eval": eval_det}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _configs(name):
    from tests.torch_parity import tiny_configs

    m, size, batch, train_bn, remat, whole_remat, _, _, _ = CASES[name]
    return tiny_configs(
        "retinanet", model=dict(image_size=size, train_bn=train_bn, remat=remat),
        data=dict(batch_size=batch, max_boxes=4),
        train=dict(base_lr=0.05, warmup_steps=1, weight_decay=1e-2, grad_clip_norm=0.5,
                   lr_decay_steps=(100,), remat=whole_remat),
        match=dict(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True),
        loss=dict(kind="focal"), mesh=dict(model_parallelism=m))


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """The plan (configs, weights, batches, images) and the four ranks'
    results; the JAX package's steps, forwards and detects run here while
    the ranks run."""
    from shape_based_object_detection_torch.utils.convert import (
        state_dict_from_jax_variables,
    )
    from tests.torch_parity import (
        focal_weights, gt_batch, jax_train_steps, jax_variables, tiny_configs,
    )

    root = tmp_path_factory.mktemp("sp")
    cases = {}
    for i, name in enumerate(CASES):
        j_cfg, t_cfg = _configs(name)
        variables, weights = focal_weights(j_cfg, seed=50 + i)
        size, batch = t_cfg.model.image_size, t_cfg.data.batch_size
        batches = [gt_batch(60 + 10 * i + s, batch, 4, size, t_cfg.model.num_classes)
                   for s in range(STEPS)]
        cases[name] = {"cfg": t_cfg, "j_cfg": j_cfg, "variables": variables,
                       "weights": weights, "batches": batches,
                       "augment": CASES[name][6], "pipelined": CASES[name][7]}
    detect = {}
    for i, (name, (m, size, n)) in enumerate(DETECT.items()):
        j_cfg, t_cfg = tiny_configs("retinanet", model=dict(image_size=size),
                                    mesh=dict(model_parallelism=m))
        # widened classifier heads: scores spread away from the prior
        variables = jax_variables(j_cfg.model, seed=70 + i)[1]
        detect[name] = {"j_cfg": j_cfg, "cfg": t_cfg, "variables": variables,
                        "weights": state_dict_from_jax_variables(variables),
                        "images": np.random.default_rng(80 + i).integers(
                            0, 256, (n, size, size, 3), dtype=np.uint8)}
    plan = {"store": str(root / "store"),
            "cases": {k: {kk: v for kk, v in c.items() if kk not in ("j_cfg", "variables")}
                      for k, c in cases.items()},
            "detect_cfgs": {k: d["cfg"] for k, d in detect.items()},
            "detect_weights": {k: d["weights"] for k, d in detect.items()},
            "detect_images": {k: d["images"] for k, d in detect.items()}}
    plan_path = str(root / "plan.pt")
    torch.save(plan, plan_path)
    ctx = mp.start_processes(_rank_main, args=(plan_path, str(root)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for name, case in cases.items():
            if CASES[name][-1]:
                case["jax"] = jax_train_steps(case)
        for d in detect.values():
            d["jax"] = _jax_detect(d)
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(str(root / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return cases, detect, ranks


def _jax_detect(d):
    """The JAX package's forward and detect on the images, jitted as the
    reference's own spatial tests run them."""
    import jax
    import jax.numpy as jnp

    from shape_based_object_detection_tpu import detection as jax_det
    from shape_based_object_detection_tpu.models.factory import build_module
    from shape_based_object_detection_tpu.ops.anchors import anchors_for_model
    from shape_based_object_detection_tpu.utils import image as jax_image

    cfg = d["j_cfg"]
    module = build_module(cfg.model)
    images = jnp.asarray(d["images"])
    x = jax_image.normalize_images(images, cfg.data.mean, cfg.data.std)
    forward = [np.asarray(t) for t in jax.jit(module.apply)(d["variables"], x)]
    det = jax_det.make_detect_fn(module, anchors_for_model(cfg.model), cfg.model, cfg.data,
                                 use_pallas=False)(d["variables"], images)
    return forward, [np.asarray(t) for t in det]


def _single_process(case, order=None):
    """The port's steps on the global batch in one process (its rows in
    ``order``): metrics and state dict."""
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = dataclasses.replace(case["cfg"], mesh=dataclasses.replace(
        case["cfg"].mesh, model_parallelism=1))
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
    return metrics, module.state_dict()


def _bounds(name, case, metrics, state):
    """({metric: rtol}, parameter atol), as ``test_torch_parallel.py``'s:
    grad_norm 1e-4, the loss terms 1e-5, the parameters 2e-5; with
    trainable BatchNorm, twice the largest move of the single process's own
    steps under two other row orders, and never below those."""
    rtol = {k: 1e-4 if k == "grad_norm" else 1e-5 for k in metrics[0]}
    atol = 2e-5
    if not CASES[name][3]:
        return rtol, atol
    b = case["cfg"].data.batch_size
    for order in (list(range(b // 2, b)) + list(range(b // 2)), [i ^ 1 for i in range(b)]):
        other, other_state = _single_process(case, order)
        for k in rtol:
            rtol[k] = max([rtol[k]] + [2 * abs(o[k] - m[k]) / max(abs(m[k]), 1e-12)
                                       for o, m in zip(other, metrics)])
        atol = max([atol] + [2 * float((other_state[k] - v).abs().max())
                             for k, v in state.items()])
    return rtol, atol


def test_mesh_layout_is_the_references(sp):
    """Rank r = d * mp + m: data index d, model index m; the ranks of a
    data index load its rows of the global batch."""
    _, _, ranks = sp
    for r, out in enumerate(ranks):
        assert out["layout"][2] == (r // 2, r % 2, 2, slice(2 * (r // 2), 2 * (r // 2) + 2))
        assert out["layout"][4] == (0, r, 1, slice(0, 4))


@pytest.mark.parametrize("mp_size", [2, 4])
@pytest.mark.parametrize("op", list(OPS) + ["halo"])
def test_row_ops_equal_the_unsplit_ops(sp, mp_size, op):
    _, _, ranks = sp
    for out in ranks:
        errs = out["ops"][mp_size][op]
        assert max(errs) <= 1e-6, errs


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_equals_single_process_step(sp, name):
    cases, _, ranks = sp
    case = cases[name]
    metrics, state = _single_process(case)
    rtol, param_atol = _bounds(name, case, metrics, state)
    for got in ranks:
        assert got[name]["step"] == STEPS
        for s, (g, w) in enumerate(zip(got[name]["metrics"], metrics)):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=rtol[key],
                                           err_msg=f"{key} step {s}")
        for k, w in state.items():
            np.testing.assert_allclose(got[name]["state"][k].numpy(), w.numpy(), rtol=0,
                                       atol=param_atol, err_msg=k)
    assert ranks[0][name]["metrics"][-1]["num_pos"] > 0
    assert ranks[0][name]["exchanges"] > 0
    moved = max(float((state[k] - case["weights"][k]).abs().max()) for k in case["weights"])
    assert moved > 1e-3
    # every rank ends with the same parameters and metrics
    for other in ranks[1:]:
        assert other[name]["metrics"] == ranks[0][name]["metrics"]
        for k, v in ranks[0][name]["state"].items():
            assert torch.equal(other[name]["state"][k], v), k


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[-1]])
def test_split_step_equals_jax_global_step(sp, name):
    """As ``test_torch_parallel.py::test_two_rank_step_equals_jax_global_step``:
    metrics 1e-5 and parameters 2e-5; with ``train_bn`` the loss terms and
    the running statistics at 1e-4."""
    cases, _, ranks = sp
    case = cases[name]
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
    if train_bn:
        assert any(not torch.equal(got["state"][k], case["weights"][k])
                   for k in want if k.endswith("running_mean"))


@pytest.mark.parametrize("name", list(DETECT))
def test_split_forward_equals_jax_forward(sp, name):
    _, detect, ranks = sp
    (want_cls, want_box), _ = detect[name]["jax"]
    for out in ranks:
        got = out["detect"][name]
        rows = got["rows"]
        np.testing.assert_allclose(got["forward"][0].numpy(), want_cls[rows], atol=2e-4)
        np.testing.assert_allclose(got["forward"][1].numpy(), want_box[rows], atol=2e-4)


def _assert_detections_equal(got, want):
    """``test_parallel.py:150-156``'s bounds."""
    got = [np.asarray(t) for t in got]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(DETECT))
def test_split_detect_equals_unsplit_and_jax_detect(sp, name):
    """Each rank's detect of its data index's images, and the eval step's
    gathered detections of the whole batch, equal the unsplit port's detect
    and the JAX package's."""
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model

    _, detect, ranks = sp
    d = detect[name]
    module, anchors = build_model(d["cfg"].model, "cpu")
    module.load_state_dict(d["weights"])
    unsplit = [t.numpy() for t in make_detect_fn(module, anchors, d["cfg"].model,
                                                 d["cfg"].data, "cpu")(d["images"])]
    _, jax_det = d["jax"]
    assert unsplit[3].any()
    for out in ranks:
        got = out["detect"][name]
        rows = got["rows"]
        for want in (unsplit, jax_det):
            _assert_detections_equal(got["det"], [t[rows] for t in want])
            _assert_detections_equal(got["eval"], want)


def test_unsupported_paths_raise_under_a_model_axis():
    """Rows that do not split evenly down to P7 (ValueError), SSD, hflip
    TTA, the int8 tier and the artifact (NotImplementedError naming
    ROADMAP.md) raise; checked before any collective, on a mesh record."""
    from shape_based_object_detection_torch import config, export, quantize
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.models.retinanet import set_row_shard
    from shape_based_object_detection_torch.parallel import Mesh, spatial_image_sharding
    from tests.torch_parity import with_detect

    mesh = Mesh(None, 1, 2, torch.device("cpu"), 2)
    retina = config.tiny_test_model("retinanet")
    with pytest.raises(ValueError, match="not divisible by the coarsest stride 128"):
        spatial_image_sharding(mesh, model=dataclasses.replace(retina, image_size=384))
    with pytest.raises(ValueError, match="coarsest stride"):
        spatial_image_sharding(mesh, model=retina)  # 128 px: one P7 row for two ranks
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        spatial_image_sharding(mesh, model=config.tiny_test_model("ssd"))
    ssd, _ = build_model(config.tiny_test_model("ssd"), "cpu")
    shard = spatial_image_sharding(mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        set_row_shard(ssd, shard)
    cfg = dataclasses.replace(retina, image_size=256)
    module, anchors = build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="hflip TTA"):
        make_detect_fn(module, anchors, with_detect(cfg, tta_hflip=True), device="cpu",
                       mesh=mesh)
    set_row_shard(module, shard)
    assert module.backbone.row_shard is shard and module.cls_head.row_shard is shard
    with pytest.raises(NotImplementedError, match="int8 tier"):
        quantize.quantize_module(module, "weights", device="cpu")
    with pytest.raises(NotImplementedError, match="artifact"):
        export.export_detect(module, anchors, cfg, device="cpu")
    with pytest.raises(ValueError, match="RowShard.split"):
        module(torch.zeros(1, 3, 256, 256))
