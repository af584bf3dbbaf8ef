"""The model axis in the port (``parallel/spatial.py``, the row-split
RetinaNet and SSD, and the train step, eval step, detect, TTA, the int8
tiers and the artifact under a mesh with ``model_parallelism > 1``), on a
gloo group of four ranks on the CPU, started once for the module and
returning every check's numbers from that one start, against the
reference's own checks of its spatial sharding
(``tests/test_parallel.py::test_spatial_sharding_equals_single_device`` and
``::test_spatial_sharded_detect_equals_single_device``):

- ``halo_exchange``, ``row_conv2d`` and ``row_max_pool2d`` on a rank's rows
  equal the unsplit op's rows, forward and gradient (the weight's gradient
  summed over the model group), within 1e-6 of the largest value, over
  model groups of 2 (2 data x 2 model) and 4 (1 x 4): the ResNet's layers
  on maps that split evenly, and SSD's on maps that do not (GSPMD's ceil
  layout: the dilated conv6 on 19 rows, the unpadded 3x3 on 5 and 3, the
  4x4 pad-1 on 2, the ceil-mode pool on 75, a 3x3/2 on 5, the FPN's
  upsample from 5 to 10 rows, a 1-row map);
- the split forward of the tiny RetinaNet and of tiny SSD300 and SSD-512
  equals the JAX package's forward on the same images within 2e-4 (256 px
  on 2 x 2, 512 and 128 px, the reference's own case, on 1 x 4, SSD300 on
  1 x 4, SSD-512 on 2 x 2);
- two steps of each train case on the split mesh equal the port's
  single-process steps on the global batch (loss 1e-5 relative, grad_norm
  1e-4, the parameters within 2e-5, ``tests/test_torch_parallel.py``'s
  bounds) and, augmentation off, the JAX package's ``train_step`` on the
  global batch (``test_torch_parallel.py``'s tolerances, ``train_bn``
  included); cases: focal on 2 x 2, focal with ``train_bn`` and the
  whole-forward ``train.remat`` on 2 x 2, ``model.remat`` on 1 x 4, the
  pipelined step (augmentation on) with ``train_bn`` and ``model.remat``
  on 2 x 2, the reference's 128 px on 1 x 4, SSD300 (multibox) on 1 x 4
  and SSD-512 on 2 x 2;
- the split detect and eval step equal the unsplit port's detect at
  ``test_parallel.py:150-156``'s tolerances, and the JAX package's detect;
- hflip and two-scale TTA (128 and 160 px, neither splitting evenly down
  to P7) on 2 x 2 equal the unsplit port's and match the JAX package's;
- the weight-only, full-dynamic and full-static int8 tiers on 2 x 2 equal
  the unsplit port's same tier: every int8 product bit-equal, the
  detections at the reference's bounds; the static scales calibrated on
  the split module equal the unsplit calibration's;
- ``export_detect`` of a row-split module gives the unsplit export's
  detections;
- what still raises under a model axis does.

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


def _case(mp_size, size, batch, family="retinanet", train_bn=False, remat=False,
          whole_remat=False, augment=False, pipelined=False, jax=False):
    return dict(mp=mp_size, size=size, batch=batch, family=family, train_bn=train_bn,
                remat=remat, whole_remat=whole_remat, augment=augment, pipelined=pipelined,
                jax=jax)


CASES = {
    "focal_2x2": _case(2, 256, 4, jax=True),
    "focal_train_bn_whole_remat_2x2": _case(2, 256, 4, train_bn=True, whole_remat=True,
                                            jax=True),
    "focal_remat_1x4": _case(4, 512, 2, remat=True),
    "focal_pipelined_train_bn_remat_2x2": _case(2, 256, 4, train_bn=True, remat=True,
                                                augment=True, pipelined=True),
    # the reference's test_parallel.py:98-130: 128 px over four model ranks
    # (P6 has 2 rows and P7 1)
    "focal_128_1x4": _case(4, 128, 2, jax=True),
    "ssd300_1x4": _case(4, 300, 2, family="ssd"),
    "ssd512_2x2": _case(2, 512, 4, family="ssd512"),
}
# name: (model_parallelism, image size, images, family)
DETECT = {"detect_2x2": (2, 256, 4, "retinanet"), "detect_1x4": (4, 512, 2, "retinanet"),
          "detect_128_1x4": (4, 128, 2, "retinanet"), "detect_ssd300_1x4": (4, 300, 2, "ssd"),
          "detect_ssd512_2x2": (2, 512, 4, "ssd512")}
# the serving paths on 2 x 2: the tiny RetinaNet at 128 px (P7's one row
# over two ranks), TTA at 128 and 160 px, the int8 tiers
SERVE_IMAGES = 4
TTA_SCALES = (128, 160)
TIERS = ("weights", "dynamic", "static")
# name: (kind, kernel, stride, padding, dilation, rows: None for 16 per rank)
OPS = {
    "conv7x7s2": ("conv", 7, 2, 3, 1, None), "conv3x3s2": ("conv", 3, 2, 1, 1, None),
    "conv3x3s1": ("conv", 3, 1, 1, 1, None), "conv1x1s2": ("conv", 1, 2, 0, 1, None),
    "pool": ("pool", 3, 2, 1, 1, None),
    # maps that do not split evenly: SSD's layers and the FPN's upsample
    "conv3x3d6_19rows": ("conv", 3, 1, 6, 6, 19),
    "conv3x3valid_5rows": ("conv", 3, 1, 0, 1, 5),
    "conv3x3valid_3rows": ("conv", 3, 1, 0, 1, 3),
    "conv4x4p1_2rows": ("conv", 4, 1, 1, 1, 2),
    "pool2x2ceil_75rows": ("pool_ceil", 2, 2, 0, 1, 75),
    "pool3x3s1_19rows": ("pool", 3, 1, 1, 1, 19),
    "conv3x3s2_5rows": ("conv", 3, 2, 1, 1, 5),
    "upsample_5to10rows": ("upsample", 0, 0, 0, 0, 5),
    "conv3x3_1row": ("conv", 3, 1, 1, 1, 1),
}


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _ops_checks(mesh):
    """The largest |difference| of each op on this rank's real rows from the
    unsplit op's rows, over the largest |value| of the latter: output (its
    padding rows must be zeros), input gradient and weight gradient (summed
    over the model group); and of ``halo_exchange`` from zero padding,
    whose windows overlap, so each rank's input gradient sums every rank's
    window that holds its rows. Square maps, as the models', in float64, so
    that the order of the sums (the weight's gradient is summed over the
    ranks) stays far below the bound."""
    from shape_based_object_detection_torch.parallel import (
        halo_exchange, row_conv2d, row_max_pool2d, row_upsample_nearest,
        spatial_image_sharding,
    )

    shard = spatial_image_sharding(mesh)
    gen = torch.Generator().manual_seed(11)
    out = {}
    for name, (kind, k, s, p, d, rows) in OPS.items():
        h = rows or 16 * mesh.model_parallelism
        x = torch.randn(2, 3, h, h, generator=gen, dtype=torch.float64)
        conv = torch.nn.Conv2d(3, 5, max(k, 1), max(s, 1), p, max(d, 1), dtype=torch.float64)
        with torch.no_grad():
            for t in conv.parameters():
                t.copy_(torch.randn(t.shape, generator=gen, dtype=torch.float64))
        if kind == "conv":
            def op(z, sh):
                return row_conv2d(conv, z, sh)
        elif kind == "upsample":
            def op(z, sh):
                return row_upsample_nearest(z, 2 * h, 2 * h, sh)
        else:
            def op(z, sh):
                return row_max_pool2d(z, k, s, p, sh, ceil_mode=kind == "pool_ceil")
        full = x.clone().requires_grad_()
        want = op(full, None)
        w = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        (want * w).sum().backward()
        w_grad = None if kind != "conv" else conv.weight.grad.clone()
        conv.zero_grad()
        part = shard.split(x).clone().requires_grad_()
        got = op(part, shard)
        (got * shard.split(w)).sum().backward()
        r_out, r_in = shard.rows(want.shape[2]), shard.rows(h)
        n_out, n_in = r_out.stop - r_out.start, r_in.stop - r_in.start
        got, want = got.detach(), want.detach()
        errs = [_rel_err(got[:, :, :n_out], want[:, :, r_out]) if n_out else 0.0,
                float(got[:, :, n_out:].abs().sum()),
                _rel_err(part.grad[:, :, :n_in], full.grad[:, :, r_in]) if n_in else 0.0]
        if kind == "conv":
            g = torch.zeros_like(w_grad) if conv.weight.grad is None else conv.weight.grad
            dist.all_reduce(g, group=shard.group)
            errs.append(_rel_err(g, w_grad))
        out[name] = [float(e) for e in errs]
    # the exchange alone: 2 rows above and 1 below from the neighbours
    top, bottom = 2, 1
    h = 16 * mesh.model_parallelism
    x = torch.randn(2, 3, h, h, generator=gen, dtype=torch.float64)
    part = shard.split(x).clone().requires_grad_()
    got = halo_exchange(part, top, bottom, shard)
    full = x.clone().requires_grad_()
    padded = torch.nn.functional.pad(full, (0, 0, top, bottom))
    w = torch.randn(padded.shape, generator=gen, dtype=torch.float64)
    n = h // shard.size
    windows = [slice(m * n, (m + 1) * n + top + bottom) for m in range(shard.size)]
    mine = windows[shard.index]
    (got * w[:, :, mine]).sum().backward()
    sum(((padded * w)[:, :, win]).sum() for win in windows).backward()
    out["halo"] = [_rel_err(got.detach(), padded[:, :, mine].detach()),
                   _rel_err(part.grad, shard.split(full.grad))]
    return out


class _Products:
    """Every int8 product (``Int8Conv2d``'s int32 accumulator) of the
    forwards run inside it, in call order."""

    def __enter__(self):
        from shape_based_object_detection_torch.quantize import Int8Conv2d

        self.cls, self.orig, self.accs = Int8Conv2d, Int8Conv2d.dequantize_output, []

        def record(mod, acc, ls, dtype):
            self.accs.append(acc.clone())
            return self.orig(mod, acc, ls, dtype)

        Int8Conv2d.dequantize_output = record
        return self

    def __exit__(self, *exc):
        self.cls.dequantize_output = self.orig


def _serving_checks(plan, mesh, out_dir):
    """The serving paths on the 2 x 2 mesh, each rank on its data index's
    images: hflip TTA, two-scale TTA, the three int8 tiers (every int8
    product against the unsplit tier's on the same images, in the rank) and
    the calibration on the split module; rank 0 exports the row-split
    module."""
    from shape_based_object_detection_torch import export, quantize
    from shape_based_object_detection_torch.detection import (
        MultiScaleBatchDetector, make_detect_fn,
    )
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.parallel import (
        set_row_shard, spatial_image_sharding,
    )
    from tests.torch_parity import with_detect

    cfg = plan["serve_cfg"]
    images = plan["serve_images"][mesh.rows(SERVE_IMAGES)]

    def model():
        module, anchors = build_model(cfg.model, "cpu")
        module.load_state_dict(plan["serve_weights"])
        return module, anchors

    out = {"rows": mesh.rows(SERVE_IMAGES)}
    module, anchors = model()
    out["hflip"] = make_detect_fn(module, anchors, with_detect(cfg.model, tta_hflip=True),
                                  cfg.data, "cpu", mesh)(images)
    module, _ = model()
    out["scales"] = MultiScaleBatchDetector(cfg.model, module, TTA_SCALES, cfg.data, "cpu",
                                            mesh=mesh)(images)
    shard = spatial_image_sharding(mesh)
    module, _ = model()
    set_row_shard(module, shard)
    # every rank calibrates on the whole batch, as the unsplit calibration
    out["calibrated"] = quantize.calibrate_activation_scales(
        module, [plan["serve_images"]], cfg.data, min_size=1)
    out["tiers"] = {}
    for tier in TIERS:
        mode = "weights" if tier == "weights" else "full"
        scales = plan["serve_scales"] if tier == "static" else None
        alone, anchors = model()
        alone_q = quantize.quantize_module(alone, mode, scales, min_size=1, device="cpu")
        with _Products() as want:
            want_det = make_detect_fn(alone_q, anchors, cfg.model, cfg.data, "cpu")(images)
        module, anchors = model()
        split = quantize.quantize_module(module, mode, scales, min_size=1, device="cpu")
        detect = make_detect_fn(split, anchors, cfg.model, cfg.data, "cpu", mesh)
        with _Products() as got:
            det = detect(images)
        differ = len(got.accs) != len(want.accs)
        for g, w in zip(got.accs, want.accs):
            r = shard.rows(w.shape[1])
            differ |= not torch.equal(g[:, :r.stop - r.start], w[:, r])
        out["tiers"][tier] = {"det": det, "unsplit": want_det, "products": len(got.accs),
                              "products_differ": differ}
    if mesh.rank == 0:
        module, anchors = model()
        set_row_shard(module, shard)
        blob = export.export_detect(module, anchors, cfg.model, cfg.data, batch_size=2,
                                    device="cpu")
        out["export_kept_shard"] = module.row_shard is shard
        export.save_artifact(blob, os.path.join(out_dir, "split.sbdx"))
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
        for name, (m, size, _, _) in DETECT.items():
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
        out["serve"] = _serving_checks(plan, meshes[2], out_dir)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _family_configs(family, model=None, **sections):
    """``tiny_configs`` of the family; "ssd512" is SSD-512 at the tiny
    SSD's width (its own anchors, extras and 512 px)."""
    from shape_based_object_detection_tpu import config as jax_config
    from shape_based_object_detection_torch import config as torch_config
    from tests.torch_parity import tiny_configs

    if family != "ssd512":
        return tiny_configs(family, model=model, **sections)

    def make(lib):
        m = dataclasses.replace(lib.SSD512, width_mult=0.125, num_classes=4,
                                precision="highest", **(model or {}))
        return lib.ExperimentConfig(model=m, **{
            k: getattr(lib, f"{k.capitalize()}Config")(**v) for k, v in sections.items()})

    return make(jax_config), make(torch_config)


def _configs(name):
    c = CASES[name]
    if c["family"] == "retinanet":
        match, loss = (dict(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True),
                       dict(kind="focal"))
    else:
        match, loss = (dict(pos_threshold=0.5, neg_threshold=0.5, shape_weight=0.3,
                            shape_tau=1.0), dict(kind="multibox", neg_pos_ratio=3.0))
    model = dict(train_bn=c["train_bn"], remat=c["remat"])
    if c["family"] != "ssd512":
        model["image_size"] = c["size"]
    return _family_configs(
        c["family"], model=model, data=dict(batch_size=c["batch"], max_boxes=4),
        train=dict(base_lr=0.05, warmup_steps=1, weight_decay=1e-2, grad_clip_norm=0.5,
                   lr_decay_steps=(100,), remat=c["whole_remat"]),
        match=match, loss=loss, mesh=dict(model_parallelism=c["mp"]))


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """The plan (configs, weights, batches, images) and the four ranks'
    results; the JAX package's steps, forwards and detects run here while
    the ranks run."""
    from shape_based_object_detection_torch import quantize
    from shape_based_object_detection_torch.utils.convert import (
        state_dict_from_jax_variables,
    )
    from tests.torch_parity import (
        focal_weights, gt_batch, jax_train_steps, jax_variables, port_model, tiny_configs,
        with_detect,
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
                       "augment": CASES[name]["augment"],
                       "pipelined": CASES[name]["pipelined"]}
    detect = {}
    for i, (name, (m, size, n, family)) in enumerate(DETECT.items()):
        model = {} if family == "ssd512" else dict(image_size=size)
        j_cfg, t_cfg = _family_configs(family, model=model, mesh=dict(model_parallelism=m))
        # RetinaNet's classifier widened, so that scores spread away from
        # the prior; SSD's at its initial scale: widened, its softmax
        # saturates within 1e-5 of 1, where overlapping candidates tie
        variables = jax_variables(j_cfg.model, seed=70 + i,
                                  cls_predict_scale=1.0 if "ssd" in family else 4.0)[1]
        detect[name] = {"j_cfg": j_cfg, "cfg": t_cfg, "variables": variables,
                        "weights": state_dict_from_jax_variables(variables),
                        "images": np.random.default_rng(80 + i).integers(
                            0, 256, (n, size, size, 3), dtype=np.uint8)}
    j_serve, t_serve = tiny_configs("retinanet", mesh=dict(model_parallelism=2))
    j_serve, t_serve = (dataclasses.replace(c, model=with_detect(c.model, score_threshold=0.0))
                        for c in (j_serve, t_serve))
    serve_vars = jax_variables(j_serve.model, seed=90)[1]
    serve_images = np.random.default_rng(91).integers(0, 256, (SERVE_IMAGES, 128, 128, 3),
                                                      dtype=np.uint8)
    serve_module, serve_anchors = port_model(t_serve.model, serve_vars)
    serve = {"j_cfg": j_serve, "cfg": t_serve, "variables": serve_vars,
             "weights": serve_module.state_dict(), "images": serve_images,
             "scales": quantize.calibrate_activation_scales(serve_module, [serve_images],
                                                            t_serve.data, min_size=1)}
    plan = {"store": str(root / "store"),
            "cases": {k: {kk: v for kk, v in c.items() if kk not in ("j_cfg", "variables")}
                      for k, c in cases.items()},
            "detect_cfgs": {k: d["cfg"] for k, d in detect.items()},
            "detect_weights": {k: d["weights"] for k, d in detect.items()},
            "detect_images": {k: d["images"] for k, d in detect.items()},
            "serve_cfg": t_serve, "serve_weights": serve["weights"],
            "serve_images": serve_images, "serve_scales": serve["scales"]}
    plan_path = str(root / "plan.pt")
    torch.save(plan, plan_path)
    ctx = mp.start_processes(_rank_main, args=(plan_path, str(root)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for name, case in cases.items():
            if CASES[name]["jax"]:
                case["jax"] = jax_train_steps(case)
        for d in detect.values():
            d["jax"] = _jax_detect(d)
        serve["jax"] = _jax_tta(serve)
        serve["export"] = _unsplit_export(serve_module, serve_anchors, t_serve)
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(str(root / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    serve["split_artifact"] = str(root / "split.sbdx")
    return cases, detect, ranks, serve


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


def _jax_tta(serve):
    """The JAX package's hflip detect and two-scale MultiScaleBatchDetector
    on the serving images."""
    import jax.numpy as jnp

    from shape_based_object_detection_tpu import detection as jax_det
    from shape_based_object_detection_tpu.models.factory import build_module
    from shape_based_object_detection_tpu.ops.anchors import anchors_for_model
    from tests.torch_parity import with_detect

    cfg = serve["j_cfg"]
    hcfg = with_detect(cfg.model, tta_hflip=True)
    images = jnp.asarray(serve["images"])
    hflip = jax_det.make_detect_fn(build_module(hcfg), anchors_for_model(hcfg), hcfg,
                                   cfg.data, use_pallas=False)(serve["variables"], images)
    scales = jax_det.MultiScaleBatchDetector(cfg.model, serve["variables"], TTA_SCALES,
                                             cfg.data, use_pallas=False)(serve["variables"],
                                                                         images)
    return {"hflip": hflip, "scales": scales}


def _unsplit_export(module, anchors, cfg):
    from shape_based_object_detection_torch import export

    return export.export_detect(module, anchors, cfg.model, cfg.data, batch_size=2,
                                device="cpu")


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
    if not CASES[name]["train_bn"]:
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
    ranks = sp[2]
    for r, out in enumerate(ranks):
        assert out["layout"][2] == (r // 2, r % 2, 2, slice(2 * (r // 2), 2 * (r // 2) + 2))
        assert out["layout"][4] == (0, r, 1, slice(0, 4))


@pytest.mark.parametrize("mp_size", [2, 4])
@pytest.mark.parametrize("op", list(OPS) + ["halo"])
def test_row_ops_equal_the_unsplit_ops(sp, mp_size, op):
    ranks = sp[2]
    for out in ranks:
        errs = out["ops"][mp_size][op]
        assert max(errs) <= 1e-6, errs


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_equals_single_process_step(sp, name):
    cases, _, ranks, _ = sp
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


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["jax"]])
def test_split_step_equals_jax_global_step(sp, name):
    """As ``test_torch_parallel.py::test_two_rank_step_equals_jax_global_step``:
    metrics 1e-5 and parameters 2e-5; with ``train_bn`` the loss terms and
    the running statistics at 1e-4."""
    cases, _, ranks, _ = sp
    case = cases[name]
    want_metrics, want = case["jax"]
    got = ranks[0][name]
    train_bn = CASES[name]["train_bn"]
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
    _, detect, ranks, _ = sp
    (want_cls, want_box), _ = detect[name]["jax"]
    for out in ranks:
        got = out["detect"][name]
        rows = got["rows"]
        np.testing.assert_allclose(got["forward"][0].numpy(), want_cls[rows], atol=2e-4)
        np.testing.assert_allclose(got["forward"][1].numpy(), want_box[rows], atol=2e-4)


def _assert_detections_equal(got, want):
    """``test_parallel.py:150-156``'s bounds."""
    got = [np.asarray(t) for t in got]
    want = [np.asarray(t) for t in want]
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

    _, detect, ranks, _ = sp
    d = detect[name]
    module, anchors = build_model(d["cfg"].model, "cpu")
    module.load_state_dict(d["weights"])
    unsplit = [t.numpy() for t in make_detect_fn(module, anchors, d["cfg"].model,
                                                 d["cfg"].data, "cpu")(d["images"])]
    _, jax_det = d["jax"]
    assert unsplit[3].any()
    # SSD's scores crowd: tied detections may swap slots (same_detections)
    check = _assert_detections_match if d["cfg"].model.family == "ssd" else (
        _assert_detections_equal)
    for out in ranks:
        got = out["detect"][name]
        rows = got["rows"]
        for want in (unsplit, jax_det):
            check(got["det"], [t[rows] for t in want])
            check(got["eval"], want)


def _assert_detections_match(got, want):
    """``_assert_detections_equal``'s bounds, each image's detections
    matched one to one in any order."""
    from tests.torch_kernel_cases import same_detections

    assert same_detections(got, want)


def _lists(det):
    """Fixed-size Detections -> per image (boxes, scores, labels) of the
    valid slots."""
    out = []
    for i in range(det.valid.shape[0]):
        v = np.asarray(det.valid[i])
        out.append(tuple(np.asarray(t[i])[v] for t in (det.boxes, det.scores, det.labels)))
    return out


@pytest.mark.parametrize("tta", ["hflip", "scales"])
def test_split_tta_equals_unsplit_and_jax(sp, tta):
    """hflip TTA and two-scale TTA (128 and 160 px: P7's one row and P5's
    five over two ranks) on 2 x 2: each rank's detections of its data
    index's images equal the unsplit port's at the reference's bounds, and
    match the JAX package's (label, box IoU >= 0.99, score within 1e-3,
    ``tests/test_torch_tta.py``'s bars)."""
    from shape_based_object_detection_torch.detection import (
        MultiScaleBatchDetector, make_detect_fn,
    )
    from tests.torch_parity import assert_matched, port_model, with_detect

    *_, ranks, serve = sp
    cfg = serve["cfg"]
    module, anchors = port_model(cfg.model, serve["variables"])
    if tta == "hflip":
        unsplit = make_detect_fn(module, anchors, with_detect(cfg.model, tta_hflip=True),
                                 cfg.data, "cpu")(serve["images"])
    else:
        unsplit = MultiScaleBatchDetector(cfg.model, module, TTA_SCALES, cfg.data,
                                          "cpu")(serve["images"])
    assert unsplit.valid.any()
    want = serve["jax"][tta]
    for out in ranks:
        rows = out["serve"]["rows"]
        got = out["serve"][tta]
        _assert_detections_equal(got, [t[rows] for t in unsplit])
        assert_matched(_lists(got), _lists(want)[rows], [1.0] * (rows.stop - rows.start))


@pytest.mark.parametrize("tier", TIERS)
def test_split_int8_tier_equals_unsplit(sp, tier):
    """The weight-only, full-dynamic and full-static tiers (every
    convolution int8, ``min_size=1``) on 2 x 2: every int8 product of the
    split forward bit-equal to the unsplit tier's rows, the detections at
    the reference's bounds against the unsplit tier run in the test; the
    dynamic scale is the MAX over the model group, so every rank quantizes
    with the whole image's."""
    from shape_based_object_detection_torch import quantize
    from shape_based_object_detection_torch.detection import make_detect_fn
    from tests.torch_parity import port_model

    *_, ranks, serve = sp
    cfg = serve["cfg"]
    module, anchors = port_model(cfg.model, serve["variables"])
    qmodule = quantize.quantize_module(module, "weights" if tier == "weights" else "full",
                                       serve["scales"] if tier == "static" else None,
                                       min_size=1, device="cpu")
    unsplit = make_detect_fn(qmodule, anchors, cfg.model, cfg.data, "cpu")(serve["images"])
    assert unsplit.valid.any()
    for out in ranks:
        rows = out["serve"]["rows"]
        got = out["serve"]["tiers"][tier]
        assert not got["products_differ"]
        assert (got["products"] > 0) == (tier != "weights")
        _assert_detections_equal(got["det"], [t[rows] for t in unsplit])
        _assert_detections_equal(got["det"], got["unsplit"])


def test_split_calibration_and_export_equal_unsplit(sp):
    """``calibrate_activation_scales`` on the row-split module gives the
    unsplit module's abs-maxes (one MAX all-reduce per batch over the model
    group; the float forwards may differ in the last bit), and the artifact
    exported from a row-split module is the unsplit program: its
    detections equal the unsplit module's export, bit for bit."""
    from shape_based_object_detection_torch import export

    *_, ranks, serve = sp
    for out in ranks:
        got = out["serve"]["calibrated"]
        assert set(got) == set(serve["scales"])
        for k, v in serve["scales"].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    assert ranks[0]["serve"]["export_kept_shard"]
    split = export.load_artifact(serve["split_artifact"], "cpu")
    unsplit = export.load_detect(serve["export"], "cpu")
    images = serve["images"][:2]
    for g, w in zip(split(images), unsplit(images)):
        assert torch.equal(g, w)
    assert unsplit(images).valid.any()


def test_what_still_raises_under_a_model_axis():
    """A model axis that does not divide the world, a size at which a map
    falls under one row (SSD's extras), and a full tensor passed to a split
    forward raise ValueError, before any collective; every other size
    splits, and ``set_row_shard`` reaches every module that splits."""
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.parallel import (
        Mesh, make_mesh_for_batch, set_row_shard, spatial_image_sharding,
    )
    from shape_based_object_detection_torch.quantize import Int8Conv2d, quantize_module

    mesh = Mesh(None, 1, 2, torch.device("cpu"), 2)
    with pytest.raises(ValueError, match="does not divide the world size 3"):
        make_mesh_for_batch(6, Mesh(None, 0, 3, torch.device("cpu")),
                            config.MeshConfig(model_parallelism=2))
    ssd = config.tiny_test_model("ssd")
    with pytest.raises(ValueError, match="too small for the SSD extras"):
        spatial_image_sharding(mesh, model=dataclasses.replace(ssd, image_size=64))
    retina = config.tiny_test_model("retinanet")
    for model in (retina, dataclasses.replace(retina, image_size=384), ssd):
        assert spatial_image_sharding(mesh, model=model).index == 1
    shard = spatial_image_sharding(mesh)
    for model in (retina, ssd):
        module, _ = build_model(model, "cpu")
        set_row_shard(module, shard)
        splits = [m for m in module.modules() if hasattr(m, "row_shard")]
        assert splits and all(m.row_shard is shard for m in splits)
        size = model.image_size
        with pytest.raises(ValueError, match="RowShard.split"):
            module(torch.zeros(1, 3, size, size))
        qmodule = quantize_module(module, "full", device="cpu")
        assert all(m.row_shard is shard for m in qmodule.modules()
                   if isinstance(m, Int8Conv2d))
