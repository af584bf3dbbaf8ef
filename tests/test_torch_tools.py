"""The port's checkpoint tools on the CPU (``--device cpu``) against the JAX
package's, on the tiny presets: ``tools/average_checkpoints`` bit-equal to
the reference's ``average_states`` (with and without EMA), its selection
and guards, its output restored by ``eval_cli`` and a ``train_cli`` resume;
``tools/convert_checkpoint`` on a synthetic torchvision VGG-16 equal to the
reference's ``load_pretrained_vgg_into_flax`` and loaded by ``train_cli
--init-params``, its ``mirror`` round trip, and SSD-300 weights refused by
config #3's SSD-512 in both packages."""

import contextlib
import dataclasses
import functools
import io

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu import train as jax_train
from shape_based_object_detection_tpu.utils import vgg_surgery as ref_vgg
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch import train as train_lib
from shape_based_object_detection_torch.checkpoint import CheckpointManager
from shape_based_object_detection_torch.cli import eval_cli, train_cli
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.tools import average_checkpoints, convert_checkpoint
from shape_based_object_detection_torch.utils.convert import state_dict_from_jax_variables
from tests.torch_kernel_cases import torchvision_vgg16
from tests.torch_parity import jax_variables, one_torch_thread  # noqa: F401
from tools.average_checkpoints import average_states

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = ["--device", "cpu"]


def _quiet(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _configs(ema: bool):
    """The tiny RetinaNet preset of both packages, with or without EMA."""
    decay = 0.9 if ema else 0.0
    j = jax_config.get_config("tiny_retinanet")
    t = torch_config.get_config("tiny_retinanet")
    return (dataclasses.replace(j, train=dataclasses.replace(j.train, ema_decay=decay)),
            dataclasses.replace(t, train=dataclasses.replace(t.train, ema_decay=decay)))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _variables(seed):
    """The tiny RetinaNet's flax module and variables of its shapes with
    random float leaves from ``seed`` (numpy), made once per process."""
    module, variables = jax_variables(jax_config.get_config("tiny_retinanet").model)
    rng = np.random.default_rng(seed)
    return module, jax.tree_util.tree_map(
        lambda x: rng.normal(0.0, 0.5, x.shape).astype(np.float32), variables)


SEEDS = (1, 2, 3)  # steps 1-3; each step's EMA from seed + 10


def _write_runs(tmp_path, ema, ema_from=1):
    """The port's checkpoint directory (steps 1-3, random float leaves) and
    its config file. ``ema_from``: the first step that has an EMA."""
    _, tcfg = _configs(ema)
    module, _ = build_model(tcfg.model, "cpu", train=True)
    ckpt = tmp_path / "run"
    mgr = CheckpointManager(str(ckpt), keep=5, async_save=False)
    for step, seed in enumerate(SEEDS, start=1):
        _, variables = _variables(seed)
        module.load_state_dict(state_dict_from_jax_variables(variables), strict=True)
        state = train_lib.create_train_state(module, tcfg, device="cpu")
        state.step = step
        state.ema = None
        if ema and step >= ema_from:
            sd = state_dict_from_jax_variables({**variables,
                                                "params": _variables(seed + 10)[1]["params"]})
            state.ema = {n: sd[n] for n, _ in module.named_parameters()}
        mgr.save(state)
    mgr.close()
    torch_config.save_config_file(tcfg, str(tmp_path / "config.json"))
    return str(ckpt), str(tmp_path / "config.json")


def _reference(ema, steps):
    """The reference's ``average_states`` over the same leaves' TrainStates
    at ``steps``, as state dicts of the port: (parameters and buffers, EMA
    or None)."""
    states = []
    for step in steps:
        _, variables = _variables(SEEDS[step - 1])
        states.append(jax_train.TrainState(
            step=step, params=variables["params"],
            extra_vars={k: v for k, v in variables.items() if k != "params"},
            opt_state=None, rng=None,
            ema_params=_variables(SEEDS[step - 1] + 10)[1]["params"] if ema else None))
    avg = average_states(states)
    extra = _numpy(avg.extra_vars)
    return (state_dict_from_jax_variables({**extra, "params": _numpy(avg.params)}),
            state_dict_from_jax_variables({**extra, "params": _numpy(avg.ema_params)})
            if ema else None)


@pytest.mark.parametrize("ema", [False, True])
def test_average_bit_equal_to_reference(tmp_path, ema):
    """Parameters, buffers (BatchNorm statistics) and the EMA of three
    checkpoints averaged by the tool equal the reference's ``average_states``
    of the same leaves, to the bit; the step is the newest's."""
    ckpt, cfg_path = _write_runs(tmp_path, ema)
    out = str(tmp_path / "avg")
    printed = _quiet(average_checkpoints.main,
                     ["--config", cfg_path, "--checkpoint-dir", ckpt, "--out", out, *CPU])
    assert "averaged 3 checkpoints [1, 2, 3]" in printed
    want, want_ema = _reference(ema, [1, 2, 3])
    snap = CheckpointManager(out).read(3)
    assert snap["step"] == 3
    got = {**snap["params"], **snap["buffers"]}
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].view(torch.int32), v.view(torch.int32)), k
    if ema:
        assert snap["ema"] and all(torch.equal(t.view(torch.int32), want_ema[k].view(torch.int32))
                                   for k, t in snap["ema"].items())
    else:
        assert snap["ema"] is None


def test_average_selects_steps_and_last(tmp_path):
    """``--steps`` then ``--last``: the newest two of the named steps."""
    ckpt, cfg_path = _write_runs(tmp_path, False)
    out = str(tmp_path / "avg")
    printed = _quiet(average_checkpoints.main,
                     ["--config", cfg_path, "--checkpoint-dir", ckpt, "--out", out,
                      "--steps", "1,2,3", "--last", "2", *CPU])
    assert "averaged 2 checkpoints [2, 3]" in printed
    want, _ = _reference(False, [2, 3])
    snap = CheckpointManager(out).read(3)
    assert all(torch.equal(snap["params"][k], want[k]) for k in snap["params"])


@pytest.mark.parametrize("args,match", [
    (["--steps", "1,9"], "not retained"),
    (["--steps", "1,x"], "comma-separated"),
    (["--last", "1"], "need >=2"),
    (["--steps", "2"], "need >=2"),
])
def test_average_guards(tmp_path, args, match):
    ckpt, cfg_path = _write_runs(tmp_path, False)
    with pytest.raises(SystemExit, match=match):
        average_checkpoints.main(["--config", cfg_path, "--checkpoint-dir", ckpt,
                                  "--out", str(tmp_path / "avg"), *args, *CPU])


def test_average_refuses_mixed_ema_and_an_empty_directory(tmp_path):
    ckpt, cfg_path = _write_runs(tmp_path, True, ema_from=3)
    with pytest.raises(SystemExit, match="disagree on EMA"):
        average_checkpoints.main(["--config", cfg_path, "--checkpoint-dir", ckpt,
                                  "--out", str(tmp_path / "avg"), *CPU])
    # the consistent subset averages
    _quiet(average_checkpoints.main, ["--config", cfg_path, "--checkpoint-dir", ckpt,
                                      "--out", str(tmp_path / "avg"), "--steps", "1,2", *CPU])
    with pytest.raises(SystemExit, match="no checkpoints"):
        average_checkpoints.main(["--config", cfg_path, "--checkpoint-dir",
                                  str(tmp_path / "empty"), "--out", str(tmp_path / "x"), *CPU])


def test_average_output_serves_and_resumes(tmp_path):
    """A train_cli run's last three checkpoints averaged: eval_cli restores
    the result, and train_cli resumes from it at the newest step."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "avg")
    train = ["--config", "tiny_retinanet", "--workers", "0", "--set",
             "train.checkpoint_every=1", *CPU]
    _quiet(train_cli.main, [*train, "--steps", "3", "--checkpoint-dir", ckpt])
    assert CheckpointManager(ckpt).all_steps() == [1, 2, 3]
    _quiet(average_checkpoints.main, ["--config", "tiny_retinanet", "--checkpoint-dir", ckpt,
                                      "--out", out, "--last", "3", *CPU])
    printed = _quiet(eval_cli.main, ["--config", "tiny_retinanet", "--checkpoint-dir", out,
                                     "--max-batches", "1", *CPU])
    assert "mAP" in printed
    printed = _quiet(train_cli.main, [*train, "--steps", "4", "--checkpoint-dir", out])
    assert "restored checkpoint at step 3" in printed and "done at step 4" in printed


def test_convert_vgg_backbone_equals_reference_and_trains(tmp_path):
    """A synthetic torchvision VGG-16 at the tiny SSD's widths converted by
    the tool: its 15 VGG layers equal the reference's merge through
    ``utils/convert.py``, every other layer keeps the model's initial value,
    and ``train_cli --init-params`` loads the file (strict) and trains."""
    sd = torchvision_vgg16(np.random.default_rng(4), width=64, fc=512)
    torch.save(sd, tmp_path / "vgg16.pth")
    out = str(tmp_path / "init.pt")
    printed = _quiet(convert_checkpoint.main,
                     ["--model", "tiny_ssd", "--torch-ckpt", str(tmp_path / "vgg16.pth"),
                      "--mode", "vgg_backbone", "--out", out, *CPU])
    assert f"wrote {out}" in printed
    got = torch.load(out, weights_only=True)
    _, variables = jax_variables(jax_config.get_config("tiny_ssd").model, seed=3)
    want = state_dict_from_jax_variables(ref_vgg.load_pretrained_vgg_into_flax(sd, variables))
    fresh, _ = build_model(torch_config.get_config("tiny_ssd").model, "cpu", train=True)
    assert set(got) == set(want) == set(fresh.state_dict())
    vgg = [k for k in got if k.startswith("vgg.conv")]
    assert len(vgg) == 30
    for k in got:
        expect = want[k] if k in vgg else fresh.state_dict()[k]
        assert torch.equal(got[k], expect), k
    printed = _quiet(train_cli.main, ["--config", "tiny_ssd", "--steps", "2", "--workers", "0",
                                      "--checkpoint-dir", str(tmp_path / "ckpt"),
                                      "--init-params", out, *CPU])
    assert "initialized params from" in printed and "done at step 2" in printed


def test_convert_mirror_round_trips(tmp_path):
    """A state dict in the port's (the mirror's) names comes back as it
    went in; a foreign key is refused by name."""
    module, _ = build_model(torch_config.get_config("tiny_retinanet").model, "cpu", train=True)
    gen = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
          for k, v in module.state_dict().items()}
    torch.save(sd, tmp_path / "mirror.pt")
    out = str(tmp_path / "out.pt")
    _quiet(convert_checkpoint.main, ["--model", "tiny_retinanet", "--torch-ckpt",
                                     str(tmp_path / "mirror.pt"), "--out", out, *CPU])
    got = torch.load(out, weights_only=True)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    torch.save({**sd, "extra.weight": torch.zeros(1)}, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="extra.weight"):
        convert_checkpoint.main(["--model", "tiny_retinanet", "--torch-ckpt",
                                 str(tmp_path / "bad.pt"), "--out", out, *CPU])
    with pytest.raises(SystemExit, match="into an SSD"):
        convert_checkpoint.main(["--model", "tiny_retinanet", "--torch-ckpt",
                                 str(tmp_path / "mirror.pt"), "--mode", "vgg_backbone",
                                 "--out", out, *CPU])


def test_ssd300_weights_into_config3_raise_in_both_packages(tmp_path):
    """The user guide's pair, SSD-300 weights into config #3's SSD-512 (at
    1/8 width here): SSD-512 has a seventh head and a conv12 extra, and 21
    classes where SSD-300 has 81. The reference's orbax restore refuses the
    tree; the port's strict load refuses the keys, naming them."""
    narrow = lambda cfg: dataclasses.replace(cfg.model, width_mult=0.125)
    _, src = jax_variables(narrow(jax_config.get_config("ssd300")))
    _, dst = jax_variables(narrow(jax_config.get_config("config3_ssd512_voc_train")))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "orbax"), src)
    ckptr.wait_until_finished()
    with pytest.raises(ValueError, match="tree structures do not match"):
        ckptr.restore(str(tmp_path / "orbax"), dst)

    module, _ = build_model(narrow(torch_config.get_config("ssd300")), "cpu", train=True)
    torch.save(module.state_dict(), tmp_path / "ssd300.pt")
    with pytest.raises(RuntimeError, match=r"(?s)Missing key.*cls_6.*size mismatch"):
        train_cli.main(["--config", "config3_ssd512_voc_train", "--set",
                        "model.width_mult=0.125", "--steps", "1", "--workers", "0",
                        "--checkpoint-dir", str(tmp_path / "ckpt"),
                        "--init-params", str(tmp_path / "ssd300.pt"), *CPU])


def test_tools_default_to_the_card(tmp_path):
    """Without ``--device cpu`` both tools run on the card, and raise where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    ckpt, cfg_path = _write_runs(tmp_path, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        average_checkpoints.main(["--config", cfg_path, "--checkpoint-dir", ckpt,
                                  "--out", str(tmp_path / "avg")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_checkpoint.main(["--model", "tiny_ssd", "--torch-ckpt", "unused.pth",
                                 "--out", str(tmp_path / "x.pt")])
