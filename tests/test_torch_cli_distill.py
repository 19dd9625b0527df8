"""`python -m upgpt_torch.cli distill` and the distilled-student sidecar
in `sample`, `test` and `serve`, on the CPU.

The JAX package's `configs/deepfashion/interp_256.yaml` with a dotlist
that puts the `tiny` variant on the CPU at an 8x8 latent (16x16 images):
`distill --synthetic` from a seeded teacher checkpoint writes a v student
and its grid sidecar, and `sample` from it equals the pipeline on that
grid (eta-0 DDIM) bit for bit: one process, the same operations on the
same inputs. A sidecar written by JAX's `cmd_distill` (its ladder replaced
by a stub that returns the teacher's weights as a v student, so nothing
compiles) is read the same way once the JAX student is bridged. JAX's
`cmd_distill` drops a student teacher's sidecar (ROADMAP R15), which the
stubs record; the port continues its grid at its parameterisation.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_torch import cli  # noqa: E402
from upgpt_torch.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint,
)
from upgpt_torch.config import (  # noqa: E402
    instantiate_from_config, merge_configs,
)
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.inference import pipeline as tpipe  # noqa: E402
from upgpt_torch.training import distill as td  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")
MODEL = ["model.params.variant=tiny", "model.params.device=cpu",
         "model.params.latent_size=(8,8)"]
LADDER = ["--start-steps", "8", "--end-steps", "2", "--stage-steps", "2",
          "--adapt-steps", "1", "--batch", "2", "--grid", "karras",
          "--synthetic"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # its import pulls in TensorFlow here (~17 s a process)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _redraw(model, seed):
    """Every parameter drawn (weights N(0, 1/fan_in), norm scales
    1 + 0.1 N, the rest 0.1 N): no zero-initialised layer hides the
    teacher's two sub-steps."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                z = z / p[0].numel() ** 0.5
            else:
                z = (1.0 if name.endswith("weight") else 0.0) + 0.1 * z
            p.copy_(z)
    return model


def _data(tree):
    out = [f"data.{s}.params.{k}={tree[v]}"
           for s in ("train", "validation", "test")
           for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    out += [f"data.{s}.params.{k}={v}" for s in ("train", "validation",
                                                  "test")
            for k, v in (("image_size", "[16,16]"), ("f", 2))]
    out += [f"data.train.params.pair_file=['{tree['train']}']",
            f"data.validation.params.pair_file=['{tree['validation']}']",
            f"data.test.params.pair_file=['{tree['validation']}']"]
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (1, 1), "validation": (2, 0)},
                              image_hw=(16, 16), seed=2)


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill")
    teacher = str(root / "teacher.pt")
    save_checkpoint(_redraw(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8)), 0), teacher)
    out = str(root / "student.pt")
    result = cli.main(["distill", "--base", CONFIG, "--teacher-ckpt",
                       teacher, "--out", out, *LADDER] + MODEL)
    return teacher, out, result


def _sample(ckpt, tree, out):
    return cli.main(["sample", "--base", CONFIG, "--debug-encoder",
                     "--ckpt", ckpt, "--batch", "2", "--steps", "7",
                     "--sampler", "unipc", "--out", str(out)]
                    + _data(tree) + MODEL)


def _pipeline_images(ckpt, tree, parameterization, grid):
    """The pipeline on `grid`, eta 0, over the weights of `ckpt`, the
    first test batch through the debug encoder and the sampler's seed."""
    from upgpt_torch.data.deepfashion import DataLoader
    from upgpt_torch.inference.encoders import DebugConditioningEncoder

    cfg = merge_configs([CONFIG], _data(tree) + MODEL)
    model_cfg = dict(cfg["model"])
    model_cfg["params"] = dict(model_cfg["params"],
                               parameterization=parameterization)
    model = load_checkpoint(instantiate_from_config(model_cfg), ckpt)
    raw = next(DataLoader(instantiate_from_config(cfg["data"]["test"]), 2,
                          shuffle=False).epoch(0))
    batch = DebugConditioningEncoder().encode_batch(raw)
    batch = {k: torch.as_tensor(np.asarray(batch[k]))
             for k in ("text_emb", "style_emb", "smpl", "person_mask")}
    return tpipe.GenerationPipeline(
        model, num_steps=len(grid), eta=0.0, timesteps=grid).generate(
            batch, torch.Generator().manual_seed(0)).float().numpy()


def test_cli_distill_writes_the_student_and_its_sidecar(distilled, capsys):
    teacher, out, result = distilled
    meta = json.loads(open(out + ".distill.json").read())
    assert set(meta) == {"parameterization", "timesteps", "history"}
    assert meta["parameterization"] == "v"
    student = result["student"]
    want = td.make_distill_grids(student.schedule, 8, 2, method="karras")
    assert meta["timesteps"] == want[-1].tolist() == result["grid"].tolist()
    # the adapt entry, then one per halving stage
    assert [(h["stage"], h["steps"]) for h in meta["history"]] == [
        (-1, 8), (0, 4), (1, 2)]
    assert meta["history"][0]["adapt"] is True
    assert all(np.isfinite(h["loss"]) for h in meta["history"])
    assert set(meta["history"][1]) == {"stage", "steps", "loss", "loss_x",
                                       "teacher_gap"}
    assert set(result["seconds"]) == {"load", "adapt", "stages", "write"}
    # the student moved from the teacher and holds float32 masters
    t_weights = torch.load(teacher, weights_only=True)
    s_weights = torch.load(out, weights_only=True)
    assert set(s_weights) == {"unet", "pose", "vae"}
    assert s_weights["unet"]["conv_in.weight"].dtype == torch.float32
    assert any(not torch.equal(t_weights["unet"][k], v)
               for k, v in s_weights["unet"].items())
    for k, v in t_weights["vae"].items():
        assert torch.equal(s_weights["vae"][k], v), k


def test_cli_sample_from_the_student_equals_its_grid(distilled, tree,
                                                     tmp_path, capsys):
    """--steps and --sampler do not apply to a student: it samples eta-0
    DDIM on its own grid."""
    _, out, result = distilled
    imgs = _sample(out, tree, tmp_path / "out")
    assert "distilled student: v-param, 2-step grid" in (
        capsys.readouterr().err)
    assert sorted(os.listdir(tmp_path / "out")) == ["sample_000.jpg",
                                                    "sample_001.jpg"]
    want = _pipeline_images(out, tree, "v", result["grid"])
    np.testing.assert_array_equal(imgs, want)


def test_cli_test_and_serving_honour_the_sidecar(distilled, tree, tmp_path,
                                                 monkeypatch):
    _, out, result = distilled
    grid = result["grid"].tolist()
    made = []
    init = tpipe.GenerationPipeline.__init__

    def spy(self, model, *a, **kw):
        init(self, model, *a, **kw)
        made.append((model.config.parameterization, self.sampler, self.eta,
                     self.ddim.timesteps.tolist()))

    monkeypatch.setattr(tpipe.GenerationPipeline, "__init__", spy)
    res = cli.main(["test", "--base", CONFIG, "--debug-encoder", "--ckpt",
                    out, "--steps", "5", "--batch", "2", "--max-images",
                    "2", "--out", str(tmp_path / "results"),
                    "eval.crop_size=[16,16]"] + _data(tree) + MODEL)
    assert made == [("v", "ddim", 0.0, grid[::-1])]
    assert set(res["metrics"]) >= {"ssim"}
    cfg = merge_configs([CONFIG], MODEL)
    args = argparse.Namespace(
        ckpt=out, debug_encoder=True, batch=2, max_delay=0.05, seed=0,
        steps=50, sampler="unipc", schedule="karras", in_flight=2,
        upscale_base=None, upscale_ckpt=None, dp=1, tp=1)
    engine, builder, label = cli._build_serving(cfg, args)
    assert label == f"distilled-2 {grid}"
    assert made[-1] == ("v", "ddim", 0.0, grid[::-1])
    assert engine.pipeline.output_uint8


def test_cli_distill_on_the_configs_train_split(distilled, tree, tmp_path):
    """Without --synthetic the ladder reads the config's train loader
    through the conditioning encoder."""
    teacher, _, _ = distilled
    result = cli.main(["distill", "--base", CONFIG, "--debug-encoder",
                       "--teacher-ckpt", teacher, "--out",
                       str(tmp_path / "s.pt"), "--start-steps", "4",
                       "--end-steps", "2", "--stage-steps", "2",
                       "--adapt-steps", "1", "--batch", "2"]
                      + _data(tree) + MODEL)
    assert [(h["stage"], h["steps"]) for h in result["history"]] == [
        (-1, 4), (0, 2)]
    assert all(np.isfinite(h["loss"]) for h in result["history"])


def test_cli_distill_refuses_a_bad_config_before_loading(tmp_path):
    """ROADMAP R4: JAX's ladder reads a stage's metrics after a loop that
    never ran; the port refuses the flags before reading the teacher."""
    with pytest.raises(SystemExit, match="steps_per_stage"):
        cli.main(["distill", "--base", CONFIG, "--teacher-ckpt",
                  str(tmp_path / "missing.pt"), "--out",
                  str(tmp_path / "s.pt"), "--stage-steps", "0"] + MODEL)


@pytest.mark.parametrize("sidecar,match", [
    ("{}", "parameterization"),
    ('{"parameterization": "v"}', "timesteps"),
    ("not json", "JSONDecodeError"),
    ('{"parameterization": "v", "timesteps": [400, 90]}', "ascending"),
    ('{"parameterization": "v", "timesteps": [0, 500]}', "must lie in"),
    ('{"parameterization": "q", "timesteps": [90, 500]}', "unknown")])
def test_malformed_sidecar_exits_naming_the_file(distilled, tmp_path,
                                                 sidecar, match):
    _, out, _ = distilled
    ckpt = tmp_path / "student.pt"
    ckpt.write_bytes(open(out, "rb").read())
    (tmp_path / "student.pt.distill.json").write_text(sidecar)
    with pytest.raises(SystemExit, match=match) as exc:
        cli._load_model(merge_configs([CONFIG], MODEL)["model"], str(ckpt))
    assert "student.pt.distill.json" in str(exc.value)


def test_an_upscale_checkpoint_with_a_sidecar_is_refused(tmp_path):
    up = tmp_path / "up.pt"
    (tmp_path / "up.pt.distill.json").write_text("{}")
    args = argparse.Namespace(
        ckpt=str(tmp_path / "base.pt"), debug_encoder=True, batch=2,
        max_delay=0.05, seed=0, steps=2, sampler="ddim", schedule=None,
        in_flight=2, upscale_base=["x.yaml"], upscale_ckpt=str(up), dp=1,
        tp=1)
    with pytest.raises(SystemExit, match="no upscale students"):
        cli._build_serving({}, args)


# ------------------------------------------------- JAX's cmd_distill


def _jax_teacher(tmp_path):
    """A JAX tiny teacher at the 8x8 latent, seeded weights from the
    abstract shapes (a flax init would compile op by op), saved with
    orbax as JAX's `cli convert` lays it out."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from upgpt_tpu.zoo import build_latent_diffusion as jax_build

    jm = jax_build("tiny", latent_size=(8, 8))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.05 * rng.normal(size=a.shape), a.dtype),
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    path = tmp_path / "jax_teacher"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path.absolute(), params, force=True)
    ckptr.wait_until_finished()
    return path, params


def _jax_args(teacher, out):
    return argparse.Namespace(
        teacher_ckpt=str(teacher), out=str(out), start_steps=8, end_steps=2,
        stage_steps=2, lr=2e-4, batch=2, grid="karras", ema_decay=0.999,
        adapt_steps=1, seed=0, synthetic=True, debug_encoder=False)


JAX_CFG = {"model": {"target": "upgpt_tpu.zoo.build_latent_diffusion",
                     "params": {"variant": "tiny", "latent_size": (8, 8)}}}


def test_a_sidecar_written_by_jax_is_read(tree, tmp_path, monkeypatch,
                                          capsys):
    """JAX's cmd_distill writes its orbax student and sidecar (its ladder
    stubbed to hand the teacher's weights back as a v student on a fixed
    grid); the student bridged by `convert.from_jax` and saved by
    `save_checkpoint` beside JAX's sidecar samples on that grid."""
    import dataclasses

    import orbax.checkpoint as ocp

    from upgpt_tpu import cli as jax_cli
    from upgpt_tpu.diffusion.latent_diffusion import LatentDiffusion
    from upgpt_tpu.training import distill as jd
    from upgpt_torch.convert.from_jax import load_jax_params

    teacher, _ = _jax_teacher(tmp_path)
    grid = np.asarray([237, 999])

    def ladder(model, params, frozen, data_iter, config, **kw):
        student = LatentDiffusion(dataclasses.replace(
            model.config, parameterization="v"))
        return student, params, grid, [{"stage": 0, "steps": 2,
                                        "loss": 0.5}]

    monkeypatch.setattr(jd, "progressive_distill", ladder)
    jax_cli.cmd_distill(JAX_CFG, _jax_args(teacher, tmp_path / "jax_out"))
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2
    tree_ = ocp.StandardCheckpointer().restore(
        (tmp_path / "jax_out").absolute())
    port = load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8), parameterization="v"),
        tree_)
    ckpt = str(tmp_path / "bridged.pt")
    save_checkpoint(port, ckpt)
    sidecar = (tmp_path / "jax_out.distill.json").read_text()
    assert json.loads(sidecar)["timesteps"] == grid.tolist()
    open(ckpt + ".distill.json", "w").write(sidecar)
    imgs = _sample(ckpt, tree, tmp_path / "out")
    np.testing.assert_array_equal(
        imgs, _pipeline_images(ckpt, tree, "v", grid))


def test_r15_a_student_teacher_continues_its_grid(tmp_path, monkeypatch):
    """ROADMAP R15: handed a student (a checkpoint with a v sidecar) as the
    teacher, JAX's cmd_distill builds it at the config's eps and hands
    its ladder no start grid; the port builds it at v and continues the
    sidecar's grid (so no adapt phase runs: the teacher is v)."""
    from upgpt_tpu import cli as jax_cli
    from upgpt_tpu.training import distill as jd

    saved = np.asarray([31, 237, 613, 999])
    meta = json.dumps({"parameterization": "v",
                       "timesteps": saved.tolist(), "history": []})
    seen = {}

    def jax_ladder(model, params, frozen, data_iter, config, **kw):
        seen["jax"] = (model.config.parameterization, kw.get("start_grid"),
                       config.adapt_steps)
        raise KeyboardInterrupt  # stop before JAX writes anything

    teacher, _ = _jax_teacher(tmp_path)
    (tmp_path / "jax_teacher.distill.json").write_text(meta)
    monkeypatch.setattr(jd, "progressive_distill", jax_ladder)
    with pytest.raises(KeyboardInterrupt):
        jax_cli.cmd_distill(JAX_CFG, _jax_args(teacher, tmp_path / "j"))
    assert seen["jax"] == ("eps", None, 1)

    port_teacher = str(tmp_path / "student.pt")
    save_checkpoint(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8), parameterization="v"),
        port_teacher)
    open(port_teacher + ".distill.json", "w").write(meta)

    real = td.progressive_distill

    def port_ladder(teacher, data_iter, config, **kw):
        seen["port"] = (teacher.config.parameterization,
                        kw["start_grid"].tolist())
        return real(teacher, data_iter, config, **kw)

    monkeypatch.setattr(td, "progressive_distill", port_ladder)
    result = cli.main(["distill", "--base", CONFIG, "--teacher-ckpt",
                       port_teacher, "--out", str(tmp_path / "next.pt"),
                       "--end-steps", "2", "--stage-steps", "1",
                       "--adapt-steps", "3", "--batch", "2", "--synthetic"]
                      + MODEL)
    assert seen["port"] == ("v", saved.tolist())
    assert result["grid"].tolist() == [237, 999]
    # one stage, no adapt entry
    assert [(h["stage"], h["steps"]) for h in result["history"]] == [(0, 2)]
