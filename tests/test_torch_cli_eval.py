"""`python -m upgpt_torch.cli test`, `eval` and `train-vae` on the CPU.

- `test`: the JAX package's `configs/deepfashion/interp_256.yaml` with a
  dotlist that points its data at a DeepFashion-shaped tree of 64x48
  images (four distinct test pairs) and its model at the `tiny` variant
  on the CPU, from a checkpoint of seeded weights, DDIM-2 at batch 2: the
  seven groups of the dump, metrics.json equal to what the run returns
  and prints, JAX's `evaluate_dirs` on the port's dump giving the port's
  SSIM (2e-5 absolute: the smooth images' local variances cancel in
  float32 on both sides). `--fid-weights` takes a pt_inception .pth and
  refuses a directory (JAX's orbax layout), naming ROADMAP item 11.
- `eval --dir` reproduces metrics.json.
- `train-vae`: `configs/autoencoder/kl_f8_deepfashion.yaml` with a tiny
  autoencoder (ch 32, ch_mult (1, 2)) over 32x32 images, batch 2, the GAN
  terms from step 0; `last` loads back into `build_autoencoder` and the
  loss. R8: the run says on stderr that the perceptual term is off; JAX's
  builds the loss without an LPIPS function, silently. R9: with four
  steps an epoch and `max_steps=2` the port stops after two; JAX's loop
  (its step stubbed, so nothing is compiled) runs the epoch out, four.
"""

import csv
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_torch import cli  # noqa: E402
from upgpt_torch.checkpoint import save_checkpoint  # noqa: E402
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.training.vae_loss import (  # noqa: E402
    LPIPSWithDiscriminator, VAELossConfig,
)
from upgpt_torch.zoo import (  # noqa: E402
    build_autoencoder, build_latent_diffusion,
)
from upgpt_tpu import cli as jax_cli  # noqa: E402
from upgpt_tpu.eval.harness import (  # noqa: E402
    evaluate_dirs as jax_evaluate_dirs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")
VAE_CONFIG = os.path.join(REPO, "configs", "autoencoder",
                          "kl_f8_deepfashion.yaml")
GROUPS = ("samples", "gt", "recon", "src", "smpl", "concats", "styles")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fashion")
    out = write_fashion_tree(root / "tree", {"train": (2, 0),
                                             "validation": (8, 0)},
                             image_hw=(64, 48), seed=4)
    # four distinct pairs: the dump names each image by its pair
    with open(out["validation"], newline="") as f:
        people = sorted({p for r in csv.DictReader(f)
                         for p in (r["from"], r["to"])})
    out["test"] = str(root / "pairs-test.csv")
    with open(out["test"], "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["from", "to"])
        w.writerows((people[i], people[(i + 1) % len(people)])
                    for i in range(4))
    torch.manual_seed(0)
    out["ckpt"] = str(root / "tiny.pt")
    save_checkpoint(build_latent_diffusion("tiny", device="cpu"),
                    out["ckpt"])
    return out


def _dotlist(tree):
    out = [f"data.{s}.params.{k}={tree[v]}"
           for s in ("train", "validation", "test")
           for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    out += [f"data.{s}.params.{k}={v}" for s in ("train", "validation",
                                                  "test")
            for k, v in (("image_size", "[64,48]"), ("f", 2))]
    out += [f"data.train.params.pair_file=['{tree['train']}']",
            f"data.validation.params.pair_file=['{tree['validation']}']",
            f"data.test.params.pair_file=['{tree['test']}']",
            "model.params.variant=tiny", "model.params.device=cpu"]
    return out


@pytest.fixture(scope="module")
def tested(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("results")
    result = cli.main(["test", "--base", CONFIG, "--debug-encoder",
                       "--ckpt", tree["ckpt"], "--steps", "2", "--batch",
                       "2", "--max-images", "4", "--out", str(out)]
                      + _dotlist(tree))
    return out, result


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def test_cli_test_dumps_every_group_and_scores(tested):
    out, result = tested
    for group in GROUPS:
        files = sorted(os.listdir(out / group))
        assert len(files) == 4 and all(f.endswith(".jpg") for f in files)
    metrics = json.loads((out / "metrics.json").read_text())
    assert _same(metrics, result["metrics"])
    assert metrics["n_images"] == 4
    # 64x48 crops have no five MS-SSIM scales: NaN, as JAX scores them
    assert math.isnan(metrics["ms_ssim"]) and "fid" not in metrics
    assert set(result["seconds"]) == {"sampling", "recon", "dump",
                                      "metrics"}
    # the tree's smooth fields have small local variances, which SSIM takes
    # as E[x^2] - mu^2 in float32 on both sides: 4.4e-6 apart here, so an
    # absolute 2e-5 on a score of at most 1
    want = jax_evaluate_dirs(str(out))
    assert metrics["ssim"] == pytest.approx(want["ssim"], abs=2e-5)


def test_cli_eval_reproduces_metrics_json(tested, capsys):
    out, _ = tested
    before = json.loads((out / "metrics.json").read_text())
    got = cli.main(["eval", "--dir", str(out), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _same(got, before) and _same(printed, before)
    assert _same(json.loads((out / "metrics.json").read_text()), before)


def test_fid_weights_take_a_pth_and_refuse_a_directory(tmp_path):
    from upgpt_torch.eval.inception import (
        InceptionFeatureFn, InceptionV3Features,
    )

    state = {}
    for name, mod in InceptionV3Features().named_modules():
        if name and hasattr(mod, "bn_scale"):
            o = mod.bn_scale.numel()
            state[f"{name}.conv.weight"] = mod.conv.weight.detach()
            state[f"{name}.bn.weight"] = torch.ones(o)
            state[f"{name}.bn.bias"] = torch.zeros(o)
            state[f"{name}.bn.running_mean"] = torch.zeros(o)
            state[f"{name}.bn.running_var"] = torch.ones(o)
    torch.save(state, tmp_path / "pt_inception.pth")
    args = cli.parser().parse_args(
        ["eval", "--dir", str(tmp_path), "--fid-weights",
         str(tmp_path / "pt_inception.pth")])
    fn = cli._fid_fn({}, args, "cpu")
    assert isinstance(fn, InceptionFeatureFn) and fn.fid_name == "inception"
    args.fid_weights = str(tmp_path)
    with pytest.raises(SystemExit, match="item 11"):
        cli._fid_fn({}, args, "cpu")
    args.fid_weights = None
    assert cli._fid_fn({}, args, "cpu") is None


def test_cli_test_refuses_tensor_parallel(tree, tmp_path):
    with pytest.raises(SystemExit, match="--tp"):
        cli.main(["test", "--base", CONFIG, "--debug-encoder", "--ckpt",
                  tree["ckpt"], "--tp", "2", "--out", str(tmp_path)]
                 + _dotlist(tree))


TINY_VAE = ["model.params.ch=32", "model.params.ch_mult=(1,2)",
            "model.params.num_res_blocks=1", "model.params.resolution=32"]


@pytest.fixture(scope="module")
def vae_tree(tmp_path_factory):
    # 8 training images, batch 2: four steps an epoch
    return write_fashion_tree(tmp_path_factory.mktemp("vae") / "tree",
                              {"train": (8, 0)}, image_hw=(32, 32), seed=5)


def _vae_dotlist(tree, logdir):
    return [f"data.train.params.folder={tree['folder']}",
            f"data.train.params.data_file={tree['data_file']}",
            f"data.train.params.pair_file=['{tree['train']}']",
            "data.train.params.image_size=[32,32]",
            "trainer.batch_size=2", "trainer.max_steps=2",
            "trainer.log_every=1", "loss.disc_start=0",
            f"trainer.logdir={logdir}"] + TINY_VAE


def test_cli_train_vae_stops_at_max_steps_and_writes_last(vae_tree,
                                                          tmp_path, capsys):
    result = cli.main(["train-vae", *_vae_dotlist(vae_tree, tmp_path),
                       "model.params.device=cpu", "--base", VAE_CONFIG])
    captured = capsys.readouterr()
    # R8: said, not silent
    assert "perceptual term" in captured.err
    # R9: two steps of an epoch of four
    assert result["step"] == 2 and [r["step"] for r in result["logs"]] == [
        1, 2]
    lines = [json.loads(x) for x in captured.out.splitlines()
             if x.startswith("{")]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(v) for x in lines for v in x.values())
    assert all(x["gen/d_weight"] > 0 for x in lines)
    last = torch.load(tmp_path / "last", weights_only=True)
    assert last["step"] == 2 and set(last["loss"]) == {"disc", "disc_stats",
                                                       "logvar"}
    vae = build_autoencoder("kl_f8", "bfloat16", device="cpu", ch=32,
                            ch_mult=(1, 2), num_res_blocks=1, resolution=32)
    vae.load_state_dict(last["vae"], strict=True)
    assert all(torch.equal(a, b) for a, b in zip(
        vae.state_dict().values(), result["vae"].state_dict().values()))
    loss = LPIPSWithDiscriminator(VAELossConfig())
    loss.load_checkpoint_state(last["loss"])
    assert all(torch.equal(a, b) for a, b in zip(
        loss.state_dict().values(), result["loss"].state_dict().values()))


class _NoVAE:
    """Stands in for JAX's autoencoder where only the loop is under test
    (flax's un-jitted init of even the tiny VAE compiles ~240 ops)."""

    def init(self, key, x, key2):
        return {"params": {"w": np.zeros(1, np.float32)}}


def no_vae(**_):
    return _NoVAE()


def test_r8_r9_jax_train_vae_runs_the_epoch_out_without_lpips(
        vae_tree, tmp_path, monkeypatch, capsys):
    """JAX's loop over the same tree and config, its model and step
    stubbed (the loop is under test): it builds the loss without an LPIPS
    function though perceptual_weight is 1.0, says nothing (R8), and
    checks max_steps only after the epoch, so it runs four steps (R9)."""
    from upgpt_tpu.training import vae_trainer as jvt

    seen = []

    def stub(vae, loss_mod, p, lp, opts, os_, b, k, s):
        seen.append(loss_mod)
        return p, lp, os_, {}

    monkeypatch.setattr(jvt, "vae_train_step", stub)
    dotlist = _vae_dotlist(vae_tree, tmp_path) + [
        f"model.target={__name__}.no_vae"]
    jax_cli.main(["train-vae", *dotlist, "--base", VAE_CONFIG])
    captured = capsys.readouterr()
    steps = [json.loads(x)["step"] for x in captured.out.splitlines()
             if x.startswith("{")]
    assert steps == [1, 2, 3, 4]
    assert seen and seen[0].lpips_fn is None
    assert seen[0].config.perceptual_weight == 1.0
    assert "perceptual" not in captured.err
