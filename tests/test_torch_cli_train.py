"""`python -m upgpt_torch.cli train`, `sample` and `data-verify` on the CPU.

The JAX package's own config, `configs/deepfashion/interp_256.yaml`, with a
dotlist that points its data at a DeepFashion-shaped tree of 16x16 images
and its model at the `tiny` variant on the CPU (an 8x8 latent): `train`
builds float32 masters under the config's bf16 compute and writes the
trainer's checkpoints, `train --resume` continues from `last`, `sample`
writes JPEGs from `last` equal to the pipeline's on the same weights, batch
and generator, and `data-verify` reports a tree as JAX's drill does.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_tpu.data.verify import verify_root as jax_verify_root  # noqa: E402
from upgpt_torch import cli  # noqa: E402
from upgpt_torch.checkpoint import read_weights  # noqa: E402
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # its import pulls in TensorFlow here (~17 s a process)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (1, 1), "validation": (2, 0)},
                              image_hw=(16, 16), seed=2)


def _dotlist(tree, logdir):
    out = [f"data.{s}.params.{k}={tree[v]}"
           for s in ("train", "validation", "test")
           for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    out += [f"data.{s}.params.{k}={v}" for s in ("train", "validation",
                                                  "test")
            for k, v in (("image_size", "[16,16]"), ("f", 2))]
    out += [f"data.train.params.pair_file=['{tree['train']}']",
            f"data.validation.params.pair_file=['{tree['validation']}']",
            f"data.test.params.pair_file=['{tree['validation']}']",
            "model.params.variant=tiny", "model.params.device=cpu",
            "model.params.latent_size=(8,8)",
            "trainer.batch_size=2", "trainer.log_every=1",
            "trainer.warm_up_steps=1", "trainer.log_images_every=3",
            "trainer.image_log_ddim_steps=2",
            "trainer.image_log_progressive_frames=2",
            "trainer.ckpt_every_steps=3", f"trainer.logdir={logdir}"]
    return out


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    logdir = tmp_path_factory.mktemp("run")
    args = ["train", "--base", CONFIG, "--debug-encoder"] + _dotlist(
        tree, logdir)
    state = cli.main(args + ["trainer.max_epochs=1"])
    return args, logdir, state


def test_train_writes_float32_masters_and_checkpoints(trained):
    args, logdir, state = trained
    assert state.step == 3  # (1 + 1 * 5 men_factor) pairs / batch 2
    assert all(p.dtype == torch.float32 for p in state.params)
    ckpts = sorted(os.listdir(logdir / "checkpoints"))
    assert ckpts == ["best", "best.meta.json", "last", "last.meta.json",
                     "trainstep_000000003", "trainstep_000000003.meta.json"]
    merged = json.loads((logdir / "configs" / "merged.json").read_text())
    assert merged["model"]["params"]["dtype"] == "bfloat16"
    assert merged["trainer"]["logdir"] == str(logdir)
    assert {p.split("_")[0] for p in os.listdir(logdir / "images")} == {
        "samples", "progressive", "src", "smpl", "styles"}
    records = [json.loads(x) for x in open(logdir / "metrics.jsonl")]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)


def test_resume_and_finetune(trained, tmp_path):
    args, logdir, _ = trained
    copy = tmp_path / "run"
    shutil.copytree(logdir, copy)
    moved = [a if not a.startswith("trainer.logdir=")
             else f"trainer.logdir={copy}" for a in args]
    state = cli.main(moved[:1] + ["--resume"] + moved[1:]
                     + ["trainer.max_epochs=2"])
    assert state.step == 6
    records = [json.loads(x) for x in open(copy / "metrics.jsonl")]
    assert [r["step"] for r in records if "loss" in r] == list(range(1, 7))
    # --finetune-from: the checkpoint's weights (EMA first), a fresh
    # optimizer; no epoch runs
    fresh = [a if not a.startswith("trainer.logdir=")
             else f"trainer.logdir={tmp_path / 'ft'}" for a in args]
    last = str(logdir / "checkpoints" / "last")
    state = cli.main(fresh[:1] + ["--finetune-from", last] + fresh[1:]
                     + ["trainer.max_epochs=0"])
    weights, _ = read_weights(last)
    assert state.step == 0
    assert all(torch.equal(p, weights[n])
               for n, p in zip(state.names, state.params))


def test_sample_from_last_equals_the_pipeline(trained, tree, tmp_path):
    from PIL import Image

    from upgpt_torch.config import instantiate_from_config, merge_configs
    from upgpt_torch.inference.encoders import DebugConditioningEncoder
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.checkpoint import load_checkpoint
    from upgpt_torch.data.deepfashion import DataLoader

    _, logdir, _ = trained
    last = str(logdir / "checkpoints" / "last")
    dotlist = _dotlist(tree, logdir)
    imgs = cli.main(["sample", "--base", CONFIG, "--debug-encoder",
                     "--ckpt", last, "--batch", "2", "--steps", "4",
                     "--out", str(tmp_path / "out")] + dotlist)
    files = sorted(os.listdir(tmp_path / "out"))
    assert files == ["sample_000.jpg", "sample_001.jpg"]
    assert np.asarray(Image.open(tmp_path / "out" / files[0])).shape == (
        16, 16, 3)
    cfg = merge_configs([CONFIG], dotlist)
    model = load_checkpoint(instantiate_from_config(cfg["model"]), last)
    assert model.unet.conv_in.weight.dtype == torch.bfloat16
    raw = next(DataLoader(instantiate_from_config(cfg["data"]["test"]), 2,
                          shuffle=False).epoch(0))
    batch = DebugConditioningEncoder().encode_batch(raw)
    batch = {k: torch.as_tensor(np.asarray(batch[k]))
             for k in ("text_emb", "style_emb", "smpl", "person_mask")}
    want = GenerationPipeline(model, num_steps=4, eta=1.0).generate(
        batch, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(imgs, want.float().numpy())


def test_data_verify_reports_like_jax(tree, tmp_path, capsys):
    args = ["data-verify", "--root", tree["folder"], "--pair-file",
            tree["train"], "--data-file", tree["data_file"]]
    cli.main(args)
    report = json.loads(capsys.readouterr().out)
    want = jax_verify_root(root=tree["folder"], pair_files=[tree["train"]],
                           data_file=tree["data_file"])
    assert report == json.loads(json.dumps(want)) and report["ok"]
    broken = tmp_path / "broken"
    shutil.copytree(tree["folder"], broken)
    shutil.rmtree(broken / "segm_256")
    with pytest.raises(SystemExit) as exc:
        cli.main(["data-verify", "--root", str(broken), "--pair-file",
                  tree["train"], "--data-file", str(broken / "map.csv")])
    assert exc.value.code == 2
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"] and report["missing"]["segm"]["count"] == 2
    # the paths from a config's data.<split> entry
    cli.main(["data-verify", "--base", CONFIG, "--split", "validation",
              f"data.validation.params.folder={tree['folder']}",
              f"data.validation.params.data_file={tree['data_file']}",
              f"data.validation.params.pair_file=['{tree['validation']}']"])
    assert json.loads(capsys.readouterr().out)["counts"]["pair_rows"] == 2


@pytest.mark.parametrize("cmd", ["test", "sample"])
def test_sample_and_test_run_tensor_parallel(trained, tree, tmp_path, cmd):
    """`--tp 2` on the CPU (one data group of two CPU shards) from the
    trained `last`, its U-Net re-drawn, against `--tp 1`. The U-Net's
    proj_outs, ResBlock out convs and out conv start at zero and stay near
    it after three steps, so its eps would be ~0 and a wrong split would
    not show in the images."""
    from test_torch_tp import _redraw
    from upgpt_torch.checkpoint import load_checkpoint, save_checkpoint
    from upgpt_torch.config import instantiate_from_config, merge_configs

    _, logdir, _ = trained
    # float32: a re-drawn U-Net carries a bf16 rounding apart over the
    # steps (SSIM 0.037 against 0.041 measured), where float32 holds the
    # split to the unsharded sums' rounding
    dotlist = _dotlist(tree, logdir) + ["eval.crop_size=[16,16]",
                                        "model.params.dtype=float32"]
    ckpt = str(tmp_path / "redrawn.pt")
    model = load_checkpoint(
        instantiate_from_config(merge_configs([CONFIG], dotlist)["model"]),
        str(logdir / "checkpoints" / "last"))
    _redraw(model.unet, seed=5)
    save_checkpoint(model, ckpt)
    runs = [cli.main([cmd, "--base", CONFIG, "--debug-encoder", "--ckpt",
                      ckpt, "--batch", "2", "--steps", "4", "--tp", str(tp),
                      "--out", str(tmp_path / f"tp{tp}")] + dotlist)
            for tp in (1, 2)]
    if cmd == "sample":
        # shard partials summed in another order: 1.7e-6 measured
        np.testing.assert_allclose(runs[1], runs[0], rtol=0, atol=2e-4)
    else:
        # the same JPEGs score the same (equal measured; MS-SSIM is NaN at
        # 16x16)
        assert json.dumps(runs[1]["metrics"]) == json.dumps(
            runs[0]["metrics"])


@pytest.mark.parametrize("argv,item", [
    (["sample", "--ckpt", "SIDECAR"], "'parameterization'")])
def test_unported_options_are_refused(tmp_path, argv, item):
    # a sidecar without its keys exits naming the missing one, before the
    # checkpoint is read
    if "SIDECAR" in argv:
        ckpt = tmp_path / "student"
        (tmp_path / "student.distill.json").write_text("{}")
        argv = [str(ckpt) if a == "SIDECAR" else a for a in argv]
    with pytest.raises(SystemExit, match=item):
        cli.main(argv + ["--base", CONFIG, "--debug-encoder",
                         "model.params.variant=tiny",
                         "model.params.device=cpu"])


# ------------------------------------------------ CLIP and the fusion

LAION = os.path.join(REPO, "configs", "deepfashion", "inshop_laion_clip.yaml")
MERGES = [("w", "o"), ("wo", "man</w>"), ("s", "h"), ("sh", "ir"),
          ("shir", "t</w>"), ("r", "e"), ("re", "d</w>"), ("d", "e"),
          ("de", "n"), ("den", "im</w>")]


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """Small towers in openai's layout, text and `visual.` in one file
    (one block each; the text 768 wide, the U-Net's context width; the
    vision 128 wide over 224x224 crops, projected to 768), and a merges
    file: the `clip.*` dotlist."""
    from test_torch_clip import _torch_sd, openai_clip

    from upgpt_torch.data.tokenizer import CLIPTokenizer

    root = tmp_path_factory.mktemp("clip")
    vocab = CLIPTokenizer(merges=MERGES).eos_id + 1
    torch.save(_torch_sd(openai_clip(
        13, image=224, vocab=vocab, pos=77, text_width=768,
        vision_width=128, layers=1, proj=768)), root / "clip.pt")
    (root / "bpe.txt").write_text("\n".join(" ".join(m) for m in MERGES))
    return [f"clip.text_params={root / 'clip.pt'}",
            f"clip.vision_params={root / 'clip.pt'}",
            f"clip.bpe_path={root / 'bpe.txt'}"]


def _laion_dotlist(tree, logdir, clip_files):
    """inshop_laion_clip.yaml on `tiny` with its fusion (and the config's
    remat and smpl RPM mask), the compact transport on the CPU."""
    # the config has no test split: sampling reads the validation split
    return ([a for a in _dotlist(tree, logdir)
             if not a.startswith("data.test.")] + clip_files
            + ["model.params.cond_fusion=image",
               "trainer.compact_transport=True", "trainer.scale_lr=True"])


@pytest.fixture(scope="module")
def laion_trained(tree, clip_files, tmp_path_factory):
    logdir = tmp_path_factory.mktemp("laion")
    dotlist = _laion_dotlist(tree, logdir, clip_files)
    # no --debug-encoder: the dotlist follows the options
    state = cli.main(["train"] + dotlist + ["trainer.max_epochs=3",
                                            "--base", LAION])
    return dotlist, logdir, state


def test_train_laion_through_clip(laion_trained):
    from upgpt_torch.config import merge_configs

    dotlist, logdir, state = laion_trained
    cfg = merge_configs([LAION], dotlist)
    assert cfg["model"]["params"]["use_checkpoint"] is True
    assert cfg["data"]["train"]["params"]["input_mask_type"] == "smpl"
    assert state.step == 3  # 2 pairs (no men_factor) a batch, 3 epochs
    fusion = [n for n in state.names if n.startswith("cond_fusion.")]
    assert fusion and state.names[:1] == ["unet.time_embed_0.weight"]
    records = [json.loads(x) for x in open(logdir / "metrics.jsonl")]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert any("val/loss_simple_ema" in r for r in records)
    # the fusion trains: on step 3 the gradient reaches it (steps 1 and 2
    # move the zero-initialised out conv and proj_out first)
    grads = dict(zip(state.names, (p.grad for p in state.params)))
    assert all(grads[n].abs().max() > 0 for n in fusion)
    saved, _ = read_weights(str(logdir / "checkpoints" / "last"))
    assert set(fusion) <= set(saved)


def test_sample_laion_through_clip_equals_the_pipeline(
        laion_trained, tmp_path):
    from upgpt_torch.checkpoint import load_checkpoint
    from upgpt_torch.config import instantiate_from_config, merge_configs
    from upgpt_torch.data.deepfashion import DataLoader
    from upgpt_torch.inference.pipeline import GenerationPipeline

    dotlist, logdir, _ = laion_trained
    last = str(logdir / "checkpoints" / "last")
    imgs = cli.main(["sample", "--base", LAION, "--ckpt", last, "--batch",
                     "2", "--steps", "4", "--out", str(tmp_path / "out")]
                    + dotlist)
    assert sorted(os.listdir(tmp_path / "out")) == ["sample_000.jpg",
                                                    "sample_001.jpg"]
    cfg = merge_configs([LAION], dotlist)
    model = load_checkpoint(instantiate_from_config(cfg["model"]), last)
    enc = cli._build_cond_encoder(cfg, model)
    assert not enc.text_tower.config.quick_gelu  # R6: the fusion's towers
    raw = next(DataLoader(instantiate_from_config(
        cfg["data"]["validation"]), 2, shuffle=False).epoch(0))
    batch = enc.encode_batch(raw)
    assert batch["text_emb"].shape == (2, 77, 768)
    batch = {k: torch.as_tensor(batch[k]) for k in (
        "text_emb", "style_emb", "smpl", "person_mask")}
    want = GenerationPipeline(model, num_steps=4, eta=1.0).generate(
        batch, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(imgs, want.float().numpy())
