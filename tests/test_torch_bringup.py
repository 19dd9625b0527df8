"""The weight-drop runbook (`upgpt_torch.bringup`, `cli bringup`) against
the JAX package's `run_bringup`, on the CPU.

One synthetic drop in the reference's layout (`test_torch_convert`'s
test-local writer over a seeded JAX `tiny` tree, a LitEma shadow that
differs from the raw U-Net, a tiny HF-layout CLIP snapshot with a merges
table, placeholder metric weights) goes through both runbooks once
(module scope) at `--geometry tiny`, without the bench, the eval or the
sampler check. Both get the same inventory, submodels and EMA
flag; the VAE's round-trip PSNR agrees within 0.01 dB and the mid-t noise
correlation within 1e-3, with JAX's noise draw injected into the port's
validator (float32 both sides); both reject the random weights. The port's
CLIP step loads the towers back; its sampler check, on the converted
weights over an 8x8 latent, gives finite SSIMs.

R13: the port's eval step runs `cli test` on a `data/tree.py` tree and
writes metrics; JAX's eval argv cannot: the `root` override it writes is
not a parameter of the dataset (TypeError), and without `--debug-encoder`
or converted towers its `cli test` exits before sampling. R14: a CLIP
directory with only safetensors counts as missing in the port's inventory;
JAX's counts it as present, and its CLIP step then finds nothing to read.
"""

import csv
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from test_torch_convert import (  # noqa: E402
    _random_tree, lightning_file, reference_state_dict,
)
from upgpt_tpu import bringup as jax_bringup  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch import bringup, cli  # noqa: E402
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")
MERGES = [("r", "e"), ("re", "d</w>"), ("s", "h"), ("sh", "i"),
          ("shi", "r"), ("shir", "t</w>")]


def hf_clip_state_dict(width=64, layers=1, vwidth=64, vlayers=1, patch=14,
                       side=2, vocab=520, seed=0) -> dict:
    """A tiny HF CLIPModel state dict (`text_model.`, `vision_model.`,
    both projections), seeded."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: 0.05 * torch.randn(*s, generator=g)  # noqa: E731
    sd = {}

    def block(p, w):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{proj}.weight"] = r(w, w)
            sd[f"{p}.self_attn.{proj}.bias"] = r(w)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + r(w), r(w)
        sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = r(4 * w, w), r(
            4 * w)
        sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = r(w, 4 * w), r(w)

    t, v = "text_model.", "vision_model."
    sd[f"{t}embeddings.token_embedding.weight"] = r(vocab, width)
    sd[f"{t}embeddings.position_embedding.weight"] = r(77, width)
    for i in range(layers):
        block(f"{t}encoder.layers.{i}", width)
    sd[f"{t}final_layer_norm.weight"] = 1 + r(width)
    sd[f"{t}final_layer_norm.bias"] = r(width)
    sd[f"{v}embeddings.patch_embedding.weight"] = r(vwidth, 3, patch, patch)
    sd[f"{v}embeddings.class_embedding"] = r(vwidth)
    sd[f"{v}embeddings.position_embedding.weight"] = r(side * side + 1,
                                                       vwidth)
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{v}{ln}.weight"], sd[f"{v}{ln}.bias"] = 1 + r(vwidth), r(vwidth)
    for i in range(vlayers):
        block(f"{v}encoder.layers.{i}", vwidth)
    sd["text_projection.weight"] = r(width, width)
    sd["visual_projection.weight"] = r(width, vwidth)
    return sd


@pytest.fixture(scope="module")
def drop(tmp_path_factory):
    root = tmp_path_factory.mktemp("drop")
    jm = jax_build("tiny", use_flash_attention=False)
    tree = _random_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
                        seed=9)
    s = reference_state_dict(tree, jm.config)
    lightning_file(s, root / "interp_256.ckpt",
                   ema={k: 0.9 * v for k, v in s["unet"].items()})
    clip = root / "clip-vit-large-patch14"
    clip.mkdir()
    torch.save(hf_clip_state_dict(), clip / "pytorch_model.bin")
    (clip / "merges.txt").write_text(
        "\n".join(["#version: 0.2"] + [" ".join(m) for m in MERGES]) + "\n")
    torch.save({"placeholder": torch.zeros(1)}, root / "vgg.pth")
    torch.save({"placeholder": torch.zeros(1)}, root / "pt_inception-2015.pth")
    return root


@pytest.fixture(scope="module")
def runs(drop, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    want = jax_bringup.run_bringup(
        str(drop), str(out / "jax"), variants=("interp_256",),
        geometry_override="tiny", skip_bench=True, skip_eval=True,
        skip_sampler_check=True)
    # JAX's validator draws its noise from PRNGKey(0) at the latent's shape
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 32, 24, 4)))
    got = bringup.run_bringup(
        str(drop), str(out / "port"), variants=("interp_256",),
        geometry_override="tiny", skip_bench=True, skip_eval=True,
        skip_sampler_check=True, device="cpu", validate_eps=eps)
    return out, got, want


def test_inventory_and_conversion_match_jax(runs, drop):
    out, got, want = runs
    gi, wi = got["steps"]["inventory"], want["steps"]["inventory"]
    for k in ("found", "clip", "lpips", "inception", "missing"):
        assert gi[k] == wi[k], k
    assert gi["found"] == {"interp_256": str(drop / "interp_256.ckpt")}
    assert gi["missing"] == [] and gi["clip_unreadable"] == []
    (gc,), (wc,) = got["steps"]["convert"], want["steps"]["convert"]
    assert gc["ema"] is wc["ema"] is True
    assert gc["submodels"] == sorted(wc["submodels"]) == ["pose", "unet",
                                                          "vae"]
    assert gc["out"] == str(out / "port" / "tiny" / "model.pt")


def test_validators_match_jax_and_reject_random_weights(runs):
    out, got, want = runs
    (gv,), (wv,) = got["steps"]["validate"], want["steps"]["validate"]
    assert "error" not in gv and "error" not in wv, (gv, wv)
    # JAX rounds to 0.01 dB and 1e-4
    assert abs(gv["vae_roundtrip_psnr_db"]
               - wv["vae_roundtrip_psnr_db"]) <= 0.01 + 1e-9
    assert abs(gv["eps_corr_mid_t"] - wv["eps_corr_mid_t"]) <= 1e-3
    assert gv["vae_roundtrip_psnr_db"] < 20.0 and not gv["vae_pass"]
    assert abs(gv["eps_corr_mid_t"]) < 0.3 and not gv["unet_pass"]
    assert gv["unet_finite"] is True
    assert got["accepted"] is want["accepted"] is False
    for d in ("port", "jax"):
        assert json.loads((out / d / "report.json").read_text())[
            "accepted"] is False
        assert "ACCEPTED: False" in (out / d / "REPORT.md").read_text()


def test_sampler_check_and_clip_step(runs):
    from upgpt_torch.checkpoint import load_checkpoint
    from upgpt_torch.zoo import build_latent_diffusion

    out, got, _ = runs
    clip = got["steps"]["clip"]
    assert clip["loaded_on"] == "cpu" and clip["text_width"] == 64
    assert clip["vision_width"] == 64
    for k in ("text_params", "vision_params"):
        assert os.path.exists(clip[k])
    assert got["steps"]["bench"] == {"skipped": True}
    assert got["steps"]["sampler_check"] == {"skipped": True}
    # the four samplers' 278 U-Net evals over an 8x8 latent (16x16 images)
    model = load_checkpoint(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8)),
        got["steps"]["convert"][0]["out"])
    sc = bringup.sampler_check(model)
    for k in ("ssim_ddim50_vs_ddim200", "ssim_unipc8k_vs_ddim200",
              "ssim_dpmpp20_vs_ddim200"):
        assert math.isfinite(sc[k]) and -1.0 <= sc[k] <= 1.0, sc
    assert isinstance(sc["karras_guidance_holds"], bool)


def test_cli_bringup_exits_3(drop, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["bringup", "--drop", str(drop), "--out",
                  str(tmp_path / "b"), "--variants", "interp_256",
                  "--geometry", "tiny", "--skip-bench", "--skip-eval",
                  "--skip-sampler-check", "--device", "cpu"])
    assert exc.value.code == 3
    assert (tmp_path / "b" / "REPORT.md").exists()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "accepted"] is False


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fashion")
    out = write_fashion_tree(root / "tree", {"train": (2, 0),
                                             "validation": (16, 0)},
                             image_hw=(64, 48), seed=6)
    with open(out["validation"], newline="") as f:
        people = sorted({p for r in csv.DictReader(f)
                         for p in (r["from"], r["to"])})
    out["test"] = str(root / "pairs-test.csv")
    with open(out["test"], "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["from", "to"])
        # one batch of `cli test`'s default 8, each pair distinct: the
        # dump names an image by its pair
        w.writerows([(a, b) for a in people for b in people if a != b][:8])
    return out


def test_r13_eval_step_scores_where_jax_cannot(runs, tree, tmp_path):
    from upgpt_tpu import cli as jax_cli
    from upgpt_tpu.config import instantiate_from_config as jax_inst
    from upgpt_tpu.config import merge_configs as jax_merge

    out, got, _ = runs
    # the dataset's other splits and sizes; the runbook sets the test
    # split's folder itself
    over = [f"data.{s}.params.{k}={v}" for s in ("train", "validation")
            for k, v in (("folder", tree["folder"]),)]
    over += [f"data.{s}.params.{k}={v}" for s in ("train", "validation",
                                                  "test")
             for k, v in (("data_file", tree["data_file"]),
                          ("image_size", "[64,48]"), ("f", 2))]
    over += [f"data.{s}.params.pair_file=['{tree[s]}']"
             for s in ("train", "validation", "test")]
    over += ["sampling.ddim_steps=2"]
    rec = bringup.eval_step(got["steps"]["convert"][0]["out"], "tiny",
                            tree["folder"], tmp_path, clip=None,
                            device="cpu", overrides=over)
    assert rec["parity"] is False and rec["encoder"].startswith("debug")
    m = rec["metrics"]
    assert m["n_images"] == 8 and math.isfinite(m["ssim"])
    assert json.loads((tmp_path / "eval" / "metrics.json").read_text())[
        "n_images"] == 8
    # JAX's runbook overrides `data.test.params.root`, which its dataset
    # does not take
    cfg = jax_merge([CONFIG], over + [f"data.test.params.root={tree['folder']}"])
    with pytest.raises(TypeError, match="root"):
        jax_inst(cfg["data"]["test"])
    # and hands `cli test` neither towers nor --debug-encoder: it exits
    # before sampling (the runbook's argv, bringup.py:378-384, on the
    # tiny weights the JAX run converted)
    with pytest.raises(SystemExit, match="debug-encoder"):
        jax_cli.main(["test", "--base", CONFIG, "--ckpt",
                      str(out / "jax" / "tiny" / "weights"), "--out",
                      str(tmp_path / "jax_eval"), "model.params.variant=tiny",
                      f"data.test.params.root={tree['folder']}"])


def test_r14_safetensors_only_clip_dir(tmp_path):
    clip = tmp_path / "clip-vit-large-patch14"
    clip.mkdir()
    (clip / "model.safetensors").write_bytes(b"\0" * 8)
    got = bringup.find_drop_files(tmp_path, ())
    assert got.clip_dir is None and "clip" in got.missing
    assert got.unreadable == [str(clip)]
    want = jax_bringup.find_drop_files(tmp_path, ())
    assert want.clip_dir == clip and "clip" not in want.missing
    assert "error" in jax_bringup._convert_clip(clip, tmp_path)
