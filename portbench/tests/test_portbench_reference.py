"""The frozen reference against the program's plain path on the CPU.

At the tiny geometry with the same seeded weights and inputs: the U-Net's
eps, DDIM-eta-1 and UniPC-karras latents, the decode and one AdamW + EMA
train step's loss and update. Both sides run float32 on the CPU, so the
two agree to float32 rounding."""

import json
import os

import pytest
import torch

from portbench import inputs, judge
from portbench.reference import ldm
from portbench.weights import SeededWeights

torch.set_num_threads(1)
HERE = os.path.dirname(__file__)


@pytest.fixture(scope="module")
def tiny():
    from upgpt_torch.zoo import build_latent_diffusion

    with open(os.path.join(HERE, "tiny.json")) as f:
        cfg = json.load(f)
    w = SeededWeights(cfg, 7, "cpu", torch.float32)
    model = build_latent_diffusion("tiny", dtype="float32", device="cpu")
    w.load_into(model)
    return cfg, w, model


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def test_unet_eps_and_decode(tiny):
    cfg, w, model = tiny
    cond = inputs.conditioning(cfg, 2, 11, "cpu")
    x = torch.randn(2, 32, 24, 4, generator=torch.Generator().manual_seed(3))
    t = torch.tensor([981, 421])
    with torch.no_grad():
        ctx = model.build_context(cond["text_emb"], cond["style_emb"],
                                  cond["smpl"])
        got = model.apply_model(x, t, {"c_crossattn": ctx,
                                       "c_concat": cond["person_mask"]})
        ref_ctx = ldm.context(cond["text_emb"], cond["style_emb"],
                              cond["smpl"], w.views)
        want = ldm.unet(torch.cat([x, cond["person_mask"]], -1), t, ref_ctx,
                        w.views, cfg)
        assert _rel(got, want) < 1e-5
        img = model.decode_first_stage(x)
        assert _rel(img, ldm.decode(x, w.views, cfg)) < 1e-5


@pytest.mark.parametrize("sampling", [
    {"sampler": "ddim", "steps": 10, "eta": 1.0, "schedule": "uniform"},
    {"sampler": "unipc", "steps": 8, "eta": 0.0, "schedule": "karras"},
], ids=["ddim_eta1", "unipc_karras"])
def test_sampler_latents(tiny, sampling):
    from upgpt_torch.inference.pipeline import GenerationPipeline

    cfg, w, model = tiny
    b = 2
    cond = inputs.conditioning(cfg, b, 12, "cpu")
    g = torch.Generator().manual_seed(5)
    x_T = torch.randn(b, 32, 24, 4, generator=g)
    pipe = GenerationPipeline(model, num_steps=sampling["steps"],
                              eta=sampling["eta"], sampler=sampling["sampler"],
                              schedule_method=sampling["schedule"],
                              decode=False)
    kw = {"x_T": x_T}
    ref_in = dict(cond, x_T=x_T)
    if sampling["sampler"] == "ddim":
        noise = torch.randn((pipe.num_steps, b, 32, 24, 4), generator=g)
        kw["noise"] = noise
        ref_in["noise"] = noise
    got = pipe.generate(cond, **kw)
    with torch.no_grad():
        ctx = ldm.context(cond["text_emb"], cond["style_emb"], cond["smpl"],
                          w.views)

        def eps_fn(x, t):
            tb = torch.full((b,), t)
            return ldm.unet(torch.cat([x, cond["person_mask"]], -1), tb, ctx,
                            w.views, cfg)

        if sampling["sampler"] == "ddim":
            want = ldm.ddim(eps_fn, x_T, cfg, sampling["steps"], 1.0, noise)
        else:
            want = ldm.unipc(eps_fn, x_T, cfg, sampling["steps"], "karras")
    assert _rel(got, want) < 1e-4


def test_train_step(tiny):
    from upgpt_torch.training.lr import lambda_linear_schedule
    from upgpt_torch.training.train_state import (
        create_train_state, train_step,
    )
    from upgpt_torch.zoo import build_latent_diffusion

    cfg, w, _ = tiny
    model = build_latent_diffusion("tiny", dtype="float32", device="cpu")
    w.load_into(model)
    opt = {"learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
           "weight_decay": 0.01, "warm_up_steps": 1, "scheduler_f_start": 0.5,
           "ema_decay": 0.9999}
    state = create_train_state(
        model, opt["learning_rate"], lambda_linear_schedule(
            [1], [1.0], [1.0], [opt["scheduler_f_start"]], [10**13]))
    batches = [inputs.train_batch(cfg, 2, s, "cpu") for s in (1, 2)]
    draws = [inputs.train_draws(cfg, 2, s, "cpu") for s in (3, 4)]
    losses = []
    first = None
    for b, d in zip(batches, draws):
        state, metrics = train_step(model, state, b, draws=d)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = {n: state.optimizer.state[p]["exp_avg"] / 0.1
                     for n, p in zip(state.names, state.params)}
    ref = judge.reference_norms(
        ldm.train_steps(w.views, batches, draws, cfg, opt, rows_per_block=1))
    params = dict(zip(state.names, state.params))
    got = {"losses": losses,
           "grad_norms": {n: float(g.norm()) for n, g in first.items()},
           "change_norms": {n: float((params[n].detach() - w.views[n]).norm())
                            for n in params},
           "ema_change_norms": {n: float((s - w.views[n]).norm()) for n, s in
                                zip(state.names, state.ema.shadow)}}
    numbers = judge.train_numbers(got, ref)
    assert numbers["loss_rel"] < 1e-5
    assert numbers["grad_norm_gap"] < 1e-4
    assert numbers["change_norm_gap"] < 1e-4
    assert numbers["ema_change_norm_gap"] < 1e-4
