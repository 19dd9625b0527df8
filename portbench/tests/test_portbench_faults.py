"""The check catches a broken timed path.

Each cell runs on the CPU at the tiny geometry with its own limits, past
the harness's look for a card: sound, `correct` is true; with a fault
planted under the timed path, false. Faults: a sampler step or a train
step that returns its state unchanged, half of the batch left out (the
other half's result repeated, or the loss's mean over the rest), and an
answer altered where it is produced (an image inverted, the loss scaled);
in training also the EMA shadow left unchanged, or moved at the
configured decay without LitEma's warm-up. One card has no exchange
between cards to leave out."""

import dataclasses

import pytest
import torch

from portbench.tests import run_tiny

CELLS = ["interp256_ddim50_b64", "mm512_serve_unipc8", "interp256_train_b48"]


def _drop_one_step(mod, name, schedule_cls):
    orig = getattr(mod, name)

    def f(eps_model, table, shape, cond, **kw):
        keep = [i for i in range(table.num_steps) if i != 1]
        sub = schedule_cls(**{fl.name: getattr(table, fl.name)[keep]
                              for fl in dataclasses.fields(table)})
        if kw.get("noise") is not None:
            kw["noise"] = kw["noise"][keep]
        return orig(eps_model, sub, shape, cond, **kw)

    return f


def _unchanged_state(monkeypatch, cell):
    from upgpt_torch.diffusion.schedule import DDIMSchedule
    from upgpt_torch.diffusion.unipc import UniPCSchedule
    from upgpt_torch.inference import pipeline
    from upgpt_torch.training import train_state

    if cell == "interp256_train_b48":
        monkeypatch.setattr(train_state.TrainState, "apply_gradients",
                            lambda self: self)
    else:
        monkeypatch.setattr(pipeline, "ddim_sample", _drop_one_step(
            pipeline, "ddim_sample", DDIMSchedule))
        monkeypatch.setattr(pipeline, "unipc_sample", _drop_one_step(
            pipeline, "unipc_sample", UniPCSchedule))


def _half_batch(monkeypatch, cell):
    from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
    from upgpt_torch.inference.pipeline import GenerationPipeline

    if cell == "interp256_train_b48":
        orig_loss = LatentDiffusion.training_loss

        def loss(self, batch, generator=None, draws=None):
            half = batch["image"].shape[0] // 2
            return orig_loss(self, {k: v[:half] for k, v in batch.items()},
                             generator, {k: v[:half] for k, v in draws.items()})

        monkeypatch.setattr(LatentDiffusion, "training_loss", loss)
        return
    orig = GenerationPipeline.generate

    def generate(self, batch, generator=None, **kw):
        n = batch["text_emb"].shape[0]
        half = max(1, n // 2)
        part = {k: v[:half] for k, v in batch.items()}
        for key in ("x_T",):
            if kw.get(key) is not None:
                kw[key] = kw[key][:half]
        if kw.get("noise") is not None:
            kw["noise"] = kw["noise"][:, :half]
        out = orig(self, part, generator, **kw)
        return torch.cat([out] * (n // half))[:n]

    monkeypatch.setattr(GenerationPipeline, "generate", generate)


def _altered_answer(monkeypatch, cell):
    from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
    from upgpt_torch.inference import pipeline

    if cell == "interp256_train_b48":
        orig = LatentDiffusion.p_losses

        def p_losses(self, *a, **kw):
            loss, metrics = orig(self, *a, **kw)
            return loss * 1.1, dict(metrics, loss=loss * 1.1)

        monkeypatch.setattr(LatentDiffusion, "p_losses", p_losses)
        return
    orig_u8 = pipeline._to_uint8

    def to_uint8(img):
        out = orig_u8(img).clone()
        out[-1] = 255 - out[-1]
        return out

    monkeypatch.setattr(pipeline, "_to_uint8", to_uint8)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, _, rows, _ = run_tiny(cell)
    assert result["correct"], rows
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer],
                         ids=["unchanged_state", "half_batch",
                              "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    result, _, rows, _ = run_tiny(cell)
    assert not result["correct"], rows


def _ema_skipped(monkeypatch):
    from upgpt_torch.training import train_state

    monkeypatch.setattr(train_state, "ema_update", lambda state, params: state)


def _ema_without_warm_up(monkeypatch):
    from upgpt_torch.training import ema

    monkeypatch.setattr(ema, "ema_decay", lambda n, decay: decay)


@pytest.mark.parametrize("fault", [_ema_skipped, _ema_without_warm_up],
                         ids=["ema_skipped", "ema_without_warm_up"])
def test_ema_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, _, rows, _ = run_tiny("interp256_train_b48")
    assert not result["correct"], rows
    assert dict((n, v > lim) for n, v, lim in rows)["ema_change_norm_gap"]
