"""The analytic work: totals equal `benchmarks/flop_count.py`'s walk, and
each layer's FLOPs sum to the U-Net's."""

import json
import os

import pytest

from portbench import flops, spec


def _cfg(name):
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,unet_gf,decode_gf", [
    ("interp_256", 65.521268736, 466.23780864),
    ("mm_512", 298.183409664, 1879.446749184)])
def test_totals(name, unet_gf, decode_gf):
    cfg = _cfg(name)
    assert flops.unet_flops(cfg) / 1e9 == pytest.approx(unet_gf, rel=1e-12)
    assert flops.decoder_flops(cfg) / 1e9 == pytest.approx(decode_gf,
                                                           rel=1e-12)


def test_train_image():
    assert flops.train_flops(_cfg("interp_256")) / 1e12 == pytest.approx(
        0.400702777344, rel=1e-12)


@pytest.mark.parametrize("name", ["interp_256", "mm_512"])
def test_layers_sum_to_the_unet(name):
    cfg = _cfg(name)
    layers = flops.unet_layers(cfg)
    by_kind = {}
    for kind, f in layers:
        by_kind[kind] = by_kind.get(kind, 0) + f
    assert sum(by_kind.values()) == flops.unet_flops(cfg)
    assert by_kind["res"] > 0 and by_kind["attn"] > 0
    # per-call functions reproduce the walk's layers at batch 1 and scale
    # with the batch
    u = cfg["unet"]
    h, w = cfg["latent_size"]
    tk = cfg["text_tokens"] + cfg["style_tokens"] + 1
    c = u["model_channels"]
    assert flops.transformer(1, h * w, c, tk)[0] in [f for k, f in layers
                                                     if k == "attn"]
    assert flops.transformer(3, h * w, c, tk)[0] == 3 * flops.transformer(
        1, h * w, c, tk)[0]
    assert flops.resblock(2, h, w, c, c, 4 * c)[0] == 2 * flops.resblock(
        1, h, w, c, c, 4 * c)[0]


def test_least_time_is_the_larger_bound():
    assert flops.least_s(989e12, 0) == pytest.approx(1.0)
    assert flops.least_s(0, 3.35e12) == pytest.approx(1.0)
