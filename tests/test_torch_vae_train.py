"""The port's first-stage training against the JAX package's, on the CPU
in float32.

- `DiagonalGaussian.kl` (to the standard normal and to another posterior)
  and `nll` against JAX's: 1e-5 relative.
- The PatchGAN discriminator (flax BatchNorm: momentum 0.99, the biased
  batch variance into the running statistics) on JAX's weights through
  the bridge: the eval forward, the train forward and the running
  statistics after it within 1e-5 of flax's.
- `generator_loss` (without the adaptive weight, as JAX's loss takes it)
  and `discriminator_loss` against JAX's: every log entry to 1e-5.
- One and three `vae_train_step`s on JAX's tiny VAE (ch 32, ch_mult
  (1, 2), 32x32, batch 2), JAX's two posterior draws a step injected, at
  disc_start 0 and 10**6 (JAX's step traced once, its step numbers
  shifted by disc_start): every log entry within 1e-4 of JAX's (the
  adaptive weight is a ratio of gradient norms; ROADMAP R10 below), the
  VAE's and the discriminator's parameters after the steps, from the same
  start, as their updates: Adam's first steps take about lr *
  sign(gradient), which rounding flips where an element's gradient is
  near 0, so at most one element in 10**4 of a tensor (or one) may move
  the other way and the rest agree within 2e-3 relative L2; the running
  statistics 1e-4 of max|ref|, logvar exactly. The weights are the port's seeded ones, conv
  biases at 0 as flax initialises them, carried to JAX's trees. A tensor whose
  gradient is zero in exact arithmetic (a conv bias feeding a GroupNorm
  of one channel a group, an attention's key bias) moves by about Adam's
  lr a step in the direction rounding gives it on either side; such
  tensors are held to |update| <= 1.1 lr a step instead.
- R10: JAX's `gen/total_loss` log leaves out the adaptive GAN term; the
  port logs the loss it optimises.
- `build_autoencoder` from both autoencoder configs: JAX's parameter
  tree's shapes and count, float32 masters under bf16 compute.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_torch.config import (  # noqa: E402
    instantiate_from_config, load_config,
)
from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, torch_array, torch_key,
)
from upgpt_torch.models.vae import DiagonalGaussian  # noqa: E402
from upgpt_torch.training import vae_loss as tvl  # noqa: E402
from upgpt_torch.training.vae_trainer import (  # noqa: E402
    make_vae_optimizers, vae_train_step,
)
from upgpt_torch.zoo import build_autoencoder  # noqa: E402
from upgpt_tpu import zoo as jzoo  # noqa: E402
from upgpt_tpu.models import vae as jvae  # noqa: E402
from upgpt_tpu.training import vae_loss as jvl  # noqa: E402
from upgpt_tpu.training import vae_trainer as jvt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, resolution=32)
LR = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_diagonal_gaussian_kl_and_nll_match_jax():
    rng = np.random.default_rng(0)
    m1, m2 = (rng.normal(0, 2, (2, 4, 3, 8)).astype(np.float32)
              for _ in range(2))
    x = rng.normal(size=(2, 4, 3, 4)).astype(np.float32)
    jp, jq = jvae.DiagonalGaussian(jnp.asarray(m1)), jvae.DiagonalGaussian(
        jnp.asarray(m2))
    tp, tq = DiagonalGaussian(torch.from_numpy(m1)), DiagonalGaussian(
        torch.from_numpy(m2))
    for got, want in ((tp.kl(), jp.kl()), (tp.kl(tq), jp.kl(jq)),
                      (tp.nll(torch.from_numpy(x)), jp.nll(jnp.asarray(x))),
                      (tp.var, jp.var)):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), want) < 1e-5
    assert float(tp.kl(tp).abs().max()) < 1e-5


_LEAVES = {"running_mean": "mean", "running_var": "var"}


def _jax_trees(module):
    """(params, batch_stats) of a port module as JAX's trees: OIHW kernels
    to HWIO, norm weights to `scale`, running statistics to `mean` /
    `var` (the bridge's inverse; building the trees here spares a flax
    init of each module)."""
    params, stats = {}, {}
    for name, t in module.state_dict().items():
        *path, leaf = name.split(".")
        arr = t.detach().numpy()
        if leaf == "weight":
            leaf, arr = (("kernel", arr.transpose(2, 3, 1, 0))
                         if arr.ndim == 4 else ("scale", arr))
        node = stats if leaf in _LEAVES else params
        for part in path:
            node = node.setdefault(part, {})
        node[_LEAVES.get(leaf, leaf)] = np.ascontiguousarray(arr)
    return params, stats


@pytest.fixture(scope="module")
def disc_pair():
    """The port's discriminator with perturbed BatchNorms and JAX's on the
    same weights."""
    torch.manual_seed(2)
    port = tvl.NLayerDiscriminator()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, t in port.state_dict().items():
            if name.startswith("bn_"):
                t.add_(torch.rand(t.shape, generator=g) * 0.4 + 0.1)
    params, stats = _jax_trees(port)
    # the bridge maps the trees back onto the module
    load_jax_params(tvl.NLayerDiscriminator(),
                    {**flatten_tree(params), **flatten_tree(stats)})
    return jvl.NLayerDiscriminator(), params, stats, port


def test_discriminator_forwards_and_running_stats_match_flax(disc_pair):
    mod, params, stats, port = disc_pair
    port = tvl.NLayerDiscriminator()
    load_jax_params(port, {**flatten_tree(params), **flatten_tree(stats)})
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want_eval = mod.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)
    want_train, new = mod.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = port(torch.from_numpy(x), train=False)
        got_train = port(torch.from_numpy(x), train=True)
    assert tuple(got_eval.shape) == (2, 2, 2, 1)
    assert _rel(got_eval.numpy(), want_eval) < 1e-5
    assert _rel(got_train.numpy(), want_train) < 1e-5
    sd = port.state_dict()
    for k, v in flatten_tree(new["batch_stats"]).items():
        assert _rel(sd[torch_key(k)].numpy(), v) < 1e-5, k
    # torch's BatchNorm2d would have taken the unbiased variance
    assert "bn_1.num_batches_tracked" not in sd


def _posterior(seed, shape=(2, 16, 16, 8)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("disc_start", [0, 10 ** 6])
def test_generator_and_discriminator_losses_match_jax(disc_pair,
                                                      disc_start):
    mod, params, stats, _ = disc_pair
    cfg = dict(disc_start=disc_start, logvar_init=0.3)
    jloss = jvl.LPIPSWithDiscriminator(jvl.VAELossConfig(**cfg))
    tloss = tvl.LPIPSWithDiscriminator(tvl.VAELossConfig(**cfg))
    load_jax_params(tloss.disc, {**flatten_tree(params),
                                 **flatten_tree(stats)})
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    xr = np.clip(x + rng.normal(0, 0.2, x.shape), -1, 1).astype(np.float32)
    w = rng.uniform(0.5, 2, (2, 32, 32, 1)).astype(np.float32)
    mom = _posterior(6)
    lp = {"disc": params, "disc_stats": stats,
          "logvar": jnp.asarray(0.3, jnp.float32)}
    want_loss, want = jloss.generator_loss(
        lp, jnp.asarray(x), jnp.asarray(xr),
        jvae.DiagonalGaussian(jnp.asarray(mom)), 3, weights=jnp.asarray(w))
    got_loss, got = tloss.generator_loss(
        torch.from_numpy(x), torch.from_numpy(xr),
        DiagonalGaussian(torch.from_numpy(mom)), 3,
        weights=torch.from_numpy(w))
    assert set(got) == set(want)
    assert float(got_loss.detach()) == pytest.approx(float(want_loss),
                                                     rel=1e-5)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                              abs=1e-7), k
    want_d, wlog = jloss.discriminator_loss(lp, jnp.asarray(x),
                                            jnp.asarray(xr), 3)
    got_d, glog = tloss.discriminator_loss(torch.from_numpy(x),
                                           torch.from_numpy(xr), 3)
    assert float(got_d.detach()) == pytest.approx(float(want_d), rel=1e-5,
                                                  abs=1e-7)
    for k in ("disc_loss", "logits_real", "logits_fake"):
        assert float(glog[k]) == pytest.approx(float(wlog[k]), rel=1e-5,
                                               abs=1e-7), k
    sd = tloss.disc.state_dict()
    for k, v in flatten_tree(wlog["new_disc_stats"]).items():
        assert _rel(sd[torch_key(k)].numpy(), v) < 1e-5, k


def test_vanilla_loss_and_adopt_weight_match_jax():
    rng = np.random.default_rng(7)
    r, f = (rng.normal(size=(2, 3, 3, 1)).astype(np.float32)
            for _ in range(2))
    for jf, tf in ((jvl.hinge_d_loss, tvl.hinge_d_loss),
                   (jvl.vanilla_d_loss, tvl.vanilla_d_loss)):
        assert float(tf(torch.from_numpy(r), torch.from_numpy(f))) == \
            pytest.approx(float(jf(jnp.asarray(r), jnp.asarray(f))),
                          rel=1e-6)
    for step in (0, 4, 5, 9):
        assert tvl.adopt_weight(0.5, step, 5) == float(
            jvl.adopt_weight(0.5, step, 5))


@pytest.fixture(scope="module")
def jax_rig():
    """JAX's tiny VAE, its loss at disc_start 0 and the jitted step, traced
    once: the step number reaches the loss only through `adopt_weight`,
    so disc_start d at step i is disc_start 0 at step i - d."""
    vae = jvae.AutoencoderKL(jvae.AutoencoderConfig(**TINY))
    lm = jvl.LPIPSWithDiscriminator(jvl.VAELossConfig(disc_start=0,
                                                      disc_weight=0.5))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    # the port's seeded weights, conv biases at 0 as flax initialises them
    torch.manual_seed(0)
    port_vae = build_autoencoder("kl_f8", "float32", device="cpu", **TINY)
    port_disc = tvl.NLayerDiscriminator()
    for mod in (port_vae, port_disc):
        for name, p in mod.named_parameters():
            if name.endswith("bias") and "norm" not in name:
                torch.nn.init.zeros_(p)
    params, _ = _jax_trees(port_vae)
    disc, disc_stats = _jax_trees(port_disc)
    lp = {"disc": disc, "disc_stats": disc_stats,
          "logvar": np.asarray(0.0, np.float32)}
    opts = jvt.make_vae_optimizers(LR)
    step = jax.jit(lambda p, l, s, b, k, i: jvt.vae_train_step(
        vae, lm, p, l, opts, s, b, k, i))
    return x, params, lp, opts, step


def _jax_steps(rig, disc_start, steps):
    """`steps` JAX steps from the rig's start; each step's state and logs
    and the posterior draws it made."""
    x, params, lp, opts, step = rig
    key = jax.random.PRNGKey(0)
    state = (opts[0].init(params), opts[1].init(lp["disc"]))
    out, p, l = [], params, lp
    for i in range(steps):
        k = jax.random.fold_in(key, i)
        kg, kd = jax.random.split(k)
        draws = [np.asarray(jax.random.normal(kk, (2, 16, 16, 4)))
                 for kk in (kg, kd)]
        p, l, state, logs = step(p, l, state, jnp.asarray(x), k,
                                 i - disc_start)
        out.append({"params": jax.device_get(p), "loss": jax.device_get(l),
                    "logs": {kk: float(v) for kk, v in logs.items()},
                    "draws": draws})
    return x, params, lp, out


@pytest.fixture(scope="module", params=[0, 10 ** 6],
                ids=["disc_start_0", "disc_start_1e6"])
def steps(request, jax_rig):
    x, params, lp, jax_out = _jax_steps(jax_rig, request.param, 3)
    vae = build_autoencoder("kl_f8", "float32", device="cpu", **TINY)
    load_jax_params(vae, params)
    loss = tvl.LPIPSWithDiscriminator(tvl.VAELossConfig(
        disc_start=request.param, disc_weight=0.5))
    load_jax_params(loss.disc, {**flatten_tree(lp["disc"]),
                                **flatten_tree(lp["disc_stats"])})
    opts = make_vae_optimizers(LR, vae, loss)
    port_out = []
    for i, j in enumerate(jax_out):
        logs = vae_train_step(vae, loss, opts, torch.from_numpy(x), i,
                              noises=[torch.from_numpy(d.copy())
                                      for d in j["draws"]])
        port_out.append({"logs": logs, "vae": {
            k: v.clone() for k, v in vae.state_dict().items()},
            "disc": {k: v.clone() for k, v in loss.disc.state_dict().items()},
            "logvar": float(loss.logvar)})
    return {"disc_start": request.param, "jax": jax_out, "port": port_out,
            "start": (params, lp), "opts": opts, "vae": vae}


def _zero_gradient(opt, module) -> set:
    """Names of the parameters whose gradient at the first step was below
    1e-6 of the largest: rounding noise where the exact gradient is 0."""
    names = {id(p): n for n, p in module.named_parameters()}
    g = {names[id(p)]: float((s["exp_avg_sq"] / (1 - 0.9 ** s["step"]))
                             .sqrt().max()) for p, s in opt.state.items()}
    top = max(g.values())
    return {n for n, v in g.items() if v < 1e-6 * top}


def _hold(jax_tree, port_sd, jax_before, zero, steps, label):
    for jk, v in flatten_tree(jax_tree).items():
        tk = torch_key(jk)
        want = torch_array(jk, np.asarray(v))
        got = port_sd[tk].numpy()
        start = torch_array(jk, np.asarray(flatten_tree(jax_before)[jk]))
        if tk in zero:
            # Adam with betas (0.5, 0.9) moves an element at most ~1.1 lr
            # a step (Cauchy-Schwarz on its bias-corrected moments)
            assert np.abs(got - start).max() <= steps * 1.1 * LR, tk
            continue
        # an element whose gradient is at rounding level takes Adam's lr the
        # other way: at most one in 10**4 (one in 131,072 measured), and
        # the rest within 2e-3 (3.3e-4 measured)
        flipped = np.abs((got - start) - (want - start)) > 0.5 * LR
        assert flipped.sum() <= max(1, 1e-4 * flipped.size), (label, tk)
        assert _rel_l2((got - start)[~flipped],
                       (want - start)[~flipped]) < 2e-3, (label, tk)


@pytest.mark.parametrize("n", [1, 3])
def test_vae_train_steps_match_jax(steps, n):
    j, p = steps["jax"][n - 1], steps["port"][n - 1]
    params, lp = steps["start"]
    zero_vae = _zero_gradient(steps["opts"][0], steps["vae"])
    # the exactly-zero gradients: biases only (conv biases ahead of a
    # one-channel-a-group GroupNorm, the attention's key bias)
    assert zero_vae and all(k.endswith("bias") for k in zero_vae)
    for k in j["logs"]:
        if k == "gen/total_loss":
            continue  # R10
        assert p["logs"][k] == pytest.approx(j["logs"][k], rel=1e-4,
                                             abs=1e-7), k
    _hold(j["params"], p["vae"], params, zero_vae, n, "vae")
    _hold(j["loss"]["disc"], p["disc"], lp["disc"], set(), n, "disc")
    # the statistics take the discriminator's inputs after each update,
    # so the steps' float32 differences reach them: 1.2e-5 after three
    for k, v in flatten_tree(j["loss"]["disc_stats"]).items():
        assert _rel(p["disc"][torch_key(k)].numpy(), v) < 1e-4, k
    assert p["logvar"] == float(j["loss"]["logvar"]) == 0.0
    if steps["disc_start"]:
        assert p["logs"]["gen/disc_factor"] == 0.0
        assert float(p["logs"]["disc/disc_loss"]) == 0.0
    assert float(p["logs"]["gen/d_weight"]) > 0


def test_r10_total_loss_log_holds_the_gan_term(steps):
    """R10: JAX logs `gen/total_loss` from `generator_loss` called without
    the adaptive weight (`upgpt_tpu/training/vae_trainer.py:82-96`), so
    its log leaves out d_weight * disc_factor * g_loss although its
    gradient includes it. The port logs the loss it optimises
    (contperceptual.py's `total_loss`)."""
    for j, p in zip(steps["jax"], steps["port"]):
        lg = p["logs"]
        gan = float(lg["gen/d_weight"]) * lg["gen/disc_factor"] * float(
            lg["gen/g_loss"])
        assert float(lg["gen/total_loss"]) == pytest.approx(
            j["logs"]["gen/total_loss"] + gan, rel=1e-5)
        if steps["disc_start"] == 0:
            assert abs(gan) > 1e-3 * abs(j["logs"]["gen/total_loss"])


@pytest.mark.parametrize("name,kind", [("kl_f8_deepfashion.yaml", "kl_f8"),
                                       ("kl_f4.yaml", "kl_f4")])
def test_build_autoencoder_from_config_matches_jax_tree(name, kind):
    cfg = load_config(os.path.join(REPO, "configs", "autoencoder", name))
    model_cfg = {**cfg["model"], "params": {**cfg["model"]["params"],
                                            "device": "cpu"}}
    vae = instantiate_from_config(model_cfg)
    assert vae.config.dtype == torch.bfloat16
    assert not vae.config.use_flash_attention
    assert not vae.config.use_fused_groupnorm
    assert all(p.dtype == torch.float32 for p in vae.parameters())
    jmod = jzoo.build_autoencoder(kind, "bfloat16")
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x,
                                              jax.random.PRNGKey(0)))
    flat = flatten_tree(jax.tree.map(lambda a: np.zeros(a.shape, np.int8),
                                     shapes["params"]))
    sd = vae.state_dict()
    assert len(flat) == len(sd)
    for k, v in flat.items():
        assert tuple(sd[torch_key(k)].shape) == torch_array(k, v).shape, k
    assert sum(v.size for v in flat.values()) == sum(
        p.numel() for p in vae.parameters())
    with pytest.raises(KeyError):
        build_autoencoder("kl_f16", device="cpu")


def test_double_z_off_matches_jax_tree():
    jmod = jvae.AutoencoderKL(jvae.AutoencoderConfig(double_z=False, **TINY))
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jax.random.PRNGKey(0)))["params"]
    vae = build_autoencoder("kl_f8", device="cpu", double_z=False, **TINY)
    sd = vae.state_dict()
    for k, v in flatten_tree(jax.tree.map(lambda a: np.zeros(a.shape,
                                                             np.int8),
                                          shapes)).items():
        assert tuple(sd[torch_key(k)].shape) == torch_array(k, v).shape, k
