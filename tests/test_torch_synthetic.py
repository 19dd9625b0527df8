"""The port's synthetic pose-transfer rig against the JAX package's.

Both render from numpy with the same seeds, so every sample, batch and
epoch order is bit-equal: the port's iterator yields CPU tensors where
JAX's (with `as_jnp=False`) yields numpy arrays. A bad split raises
ValueError in the port; JAX asserts, which `python -O` drops (ROADMAP R3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_tpu.data.synthetic import SyntheticPairs as JaxPairs  # noqa: E402
from upgpt_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusionConfig as JaxConfig,
)
from upgpt_torch.data.synthetic import SyntheticPairs  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

KW = dict(img_hw=(16, 12), latent_hw=(8, 6), ctx_dim=64, n_samples=40)


@pytest.mark.parametrize("split,seed", [("train", 0), ("val", 0),
                                        ("train", 3)])
def test_samples_and_batches_equal_jax(split, seed):
    port = SyntheticPairs(split=split, seed=seed, **KW)
    ref = JaxPairs(split=split, seed=seed, **KW)
    np.testing.assert_array_equal(port.indices, ref.indices)
    assert len(port) == len(ref) == (35 if split == "train" else 5)
    for i in (0, 1, len(ref) - 1):
        got, want = port.sample(i), ref.sample(i)
        assert set(got) == set(want) == {"image", "person_mask", "text_emb",
                                         "style_emb", "smpl", "loss_w"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = port.batch([2, 0, 3]), ref.batch([2, 0, 3])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].shape == (3, 16, 12, 3)
    assert got["person_mask"].shape == (3, 8, 6, 1)
    assert got["text_emb"].shape == (3, 77, 64)
    assert got["style_emb"].shape == (3, 9, 64)
    assert got["smpl"].shape == (3, 1, 85)


def test_two_epochs_of_the_iterator_equal_jax():
    """Batches of 4 over 35 training samples: 8 a epoch, the tail of 3
    dropped, each epoch in its own seeded order."""
    port = SyntheticPairs(**KW).iterator(4, seed=2)
    ref = JaxPairs(**KW).iterator(4, seed=2, as_jnp=False)
    orders = []
    for _ in range(16):
        got, want = next(port), next(ref)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)
        orders.append(got["smpl"][:, 0, 0].numpy())
    # the two epochs shuffle differently
    first = np.concatenate(orders[:8])
    second = np.concatenate(orders[8:])
    assert not np.array_equal(first, second)


def test_for_model_geometry_equals_jax():
    model = build_latent_diffusion("tiny", device="cpu", latent_size=(8, 6))
    port = SyntheticPairs.for_model(model.config, n_samples=16)
    # JAX's for_model reads the same three fields of its config
    jcfg = JaxConfig(latent_size=(8, 6), context_dim=768)
    ref = JaxPairs.for_model(jcfg, n_samples=16)
    assert port.img_hw == (16, 12) and port.latent_hw == (8, 6)
    assert port.ctx_dim == 768 and ref.ctx_dim == 768
    # kl-f8's three downsamplings against the tiny VAE's one
    assert ref.img_hw == (64, 48)
    np.testing.assert_array_equal(port.sample(5)["text_emb"],
                                  JaxPairs(img_hw=(16, 12), latent_hw=(8, 6),
                                           ctx_dim=768, n_samples=16)
                                  .sample(5)["text_emb"])


def test_r3_bad_split_raises_value_error():
    with pytest.raises(ValueError, match="split"):
        SyntheticPairs(split="test", **KW)
    # JAX's is a bare assert, gone under `python -O`
    with pytest.raises(AssertionError):
        JaxPairs(split="test", **KW)
