"""The data-prep tools (`upgpt_torch.data.prep`) against the JAX package's
`upgpt_tpu/data/prep.py`, on the same inputs, byte for byte: the
segmentation palette conversion (labels, palette and the PNG written),
the high-res resize (the JPEG written) and the style crops (the JPEGs
written, and no file for an absent slot). The three cases of
`tests/test_prep_and_app.py`."""

import os

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_tpu.data import prep as jprep  # noqa: E402
from upgpt_torch.data import prep  # noqa: E402


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_convert_segm_equals_jax(tmp_path):
    rgb = np.zeros((16, 16, 3), np.uint8)
    rgb[:8] = (255, 0, 0)       # hair -> 13
    rgb[8:] = (144, 238, 144)   # skin -> 15
    rgb[4:6, 4:6] = (16, 78, 139)  # face -> 14
    assert prep.SEGM_COLOR_TABLE == jprep.SEGM_COLOR_TABLE
    assert prep.palette() == jprep.palette()
    got, want = prep.convert_segm_image(rgb), jprep.convert_segm_image(rgb)
    assert set(np.unique(np.asarray(got))) == {13, 14, 15}
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.getpalette() == want.getpalette()
    src = tmp_path / "segm_rgb.png"
    Image.fromarray(rgb).save(src)
    prep.convert_segm_file((str(src), str(tmp_path / "a" / "out.png")))
    jprep.convert_segm_file((str(src), str(tmp_path / "b" / "out.png")))
    assert _bytes(tmp_path / "a" / "out.png") == _bytes(
        tmp_path / "b" / "out.png")


def test_resize_highres_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "in.jpg"
    Image.fromarray(rng.integers(0, 255, (1101, 750, 3), np.uint8)).save(src)
    prep.resize_highres_file((str(src), str(tmp_path / "a.jpg"), 512))
    jprep.resize_highres_file((str(src), str(tmp_path / "b.jpg"), 512))
    assert Image.open(tmp_path / "a.jpg").size == (384, 512)
    assert _bytes(tmp_path / "a.jpg") == _bytes(tmp_path / "b.jpg")


def test_style_extraction_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    img_p = tmp_path / "img.jpg"
    Image.fromarray(rng.integers(0, 255, (256, 192, 3), np.uint8)).save(img_p)
    segm = np.zeros((256, 192), np.uint8)
    segm[10:60, 60:120] = 14  # face
    segm[60:200, 50:140] = 1  # top
    segm_p = tmp_path / "segm.png"
    Image.fromarray(segm).save(segm_p)
    prep.extract_styles_for((str(img_p), str(segm_p), str(tmp_path / "a")))
    jprep.extract_styles_for((str(img_p), str(segm_p), str(tmp_path / "b")))
    files = sorted(os.listdir(tmp_path / "a"))
    assert files == sorted(os.listdir(tmp_path / "b"))
    assert "face.jpg" in files and "top.jpg" in files
    assert "shoes.jpg" not in files
    for f in files:
        assert _bytes(tmp_path / "a" / f) == _bytes(tmp_path / "b" / f), f
