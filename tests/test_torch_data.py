"""The port's host-side data path against the JAX package's, on the CPU.

Both packages' DeepFashion datasets and loaders read the same
DeepFashion-shaped tree (`upgpt_torch.data.tree.write_fashion_tree`: 64x48
person images, 224x224 style crops, SMPL pickles, silhouettes, DeepFashion-
MM segmentations). Items and batches are pure functions of (seed, epoch,
index) on both sides, so they must agree bit for bit: every array equal in
dtype and value, every string equal, over two epochs, style dropout and
men_factor oversampling included, for the serial, thread and process
loaders. The native JPEG core must decode exactly what PIL and the JAX
package's core decode; it is skipped only where no libjpeg header exists.
"""

import io
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_tpu import native as jax_native  # noqa: E402
from upgpt_tpu.data import deepfashion as jdf  # noqa: E402
from upgpt_tpu.data import segm as jsegm  # noqa: E402
from upgpt_tpu.data import transforms as jtf  # noqa: E402
from upgpt_tpu.data.verify import verify_root as jax_verify_root  # noqa: E402
from upgpt_torch import native  # noqa: E402
from upgpt_torch.data import deepfashion as tdf  # noqa: E402
from upgpt_torch.data import segm as tsegm  # noqa: E402
from upgpt_torch.data import transforms as ttf  # noqa: E402
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.data.verify import verify_root  # noqa: E402

HW = (64, 48)
LOSS_W = {"background": 0.5, "left-arm": 2.0, "face": 5.0}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (5, 1), "validation": (4, 0)},
                              image_hw=HW, seed=3)


def _pair(module, tree, **kw):
    return module.DeepFashionPair(
        folder=tree["folder"], image_dir="img_256",
        pair_file=[tree["train"]], data_file=tree["data_file"],
        image_size=HW, f=8, input_mask_type="bbox", men_factor=4,
        loss_weight=LOSS_W, **kw)


def _assert_same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("mask", ["bbox", "mask", "smpl"])
def test_pair_items_equal_jax(tree, compact, mask):
    kw = dict(compact=compact, dropout=0.5, shuffle=True)
    ours, theirs = _pair(tdf, tree, **kw), _pair(jdf, tree, **kw)
    ours.input_mask_type = theirs.input_mask_type = mask
    assert len(ours) == len(theirs) == 5 + 1 * 5  # men_factor 4
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            _assert_same(ours[i], theirs[i])


def test_item_layout_and_skip(tree):
    ds = _pair(tdf, tree)
    item = ds[0]
    assert item["image"].shape == HW + (3,)
    assert item["image"].dtype == np.float32
    assert item["styles"].shape == (9, 224, 224, 3)
    assert item["person_mask"].shape == item["loss_w"].shape == (8, 6, 1)
    assert item["smpl"].shape == (1, 85)
    # a broken row is skipped to the next one, as JAX's skip_sample
    ds.rows = [{"from": "missing", "to": "missing"}] + ds.rows
    _assert_same(ds[0], _pair(tdf, tree)[0])


@pytest.mark.parametrize("variant", ["sample", "superres",
                                     "superres_sampling"])
def test_other_datasets_equal_jax(tree, tmp_path, variant):
    root = tree["folder"]
    recon = os.path.join(root, "recon_256")
    lr_dir = tmp_path / "lr"
    lr_dir.mkdir()
    kw = dict(folder=root, image_dir="img_256", pair_file=[tree["train"]],
              data_file=tree["data_file"], image_size=HW, f=8,
              input_mask_type="bbox")
    if variant != "sample":
        # the low-res inputs: recon_256 mirrors img_256; the sampling
        # variant reads generated 256 samples named by get_name
        for ds_row in _pair(tdf, tree).rows:
            src = os.path.join(root, "img_256", ds_row["from"])
            dst = os.path.join(recon, ds_row["from"])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            Image.open(src).save(dst)
            Image.open(src).save(lr_dir / (tdf.get_name(
                ds_row["from"], ds_row["to"]) + ".jpg"))
    cls = {"sample": "DeepFashionSample", "superres": "DeepFashionSuperRes",
           "superres_sampling": "DeepFashionSuperResSampling"}[variant]
    if variant == "superres_sampling":
        kw["lr_dir"] = str(lr_dir)
    if variant == "sample":
        kw.pop("pair_file")
    ours, theirs = getattr(tdf, cls)(**kw), getattr(jdf, cls)(**kw)
    assert len(ours) == len(theirs) > 0
    for i in range(min(len(ours), 4)):
        _assert_same(ours[i], theirs[i])


@pytest.mark.parametrize("kind", ["DataLoader", "PrefetchDataLoader",
                                  "ProcessDataLoader"])
def test_loader_batches_equal_jax(tree, kind):
    kw = {} if kind == "DataLoader" else {"num_workers": 2}
    make = lambda module: getattr(module, kind)(  # noqa: E731
        _pair(module, tree, compact=True, dropout=0.5), 4, shuffle=True,
        seed=5, drop_last=False, **kw)
    ours, theirs = make(tdf), make(jdf)
    try:
        assert len(ours) == len(theirs) == 3
        for epoch in (0, 1):
            got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                _assert_same(a, b)
    finally:
        for loader in (ours, theirs):
            if hasattr(loader, "close"):
                loader.close()


@pytest.mark.parametrize("count,drop_last", [(1, True), (2, False),
                                             (4, False), (4, True)])
def test_process_slicing_equals_jax(count, drop_last):
    """Each process's slice of every global batch, JAX's padding rule
    (a short tail wrap-padded to divide over the processes)."""
    ds = [0] * 10
    for index in range(count):
        ours = tdf.DataLoader(ds, 4, seed=2, drop_last=drop_last,
                              process_index=index, process_count=count)
        theirs = jdf.DataLoader(ds, 4, seed=2, drop_last=drop_last,
                                process_index=index, process_count=count)
        idx = ours._permutation(3)
        np.testing.assert_array_equal(idx, theirs._permutation(3))
        for i in range(len(ours)):
            np.testing.assert_array_equal(ours._batch_indices(idx, i),
                                          theirs._batch_indices(idx, i))


def test_prefetch_loader_propagates_errors_and_stops():
    class BadDs:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("boom")
            return {"x": np.full((2,), i, np.float32)}

    loader = tdf.PrefetchDataLoader(BadDs(), 2, shuffle=False, num_workers=2)
    with pytest.raises(ValueError, match="boom"):
        list(loader.epoch(0))
    # only the loader's own threads (its producer and decode pool, named):
    # under xdist the worker process starts threads of its own. They are
    # polled, not joined: `threading.enumerate` also lists a thread still
    # starting (the decode pool grows while the producer runs), and
    # joining one of those raises
    def loader_threads():
        return {t for t in threading.enumerate()
                if t.name.startswith(tdf.PRODUCER_THREAD)}

    before = loader_threads()
    it = loader.epoch(1)
    assert next(it)["x"].tolist() == [[0, 0], [1, 1]]
    it.close()  # an abandoned epoch unwinds its producer
    deadline = time.monotonic() + 10
    while loader_threads() - before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not loader_threads() - before


def test_bad_input_mask_type_raises_value_error(tree):
    # a ValueError, not an assert: `python -O` strips asserts
    with pytest.raises(ValueError, match="input_mask_type 'depth'"):
        tdf.DeepFashionPair(folder=tree["folder"], image_dir="img_256",
                            pair_file=[tree["train"]],
                            data_file=tree["data_file"],
                            input_mask_type="depth")


@pytest.mark.parametrize("batch,index,count,match", [
    (6, 0, 4, "does not split over 4 processes"),
    (4, 2, 2, r"process_index 2 outside \[0, 2\)"),
    (4, -1, 2, r"process_index -1 outside"),
])
def test_uneven_process_split_raises_value_error(batch, index, count, match):
    with pytest.raises(ValueError, match=match):
        tdf.DataLoader(list(range(12)), batch, process_index=index,
                       process_count=count)


def test_segmenters_equal_jax():
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (96, 64, 3)).astype(np.float32)
    segm = rng.integers(0, 24, (96, 64)).astype(np.uint8)
    segm[5:20, 20:40] = 14
    for name in ("DeepfashionMMStyleSegmenter", "LipSegmenter"):
        ours, theirs = getattr(tsegm, name)(), getattr(jsegm, name)()
        a, b = ours.clip_crops(image, segm), theirs.clip_crops(image, segm)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    lw = tsegm.DeepfashionMMSegmenter().get_mask(segm, LOSS_W)
    np.testing.assert_array_equal(
        lw, jsegm.DeepfashionMMSegmenter().get_mask(segm, LOSS_W))


def test_transforms_equal_jax():
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, (40, 30, 3), np.uint8))
    mask = np.zeros((40, 30), np.uint8)
    mask[5:30, 4:20] = 1
    for fn, args in [("to_tensor_range", (img,)),
                     ("clip_normalize_image", (img,)),
                     ("to_uint8", (img,)), ("empty_style", ()),
                     ("silhouette_bbox", (mask,)),
                     ("mask_transform_binary", (mask, (5, 4))),
                     ("mask_transform_smpl", (img, (5, 4))),
                     ("resize_bilinear", (img, (7, 9)))]:
        np.testing.assert_array_equal(getattr(ttf, fn)(*args),
                                      getattr(jtf, fn)(*args), err_msg=fn)
    for fn, args in [("center_crop", (img, (20, 16))),
                     ("pad_image", (img, (8, 0), "edge")),
                     ("resize_short_side", (img, 24))]:
        np.testing.assert_array_equal(np.asarray(getattr(ttf, fn)(*args)),
                                      np.asarray(getattr(jtf, fn)(*args)))
    np.testing.assert_array_equal(ttf.CLIP_MEAN, jtf.CLIP_MEAN)
    np.testing.assert_array_equal(ttf.CLIP_STD, jtf.CLIP_STD)


# ------------------------------------------------------ the native core


def _needs_libjpeg():
    if not os.path.exists("/usr/include/jpeglib.h"):
        pytest.skip("no libjpeg header: the native core cannot build here")


def _jpeg(arr: np.ndarray, quality: int = 90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("shape,quality", [((256, 192, 3), 90),
                                           ((224, 224, 3), 75),
                                           ((37, 53, 3), 95),
                                           ((48, 40), 90)])
def test_native_decode_equals_pil_and_jax(shape, quality):
    _needs_libjpeg()
    assert native.available()
    rng = np.random.default_rng(shape[0])
    data = _jpeg(rng.integers(0, 256, shape, np.uint8), quality)
    got = native.decode_jpeg(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == pil.shape
    np.testing.assert_array_equal(got, pil)
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_native.decode_jpeg(data))
    # the library is built under the package's untracked build directory
    assert native.library_path().parent.parent.name == "_build"


def test_native_decode_refuses_bad_data_and_falls_back(tmp_path,
                                                       monkeypatch):
    _needs_libjpeg()
    assert native.decode_jpeg(b"\xff\xd8 not a jpeg") is None
    assert native.decode_jpeg_file(tmp_path / "absent.jpg") is None
    path = tmp_path / "x.jpg"
    arr = np.random.default_rng(2).integers(0, 256, (32, 24, 3), np.uint8)
    path.write_bytes(_jpeg(arr))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(np.asarray(ttf.open_rgb(path)), want)
    png = tmp_path / "x.png"
    Image.fromarray(arr).save(png)
    np.testing.assert_array_equal(np.asarray(ttf.open_rgb(png)), arr)
    monkeypatch.setenv("UPGPT_NATIVE_DECODE", "0")
    assert not native.available()
    np.testing.assert_array_equal(np.asarray(ttf.open_rgb(path)), want)


def test_native_decode_on_a_thread_pool():
    """Concurrent decodes (the GIL released in the core) give every
    caller its own image."""
    _needs_libjpeg()
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(4)
    blobs = [_jpeg(rng.integers(0, 256, (64, 48, 3), np.uint8))
             for _ in range(16)]
    want = [native.decode_jpeg(b) for b in blobs]
    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(native.decode_jpeg, blobs * 4))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, want[i % 16])


# ------------------------------------------------------ the readiness drill


def test_verify_report_equals_jax(tree, tmp_path):
    import shutil

    kw = dict(root=tree["folder"], pair_files=[tree["train"]],
              data_file=tree["data_file"], deep_smpl_every=1)
    ours, theirs = verify_root(**kw), jax_verify_root(**kw)
    assert ours == theirs and ours["ok"]
    assert ours["counts"]["pairs_checked"] == 6
    broken = tmp_path / "broken"
    shutil.copytree(tree["folder"], broken)
    first = tdf._read_csv(tree["train"])[0]
    target = next(r for r in tdf._read_csv(tree["data_file"])
                  if r["image"] == first["to"])
    os.remove(broken / "img_256" / target["image"])
    with open(broken / "smpl_256" / f"{target['pose']}.p", "wb") as f:
        f.write(b"not a pickle")
    kw.update(root=str(broken), data_file=str(broken / "map.csv"))
    ours, theirs = verify_root(**kw), jax_verify_root(**kw)
    assert not ours["ok"]
    assert set(ours["missing"]) == {"image", "smpl_schema"}
    assert ours == theirs


def test_smpl_pickles_load_through_the_restricted_unpickler(tree,
                                                            tmp_path):
    """The tree's SMPL pickles (`data/tree.py`) load through
    `load_smpl_pickle` as `pickle.load` (JAX's reader) loads them; numpy's
    protocol-2 pickles under either module name numpy has given
    `_reconstruct` load too; a pickle naming any other global is refused
    by name, in the dataset and in data-verify, without running it."""
    import pickle

    from upgpt_torch.data.smpl_pickle import load_smpl_pickle

    pickles = sorted(p for d in ("smpl_256", "smpl")
                     for p in (Path(tree["folder"]) / d).glob("*.p"))
    assert pickles
    for path in pickles:
        with open(path, "rb") as f:
            want = pickle.load(f)
        got = load_smpl_pickle(path)
        assert list(got[0]) == list(want[0])
        for k in want[0]:
            assert got[0][k].dtype == want[0][k].dtype
            np.testing.assert_array_equal(got[0][k], want[0][k])
    value = [{"pred_body_pose": np.arange(72, dtype=np.float64)}]
    raw = pickle.dumps(value, protocol=2)
    for module in (b"numpy._core.multiarray", b"numpy.core.multiarray"):
        name = raw.replace(b"numpy._core.multiarray", module).replace(
            b"numpy.core.multiarray", module)
        (tmp_path / "p2.p").write_bytes(name)
        np.testing.assert_array_equal(
            load_smpl_pickle(tmp_path / "p2.p")[0]["pred_body_pose"],
            value[0]["pred_body_pose"])

    marker = tmp_path / "ran"

    class Shell:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    (tmp_path / "shell.p").write_bytes(pickle.dumps([Shell()]))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        load_smpl_pickle(tmp_path / "shell.p")
    from upgpt_torch.data.verify import _check_smpl

    assert "system" in _check_smpl(tmp_path / "shell.p")
    ds = _pair(tdf, tree)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        ds._load_smpl(str(tmp_path / "shell"))
    assert not marker.exists()
