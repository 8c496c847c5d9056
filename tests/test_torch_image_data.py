"""The port's single-image datasets (``selfc_tpu_torch/data/image_datasets.py``)
and its MATLAB bicubic resize against the JAX package's, on the CPU, on tiny
PNG trees written here with cv2.

Each dataset pair draws from an unseeded ``random.Random`` (``rng``) on both
sides, seeded alike here: every item is compared array for array, exactly.
The resize: 1e-6 (the same numpy contribution matrices, two float32 products
on each side). The lmdb branch reads through a stand-in environment (the
lmdb module is not installed) handed to both packages' ``open_lmdb``.
"""

import pickle

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.data import image_datasets as jimg
from selfc_tpu.data import loader as jloader
from selfc_tpu.data import util as jutil
from selfc_tpu.ops import resize as jresize
from selfc_tpu.train.rescale_model import make_degrade as jmake_degrade
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.data import image_datasets as timg
from selfc_tpu_torch.data import loader as tloader
from selfc_tpu_torch.data import util as tutil
from selfc_tpu_torch.ops.resize import imresize_matlab
from selfc_tpu_torch.train.rescale_model import make_degrade


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_images(d, n, hw, seed=0):
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        cv2.imwrite(str(d / f"img{i}.png"), rng.integers(0, 256, (*hw, 3), np.uint8))


def _pair(opt):
    """The port's dataset and the JAX package's from the same options."""
    return (tloader.create_dataset(dict_to_nonedict(opt)), jloader.create_dataset(jnonedict(opt)))


def _same_items(t, j, seeds, indices):
    """Every item of ``indices`` under each seed of both datasets' ``rng``
    (where they draw) equal; returns the port's items."""
    assert len(t) == len(j)
    items = []
    for seed in seeds:
        for ds in (t, j):
            if hasattr(ds, "rng"):
                ds.rng.seed(seed)
        for i in indices:
            got, want = t[i], j[i]
            items.append(got)
            assert set(got) == set(want)
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                else:
                    assert got[k] == v, k
    return items


def test_lq_items_match_jax(tmp_path):
    _write_images(tmp_path / "lq", 3, (24, 20))
    t, j = _pair({"mode": "LQ", "phase": "test", "dataroot_LQ": str(tmp_path / "lq")})
    assert isinstance(t, timg.LQDataset)
    _same_items(t, j, (0,), range(3))


@pytest.mark.parametrize("flips", [(True, True), (False, False)], ids=["flip_rot", "none"])
def test_lqgt_train_with_lq_made_on_the_fly_matches_jax(tmp_path, flips):
    _write_images(tmp_path / "gt", 3, (64, 56))
    t, j = _pair({"mode": "LQGT", "phase": "train", "dataroot_GT": str(tmp_path / "gt"),
                  "scale": 4, "GT_size": 34, "use_flip": flips[0], "use_rot": flips[1]})
    _same_items(t, j, (1, 2, 3), range(3))
    assert t[0]["GT"].shape == (34, 34, 3) and t[0]["LQ"].shape == (8, 8, 3)


def test_lqgt_val_paired_matches_jax(tmp_path):
    _write_images(tmp_path / "gt", 2, (64, 48))
    _write_images(tmp_path / "lq", 2, (16, 12), seed=1)
    t, j = _pair({"mode": "LQGT", "phase": "val", "dataroot_GT": str(tmp_path / "gt"),
                  "dataroot_LQ": str(tmp_path / "lq"), "scale": 4})
    _same_items(t, j, (0,), range(2))


class _Env:
    """A read-only stand-in for an lmdb environment: ``begin()`` gives a
    transaction whose ``get`` reads a dict."""

    def __init__(self, blobs):
        self.blobs = blobs

    def begin(self, write=False):
        env = self

        class _Txn:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def get(self, key):
                return env.blobs[key]

        return _Txn()


def _write_lmdb_meta(root, images, sizes_as_str):
    """meta_info.pkl beside a dict of (H,W,C) uint8 blobs; the environment
    itself is the stand-in."""
    root.mkdir(parents=True)
    keys = sorted(images)
    chw = [(images[k].shape[2], *images[k].shape[:2]) for k in keys]
    res = ["_".join(map(str, s)) for s in chw] if sizes_as_str else chw
    with open(root / "meta_info.pkl", "wb") as f:
        pickle.dump({"keys": keys, "resolution": res}, f)
    return _Env({k.encode("ascii"): images[k].tobytes() for k in keys})


@pytest.mark.parametrize("sizes_as_str", [True, False], ids=["str_sizes", "tuple_sizes"])
def test_lqgt_lmdb_matches_jax(tmp_path, monkeypatch, sizes_as_str):
    """The lmdb branch: keys and sizes from meta_info.pkl (sizes as "C_H_W"
    strings or tuples), the blobs decoded, paired GT and LQ, at training."""
    rng = np.random.default_rng(3)
    gt = {f"im{i}": rng.integers(0, 256, (40, 32, 3), np.uint8) for i in range(2)}
    lq = {k: v[::4, ::4].copy() for k, v in gt.items()}
    envs = {str(tmp_path / "gt.lmdb"): _write_lmdb_meta(tmp_path / "gt.lmdb", gt, sizes_as_str),
            str(tmp_path / "lq.lmdb"): _write_lmdb_meta(tmp_path / "lq.lmdb", lq, sizes_as_str)}
    for mod in (tutil, jutil):
        monkeypatch.setattr(mod, "open_lmdb", lambda root: envs[root])
    t, j = _pair({"mode": "LQGT", "phase": "train", "data_type": "lmdb", "dataroot_GT": str(tmp_path / "gt.lmdb"),
                  "dataroot_LQ": str(tmp_path / "lq.lmdb"), "scale": 4, "GT_size": 16, "use_flip": True,
                  "use_rot": True})
    assert t.paths_GT == j.paths_GT == ["im0", "im1"] and t.sizes_GT == j.sizes_GT
    _same_items(t, j, (4, 5), range(2))


@pytest.fixture
def seg_tree(tmp_path):
    """HR images under /img/ (a 'water' and a 'sky' one), their maps under
    /bicseg/ (one .npy, one .pth), and a background pool."""
    for name, seed in (("water", 0), ("sky", 1)):
        _write_images(tmp_path / "ost" / "img" / name, 1, (100, 92), seed)
    seg_d = tmp_path / "ost" / "bicseg"
    maps = np.random.default_rng(2).random((2, 8, 100, 92), dtype=np.float32)
    (seg_d / "water").mkdir(parents=True)
    (seg_d / "sky").mkdir(parents=True)
    np.save(seg_d / "water" / "img0.npy", maps[0])
    torch.save(torch.from_numpy(maps[1]), seg_d / "sky" / "img0.pth")
    _write_images(tmp_path / "bg", 2, (96, 96), seed=3)
    return tmp_path


def test_lrhr_seg_bg_train_matches_jax(seg_tree):
    """Training items: the background pool's 1-in-10 draw, the random
    rescale, the MATLAB bicubic LR, the shared crop and flips, the maps
    read from .npy and .pth."""
    t, j = _pair({"mode": "LRHR_seg_bg", "phase": "train", "dataroot_GT": str(seg_tree / "ost" / "img"),
                  "dataroot_GT_bg": str(seg_tree / "bg"), "scale": 4, "HR_size": 64, "use_flip": True,
                  "use_rot": True})
    assert isinstance(t, timg.LRHRSegBGDataset)
    items = _same_items(t, j, range(8), range(2))
    assert {(it["category"], "/bg/" in it["HR_path"]) for it in items} == {(0, True), (4, False), (5, False)}
    for it in items:
        assert it["HR"].shape == (64, 64, 3) and it["LR"].shape == (16, 16, 3) and it["seg"].shape == (64, 64, 8)


def test_lrhr_seg_bg_val_modcrop_matches_jax(seg_tree):
    t, j = _pair({"mode": "LRHR_seg_bg", "phase": "val", "dataroot_GT": str(seg_tree / "ost" / "img"),
                  "scale": 4})
    _same_items(t, j, (0,), range(2))
    item = t[0]
    assert item["HR"].shape == (96, 88, 3) and item["LR"].shape == (24, 22, 3) and item["category"] == -1


@pytest.mark.parametrize("scale,shape", [(0.25, (1, 2, 33, 40, 3)), (0.5, (2, 18, 22, 1)), (2.0, (9, 7, 3))])
def test_imresize_matlab_matches_jax(scale, shape):
    x = np.random.default_rng(5).random(shape, dtype=np.float32)
    want = np.asarray(jresize.imresize_matlab(jnp.asarray(x), scale))
    got = imresize_matlab(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    img = x.reshape(-1, *shape[-3:])[0]
    np.testing.assert_allclose(timg.imresize_matlab_np(img, scale), jimg.imresize_matlab_np(img, scale),
                               rtol=0, atol=1e-6)


def test_make_degrade_matlab_matches_jax():
    x = np.random.default_rng(6).random((1, 2, 32, 24, 3), dtype=np.float32)
    want = np.asarray(jmake_degrade("matlab", 4)(jnp.asarray(x)))
    got = make_degrade("matlab", 4)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 2, 8, 6, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
