"""The port's data pipeline (``selfc_tpu_torch/data``) against the JAX
package's (``selfc_tpu/data``) on the CPU, on tiny PNG trees written here
with cv2: 3 clips of 9 frames at 40 x 48 (UVG: one sequence of 12 frames
at 192 x 192, MS-SSIM's least size).

Every comparison is exact (the same bits, the same bytes, the same order)
but two: the UVG I-frame PSNR / MS-SSIM, two float32 stacks within 1e-5;
the uint8 cast on the device, within 1 ulp of ``astype(float32) / 255``.
The datasets draw from an unseeded ``random.Random`` (``rng``) on both
sides: each pair is seeded alike, and the Aug mode's ``np_rng`` too.
"""

import json
import random
import sys

import cv2
import numpy as np
import pytest
import torch

from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.data import loader as jloader
from selfc_tpu.data import packed as jpacked
from selfc_tpu.data.sampler import DistIterSampler as JDistIterSampler
from selfc_tpu.data.uvg_dataset import UVGDataset as JUVGDataset
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.data import loader as tloader
from selfc_tpu_torch.data import packed as tpacked
from selfc_tpu_torch.data.datasets import epoch_ratio
from selfc_tpu_torch.data.sampler import DistIterSampler
from selfc_tpu_torch.data.uvg_dataset import UVGDataset
from selfc_tpu_torch.parallel.dist import frames_to_device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLIPS, FRAMES, H, W = 3, 9, 40, 48


def _frames():
    """The tree's frames, uint8 RGB: {name: (FRAMES, H, W, 3)}."""
    rng = np.random.default_rng(11)
    return {f"clip{v:03d}": rng.integers(0, 256, (FRAMES, H, W, 3), dtype=np.uint8)
            for v in range(CLIPS)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The PNG tree, and its packing by each package."""
    root = tmp_path_factory.mktemp("data")
    png = root / "png"
    for name, clip in _frames().items():
        (png / name).mkdir(parents=True)
        for i, rgb in enumerate(clip):
            cv2.imwrite(str(png / name / f"im{i + 1}.png"), rgb[:, :, ::-1])
    (png / "list.txt").write_text("\n".join(_frames()) + "\n")
    jpacked.pack_lqgtvid(str(png), str(png / "list.txt"), str(root / "packed_jax"))
    tpacked.pack_lqgtvid(str(png), str(png / "list.txt"), str(root / "packed"))
    return root


def _opt(tree, mode, phase, **kw):
    packed = mode == "LQGTVID_packed"
    base = {"mode": mode, "phase": phase, "scale": 4,
            "dataroot_GT": str(tree / ("packed" if packed else "png")),
            "dataroot_list": str(tree / "png" / "list.txt"), "color": "RGB"}
    if phase == "train":
        base.update(video_len=5, GT_size=32, use_flip=True, use_rot=True, use_elastic_deform=True)
    base.update(kw)
    return base


def _pair(tree, mode, phase, seed=0, **kw):
    """(JAX dataset, port dataset) of one mode, their draws seeded alike."""
    opt = _opt(tree, mode, phase, **kw)
    jopt = dict(opt, dataroot_GT=opt["dataroot_GT"].replace("packed", "packed_jax"))
    jds = jloader.create_dataset(jnonedict(jopt))
    tds = tloader.create_dataset(dict_to_nonedict(opt))
    for ds in (jds, tds):
        ds.rng = random.Random(seed)
        if hasattr(ds, "np_rng"):
            ds.np_rng = np.random.default_rng(seed)
    return jds, tds


def _same_item(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
            np.testing.assert_array_equal(b[k], v, err_msg=k)
        else:
            assert b[k] == v, k


MODES = ["LQGTVID", "LQGTVID_Aug", "LQGTVID_Consecutive", "LQGTVID_SR", "LQGTVID_bicubic",
         "LQGTVID_packed"]


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("mode", MODES)
def test_lqgtvid_modes_give_the_jax_items(tree, mode, phase):
    """Item by item (each index twice: fresh draws), the same frames, LQ
    clips and names."""
    jds, tds = _pair(tree, mode, phase)
    assert len(tds) == len(jds)
    for i in (0, 2, 1, 0):
        _same_item(jds[i], tds[i])


@pytest.mark.parametrize("u8", [False, True])
def test_packed_dataset_uint8_both_ways_and_epoch_ratio(tree, u8):
    """``output_uint8`` both ways against the JAX dataset, and the uint8
    item is the float item's bytes; ``epoch_ratio`` inflates a training
    epoch only."""
    jds, tds = _pair(tree, "LQGTVID_packed", "train", output_uint8=u8, epoch_ratio=4)
    assert len(tds) == len(jds) == CLIPS * 4 == CLIPS * epoch_ratio(tds.opt, True)
    for i in (0, 5, 11):
        _same_item(jds[i], tds[i])
    _, flt = _pair(tree, "LQGTVID_packed", "train", output_uint8=False)
    _, raw = _pair(tree, "LQGTVID_packed", "train", output_uint8=True)
    a, b = flt[1]["GT"], raw[1]["GT"]
    assert b.dtype == np.uint8 and a.dtype == np.float32
    np.testing.assert_array_equal(b.astype(np.float32) / 255.0, a)
    _, val = _pair(tree, "LQGTVID_packed", "val", epoch_ratio=4, output_uint8=True)
    assert len(val) == CLIPS and val[0]["GT"].dtype == np.uint8


def test_write_packed_is_pack_lqgtvid_byte_for_byte(tree, tmp_path):
    """The in-memory writer on the frames, against both packers on the PNGs."""
    index = tpacked.write_packed(str(tmp_path), _frames().items())
    assert index["total_bytes"] == CLIPS * FRAMES * H * W * 3
    for packed in ("packed", "packed_jax"):
        for name in ("data.u8", "index.json"):
            assert (tmp_path / name).read_bytes() == (tree / packed / name).read_bytes(), (packed, name)
    assert json.loads((tmp_path / "index.json").read_text())["clips"][1]["offset"] == FRAMES * H * W * 3
    with pytest.raises(ValueError, match="constant-resolution"):
        tpacked.write_packed(str(tmp_path / "bad"), [("c", [np.zeros((4, 4, 3), np.uint8),
                                                              np.zeros((4, 6, 3), np.uint8)])])


def test_packed_uint8_path_runs_without_cv2(tree, monkeypatch):
    """With no cv2 the packed uint8 path reads and the PNG modes raise an
    ImportError that names the mode."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    _, tds = _pair(tree, "LQGTVID_packed", "train", output_uint8=True)
    assert tds[0]["GT"].shape == (5, 32, 32, 3)
    with pytest.raises(ImportError, match="LQGTVID_Aug"):
        tloader.create_dataset(dict_to_nonedict(_opt(tree, "LQGTVID_Aug", "train")))
    with pytest.raises(ImportError, match="use_multi_scale"):
        _pair(tree, "LQGTVID_packed", "val", use_multi_scale=True)[1][0]


@pytest.mark.parametrize("size,replicas,ratio", [(7, 2, 3), (5, 3, 200)])
def test_dist_iter_sampler_indices_are_the_jaxs(size, replicas, ratio):
    for rank in range(replicas):
        a, b = JDistIterSampler(size, replicas, rank, ratio), DistIterSampler(size, replicas, rank, ratio)
        for epoch in (0, 3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(b) == list(a) and len(b) == len(a)
    with pytest.raises(ValueError):
        DistIterSampler(size, replicas, replicas)


def test_create_dataloader_batches_over_two_epochs(tree):
    """One worker (the draws in index order): the same index order, arrays
    and names two epochs running, and a drop_last length."""
    kw = {"output_uint8": True, "use_shuffle": True, "batch_size": 2, "n_workers": 1,
          "epoch_ratio": 3}
    jds, tds = _pair(tree, "LQGTVID_packed", "train", **kw)
    jl = jloader.create_dataloader(jds, jds.opt, {"world_size": 1})
    tl = tloader.create_dataloader(tds, tds.opt, {"world_size": 1})
    try:
        assert len(tl) == len(jl) == CLIPS * 3 // 2 and tl.num_workers == 1
        for _ in range(2):
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == len(tl)
            for a, b in zip(want, got):
                _same_item(a, b)
    finally:
        jl.close()
        tl.close()
    half = tloader.create_dataloader(tds, tds.opt, {"world_size": 2})
    assert half.batch_size == 1 and half.drop_last


def _names(batches):
    return [b["GT_path"] for b in batches]


def test_process_loader_gives_the_jax_batches(tree):
    """``use_process_loader``: spawned workers, one here (its draws in
    index order), against the JAX package's over two epochs; then an early
    exit, whose batches left in flight must not reach the next epoch, which
    keeps the shuffled order; ``close`` stops the workers."""
    kw = {"output_uint8": True, "use_shuffle": True, "batch_size": 2, "n_workers": 1,
          "epoch_ratio": 3, "use_process_loader": True}
    jds, tds = _pair(tree, "LQGTVID_packed", "train", **kw)
    jl = jloader.create_dataloader(jds, jds.opt, {"world_size": 1})
    tl = tloader.create_dataloader(tds, tds.opt, {"world_size": 1})
    assert isinstance(tl, tloader.ProcessDataLoader)
    try:
        for _ in range(2):
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == len(tl) == CLIPS * 3 // 2
            for a, b in zip(want, got):
                _same_item(a, b)
        next(iter(tl))
        order = np.random.default_rng(tl._epoch + 1).permutation(CLIPS * 3)[: 2 * len(tl)]
        assert _names(list(tl)) == [[f"clip{i % CLIPS:03d}/im1.png" for i in order[k : k + 2]]
                                    for k in range(0, len(order), 2)]
        procs = tl._procs
    finally:
        jl.close()
        tl.close()
    assert tl._procs is None and not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("mode", ["LQGTVID_packed", "LQGTVID_Aug"])
def test_rng_seed_gives_each_item_its_own_draws(tree, mode):
    """``rng_seed`` keys an item's draws by (seed, epoch, index): two
    datasets drawing in other orders give the same items, another epoch
    other ones, and the loaders' batches repeat whatever their threads or
    processes."""
    kw = {"rng_seed": 3, "use_elastic_deform": True} if mode == "LQGTVID_Aug" else {"rng_seed": 3}
    _, a = _pair(tree, mode, "train", seed=1, **kw)
    _, b = _pair(tree, mode, "train", seed=2, **kw)
    first = [a[i] for i in (0, 1, 2)]
    for i in (2, 0, 1):
        _same_item(first[i], b[i])
    b.epoch = 1
    assert not all(np.array_equal(first[i]["GT"], b[i]["GT"]) for i in range(3))
    if mode != "LQGTVID_packed":
        return
    loaders = [tloader.create_dataloader(ds, ds.opt, {"world_size": 1}) for ds in (a, b)]
    loaders.append(tloader.create_dataloader(
        b, dict_to_nonedict(dict(b.opt, use_process_loader=True, n_workers=2)), {"world_size": 1}))
    loaders[0].num_workers = 3
    try:
        runs = [[list(ld) for _ in range(2)] for ld in loaders]
    finally:
        for ld in loaders:
            ld.close()
    for run in runs[1:]:
        for want, got in zip(runs[0], run):
            for x, y in zip(want, got):
                _same_item(x, y)
    assert not np.array_equal(runs[0][0][0]["GT"], runs[0][1][0]["GT"])


def test_uvg_dataset_is_the_jaxs(tmp_path):
    rng = np.random.default_rng(0)
    seq = tmp_path / "seq0"
    (seq / "H265L20").mkdir(parents=True)
    for i in range(1, 13):
        cv2.imwrite(str(seq / f"im{i:03d}.png"), rng.integers(0, 255, (192, 192, 3), np.uint8))
    cv2.imwrite(str(seq / "H265L20" / "im0001.png"), rng.integers(0, 255, (192, 192, 3), np.uint8))
    (tmp_path / "list.txt").write_text("seq0\n")
    opt = {"dataroot_GT": str(tmp_path), "dataroot_list": str(tmp_path / "list.txt")}
    a, b = JUVGDataset(jnonedict(opt))[0], UVGDataset(dict_to_nonedict(opt))[0]
    for k in ("GT", "ref"):
        np.testing.assert_array_equal(b[k], a[k])
    assert b["GT"].shape == (11, 192, 192, 3)
    assert (b["ref_bpp"], b["GT_path"]) == (a["ref_bpp"], a["GT_path"])
    np.testing.assert_allclose([b["ref_psnr"], b["ref_msssim"]], [a["ref_psnr"], a["ref_msssim"]],
                               rtol=1e-5)


def test_uint8_cast_is_within_one_ulp():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 1, 16, 16, 1)
    got = frames_to_device(u8, "cpu").numpy()
    want = u8.astype(np.float32) / 255.0
    assert got.dtype == np.float32
    assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1
    flt = np.random.default_rng(1).random((1, 2, 4, 4, 3), dtype=np.float32)
    np.testing.assert_array_equal(frames_to_device(flt, "cpu").numpy(), flt)
