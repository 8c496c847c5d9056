"""The port's entry points on the CPU at a tiny size: ``cli.train`` (the
first step's logged losses against ``RescaleModel.optimize_parameters`` on
the same batch, a resume that restores Adam's step, the log lines against
the root CLIs' format strings), ``cli.test_rescaling`` against
``run_eval``, ``cli.test_compression``'s log lines, the profiler window of
``cli.train`` closed on each way out of the loop, and a 2-process gloo step
against the 1-process step on the concatenated batch.

The data is a packed set (``data/packed.py:write_packed``) of 3 clips of 4
frames at 48 x 48 (the compression eval: 2 clips of 3 frames at 176 x 176,
MS-SSIM's least size), read without flips, rotations or crops, so every item
is the same whatever the dataset's unseeded ``rng`` draws. The net is
SelfC_GMM cut to ``block_num [1]``, ``stp_blk_num 1``.

Tolerances: the logged losses are the reference's to the 5 digits the log
prints; the 2-process gradient within 1e-6 relative l2 of the 1-process
one (the same products summed in another order), the parameters after the
step within 1e-6, a hundredth of lr = 1e-4, as ``test_torch_train.py``
holds a step (Adam's first step moves an element by lr times the sign of its
gradient, less where the gradient is near its eps of 1e-8 and so turns on
its last bits).
"""

import ast
import glob
import json
import multiprocessing as mp
import os
import re
import socket
import string
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from selfc_tpu_torch import config as option
from selfc_tpu_torch.cli import test_compression as cli_compression
from selfc_tpu_torch.cli import test_rescaling as cli_rescaling
from selfc_tpu_torch.cli import train as cli_train
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.data import create_dataloader, create_dataset
from selfc_tpu_torch.data.packed import write_packed
from selfc_tpu_torch.eval.rescaling import run_eval
from selfc_tpu_torch.train import checkpoint
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils.jax_import import export_jax_params, flatten_tree

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HW = 48             # the LR's 12 x 12 is SSIM's least size (an 11-tap window)
NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "in_nc": 3, "out_nc": 3, "block_num": [1],
       "scale": 4, "init": "xavier", "global_module": "nonlocal", "stp_blk_num": 1,
       "fh_loss": "gmm", "gmm_k": 5}
TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "niter": 2, "warmup_iter": -1,
         "lr_scheme": "MultiStepLR", "lr_steps": [100], "lr_gamma": 0.5,
         "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1", "lambda_cond_prob": 0,
         "manual_seed": 10, "val_freq": 2, "lambda_fit_forw": 1, "lambda_rec_back": 1,
         "weight_decay_G": 1e-14, "gradient_clipping": 10}


def _packed(root, clips=3, frames=4, size=HW):
    rng = np.random.default_rng(3)
    write_packed(str(root), [(f"clip{v:03d}", rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8))
                             for v in range(clips)])
    return root


def _train_yaml(tmp_path, data, name="tiny_cli", path=None, train=None, logger=None):
    opt = {"name": name, "use_tb_logger": False, "model": "SelfC_GMM", "distortion": "sr_bd",
           "scale": 4,
           "datasets": {
               "train": {"name": "tiny", "mode": "LQGTVID_packed", "dataroot_GT": str(data),
                         "output_uint8": True, "video_len": 4, "use_shuffle": True,
                         "n_workers": 1, "batch_size": 2, "GT_size": HW, "use_flip": False,
                         "use_rot": False},
               "val1": {"name": "tinyval", "mode": "LQGTVID_packed", "dataroot_GT": str(data),
                        "video_len": 4}},
           "network_G": NET,
           "path": {"pretrain_model_G": None, "strict_load": None, "resume_state": None, **(path or {})},
           "train": {**TRAIN, **(train or {})},
           "logger": {"print_freq": 1, "save_checkpoint_freq": 2, **(logger or {})}}
    f = tmp_path / f"{name}.yml"
    f.write_text(yaml.safe_dump(opt))
    return str(f)


def _log(directory, prefix):
    (path,) = glob.glob(os.path.join(directory, f"{prefix}_*.log"))
    return Path(path).read_text().splitlines()


def _messages(lines):
    return [ln.split(" - INFO: ", 1)[1] for ln in lines if " - INFO: " in ln]


def _format_strings(path):
    """Every string constant with a replacement field in a root source file."""
    tree = ast.parse(Path(path).read_text())
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and "{" in n.value}


_FIELD = {"d": r"[ \d,]+", "e": r"-?(?:\d\.\d+e[+-]\d+|nan|inf)", "f": r"-?\d+\.\d+", "s": r"\S+ *", "": r".*?"}


def _regex(fmt):
    """A format string as a regex: each field by its presentation type."""
    out = ""
    for literal, field, spec, _ in string.Formatter().parse(fmt):
        out += re.escape(literal)
        if field is not None:
            out += _FIELD[(spec or "")[-1:]] if (spec or "")[-1:] in _FIELD else _FIELD["s"]
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two iterations of cli.train (checkpoint at 2, val at 2), then a
    resume from iter 2 to 3 with a checkpoint at 3."""
    tmp = tmp_path_factory.mktemp("cli")
    data = _packed(tmp / "packed")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        yml = _train_yaml(tmp, data)
        cli_train.main(["-opt", yml, "--device", "cpu"])
        exp = tmp / "experiments" / "tiny_cli"
        first = _log(exp, "train_tiny_cli")
        val = _log(exp, "val_tiny_cli")
        for f in glob.glob(str(exp / "*.log")):
            os.remove(f)
        resumed = _train_yaml(tmp, data, path={"resume_state": str(exp / "training_state" / "2.state")},
                              logger={"save_checkpoint_freq": 3})
        cli_train.main(["-opt", resumed, "--device", "cpu", "--max-iters", "3"])
        second = _log(exp, "train_tiny_cli")
    finally:
        os.chdir(cwd)
    return {"tmp": tmp, "data": data, "yml": yml, "exp": exp, "first": first, "val": val,
            "second": second}


def _logged_values(msg):
    return dict(re.findall(r"(\w+): (\S+) ", msg.split("> ", 1)[1]))


def test_cli_train_first_step_losses_are_the_models(trained):
    opt = option.parse(trained["yml"], is_train=True)
    ds = create_dataset(opt["datasets"]["train"])
    loader = create_dataloader(ds, opt["datasets"]["train"], opt)
    batch = next(iter(loader))
    loader.close()
    model = RescaleModel(opt, device="cpu", rng_seed=10)
    model.feed_data(batch)
    model.optimize_parameters(1)
    want = model.get_current_log()
    (line,) = [m for m in _messages(trained["first"]) if m.startswith("<epoch:  0, iter:       1,")]
    got = _logged_values(line)
    for k in ("l_back_rec", "l_forw_fit", "loss", "loss_c", "skipped_nonfinite"):
        assert got[k] == "{:.4e}".format(want[k]), k
    assert float(got["skipped_nonfinite"]) == 0.0 and "data_s" in got and "step_s" in got


def test_cli_train_writes_checkpoints_and_resumes_adam(trained):
    exp = trained["exp"]
    for f in ("models/2_G.msgpack", "models/latest_G.msgpack", "models/best_G.msgpack",
              "training_state/2.state", "models/3_G.msgpack", "training_state/3.state"):
        assert (exp / f).exists(), f
    state2 = checkpoint.load_training_state(str(exp / "training_state" / "2.state"))
    assert checkpoint.adam_moments(state2["opt_state"])[0] == 2
    state3 = checkpoint.load_training_state(str(exp / "training_state" / "3.state"))
    assert state3["iter"] == 3 and checkpoint.adam_moments(state3["opt_state"])[0] == 3
    msgs = _messages(trained["second"])
    assert "Resuming training from epoch: 1, iter: 2." in msgs
    assert "Start training from epoch: 1, iter: 2" in msgs
    steps = [int(m.split("iter:")[1].split(",")[0]) for m in msgs if m.startswith("<epoch:")]
    assert steps == [3]


def test_cli_train_log_lines_follow_the_root_cli_formats(trained):
    fmts = _format_strings(ROOT / "train.py")
    head = "<epoch:{:3d}, iter:{:8,d}, lr:{:.3e}> "
    assert {head, "{:s}: {:.4e} ", "rate_src: {:s} "} <= fmts
    step = re.compile(_regex(head) + "(?:" + _regex("{:s}: {:.4e} ") + ")+$")
    msgs = _messages(trained["first"])
    lines = [m for m in msgs if m.startswith("<epoch:")]
    assert len(lines) == 2 and all(step.match(m) for m in lines), lines
    assert "wall_s" in _logged_values(lines[1]) and "wall_s" not in _logged_values(lines[0])
    val_fmt = "# Validation {} # PSNR: {:.6f} SSIM: {:.6f}"
    assert val_fmt in fmts
    (v,) = _messages(trained["val"])
    assert re.fullmatch(_regex(val_fmt), v), v


def _test_yaml(tmp, data, ckpt, name="tiny_test", model="SelfC_GMM", network=None, val=None):
    opt = {"name": name, "model": model, "distortion": "sr_bd", "scale": (network or NET)["scale"],
           "datasets": {"test_1": {"name": "tinytest", "mode": "LQGTVID_packed",
                                   "dataroot_GT": str(data), "video_len": 4, "batch_size": 1}},
           "network_G": network or NET, "path": {"pretrain_model_G": ckpt}, "val": val or {}}
    f = tmp / f"{name}.yml"
    f.write_text(yaml.safe_dump(opt))
    return str(f)


def test_cli_test_rescaling_gives_run_evals_numbers(trained, monkeypatch):
    tmp = trained["tmp"]
    monkeypatch.chdir(tmp)
    yml = _test_yaml(tmp, trained["data"], str(trained["exp"] / "models" / "latest_G.msgpack"))
    got = cli_rescaling.main(["-opt", yml, "--no-images", "--device", "cpu"])
    opt = option.parse(yml, is_train=False)
    ds_opt = opt["datasets"]["test_1"]
    loader = create_dataloader(create_dataset(ds_opt), ds_opt)
    want = run_eval(opt, [("tinytest", loader)], RescaleModel(opt, device="cpu"), save_images=False)
    loader.close()
    assert got == want and np.isfinite(got["psnr_y"][0])
    fmts = _format_strings(ROOT / "selfc_tpu" / "eval" / "rescaling.py")
    msgs = _messages(_log(tmp / "results" / "tiny_test", "test_tiny_test"))
    for fmt in ("Averaged HR results for all datasets, PSNR {:.6f}dB, SSIM {:.6f}",
                "Averaged LR results for all datasets, PSNR {:.6f}dB, SSIM {:.6f}"):
        assert fmt in fmts and any(re.fullmatch(_regex(fmt), m) for m in msgs), fmt


CODEC_NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "in_nc": 3, "out_nc": 3,
             "block_num": [1], "scale": 2, "init": "xavier", "global_module": "nonlocal",
             "stp_blk_num": 1, "h265_q": 9, "h265_keyint": -1, "h265_all_default": True,
             "fh_loss": "l2", "stp_hidden_c": 24, "stp_denseblock_innerc": 12}


def test_cli_test_compression_log_lines_parse(trained, monkeypatch):
    """The zlib stand-in codec on random weights: every per-clip and average
    line in the root CLI's format."""
    tmp = trained["tmp"]
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    data = _packed(tmp / "packed_codec", clips=2, frames=3, size=176)
    yml = _test_yaml(tmp, data, None, "tiny_codec", "SelfC_GMM_Codec", CODEC_NET,
                     {"standin_codec": "zlib"})
    cli_compression.main(["-opt", yml, "--no-images", "--device", "cpu"])
    text = "\n".join(_log(tmp / "results" / "tiny_codec", "test_tiny_codec"))
    fmts = _format_strings(ROOT / "test_compression.py")
    clip_fmt = next(f for f in fmts if f.startswith("{:20s} - video_distor_loss"))
    assert len(re.findall(_regex(clip_fmt), text)) == 2
    for prefix in ("----Average PSNR/SSIM results for {}", "----Average Compression results for {}"):
        fmt = next(f for f in fmts if f.startswith(prefix))
        hits = re.findall(_regex(fmt), text)
        assert len(hits) == 2, (prefix, hits)
    assert "[rate: zlib]" in text


# (niter, --profile-at, --profile-steps, the iteration whose step raises):
# the window closes after its last step; niter comes first; a step inside
# the window raises
PROFILE_CASES = {"window": (4, 2, 2, None), "niter": (3, 2, 5, None), "raises": (4, 2, 2, 3)}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_cli_train_profile_window_is_closed(trained, monkeypatch, case):
    """``--profile-at`` on the tiny run: the trace is written whole and
    ``launches.json`` beside it on each way out of the window; the CPU run
    logs no ``gpu_step_s`` (its timer's clock is the host's)."""
    niter, at, steps, boom = PROFILE_CASES[case]
    tmp = trained["tmp"] / f"profile_{case}"
    tmp.mkdir()
    monkeypatch.chdir(tmp)
    if boom is not None:
        step = RescaleModel.optimize_parameters

        def raising(self, current_step, *args, **kw):
            if current_step == boom:
                raise RuntimeError("inside the window")
            return step(self, current_step, *args, **kw)

        monkeypatch.setattr(RescaleModel, "optimize_parameters", raising)
    yml = _train_yaml(tmp, trained["data"], name="tiny_profile", train={"niter": niter, "val_freq": 100},
                      logger={"save_checkpoint_freq": 100})
    argv = ["-opt", yml, "--device", "cpu", "--profile-at", str(at), "--profile-steps", str(steps),
            "--profile-dir", str(tmp / "prof")]
    if boom is None:
        cli_train.main(argv)
    else:
        with pytest.raises(RuntimeError, match="inside the window"):
            cli_train.main(argv)
    with open(tmp / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    with open(tmp / "prof" / "launches.json") as f:
        window = json.load(f)
    assert "aten::conv2d" in names and sorted(os.listdir(tmp / "prof")) == ["launches.json", "trace.json"]
    last = at + steps - 1 if case == "window" else None
    assert window["first_iter"] == at and window["last_iter"] == last and window["counts"]["B1"] == 0
    msgs = _messages(_log(tmp / "experiments" / "tiny_profile", "train_tiny_profile"))
    assert f"profiler: trace started at iter {at} -> {tmp / 'prof'}" in msgs
    assert ("profiler: trace closed at iter 3" if case == "window" else "profiler: trace closed on loop exit") in msgs
    lines = [m for m in msgs if m.startswith("<epoch:")]
    assert len(lines) == (niter if boom is None else boom - 1) and not any("gpu_step_s" in m for m in lines)


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------

DDP_CLIP = (4, 3, 16, 16, 3)


def _ddp_opt():
    return dict_to_nonedict({"model": "SelfC_GMM", "distortion": "sr_bd", "scale": 4,
                             "is_train": True, "network_G": NET, "train": dict(TRAIN)})


def _ddp_inputs():
    x = np.random.default_rng(5).random(DDP_CLIP, dtype=np.float32)
    eps = np.random.default_rng(6).normal(size=(4, 3, 4, 4, 48, 5)).astype(np.float32)
    return x, eps


def _step(model, x, eps):
    model.feed_data({"GT": x})
    model.optimize_parameters(1, eps=eps)
    grads = {k: p.grad.numpy().copy() for k, p in model.net.named_parameters() if p.grad is not None}
    return grads, flatten_tree(export_jax_params(model.net))


def _ddp_worker(rank, port, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from selfc_tpu_torch.parallel.dist import init_distributed

    assert init_distributed("cpu") == (rank, 2)
    x, eps = _ddp_inputs()
    half = slice(2 * rank, 2 * rank + 2)
    grads, params = _step(RescaleModel(_ddp_opt(), device="cpu", rng_seed=0), x[half], eps[half])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **{"g." + k: v for k, v in grads.items()},
             **{"p." + k: v for k, v in params.items()})
    dist.destroy_process_group()


def test_two_process_step_is_the_step_on_the_concatenated_batch(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_ddp_worker, args=(r, port, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    x, eps = _ddp_inputs()
    grads, params = _step(RescaleModel(_ddp_opt(), device="cpu", rng_seed=0), x, eps)
    for p in procs:
        p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for k, g in grads.items():
        assert np.array_equal(ranks[0]["g." + k], ranks[1]["g." + k]), k
        assert np.linalg.norm(ranks[0]["g." + k] - g) <= 1e-6 * np.linalg.norm(g) + 1e-12, k
    for k, v in params.items():
        assert np.array_equal(ranks[0]["p." + k], ranks[1]["p." + k]), k
        assert np.abs(ranks[0]["p." + k] - v).max() <= 1e-6, k
