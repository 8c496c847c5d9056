"""Training across processes, on the CPU over gloo: two ranks, each stepping
on its half of the batch, against one process on the concatenated batch.

One pair of ranks is spawned for the whole module; each runs every case and
writes its results to an ``.npz`` (the ranks import this module, so the
JAX side's imports stay inside the functions the parent runs). The cases:

- D's batch norm in train mode (``_BatchNorm``: the moments summed over
  both ranks in one all-reduce): its output and input gradient by halves,
  its parameter gradient summed over the ranks, its new statistics;
- the GAN step (``AdversarialBranch.train_step``), 'ragan' with the feature
  loss, 'wgan-gp' with the concatenated batch's interpolation weights fed
  by halves, and 'gan': also against the JAX package's step on the
  concatenated batch;
- the serial codec step (SelfC_GMM_Codec with its surrogate, one fed codec
  output).

Sizes: G of ``tests/test_torch_gan.py`` (``block_num [1]``, ``stp_blk_num
1``), D nf 8 and F to VGG's layer 4 on 32 x 32 crops of 3 frames, two clips;
the codec net of ``tests/test_torch_codec_train.py`` on two clips of
``(3, 16, 16)``.

Tolerances: both ranks hold the same bits (parameters, Adam moments, D's
statistics, the averaged gradients, the logs taken over the global batch).
Against one process: the batch norm's values within 1e-6 of max |ref|; G's
and the codec's gradients 1e-6 relative l2; D's 1e-5 (its real and fake
terms nearly cancel, so sums taken in another order move it further than
G's); the parameters after the
step 1e-6 absolute (as ``tests/test_torch_cli.py``'s two-process step)
wherever the gradient element exceeds 1e-5 of the net's largest (Adam's
first step moves an element by +-lr by the sign of its gradient, and the
sign of an element at rounding-noise size is noise); D's statistics 1e-6 relative l2; the logs (the ranks' mean) 1e-6
relative, ``D_real`` / ``D_fake`` (means of logits of order one) 1e-6
absolute. Against the JAX package: 1e-4 relative l2 as
``tests/test_torch_gan.py`` (``D_real`` / ``D_fake`` 1e-5 absolute).
"""

import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import discriminator as tdisc
from selfc_tpu_torch.parallel import dist as pdist
from selfc_tpu_torch.train import checkpoint as ckpt
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils.jax_import import flatten_tree, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RANKS = 2
GAN_TYPES = ("ragan", "wgan-gp", "gan")
BN_SHAPE = (6, 8, 5, 7)          # (N, C, H, W): three frames a rank
JOIN_S = 300


# ---------------------------------------------------------------------------
# what each case runs: on a rank its half of the batch, in the parent all
# of it
# ---------------------------------------------------------------------------


def _half(a, part):
    """The rank's half of ``a`` along its first axis (``part`` None: all)."""
    if part is None:
        return a
    n = a.shape[0] // RANKS
    return a[part * n:(part + 1) * n]


def _run_bn(case, part):
    c = case["x"].shape[1]
    bn = tdisc._BatchNorm(c)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(case["scale"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    x = torch.from_numpy(_half(case["x"], part)).requires_grad_(True)
    stats = {k: torch.from_numpy(v) for k, v in case["stats"].items()}
    y, new = bn(x, stats, True)
    (y * torch.from_numpy(_half(case["g"], part))).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": bn.scale.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": new["mean"].numpy(), "var": new["var"].numpy()}


def _run_gan(case, part):
    model = RescaleModel(dict_to_nonedict(case["opt"]), device="cpu")
    model.load_jax_params(case["g"])
    load_jax_params(model.gan.netD, case["d"])
    model.gan.load_stats(case["stats"])
    if case["f"]:
        model.gan.netF = tdisc.VGGFeatureExtractor(feature_layer=4, device="cpu").requires_grad_(False)
        load_jax_params(model.gan.netF, case["f"])
    model.feed_data({"GT": _half(case["x"], part)})
    gp_eps = case["gp_eps"]
    if gp_eps is not None and part is not None:
        gp_eps = _half(gp_eps, part)   # frames of the rank's clips, in order
    model.optimize_parameters(case["step"], eps=_half(case["e"], part), gp_eps=gp_eps)
    out = {f"log.{k}": np.float64(v) for k, v in model.get_current_log().items()}
    for tag, net, opt in (("G", model.net, model.optimizer), ("D", model.gan.netD, model.gan.optimizer)):
        for k, p in net.named_parameters():
            out[f"{tag}.{k}"] = p.detach().numpy().copy()
            if p.grad is not None:
                out[f"grad{tag}.{k}"] = p.grad.numpy().copy()
        st = ckpt.adam_state(opt, net.named_parameters())
        for m in ("mu", "nu"):
            out.update({f"{m}{tag}.{k}": v for k, v in flatten_tree(st[m]).items()})
    for k, v in model.gan.stats_numpy().items():
        out.update({f"stats.{k}.{n}": t for n, t in v.items()})
    return out


def _run_codec(case, part):
    model = CodecModel(dict_to_nonedict(case["opt"]), device="cpu")
    model.load_jax_params(case["tree"])
    model.feed_data({"GT": _half(case["x"], part)})
    model.optimize_parameters(0, codec_out=_half(case["codec_out"], part))
    out = {f"log.{k}": np.float64(v) for k, v in model.get_current_log().items() if k != "rate_source"}
    for k, p in model.params.named_parameters():
        out[f"P.{k}"] = p.detach().numpy().copy()
        if p.grad is not None:
            out[f"gradP.{k}"] = p.grad.numpy().copy()
    return out


RUNNERS = {"bn": _run_bn, "gan": _run_gan, "codec": _run_codec}


def _run(name, case, part):
    return {f"{name}|{k}": v for k, v in RUNNERS[case["kind"]](case, part).items()}


def _rank(rank, port, out, cases):
    """One of the two ranks: joins the gloo group through the launcher's
    environment and runs every case on its half."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(RANKS), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    assert pdist.init_distributed("cpu") == (rank, RANKS)
    res = {}
    for name, case in cases.items():
        res.update(_run(name, case, rank))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the inputs, the spawn and the references
# ---------------------------------------------------------------------------


def _cases():
    """Every case's inputs, seeded; the GAN cases with the JAX package's
    steps on the concatenated batch (run by ``_jax_steps``)."""
    import jax
    import jax.numpy as jnp
    from test_torch_codec_train import CLIP as CODEC_CLIP
    from test_torch_codec_train import _jax_codec, _train_opt
    from test_torch_gan import GT, STEP, T, _d_tree, _jax_g, _opt_dict, _vgg_tree
    from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
    from test_torch_models import seeded_tree

    rng = np.random.default_rng(30)
    cases = {"bn": {"kind": "bn", "x": rng.normal(0.3, 1.5, BN_SHAPE).astype(np.float32),
                    "g": rng.normal(0, 1, BN_SHAPE).astype(np.float32),
                    "scale": (1 + rng.normal(0, 0.1, BN_SHAPE[1])).astype(np.float32),
                    "bias": rng.normal(0, 0.1, BN_SHAPE[1]).astype(np.float32),
                    "stats": {"mean": rng.normal(0, 0.1, BN_SHAPE[1]).astype(np.float32),
                              "var": rng.uniform(0.5, 1.5, BN_SHAPE[1]).astype(np.float32)}}}
    x = np.random.default_rng(31).random((RANKS, T, GT, GT, 3), dtype=np.float32)
    g_tree = seeded_tree(_jax_g(), 32, jnp.asarray(x), method=JSelfCNetGMM.roundtrip)
    _, d_params, d_stats = _d_tree(8, GT, 33)
    f_tree = _vgg_tree(4, 34, GT)[1]
    e = np.random.default_rng(35).normal(0, 1, (RANKS, T, GT // 4, GT // 4, 48, 2)).astype(np.float32)
    # the JAX step's interpolation weights on the concatenated batch's frames
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11), STEP), 1)
    gp_eps = np.asarray(jax.random.uniform(key, (RANKS * T, 1, 1, 1)))
    for gan_type in GAN_TYPES:
        fea_w = 1.0 if gan_type == "ragan" else 0.0
        cases[gan_type] = {"kind": "gan", "opt": _opt_dict(gan_type=gan_type, feature_weight=fea_w),
                           "g": g_tree, "d": d_params, "stats": d_stats, "f": f_tree if fea_w else {},
                           "x": x, "e": e, "gp_eps": gp_eps if gan_type == "wgan-gp" else None, "step": STEP}
    jm = _jax_codec()
    cx = np.random.default_rng(36).random((RANKS,) + CODEC_CLIP[1:], dtype=np.float32)
    cases["codec"] = {
        "kind": "codec", "opt": dict(_train_opt()), "x": cx,
        "codec_out": np.random.default_rng(37).random((RANKS, 3, 8, 8, 3), dtype=np.float32),
        "tree": {"net": seeded_tree(jm.net, 38, jnp.asarray(cx), method=jm.net.roundtrip),
                 "surrogate": seeded_tree(jm.surrogate, 39, jnp.zeros((1, 3, 8, 8, 3)), jnp.float32(16))}}
    return cases


def _jax_steps(cases):
    """The JAX package's ``AdversarialBranch.train_step`` on each GAN
    case's concatenated batch (``tests/test_torch_gan.py``'s jitted step)."""
    from test_torch_gan import _jax_step

    out = {}
    for gan_type in GAN_TYPES:
        c = cases[gan_type]
        fea_w = 1.0 if c["f"] else 0.0
        out[gan_type] = _jax_step(gan_type, fea_w, c["g"], c["d"], c["stats"], c["f"], c["x"], c["e"])[0]
    return out


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """``(ranks, one, jax_steps)``: each rank's results, the one-process
    results on the concatenated batch (run while the ranks run) and the
    JAX package's GAN steps."""
    out = str(tmp_path_factory.mktemp("procs"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cases = _cases()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, port, out, cases)) for r in range(RANKS)]
    for p in procs:
        p.start()
    try:
        one = {}
        for name, case in cases.items():
            one.update(_run(name, case, None))
        jax_steps = _jax_steps(cases)
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():   # a rank left waiting on a collective of one that failed
                p.kill()
                p.join()
    assert not any(hung) and all(p.exitcode == 0 for p in procs), (hung, [p.exitcode for p in procs])
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(RANKS)]
    return ranks, one, jax_steps


def _part(res, name, prefix):
    return {k.split("|", 1)[1][len(prefix):]: v for k, v in res.items()
            if k.startswith(f"{name}|{prefix}")}


def _assert_params_close(got, want, grads):
    """Parameters after one Adam step within 1e-6 wherever the gradient
    element exceeds 1e-5 of the largest."""
    top = max(np.abs(v).max() for v in grads.values())
    for k, g in grads.items():
        moved = np.abs(g) > 1e-5 * top
        assert np.abs(got[k] - want[k])[moved].max(initial=0.0) <= 1e-6, k


def _rel_l2(got, want):
    keys = sorted(want)
    assert keys == sorted(got)
    num = sum(((got[k].astype(np.float64) - want[k]) ** 2).sum() for k in keys)
    return float(np.sqrt(num / sum((want[k].astype(np.float64) ** 2).sum() for k in keys)))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_global_mean_with_one_process_is_torch_mean():
    """No process group: ``global_mean`` is ``torch.mean`` to the bit and
    ``all_reduce_sum`` the tensor itself, with no collective."""
    x = torch.randn(4, 6, 5, generator=torch.Generator().manual_seed(0))
    assert pdist.world_size() == 1
    assert torch.equal(pdist.global_mean(x), torch.mean(x))
    assert torch.equal(pdist.global_mean(x, (0, 2)), torch.mean(x, (0, 2)))
    assert pdist.all_reduce_sum(x) is x


def test_batch_norm_over_two_ranks_is_the_whole_batch_norm(procs):
    """D's train-mode batch norm on two halves: the output and dx of the
    whole batch's by halves, dscale / dbias summed over the ranks, and the
    new running statistics the same bits on both ranks."""
    ranks, one, _ = procs
    r = [_part(x, "bn", "") for x in ranks]
    want = _part(one, "bn", "")
    for k in ("y", "dx"):
        got = np.concatenate([r[0][k], r[1][k]])
        assert np.abs(got - want[k]).max() <= 1e-6 * np.abs(want[k]).max(), k
    for k in ("dscale", "dbias"):
        assert np.abs(r[0][k] + r[1][k] - want[k]).max() <= 1e-6 * np.abs(want[k]).max(), k
    for k in ("mean", "var"):
        assert np.array_equal(r[0][k], r[1][k]), k
        assert np.abs(r[0][k] - want[k]).max() <= 1e-6 * np.abs(want[k]).max(), k


@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_gan_step_over_two_ranks_is_the_step_on_the_whole_batch(procs, gan_type):
    """The combined G + D step on two ranks against one process on the
    concatenated batch, at the limits of the module's docstring."""
    ranks, one, _ = procs
    for prefix in ("G.", "D.", "gradG.", "gradD.", "muG.", "nuG.", "muD.", "nuD.", "stats.", "log.D_"):
        a, b = (_part(x, gan_type, prefix) for x in ranks)
        assert a and all(np.array_equal(a[k], b[k]) for k in a), prefix
    for prefix, limit in (("gradG.", 1e-6), ("gradD.", 1e-5), ("stats.", 1e-6)):
        assert _rel_l2(_part(ranks[0], gan_type, prefix), _part(one, gan_type, prefix)) <= limit, prefix
    for tag in ("G", "D"):
        _assert_params_close(_part(ranks[0], gan_type, f"{tag}."), _part(one, gan_type, f"{tag}."),
                             _part(one, gan_type, f"grad{tag}."))
    logs = [_part(x, gan_type, "log.") for x in ranks]
    want = _part(one, gan_type, "log.")
    assert set(logs[0]) == set(want) and want["skipped_nonfinite"] == 0.0
    for k, v in want.items():
        got = (logs[0][k] + logs[1][k]) / 2
        tol = 1e-6 if k in ("D_real", "D_fake") else 1e-6 * abs(v)
        assert abs(got - v) <= tol, (k, got, v)


@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_gan_step_over_two_ranks_matches_jax(procs, gan_type):
    """Rank 0 after the two-rank step against the JAX package's step on the
    concatenated batch: G's and D's parameters, their Adam moments and D's
    running statistics 1e-4 relative l2; the logs 1e-4 relative
    (``D_real`` / ``D_fake`` 1e-5 absolute)."""
    from test_torch_gan import tree_rel_l2

    ranks, _, jax_steps = procs
    want = jax_steps[gan_type]
    r = ranks[0]
    assert tree_rel_l2(_part(r, gan_type, "G."), want[0]) <= 1e-4
    assert tree_rel_l2(_part(r, gan_type, "D."), want[2]) <= 1e-4
    assert tree_rel_l2(_part(r, gan_type, "stats."), want[3]) <= 1e-4
    for tag, adam in (("G", want[1][-1]), ("D", want[4][-1])):
        assert tree_rel_l2(_part(r, gan_type, f"mu{tag}."), adam.mu) <= 1e-4, tag
        assert tree_rel_l2(_part(r, gan_type, f"nu{tag}."), adam.nu) <= 1e-4, tag
    logs = [_part(x, gan_type, "log.") for x in ranks]
    for k, v in want[5].items():
        got = (logs[0][k] + logs[1][k]) / 2
        tol = 1e-5 if k in ("D_real", "D_fake") else 1e-4 * max(abs(float(v)), 1e-6)
        assert abs(got - float(v)) <= tol, (k, got, v)


def test_codec_step_over_two_ranks_is_the_step_on_the_whole_batch(procs):
    """The serial codec step (its surrogate, one fed codec output) on two
    ranks against one process on the concatenated batch: both ranks the same
    bits, the gradient 1e-6 relative l2 (the surrogate's Pearson term is
    taken over the global batch, not each rank's half), the parameters as
    the GAN step's, the losses (the ranks' mean) 1e-6 relative."""
    ranks, one, _ = procs
    for prefix in ("P.", "gradP."):
        a, b = (_part(x, "codec", prefix) for x in ranks)
        assert a and all(np.array_equal(a[k], b[k]) for k in a), prefix
    grads = _part(one, "codec", "gradP.")
    assert _rel_l2(_part(ranks[0], "codec", "gradP."), grads) <= 1e-6
    _assert_params_close(_part(ranks[0], "codec", "P."), _part(one, "codec", "P."), grads)
    logs = [_part(x, "codec", "log.") for x in ranks]
    want = _part(one, "codec", "log.")
    for k in ("loss", "l_forw_fit", "l_back_rec", "mimick_loss", "distortion_loss"):
        got = (logs[0][k] + logs[1][k]) / 2
        assert abs(got - want[k]) <= 1e-6 * abs(want[k]), (k, got, want[k])
