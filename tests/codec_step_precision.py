"""How far the port's codec training step lies from the JAX package's, in
fp32 and in float64 on both sides (not a test: a measurement, ~1 min on the
CPU):

    python tests/codec_step_precision.py

On the ``(2,3,16,80,3)`` clip, seeded tree and fed codec output of
``tests/test_torch_mesh_nets.py``'s codec case (the net of
``tests/test_torch_codec_train.py`` with its surrogate), the raw gradient of
the unsplit step's loss (``_loss`` of ``_encode_lf``) through both stacks,
in fp32 and in float64 (``jax.enable_x64`` as a context; the port's
parameters and inputs cast to double); then the global norm the clip
scales by: the fp32 gradient's norm summed in fp32 by torch on the CPU, by
``clip_by_global_norm_``, and in float64. Prints one JSON line: each
comparison's worst leaf (relative l2; leaves zero by construction left
out) and the norms' relative errors against the float64 sum.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

from selfc_tpu_torch.train.codec_model import CodecModel  # noqa: E402
from selfc_tpu_torch.train.rescale_model import clip_by_global_norm_  # noqa: E402
from selfc_tpu_torch.utils.jax_import import flatten_tree  # noqa: E402
from test_torch_codec_train import _jax_codec, _train_opt  # noqa: E402
from test_torch_models import seeded_tree  # noqa: E402

CLIP = (2, 3, 16, 80, 3)


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def jax_grads(jm, tree, x, codec_out, dtype):
    hr = jnp.asarray(x, dtype)
    tr = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    ref_l = jm.degrade(hr)
    (_, _), g = jax.jit(jax.value_and_grad(
        lambda q: jm._loss(q, jm._encode_lf(q, hr), hr, ref_l, jnp.asarray(codec_out, dtype),
                           jax.random.PRNGKey(0), jnp.float32(16)), has_aux=True))(tr)
    return {k: np.asarray(v, np.float64) for k, v in flatten_tree(jax.tree.map(np.asarray, g)).items()}


def port_grads(tree, x, codec_out, dtype):
    model = CodecModel(_train_opt(), device="cpu")
    model.load_jax_params(tree)
    model.params.to(dtype)
    hr = torch.from_numpy(x).to(dtype)
    loss, _ = model._loss(model._encode_lf(hr), hr, model._ref(hr), torch.from_numpy(codec_out).to(dtype), 16)
    named = list(model.params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g.detach() for (k, p), g in zip(named, grads)}


def worst(got, want):
    top = max(np.abs(v).max() for v in want.values())
    rows = [(float(np.linalg.norm(got[k] - v) / np.linalg.norm(v)), k)
            for k, v in want.items() if np.abs(v).max() >= 1e-6 * top]
    return max(rows)


def main():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    x = _rand(20, CLIP)
    codec_out = _rand(21, (*CLIP[:2], CLIP[2] // 2, CLIP[3] // 2, 3))
    jm = _jax_codec(None)
    tree = {"net": seeded_tree(jm.net, 22, jnp.asarray(x), method=jm.net.roundtrip),
            "surrogate": seeded_tree(jm.surrogate, 23, jnp.zeros((1, *codec_out.shape[1:])), jnp.float32(16))}
    p32 = port_grads(tree, x, codec_out, torch.float32)
    p64 = port_grads(tree, x, codec_out, torch.float64)
    j32 = jax_grads(jm, tree, x, codec_out, jnp.float32)
    with jax.enable_x64(True):
        j64 = jax_grads(jm, tree, x, codec_out, jnp.float64)
    np32 = {k: v.double().numpy() for k, v in p32.items()}
    np64 = {k: v.numpy() for k, v in p64.items()}
    exact = float(np.sqrt(sum((v ** 2).sum() for v in np32.values())))
    leaves = [v for v in p32.values()]
    fp32_sum = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves))))
    params = [torch.nn.Parameter(torch.zeros_like(v)) for v in leaves]
    for p, v in zip(params, leaves):
        p.grad = v.clone()
    clip_norm = float(clip_by_global_norm_(params, 1e30))
    print(json.dumps({
        "clip": list(CLIP),
        "fp32_port_vs_jax": worst(np32, j32), "fp64_port_vs_jax": worst(np64, j64),
        "fp32_port_vs_fp64_jax": worst(np32, j64), "fp32_jax_vs_fp64_jax": worst(j32, j64),
        "norm_fp64": exact, "norm_fp32_sum_rel_err": (fp32_sum - exact) / exact,
        "clip_norm_rel_err": (clip_norm - exact) / exact}))


if __name__ == "__main__":
    main()
