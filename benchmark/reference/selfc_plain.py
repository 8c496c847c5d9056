"""The plain reference of the two nets the benchmark runs, written from
their equations in plain PyTorch: ``SelfC_GMM`` 4x (frequency split, the
affine coupling blocks of D2DT dense chains, the STP prior with its
non-local temporal aggregation and the GMM head) and ``SelfC_GMM_Codec``
(the same at scale 2 with the l2 head), and the training loss of the 4x
net. It imports nothing of the program: parameters come in as a flat dict
``{name: tensor}`` under the tree names the benchmark makes its weights
with (``inv_blocks_{i}.{F,G,H}.chain.conv{k}.{weight,bias}``,
``stp_net.local_m1.chain...``, ``stp_net.global_m1.proj1_w``, ...), in the
layouts spatial ``(3,3,Cin,Cout)``, temporal ``(3,Cin,Cout)``, pointwise
``(Cin,Cout)``.

Activations are channels-last ``(B,T,H,W,C)`` at every function here; a
dense chain runs its spatial convs as ``conv2d`` on the frames and its
temporal conv as a (3,1,1) ``conv3d``, so that every product is a library
convolution in the caller's precision: fp32 (TF32 off) for the reference,
TF32 for the control (``precision``). ``param_shapes`` lists the
parameters a configuration has, the names and shapes the benchmark makes
its weights in."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

SLOPE = 0.2          # every LeakyReLU of the chains and the prior's head
CLAMP = 1.0          # the coupling's clamp of its log-scale


@contextlib.contextmanager
def precision(tf32: bool):
    """Run the body with TF32 products on (the control) or off (the
    reference), restoring the caller's flags after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaky(x):
    return F.leaky_relu(x, SLOPE)


# ------------------------------------------------------------ the parameters
def _chain_shapes(pre, c_in, c_out, gc):
    out = {}
    for k in range(4):
        out[f"{pre}.conv{k + 1}.weight"] = (3, 3, c_in + k * gc, gc)
        out[f"{pre}.conv{k + 1}.bias"] = (gc,)
    out[f"{pre}.conv5.weight"] = (3, c_in + 4 * gc, c_out)
    out[f"{pre}.conv5.bias"] = (c_out,)
    return out


def _agg_shapes(pre, c):
    return {f"{pre}.proj1_w": (c, c), f"{pre}.proj1_b": (c,), f"{pre}.fc_w": (1024, 1), f"{pre}.fc_b": (1,),
            f"{pre}.proj2_w": (c, c), f"{pre}.proj2_b": (c,), f"{pre}.proj3_w": (c, c), f"{pre}.proj3_b": (c,)}


def param_shapes(cfg):
    """``{name: shape}`` of the net a configuration file describes (its
    ``scale`` and ``network_G``), in a fixed order: the coupling blocks (F:
    hf -> 3, G and H: 3 -> hf, growth 32), then the prior (its chains and
    aggregations, then its head). The prior's widths are ``stp_hidden_c``
    and ``stp_denseblock_innerc`` where ``network_G`` states them, else
    SelfC_GMM's fixed 64 and 32."""
    net, k = cfg["network_G"], cfg["scale"]
    hf = 3 * k * k
    c, gc = net.get("stp_hidden_c", 64), net.get("stp_denseblock_innerc", 32)
    shapes = {}
    for i in range(sum(net["block_num"])):
        shapes.update(_chain_shapes(f"inv_blocks_{i}.F.chain", hf, 3, 32))
        shapes.update(_chain_shapes(f"inv_blocks_{i}.G.chain", 3, hf, 32))
        shapes.update(_chain_shapes(f"inv_blocks_{i}.H.chain", 3, hf, 32))
    shapes.update(_chain_shapes("stp_net.local_m1.chain", 3, c, gc))
    shapes.update(_chain_shapes("stp_net.local_m2.chain", c, c, gc))
    shapes.update(_agg_shapes("stp_net.global_m1", c))
    shapes.update(_agg_shapes("stp_net.global_m2", c))
    for i in range(net["stp_blk_num"] - 2):
        shapes.update(_chain_shapes(f"stp_net.other_local_{i}.chain", c, c, gc))
        shapes.update(_agg_shapes(f"stp_net.other_global_{i}", c))
    widths = [c, 2 * c, 4 * c, hf * net["gmm_k"] * 3] if net["fh_loss"] == "gmm" else [c, hf]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        shapes[f"stp_net.tail_{i}.weight"] = (a, b)
        shapes[f"stp_net.tail_{i}.bias"] = (b,)
    return shapes


def init_std(name, shape):
    """The spread of a seeded leaf: fan-in scaled for a weight (so that
    activations stay of order one), 0.05 for a vector; the last conv of each
    coupling subnet a quarter of that, so that the latents stay of order
    one through the blocks. No leaf is zero."""
    if len(shape) == 1:
        return 0.05
    std = float(np.prod(shape[:-1])) ** -0.5
    return std * 0.25 if name.startswith("inv_blocks") and ".conv5." in name else std


# ---------------------------------------------------------------- chains
def dense_chain(p, pre, x):
    """The D2DT chain ``pre``: four 3x3 convs, each followed by a LeakyReLU
    and concatenated onto its input, then a (3,1,1) conv over the whole
    concatenation; zero padding in H, W and T. x: (B,T,H,W,C)."""
    B, T, H, W, C = x.shape
    h = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)          # (BT,C,H,W)
    for k in range(1, 5):
        w = p[f"{pre}.conv{k}.weight"]                           # (3,3,Ci,Co)
        y = F.conv2d(h, w.permute(3, 2, 0, 1), p[f"{pre}.conv{k}.bias"], padding=1)
        h = torch.cat([h, leaky(y)], dim=1)
    w5 = p[f"{pre}.conv5.weight"]                                # (3,Ci,Co)
    h = h.reshape(B, T, -1, H, W).transpose(1, 2)                # (B,Ci,T,H,W)
    y = F.conv3d(h, w5.permute(2, 1, 0)[..., None, None], p[f"{pre}.conv5.bias"], padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1)


def coupling(p, pre, x1, x2, rev):
    """Affine coupling block ``pre`` on the pair (x1: 3 LR channels, x2: the
    rest)."""
    def sub(name, x):
        return dense_chain(p, f"{pre}.{name}.chain", x)

    if not rev:
        y1 = x1 + sub("F", x2)
        s = CLAMP * (2.0 * torch.sigmoid(sub("H", y1)) - 1.0)
        return y1, x2 * torch.exp(s) + sub("G", y1)
    s = CLAMP * (2.0 * torch.sigmoid(sub("H", x1)) - 1.0)
    y2 = (x2 - sub("G", x1)) * torch.exp(-s)
    return x1 - sub("F", y2), y2


# ---------------------------------------------------------- the frequency split
def area_down(x, k):
    *lead, H, W, C = x.shape
    return x.reshape(*lead, H // k, k, W // k, k, C).mean(dim=(-4, -2))


def area_up(x, k):
    return x.repeat_interleave(k, dim=-3).repeat_interleave(k, dim=-2)


def freq_forward(x, k):
    """(.., H, W, 3) -> (.., H/k, W/k, 3 + 3k^2): the block means, then the
    residual's k x k blocks with the channel index (s_h*k + s_w)*3 + c."""
    lf = area_down(x, k)
    r = x - area_up(lf, k)
    *lead, H, W, C = r.shape
    hf = r.reshape(*lead, H // k, k, W // k, k, C).movedim(-4, -3).reshape(*lead, H // k, W // k, k * k * C)
    return torch.cat([lf, hf], dim=-1)


def freq_inverse(y, k):
    """The block means upsampled, plus the HF channels in the PixelShuffle
    order c*k^2 + s_h*k + s_w (not the forward's order: the trained nets
    absorb the permutation)."""
    lf, hf = y[..., :3], y[..., 3:]
    *lead, h, w, _ = hf.shape
    hr = hf.reshape(*lead, h, w, 3, k, k).permute(*range(len(lead)), -5, -2, -4, -1, -3)
    return area_up(lf, k) + hr.reshape(*lead, h * k, w * k, 3)


def quantize(x):
    """The 255-level rounding of the LR (straight through in the backward)."""
    q = torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0
    return q.detach() + (x - x.detach())


# ------------------------------------------------------------------ the prior
def global_agg(p, pre, x):
    """Non-local temporal attention: tokens from the frames pooled to 32 x 32,
    a T x T softmax of their projections, each output frame the input plus
    the attention-weighted sum of the frames' pointwise projection."""
    B, T, H, W, C = x.shape
    pooled = F.adaptive_avg_pool2d(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2), (32, 32))
    pooled = pooled.reshape(B, T, C, 32 * 32)
    tokens = torch.einsum("btcp,po->btc", pooled, p[f"{pre}.fc_w"]) + p[f"{pre}.fc_b"][0]
    q = tokens @ p[f"{pre}.proj2_w"] + p[f"{pre}.proj2_b"]
    k = tokens @ p[f"{pre}.proj3_w"] + p[f"{pre}.proj3_b"]
    attn = torch.softmax((q @ k.transpose(1, 2)) / C, dim=-1)
    proj = x @ p[f"{pre}.proj1_w"] + p[f"{pre}.proj1_b"]
    return x + torch.einsum("bihwc,bij->bjhwc", proj, attn)


def prior(p, lr, stp_blk_num, head):
    """The STP prior on the LR: D2DT chains interleaved with global
    aggregations, then its head (``gmm``: three pointwise layers, each after
    a LeakyReLU; ``l2``: one)."""
    x = global_agg(p, "stp_net.global_m1", dense_chain(p, "stp_net.local_m1.chain", lr))
    x = global_agg(p, "stp_net.global_m2", dense_chain(p, "stp_net.local_m2.chain", x))
    for i in range(stp_blk_num - 2):
        x = global_agg(p, f"stp_net.other_global_{i}", dense_chain(p, f"stp_net.other_local_{i}.chain", x))
    for i in range(3 if head == "gmm" else 1):
        x = leaky(x) @ p[f"stp_net.tail_{i}.weight"] + p[f"stp_net.tail_{i}.bias"]
    return x


def gmm_sample(raw, eps, hf_dim, K):
    """The prior's sample: weights a softmax over the HF channels (not over
    K), log-scales clipped to [-7, 7], sum_K w (mean + eps exp(log-scale))."""
    prm = raw.reshape(*raw.shape[:-1], hf_dim, K, 3)
    w = torch.softmax(prm[..., 0], dim=-2)
    return torch.sum(w * (prm[..., 2] + eps * torch.exp(prm[..., 1].clamp(-7.0, 7.0))), dim=-1)


# ------------------------------------------------------------------ the nets
class Net:
    """One of the two nets over the parameter dict ``p``, as a configuration
    file states it: ``scale``, and under ``network_G`` ``block_num`` (a
    list), ``stp_blk_num``, ``fh_loss`` and ``gmm_k``."""

    def __init__(self, p, cfg):
        net = cfg["network_G"]
        self.p = p
        self.k = int(cfg["scale"])
        self.n_blocks = sum(net["block_num"])
        self.stp_blk_num = int(net["stp_blk_num"])
        self.head = "gmm" if net["fh_loss"] == "gmm" else "l2"
        self.K = int(net.get("gmm_k") or 5)
        self.hf_dim = 3 * self.k * self.k

    def encode(self, x):
        """HR (B,T,H,W,3) -> latent (B,T,H/k,W/k,3 + hf_dim)."""
        y = freq_forward(x, self.k)
        x1, x2 = y[..., :3], y[..., 3:]
        for i in range(self.n_blocks):
            x1, x2 = coupling(self.p, f"inv_blocks_{i}", x1, x2, False)
        return torch.cat([x1, x2], dim=-1)

    def sample_hf(self, lr, eps=None):
        raw = prior(self.p, lr, self.stp_blk_num, self.head)
        return gmm_sample(raw, eps, self.hf_dim, self.K) if self.head == "gmm" else raw

    def decode(self, lr, eps=None):
        """LR (B,T,h,w,3) and the prior's noise -> HR (B,T,H,W,3)."""
        x1, x2 = lr, self.sample_hf(lr, eps)
        for i in reversed(range(self.n_blocks)):
            x1, x2 = coupling(self.p, f"inv_blocks_{i}", x1, x2, True)
        return freq_inverse(torch.cat([x1, x2], dim=-1), self.k)


# ---------------------------------------------------------------- training
def gauss_taps(scale):
    """The 13 taps of the BD blur (sigma 0.4 scale, cut at radius
    int(4 sigma + 0.5), at most 6), normalised."""
    sigma = 0.4 * scale
    radius = min(int(4.0 * sigma + 0.5), 6)
    t = np.array([math.exp(-0.5 * (i / sigma) ** 2) if abs(i) <= radius else 0.0 for i in range(-6, 7)])
    return (t / t.sum()).astype(np.float32)


def bd_downsample(x, scale):
    """The LR target of ``distortion: sr_bd``: reflect padding of 6 + 2
    scale, the 13 x 13 separable gaussian at stride ``scale``, 2 pixels cut
    from each side. x: (B,T,H,W,3)."""
    B, T, H, W, C = x.shape
    pad = 6 + 2 * scale
    h = F.pad(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
    taps = torch.as_tensor(gauss_taps(scale), device=x.device)
    ker = (taps[:, None] * taps[None, :]).expand(C, 1, 13, 13)
    y = F.conv2d(h, ker.contiguous(), stride=scale, groups=C)[:, :, 2:-2, 2:-2]
    return y.permute(0, 2, 3, 1).reshape(B, T, y.shape[2], y.shape[3], C)


def train_loss(net, hr, eps, train_cfg):
    """The 4x training loss on the HR batch (B,T,H,W,3): the LR fit (l2 to
    the BD target) plus the HR reconstruction (Charbonnier, eps 1e-6),
    weighted by their lambdas, times the 144 * 144 * 3 values of a crop."""
    with torch.no_grad():
        ref_lr = bd_downsample(hr, net.k)
    y = net.encode(hr)
    lr_pre = y[..., :3]
    out = net.decode(quantize(lr_pre), eps)
    forw = torch.mean((lr_pre - ref_lr) ** 2)
    back = torch.mean(torch.sqrt((out - hr) ** 2 + 1e-6))
    return (train_cfg["lambda_fit_forw"] * forw + train_cfg["lambda_rec_back"] * back) * 144 * 144 * 3


class Trainer:
    """The published optimiser over the reference net: the global-norm clip
    (scale by max_norm / norm where the norm is larger), then Adam with the
    weight decay added to the gradient before the moments. ``reduce``, where
    given, takes the gradients before the clip (the mean over processes of
    a control that runs on every rank)."""

    def __init__(self, p0, cfg, train_cfg, reduce=None):
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
        self.reduce = reduce
        self.net = Net(self.params, cfg)
        self.tc = train_cfg
        self.opt = torch.optim.Adam(list(self.params.values()), lr=train_cfg["lr_G"],
                                    betas=(train_cfg["beta1"], train_cfg["beta2"]), eps=1e-8,
                                    weight_decay=train_cfg["weight_decay_G"], foreach=False)

    def step(self, hr, eps):
        """One step on the HR batch with the prior's noise; returns the loss
        and the gradient as the optimiser takes it (clipped, with the weight
        decay)."""
        self.opt.zero_grad(set_to_none=True)
        loss = train_loss(self.net, hr, eps, self.tc)
        loss.backward()
        grads = [q.grad for q in self.params.values()]
        if self.reduce is not None:
            self.reduce(grads)
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        clip = float(self.tc["gradient_clipping"])
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        wd = self.tc["weight_decay_G"]
        taken = {}
        for (k, q), g in zip(self.params.items(), grads):
            g.mul_(scale)
            taken[k] = g.detach() + wd * q.detach()
        self.opt.step()
        return loss.item(), taken
