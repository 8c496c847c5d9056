"""The adversarial branch's nets: the VGG-style discriminator
(``DiscriminatorVGG128``) and the VGG-19 feature extractor of the perceptual
loss (``VGGFeatureExtractor``), with their factories ``define_D`` and
``define_F`` (the JAX package's ``models/discriminator.py``).

Both take channels-last images ``(N, H, W, C)`` and keep the flax tree's names
and layouts: convolution ``kernel`` HWIO, dense ``kernel`` ``(in, out)``,
``bias``; the discriminator's batch norms keep ``scale`` and ``bias`` as
parameters and their running ``mean`` / ``var`` as a separate tree of tensors
(flax's ``batch_stats``) that a call takes and, in train mode, returns
updated. Inside, the convolutions run NCHW through the library (the JAX
package runs them in XLA, no Pallas kernel).

flax's ``BatchNorm(momentum=0.9)`` normalises a train-mode batch by its
biased variance ``max(E[x^2] - E[x]^2, 0)`` and folds that same biased
variance into the running one, ``0.9 * old + 0.1 * new``, with epsilon 1e-5;
``torch.nn.BatchNorm2d`` would fold in the unbiased one with the opposite
meaning of momentum, so the normalisation here is a function over the
stats tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv import lecun_normal
from ..parallel.dist import global_mean, world_size

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


class _Conv(nn.Module):
    """A flax ``nn.Conv``: ``kernel`` (kh, kw, Cin, Cout), optional ``bias``."""

    def __init__(self, c_in, c_out, k, stride=1, padding=None, bias=True, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((k, k, c_in, c_out), generator))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.stride = stride
        # 'SAME' at stride 1 for an odd k; the stride-2 k4 convs pad 1 each side
        self.padding = (k - 1) // 2 if padding is None else padding

    def forward(self, x):  # NCHW
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, self.stride, self.padding)


class _Dense(nn.Module):
    """A flax ``nn.Dense``: ``kernel`` (in, out), ``bias``."""

    def __init__(self, c_in, c_out, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((c_in, c_out), generator))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _BatchNorm(nn.Module):
    """A flax ``nn.BatchNorm``'s parameters: ``scale`` and ``bias``."""

    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, stats, train):
        """``(y, new_stats)`` on NCHW ``x``: ``stats`` is ``{mean, var}``;
        eval mode normalises by it and returns it unchanged. In train mode
        the moments are the global batch's: with more than one process they
        are summed over every process's share (``global_mean``; gradients
        flow back through the sum), so the statistics are the same bits on
        every rank, as the JAX package's BatchNorm takes them over its
        global batch."""
        if train:
            if world_size() > 1:
                # the whole batch's moments: [sum x, sum x^2, n] in one all-reduce
                mean, mean_sq = global_mean(torch.stack([x, x * x]), (1, 3, 4))
            else:
                mean, mean_sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            new = {"mean": BN_MOMENTUM * stats["mean"] + (1 - BN_MOMENTUM) * mean.detach(),
                   "var": BN_MOMENTUM * stats["var"] + (1 - BN_MOMENTUM) * var.detach()}
        else:
            mean, var, new = stats["mean"], stats["var"], stats
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y, new


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


# (conv name, c_out as a multiple of nf, kernel, stride); every conv after
# the first has no bias and a batch norm bn{i}_{j} after it
_D_LAYERS = (("0_0", 1, 3, 1), ("0_1", 1, 4, 2), ("1_0", 2, 3, 1), ("1_1", 2, 4, 2),
             ("2_0", 4, 3, 1), ("2_1", 4, 4, 2), ("3_0", 8, 3, 1), ("3_1", 8, 4, 2),
             ("4_0", 8, 3, 1), ("4_1", 8, 4, 2))


class DiscriminatorVGG128(nn.Module):
    """Five stages of a 3x3 conv and a k4 s2 conv (LeakyReLU 0.2, batch
    norm after every conv but the first), then ``linear1`` (-> 100,
    LeakyReLU) and ``linear2`` (-> 1 logit). ``linear1``'s input width is
    taken from ``input_size``, the side of the images D is built for (flax's
    lazy ``Dense`` takes it from its init input): 8 nf times the side after
    five stride-2 convs, squared. ``forward(x, stats, train)`` ->
    ``(logits (N, 1), stats')``."""

    def __init__(self, in_nc=3, nf=64, input_size=128, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.nf = nf
        c_in, side = in_nc, input_size
        for name, mult, k, stride in _D_LAYERS:
            c_out = nf * mult
            self.add_module(f"conv{name}", _Conv(c_in, c_out, k, stride, 1, name == "0_0", generator))
            if name != "0_0":
                self.add_module(f"bn{name}", _BatchNorm(c_out))
            if stride == 2:
                side = (side + 2 - 4) // 2 + 1
            c_in = c_out
        self.linear1 = _Dense(c_in * side * side, 100, generator)
        self.linear2 = _Dense(100, 1, generator)
        self.to(device)

    def init_stats(self):
        """The running statistics flax initialises: mean 0, var 1."""
        return {f"bn{name}": {"mean": torch.zeros_like(self.get_submodule(f"bn{name}").scale),
                              "var": torch.ones_like(self.get_submodule(f"bn{name}").scale)}
                for name, *_ in _D_LAYERS[1:]}

    def forward(self, x, stats, train: bool = False):
        f = x.permute(0, 3, 1, 2)
        new_stats = {}
        for name, *_ in _D_LAYERS:
            f = getattr(self, f"conv{name}")(f)
            if name != "0_0":
                f, new_stats[f"bn{name}"] = getattr(self, f"bn{name}")(f, stats[f"bn{name}"], train)
            f = _lrelu(f)
        # flatten in flax's NHWC order: linear1's rows are (h, w, c)
        f = f.permute(0, 2, 3, 1).reshape(f.shape[0], -1)
        return self.linear2(_lrelu(self.linear1(f))), new_stats


_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGGFeatureExtractor(nn.Module):
    """VGG-19's features up to layer ``feature_layer`` of torchvision's
    ``features`` (34: conv5_4 before its ReLU), on ``[0, 1]`` RGB input
    normalised by ImageNet's mean and std. Convolutions ``conv_{i}``; the
    weights are imported (``utils/torch_import.py:import_vgg19_features``)
    or random."""

    def __init__(self, feature_layer=34, use_input_norm=True, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.feature_layer = feature_layer
        self.use_input_norm = use_input_norm
        # the same walk as forward's, to know which convs exist
        self._plan = []
        layer_idx, conv_idx, c_in = 0, 0, 3
        for v in _VGG19_CFG:
            if layer_idx > feature_layer:
                break
            if v == "M":
                self._plan.append("M")
                layer_idx += 1
                continue
            self.add_module(f"conv_{conv_idx}", _Conv(c_in, v, 3, generator=generator))
            c_in = v
            layer_idx += 1
            relu = layer_idx <= feature_layer
            layer_idx += int(relu)
            self._plan.append((conv_idx, relu))
            conv_idx += 1
        self.to(device)

    def forward(self, x):
        if self.use_input_norm:
            mean = x.new_tensor(_IMAGENET_MEAN)
            std = x.new_tensor(_IMAGENET_STD)
            x = (x - mean) / std
        f = x.permute(0, 3, 1, 2)
        for step in self._plan:
            if step == "M":
                f = F.max_pool2d(f, 2, 2)
                continue
            i, relu = step
            f = getattr(self, f"conv_{i}")(f)
            if relu:
                f = F.relu(f)
        return f.permute(0, 2, 3, 1)


def define_D(opt, input_size, device=None, generator=None):
    """``network_D.which_model_D``: 'discriminator_vgg_128' (``in_nc``,
    ``nf``), built for images of side ``input_size``."""
    net_opt = opt["network_D"]
    which = net_opt["which_model_D"]
    if which == "discriminator_vgg_128":
        return DiscriminatorVGG128(in_nc=net_opt["in_nc"], nf=net_opt["nf"], input_size=input_size,
                                   device=device, generator=generator)
    raise NotImplementedError(f"Discriminator model [{which}] not recognized")


def define_F(opt=None, use_bn: bool = False, device=None, generator=None):
    """VGG-19 features to conv5_4 (layer 34; 49 for the batch-norm VGG's
    index, as the JAX package counts it)."""
    return VGGFeatureExtractor(feature_layer=49 if use_bn else 34, device=device, generator=generator)
