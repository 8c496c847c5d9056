"""Gaussian-mixture head math for the self-conditioned prior (STPNet).

Two distinct parameterizations of the same conv output are kept, as the
trained networks depend on them:

* sample path: pi = softmax over the *hf* axis of [..., 0],
  log_scale = clip([..., 1], -7, 7), mean = [..., 2];
  sample = sum_K pi * (mean + eps * exp(log_scale)).
* likelihood path: pi = softmax over *K* of [..., 0], mean = [..., 1],
  log_sigma = clip([..., 2], -7, 7).

Layout: params (..., hf_dim, K, 3), split from a tail conv whose channel
index is ((f*K + k)*3 + j). The noise ``eps`` is an argument: no function
here draws random numbers.
"""

from __future__ import annotations

import math

import torch


def split_params(raw, hf_dim: int, K: int):
    """(..., hf_dim*K*3) -> (..., hf_dim, K, 3)."""
    return raw.reshape(*raw.shape[:-1], hf_dim, K, 3)


def gmm_sample(params, eps, half_logvar: bool = False):
    """Reparameterized sample. params: (..., hf, K, 3); eps: (..., hf, K)
    standard normal noise. Returns (..., hf)."""
    pi = torch.softmax(params[..., 0], dim=-2)  # over hf
    log_scale = params[..., 1].clamp(-7.0, 7.0)
    mean = params[..., 2]
    std = torch.exp(0.5 * log_scale) if half_logvar else torch.exp(log_scale)
    return torch.sum(pi * (mean + eps.to(mean.dtype) * std), dim=-1)  # over K


def gmm_neg_log_likelihood(params, hf):
    """Mean negative log-likelihood of hf under the mixture.
    params: (..., hf, K, 3); hf: (..., hf)."""
    return -torch.mean(gmm_log_prob(params, hf))


def gmm_log_prob(params, hf):
    """The log-likelihood of each element of hf under the mixture."""
    pi = torch.softmax(params[..., 0], dim=-1)  # over K
    mean = params[..., 1]
    log_sigma = params[..., 2].clamp(-7.0, 7.0)
    sigma = torch.exp(log_sigma)
    x = hf[..., None]
    comp_logp = (
        -0.5 * ((x - mean) / sigma) ** 2
        - log_sigma
        - 0.5 * math.log(2.0 * math.pi)
    )
    return torch.logsumexp(torch.log(pi + 1e-38) + comp_logp, dim=-1)
