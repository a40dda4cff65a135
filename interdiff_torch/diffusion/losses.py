"""Likelihood helpers of the variational-bound paths
(`interdiff_tpu/diffusion/losses.py`, the reference's
`interdiff/diffusion/losses.py`): the KL divergence of two diagonal
Gaussians in nats, the discretised Gaussian log-likelihood of data in
[-1, 1] (255 bins), and the reductions over every axis but the batch's.
Only the bits-per-dim diagnostics and the learned-variance paths use them;
training uses the weighted MSE of `train/losses.py`.
"""

from __future__ import annotations

import math

import torch


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal Gaussians (nats, elementwise);
    any argument may be a Python float."""
    tensor = next(x for x in (mean1, logvar1, mean2, logvar2)
                  if isinstance(x, torch.Tensor))
    logvar1, logvar2 = (torch.as_tensor(v, dtype=tensor.dtype,
                                        device=tensor.device)
                        for v in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *,
                                        means: torch.Tensor,
                                        log_scales: torch.Tensor
                                        ) -> torch.Tensor:
    """Log-likelihood of a discretised Gaussian (data in [-1, 1], 255
    bins), elementwise."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x
                                                      + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x
                                                     - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def mean_flat(tensor: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return tensor.mean(dim=tuple(range(1, tensor.ndim)))


def sum_flat(tensor: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch axes."""
    return tensor.sum(dim=tuple(range(1, tensor.ndim)))
