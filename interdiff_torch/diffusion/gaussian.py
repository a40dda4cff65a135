"""Gaussian diffusion engine over a precomputed schedule
(`interdiff_tpu/diffusion/gaussian.py`): ancestral DDPM, DDIM and PLMS
sampling, and the training pair ``training_losses``.

The schedule is computed in float64 numpy and cast once to float32 tensors
on the engine's device.  Each sampling loop is a Python loop over the kept
timesteps; observation inpainting overwrites the model's x0 prediction on
the masked (past) elements, and ``denoised_fn`` is the correction hook.
Learned variances, x_{t-1} prediction, classifier guidance (``cond_fn``),
``ddim_reverse_sample`` and the variational-bound terms are not ported yet.
"""

from __future__ import annotations

import enum
import functools
import inspect
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.diffusion import schedule as sched_lib


class ModelMeanType(enum.Enum):
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"


class Inpaint(NamedTuple):
    """Observation inpainting: ``mask`` True means "use ground truth"."""

    mask: torch.Tensor  # bool, same shape as x
    motion: torch.Tensor  # same shape as x


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] broadcast to an ndim-dimensional tensor with batch leading."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


# float32 schedule tensors, in the order GaussianDiffusion stores them
_SCHEDULE_FIELDS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "fixed_large_variance",
    "fixed_large_log_variance")


class GaussianDiffusion:
    """Schedule constants (float32 [num_timesteps] tensors on ``device``)
    plus the static configuration of the reverse process."""

    def __init__(self, constants: dict, timestep_map: torch.Tensor, *,
                 model_mean_type: ModelMeanType, model_var_type: ModelVarType,
                 num_timesteps: int, original_num_steps: int,
                 rescale_timesteps: bool):
        for name in _SCHEDULE_FIELDS:
            setattr(self, name, constants[name])
        self.timestep_map = timestep_map
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.num_timesteps = num_timesteps
        self.original_num_steps = original_num_steps
        self.rescale_timesteps = rescale_timesteps

    @property
    def device(self) -> torch.device:
        return self.betas.device

    # -- construction -------------------------------------------------------
    @classmethod
    def create(cls, betas: np.ndarray, *,
               model_mean_type: ModelMeanType = ModelMeanType.START_X,
               model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
               rescale_timesteps: bool = False,
               timestep_map: Optional[np.ndarray] = None,
               original_num_steps: Optional[int] = None,
               device=None) -> "GaussianDiffusion":
        """Constants in float64 numpy, cast once to float32 on ``device``
        (`interdiff_tpu/diffusion/gaussian.py:103-140`)."""
        device = resolve_device(device)
        betas = np.array(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        T = betas.shape[0]

        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
        posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                              / (1.0 - alphas_cumprod))
        fixed_large_variance = np.append(posterior_variance[1], betas[1:])
        consts = {
            "betas": betas,
            "alphas_cumprod": alphas_cumprod,
            "alphas_cumprod_prev": alphas_cumprod_prev,
            "alphas_cumprod_next": alphas_cumprod_next,
            "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
            "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
            "log_one_minus_alphas_cumprod": np.log(1.0 - alphas_cumprod),
            "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod),
            "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod - 1),
            "posterior_variance": posterior_variance,
            "posterior_log_variance_clipped": np.log(
                np.append(posterior_variance[1], posterior_variance[1:])),
            "posterior_mean_coef1": (betas * np.sqrt(alphas_cumprod_prev)
                                     / (1.0 - alphas_cumprod)),
            "posterior_mean_coef2": ((1.0 - alphas_cumprod_prev)
                                     * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
            "fixed_large_variance": fixed_large_variance,
            "fixed_large_log_variance": np.log(fixed_large_variance),
        }
        if timestep_map is None:
            timestep_map = np.arange(T, dtype=np.int32)
        constants = {k: torch.as_tensor(v.astype(np.float32), device=device)
                     for k, v in consts.items()}
        return cls(constants,
                   torch.as_tensor(np.asarray(timestep_map, np.int64),
                                   device=device),
                   model_mean_type=model_mean_type,
                   model_var_type=model_var_type, num_timesteps=T,
                   original_num_steps=int(original_num_steps or T),
                   rescale_timesteps=rescale_timesteps)

    @classmethod
    def create_named(cls, *, schedule_name: str = "cosine", steps: int = 1000,
                     timestep_respacing=None, predict_xstart: bool = True,
                     sigma_small: bool = True, rescale_timesteps: bool = False,
                     scale_beta: float = 1.0,
                     device=None) -> "GaussianDiffusion":
        """Factory matching `interdiff/model/diffusion_smpl.py:251-284`."""
        betas = sched_lib.get_named_beta_schedule(schedule_name, steps,
                                                  scale_beta)
        if not timestep_respacing:
            timestep_respacing = [steps]
        use_ts = sched_lib.space_timesteps(steps, timestep_respacing)
        betas, timestep_map = sched_lib.respace_betas(betas, sorted(use_ts))
        return cls.create(
            betas,
            model_mean_type=(ModelMeanType.START_X if predict_xstart
                             else ModelMeanType.EPSILON),
            model_var_type=(ModelVarType.FIXED_SMALL if sigma_small
                            else ModelVarType.FIXED_LARGE),
            rescale_timesteps=rescale_timesteps, timestep_map=timestep_map,
            original_num_steps=steps, device=device)

    # -- timesteps and the forward process ------------------------------------
    def model_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Timesteps as the model sees them: ``timestep_map[t]``, rescaled to
        the 1000-step range when ``rescale_timesteps``."""
        new_ts = self.timestep_map[t]
        if self.rescale_timesteps:
            return new_ts.float() * (1000.0 / self.original_num_steps)
        return new_ts

    def q_mean_variance(self, x_start, t):
        """Mean, variance and log-variance of q(x_t | x_0)."""
        nd = x_start.ndim
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start,
                _extract(1.0 - self.alphas_cumprod, t, nd),
                _extract(self.log_one_minus_alphas_cumprod, t, nd))

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        posterior_mean = (_extract(self.posterior_mean_coef1, t, nd) * x_start
                          + _extract(self.posterior_mean_coef2, t, nd) * x_t)
        return (posterior_mean, _extract(self.posterior_variance, t, nd),
                _extract(self.posterior_log_variance_clipped, t, nd))

    def predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps)

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return ((_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                 - pred_xstart)
                / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    # -- training ---------------------------------------------------------------
    def training_losses(self, model_fn, x_start, t, *, noise,
                        inpaint: Optional[Inpaint] = None):
        """``(model_output, target)`` of one training draw
        (`interdiff_tpu/diffusion/gaussian.py:545-561`): the model's output
        on ``q_sample(x_start, t, noise)`` (inpainted where asked) and what
        it is trained to match, x0 or the noise; the weighted loss lives in
        `train/losses.py`."""
        x_t = self.q_sample(x_start, t, noise)
        if inpaint is not None:
            if self.model_mean_type != ModelMeanType.START_X:
                raise ValueError("inpainting needs an x0-predicting model")
            x_t = torch.where(inpaint.mask, inpaint.motion, x_t)
        model_output = model_fn(x_t, self.model_timesteps(t))
        target = (x_start if self.model_mean_type == ModelMeanType.START_X
                  else noise)
        return model_output, target

    # -- reverse process -------------------------------------------------------
    def p_mean_variance(self, model_fn: Callable, x, t, *,
                        denoised_fn: Optional[Callable] = None,
                        inpaint: Optional[Inpaint] = None):
        """Model posterior p(x_{t-1} | x_t) plus the x0 prediction.

        ``model_fn(x, model_ts) -> model_output``; ``denoised_fn(x0, t) -> x0``
        is the correction hook.  Inpainting overwrites the model output.
        """
        nd = x.ndim
        model_output = model_fn(x, self.model_timesteps(t))
        if inpaint is not None:
            if self.model_mean_type != ModelMeanType.START_X:
                raise ValueError("inpainting needs an x0-predicting model")
            model_output = torch.where(inpaint.mask, inpaint.motion,
                                       model_output)

        if self.model_var_type == ModelVarType.FIXED_SMALL:
            model_variance = _extract(self.posterior_variance, t, nd)
            model_log_variance = _extract(self.posterior_log_variance_clipped,
                                          t, nd)
        else:
            model_variance = _extract(self.fixed_large_variance, t, nd)
            model_log_variance = _extract(self.fixed_large_log_variance, t, nd)

        if self.model_mean_type == ModelMeanType.START_X:
            pred_xstart = model_output
        else:
            pred_xstart = self.predict_xstart_from_eps(x, t, model_output)
        if denoised_fn is not None:
            pred_xstart = denoised_fn(pred_xstart, t)
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance,
                "pred_xstart": pred_xstart}

    def p_sample(self, model_fn, x, t, *, noise=None, generator=None,
                 denoised_fn=None, inpaint=None):
        """One ancestral step.  ``noise`` overrides the draw from
        ``generator``; at t = 0 no noise is added."""
        out = self.p_mean_variance(model_fn, x, t, denoised_fn=denoised_fn,
                                   inpaint=inpaint)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
        nonzero_mask = (t != 0).to(x.dtype).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        sample = (out["mean"]
                  + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _initial(self, shape, noise, generator, inpaint):
        """The loops' first image: explicit ``noise`` as it is (the eval
        harnesses pass it, and the initial inpainting overwrite is then
        skipped), else a draw from ``generator`` with the overwrite."""
        if noise is not None:
            return noise
        img = torch.randn(shape, generator=generator, device=self.device)
        if inpaint is not None:
            img = torch.where(inpaint.mask, inpaint.motion, img)
        return img

    @torch.no_grad()
    def p_sample_loop(self, model_fn, shape=None, *, noise=None,
                      step_noise=None, generator=None, denoised_fn=None,
                      inpaint: Optional[Inpaint] = None):
        """The full reverse process, t = T-1 .. 0.

        A ``denoised_fn(x0, t)`` that also takes a keyword ``step`` is handed
        the loop's own index as a Python int, so that a hook which fires on
        some steps only can decide so on the host, without reading ``t``
        back from the device.

        With explicit ``noise`` the initial inpainting overwrite is skipped
        (the eval harnesses pass explicit noise); with noise drawn here it
        is applied.  ``step_noise`` [num_timesteps, *shape] replaces the
        per-step draws, first row for t = T-1.
        """
        img = self._initial(shape, noise, generator, inpaint)
        B = img.shape[0]
        hook_at = _step_hook(denoised_fn)
        for n, i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((B,), i, dtype=torch.int64, device=img.device)
            img = self.p_sample(
                model_fn, img, t,
                noise=None if step_noise is None else step_noise[n],
                generator=generator, denoised_fn=hook_at(i),
                inpaint=inpaint)["sample"]
        return img

    # -- DDIM -------------------------------------------------------------------
    def ddim_sample(self, model_fn, x, t, *, generator=None,
                    denoised_fn=None, inpaint=None, eta: float = 0.0):
        """One DDIM step (`interdiff_tpu/diffusion/gaussian.py:405-422`);
        with ``eta`` = 0 it is deterministic and draws nothing."""
        out = self.p_mean_variance(model_fn, x, t, denoised_fn=denoised_fn,
                                   inpaint=inpaint)
        nd = x.ndim
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, nd)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        sample = mean_pred
        if eta != 0.0:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
            nonzero_mask = (t != 0).to(x.dtype).reshape(
                (-1,) + (1,) * (nd - 1))
            sample = mean_pred + nonzero_mask * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    @torch.no_grad()
    def ddim_sample_loop(self, model_fn, shape=None, *, noise=None,
                         generator=None, denoised_fn=None,
                         inpaint: Optional[Inpaint] = None,
                         eta: float = 0.0):
        """DDIM sampling, t = T-1 .. 0; ``noise``, ``inpaint`` and the
        ``step`` keyword of ``denoised_fn`` as in :meth:`p_sample_loop`."""
        img = self._initial(shape, noise, generator, inpaint)
        B = img.shape[0]
        hook_at = _step_hook(denoised_fn)
        for i in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((B,), i, dtype=torch.int64, device=img.device)
            img = self.ddim_sample(model_fn, img, t, generator=generator,
                                   denoised_fn=hook_at(i), inpaint=inpaint,
                                   eta=eta)["sample"]
        return img

    # -- PLMS (pseudo linear multistep) -----------------------------------------
    @torch.no_grad()
    def plms_sample_loop(self, model_fn, shape=None, *, noise=None,
                         generator=None, denoised_fn=None,
                         inpaint: Optional[Inpaint] = None, order: int = 2):
        """PLMS sampling (`interdiff_tpu/diffusion/gaussian.py:466-543`).

        The first step uses the pseudo improved Euler warm-up: a second
        model call at t - 1 on the first estimate, which passes through the
        inpainting and ``denoised_fn`` like every call (the hook's ``step``
        is then t - 1).  Later steps combine up to ``order`` stored eps
        predictions with the Adams-Bashforth weights.
        """
        if not 1 <= order <= 4:
            raise ValueError("order must be 1..4")
        img = self._initial(shape, noise, generator, inpaint)
        B, nd = img.shape[0], img.ndim
        hook_at = _step_hook(denoised_fn)

        def model_eps(x, t, step):
            out = self.p_mean_variance(model_fn, x, t,
                                       denoised_fn=hook_at(step),
                                       inpaint=inpaint)
            return (self.predict_eps_from_xstart(x, t, out["pred_xstart"]),
                    out["pred_xstart"])

        # Adams-Bashforth weights in float32, row cur_order - 1; columns
        # weight the newest eps first
        ab = np.asarray([
            [1.0, 0.0, 0.0, 0.0],
            [3 / 2, -1 / 2, 0.0, 0.0],
            [23 / 12, -16 / 12, 5 / 12, 0.0],
            [55 / 24, -59 / 24, 37 / 24, -9 / 24],
        ], dtype=np.float32)

        hist = []  # earlier eps predictions, newest first, order - 1 kept
        for count, i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((B,), i, dtype=torch.int64, device=img.device)
            eps, x0 = model_eps(img, t, i)
            alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, nd)
            if count == 0 and order > 1:
                mean1 = (x0 * torch.sqrt(alpha_bar_prev)
                         + torch.sqrt(1 - alpha_bar_prev) * eps)
                eps2, _ = model_eps(mean1, (t - 1).clamp(min=0),
                                    max(i - 1, 0))
                eps_prime = (eps + eps2) / 2.0
            else:
                w = ab[min(count + 1, order) - 1]
                eps_prime = float(w[0]) * eps
                # slots the history has not filled yet hold zeros on the
                # JAX side: adding nothing is the same
                for k, old in enumerate(hist, start=1):
                    eps_prime = eps_prime + float(w[k]) * old
            pred_prime = self.predict_xstart_from_eps(img, t, eps_prime)
            mean_pred = (pred_prime * torch.sqrt(alpha_bar_prev)
                         + torch.sqrt(1 - alpha_bar_prev) * eps_prime)
            # at t = 0 the sample is the x0 prediction itself
            img = mean_pred if i != 0 else x0
            if order > 1:
                hist = [eps] + hist[:order - 2]
        return img


def _step_hook(denoised_fn: Optional[Callable]) -> Callable:
    """``hook_at(step)``: the hook a loop hands to `p_mean_variance` at
    timestep ``step``.  A ``denoised_fn`` that takes a keyword ``step`` gets
    the Python int bound, so it need not read ``t`` back from the device."""
    if denoised_fn is None or "step" not in inspect.signature(
            denoised_fn).parameters:
        return lambda step: denoised_fn
    return lambda step: functools.partial(denoised_fn, step=step)
