"""Gaussian diffusion engine over a precomputed schedule
(`interdiff_tpu/diffusion/gaussian.py`): ancestral DDPM, DDIM and PLMS
sampling, the deterministic DDIM encoding ``ddim_reverse_sample``, the
training pair ``training_losses`` and the variational bound in bits per
dimension (``vb_terms_bpd``, ``prior_bpd``, ``calc_bpd_loop``).

The schedule is computed in float64 numpy and cast once to float32 tensors
on the engine's device.  Each sampling loop is a Python loop over the kept
timesteps; observation inpainting overwrites the model's x0 prediction on
the masked (past) elements, and ``denoised_fn`` is the correction hook.
The model may predict x0, the noise or x_{t-1} (`ModelMeanType`), with
fixed or learned variances (`ModelVarType`; a learned one takes the second
half of the model's channel axis 1).  Classifier guidance takes a
``cond_fn(x, model_timesteps) -> gradient`` that computes its gradient
itself under ``torch.enable_grad()`` (the loops run without autograd); the
reference's ``*_with_grad`` family is the same one API, as in JAX.
"""

from __future__ import annotations

import enum
import functools
import math
import inspect
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.diffusion import schedule as sched_lib
from interdiff_torch.diffusion.losses import (
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
)
from interdiff_torch.parallel.mesh import randn_rows
from interdiff_torch.utils import profiling


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class Inpaint(NamedTuple):
    """Observation inpainting: ``mask`` True means "use ground truth"."""

    mask: torch.Tensor  # bool, same shape as x
    motion: torch.Tensor  # same shape as x

    @classmethod
    def past(cls, motion: torch.Tensor, past_len: int) -> "Inpaint":
        """``motion`` [B, T, ...] on its first ``past_len`` frames."""
        mask = torch.zeros_like(motion, dtype=torch.bool)
        mask[:, :past_len] = True
        return cls(mask, motion)


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
                     sigma_small: bool = True, learn_sigma: bool = False,
                     rescale_timesteps: bool = False,
                     scale_beta: float = 1.0,
                     device=None) -> "GaussianDiffusion":
        """Factory matching `interdiff/model/diffusion_smpl.py:251-284`."""
        betas = sched_lib.get_named_beta_schedule(schedule_name, steps,
                                                  scale_beta)
        if not timestep_respacing:
            timestep_respacing = [steps]
        use_ts = sched_lib.space_timesteps(steps, timestep_respacing)
        betas, timestep_map = sched_lib.respace_betas(betas, sorted(use_ts))
        if learn_sigma:
            var_type = ModelVarType.LEARNED_RANGE
        else:
            var_type = (ModelVarType.FIXED_SMALL if sigma_small
                        else ModelVarType.FIXED_LARGE)
        return cls.create(
            betas,
            model_mean_type=(ModelMeanType.START_X if predict_xstart
                             else ModelMeanType.EPSILON),
            model_var_type=var_type,
            rescale_timesteps=rescale_timesteps, timestep_map=timestep_map,
            original_num_steps=steps, device=device)

    @staticmethod
    def masked_l2(a: torch.Tensor, b: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
        """Mask-normalised squared error per sample
        (`gaussian_diffusion.py:201-214`): a, b [B, J, Jdim, T], mask
        [B, 1, 1, T] -> sum((a - b)^2 * mask) / (sum(mask) * J * Jdim)."""
        dims = tuple(range(1, a.ndim))
        loss = ((a - b) ** 2 * mask).sum(dim=dims)
        non_zero = mask.sum(dim=dims) * (a.shape[1] * a.shape[2])
        return loss / non_zero.clamp(min=1.0)

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

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        nd = x_t.ndim
        return (_extract(1.0 / self.posterior_mean_coef1, t, nd) * xprev
                - _extract(self.posterior_mean_coef2
                           / self.posterior_mean_coef1, t, nd) * x_t)

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
        it is trained to match: x0, the noise, or the posterior mean for an
        x_{t-1} model; the weighted loss lives in `train/losses.py`."""
        x_t = self.q_sample(x_start, t, noise)
        if inpaint is not None:
            if self.model_mean_type != ModelMeanType.START_X:
                raise ValueError("inpainting needs an x0-predicting model")
            x_t = torch.where(inpaint.mask, inpaint.motion, x_t)
        model_output = model_fn(x_t, self.model_timesteps(t))
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        return model_output, target

    # -- reverse process -------------------------------------------------------
    def p_mean_variance(self, model_fn: Callable, x, t, *,
                        clip_denoised: bool = False,
                        denoised_fn: Optional[Callable] = None,
                        inpaint: Optional[Inpaint] = None):
        """Model posterior p(x_{t-1} | x_t) plus the x0 prediction.

        ``model_fn(x, model_ts) -> model_output`` (x0, eps or x_{t-1}; with
        a learned variance the channel axis 1 carries [prediction,
        variance values]); ``denoised_fn(x0, t) -> x0`` is the correction
        hook, ``clip_denoised`` clips x0 to [-1, 1] after it.  Inpainting
        overwrites the model output.
        """
        nd = x.ndim
        with profiling.span("sampler.denoise", cuda=x.is_cuda):
            model_output = model_fn(x, self.model_timesteps(t))
        if inpaint is not None:
            if self.model_mean_type != ModelMeanType.START_X:
                raise ValueError("inpainting needs an x0-predicting model")
            model_output = torch.where(inpaint.mask, inpaint.motion,
                                       model_output)

        if self.model_var_type in (ModelVarType.LEARNED,
                                   ModelVarType.LEARNED_RANGE):
            C = x.shape[1]
            model_output, var_values = model_output[:, :C], \
                model_output[:, C:]
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = var_values
            else:
                min_log = _extract(self.posterior_log_variance_clipped, t,
                                   nd)
                max_log = _extract(torch.log(self.betas), t, nd)
                frac = (var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_SMALL:
            model_variance = _extract(self.posterior_variance, t, nd)
            model_log_variance = _extract(self.posterior_log_variance_clipped,
                                          t, nd)
        else:
            model_variance = _extract(self.fixed_large_variance, t, nd)
            model_log_variance = _extract(self.fixed_large_log_variance, t, nd)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0, t)
            return x0.clamp(-1.0, 1.0) if clip_denoised else x0

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(
                self.predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = process_xstart(model_output)
            else:
                pred_xstart = process_xstart(
                    self.predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x,
                                                              t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance,
                "pred_xstart": pred_xstart}

    # -- classifier guidance ------------------------------------------------
    def condition_mean(self, cond_fn, p_mean_var, x, t):
        """Sohl-Dickstein-style mean shift (`gaussian_diffusion.py:418-431`):
        the mean plus the variance times ``cond_fn(x, model_ts)``."""
        gradient = cond_fn(x, self.model_timesteps(t))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t):
        """Song-style score conditioning (`gaussian_diffusion.py:448-470`):
        eps shifted by sqrt(1 - alpha_bar) times the gradient, x0 and the
        mean formed again from it."""
        nd = x.ndim
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        eps = self.predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(
            x, self.model_timesteps(t))
        out = dict(p_mean_var)
        out["pred_xstart"] = self.predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(
            out["pred_xstart"], x, t)
        return out

    def p_sample(self, model_fn, x, t, *, noise=None, generator=None,
                 clip_denoised=False, denoised_fn=None, cond_fn=None,
                 inpaint=None, const_noise=False):
        """One ancestral step.  ``noise`` overrides the draw from
        ``generator``; ``const_noise`` gives every row the first row's
        noise; ``cond_fn`` shifts the mean (`condition_mean`); at t = 0 no
        noise is added."""
        out = self.p_mean_variance(model_fn, x, t,
                                   clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, inpaint=inpaint)
        if noise is None:
            noise = randn_rows(x.shape, generator, x.device, x.dtype)
        if const_noise:
            noise = noise[:1].expand(noise.shape)
        nonzero_mask = (t != 0).to(x.dtype).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        mean = out["mean"]
        if cond_fn is not None:
            mean = self.condition_mean(cond_fn, out, x, t)
        sample = mean + nonzero_mask * torch.exp(0.5 * out["log_variance"]) \
            * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _initial(self, shape, noise, generator, inpaint):
        """The loops' first image: explicit ``noise`` as it is (the eval
        harnesses pass it, and the initial inpainting overwrite is then
        skipped), else a draw from ``generator`` with the overwrite."""
        if noise is not None:
            return noise
        img = randn_rows(shape, generator, self.device)
        if inpaint is not None:
            img = torch.where(inpaint.mask, inpaint.motion, img)
        return img

    @torch.no_grad()
    def p_sample_loop(self, model_fn, shape=None, *, noise=None,
                      step_noise=None, generator=None, clip_denoised=False,
                      denoised_fn=None, cond_fn=None,
                      inpaint: Optional[Inpaint] = None, const_noise=False,
                      skip_timesteps: int = 0, init_image=None):
        """The full reverse process, t = T-1 .. ``skip_timesteps``.

        A ``denoised_fn(x0, t)`` that also takes a keyword ``step`` is handed
        the loop's own index as a Python int, so that a hook which fires on
        some steps only can decide so on the host, without reading ``t``
        back from the device.

        With explicit ``noise`` the initial inpainting overwrite is skipped
        (the eval harnesses pass explicit noise); with noise drawn here it
        is applied.  ``step_noise`` [steps, *shape] replaces the per-step
        draws, first row for the first step.  ``skip_timesteps`` stops the
        chain early at t = skip (the reference DDPM loop's semantics); with
        it or with ``init_image`` the first image is ``q_sample(init_image,
        T-1, initial noise)``, the start image zeros when not given.
        """
        img = self._initial(shape, noise, generator, inpaint)
        B = img.shape[0]
        first = self.num_timesteps - 1
        if init_image is None and skip_timesteps:
            init_image = torch.zeros_like(img)
        if init_image is not None:
            img = self.q_sample(init_image, torch.full(
                (B,), first, dtype=torch.int64, device=img.device), img)
        hook_at = _step_hook(denoised_fn)
        for n, i in enumerate(range(first, skip_timesteps - 1, -1)):
            with _step_span(n, i, img.is_cuda):
                t = torch.full((B,), i, dtype=torch.int64, device=img.device)
                img = self.p_sample(
                    model_fn, img, t,
                    noise=None if step_noise is None else step_noise[n],
                    generator=generator, clip_denoised=clip_denoised,
                    denoised_fn=hook_at(i), cond_fn=cond_fn, inpaint=inpaint,
                    const_noise=const_noise)["sample"]
        return img

    # -- one sampler by name ------------------------------------------------
    SAMPLERS = ("ddpm", "ddim", "plms")

    @staticmethod
    def check_sampler(sampler: str) -> None:
        """Raise unless ``sampler`` is one of :attr:`SAMPLERS`."""
        if sampler not in GaussianDiffusion.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}: the port has "
                             "'ddpm', 'ddim' and 'plms'")

    def sample_loop(self, sampler: str, model_fn, *, noise=None,
                    step_noise=None, generator=None,
                    inpaint: Optional[Inpaint] = None, denoised_fn=None):
        """The loop of ``sampler`` (:attr:`SAMPLERS`) at its defaults;
        ``step_noise`` goes to 'ddpm', :meth:`p_sample_loop`, alone."""
        self.check_sampler(sampler)
        loop = {"ddim": self.ddim_sample_loop, "plms": self.plms_sample_loop,
                "ddpm": functools.partial(self.p_sample_loop,
                                          step_noise=step_noise)}[sampler]
        return loop(model_fn, noise=noise, generator=generator,
                    inpaint=inpaint, denoised_fn=denoised_fn)

    # -- DDIM -------------------------------------------------------------------
    def ddim_sample(self, model_fn, x, t, *, generator=None,
                    clip_denoised=False, denoised_fn=None, cond_fn=None,
                    inpaint=None, eta: float = 0.0):
        """One DDIM step (`interdiff_tpu/diffusion/gaussian.py:405-422`);
        with ``eta`` = 0 it is deterministic and draws nothing; ``cond_fn``
        conditions the score (`condition_score`)."""
        out = self.p_mean_variance(model_fn, x, t,
                                   clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, inpaint=inpaint)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t)
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
            noise = randn_rows(x.shape, generator, x.device, x.dtype)
            nonzero_mask = (t != 0).to(x.dtype).reshape(
                (-1,) + (1,) * (nd - 1))
            sample = mean_pred + nonzero_mask * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    @torch.no_grad()
    def ddim_sample_loop(self, model_fn, shape=None, *, noise=None,
                         generator=None, clip_denoised=False,
                         denoised_fn=None, cond_fn=None,
                         inpaint: Optional[Inpaint] = None,
                         eta: float = 0.0):
        """DDIM sampling, t = T-1 .. 0; ``noise``, ``inpaint`` and the
        ``step`` keyword of ``denoised_fn`` as in :meth:`p_sample_loop`."""
        img = self._initial(shape, noise, generator, inpaint)
        B = img.shape[0]
        hook_at = _step_hook(denoised_fn)
        for n, i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            with _step_span(n, i, img.is_cuda):
                t = torch.full((B,), i, dtype=torch.int64, device=img.device)
                img = self.ddim_sample(
                    model_fn, img, t, generator=generator,
                    clip_denoised=clip_denoised, denoised_fn=hook_at(i),
                    cond_fn=cond_fn, inpaint=inpaint, eta=eta)["sample"]
        return img

    def ddim_reverse_sample(self, model_fn, x, t, *, clip_denoised=False,
                            denoised_fn=None):
        """Deterministic encoding x_t -> x_{t+1} (the DDIM ODE run forward,
        `gaussian_diffusion.py:847-884`, eta 0)."""
        out = self.p_mean_variance(model_fn, x, t,
                                   clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn)
        nd = x.ndim
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = _extract(self.alphas_cumprod_next, t, nd)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    # -- PLMS (pseudo linear multistep) -----------------------------------------
    @torch.no_grad()
    def plms_sample_loop(self, model_fn, shape=None, *, noise=None,
                         generator=None, clip_denoised=False,
                         denoised_fn=None,
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
                                       clip_denoised=clip_denoised,
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
            with _step_span(count, i, img.is_cuda):
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

    # -- variational bound (diagnostics) ----------------------------------------
    def vb_terms_bpd(self, model_fn, x_start, x_t, t, *,
                     clip_denoised=False):
        """One term of the variational bound in bits per dimension, [B]:
        KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)), or at t = 0 the
        decoder's negative log-likelihood; and the x0 prediction."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(
            x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t,
                                   clip_denoised=clip_denoised)
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"],
                                 out["log_variance"])) / math.log(2.0)
        decoder_nll = mean_flat(-discretized_gaussian_log_likelihood(
            x_start, means=out["mean"],
            log_scales=0.5 * out["log_variance"])) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}

    def prior_bpd(self, x_start):
        """Prior KL term of the bound in bits per dimension, [B]
        (`gaussian_diffusion.py:1535-1551`)."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1,
                       dtype=torch.int64, device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        return mean_flat(normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)) \
            / math.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn, x_start, *, generator=None,
                      step_noise=None, clip_denoised=False):
        """The whole variational bound (`gaussian_diffusion.py:1553-1609`):
        one model call per timestep, t = T-1 .. 0, on a fresh ``q_sample``.
        Returns ``{total_bpd [B], prior_bpd [B], vb [B,T], xstart_mse [B,T],
        mse [B,T]}``, column ``j`` of the per-step tensors holding timestep
        ``T-1-j``.  The noise comes from ``step_noise`` [T, *x_start.shape]
        (ordered t = T-1 .. 0) or from ``generator``; one of them is
        needed."""
        if step_noise is None and generator is None:
            raise ValueError("calc_bpd_loop needs `generator` or `step_noise`")
        B = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for j, i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((B,), i, dtype=torch.int64, device=x_start.device)
            noise = step_noise[j] if step_noise is not None else torch.randn(
                x_start.shape, generator=generator, device=x_start.device,
                dtype=x_start.dtype)
            x_t = self.q_sample(x_start, t, noise)
            out = self.vb_terms_bpd(model_fn, x_start, x_t, t,
                                    clip_denoised=clip_denoised)
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            eps = self.predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            mse.append(mean_flat((eps - noise) ** 2))
        vb = torch.stack(vb, dim=1)
        prior = self.prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior,
                "vb": vb, "xstart_mse": torch.stack(xstart_mse, dim=1),
                "mse": torch.stack(mse, dim=1)}


def _step_span(n: int, i: int, cuda: bool):
    """The span ``sampler.step`` of a loop's ``n``-th step, at timestep
    ``i``.  A call's second step (t = T-2, on which no hook fires) counts
    its aten operators as ``sampler.ops``: the host's dispatch work of one
    plain step."""
    return profiling.span("sampler.step", cuda=cuda,
                          ops="sampler.ops" if n == 1 else None, t=i)


def _step_hook(denoised_fn: Optional[Callable]) -> Callable:
    """``hook_at(step)``: the hook a loop hands to `p_mean_variance` at
    timestep ``step``.  A ``denoised_fn`` that takes a keyword ``step`` gets
    the Python int bound, so it need not read ``t`` back from the device."""
    if denoised_fn is None or "step" not in inspect.signature(
            denoised_fn).parameters:
        return lambda step: denoised_fn
    return lambda step: functools.partial(denoised_fn, step=step)


def firing_hook(correct: Callable, *, t_max: int, every: int,
                trace: Optional[List[Dict]] = None) -> Callable:
    """The hook ``denoised_fn(x0, t, step=None)``: ``correct(x0, step) ->
    (x0, extra)`` in the span ``hook.firing`` at ``step <= t_max``, ``step %
    every == 0``; a firing's ``trace`` entry holds ``t``, ``extra`` and, on
    the card, the span's events ``start`` and ``end``.  The loops pass
    ``step`` (:func:`_step_hook`); with only ``t`` it reads ``t[0]``."""

    def denoised_fn(x: torch.Tensor, t: torch.Tensor,
                    step: Optional[int] = None) -> torch.Tensor:
        if step is None:
            step = int(t[0])
        if step > t_max or step % every != 0:
            return x
        with profiling.span("hook.firing", cuda=x.is_cuda,
                            keep=trace is not None, t=step) as firing:
            out, extra = correct(x, step)
        if trace is not None:
            entry = {"t": step, **(extra or {})}
            if firing.events is not None:
                entry["start"], entry["end"] = firing.events
            trace.append(entry)
        return out

    return denoised_fn
