"""DDPM / DDIM schedulers for the x4 upscaler's denoise loop.

Counterpart of the JAX package's ``models/diffusion/scheduler.py``: the
constants are computed in numpy float64 and stored as float32 tensors, and
each step runs in float32 on the sample's device. The denoise loop is a
Python loop, so ``t`` and ``prev_t`` are host integers (``prev_t`` < 0 means
"below the last step").
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["DDPMScheduler", "DDIMScheduler"]


def _make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
                beta_schedule: str) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(num_train_timesteps, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / num_train_timesteps)
                          / alpha_bar(ts / num_train_timesteps), 0.999)
    raise ValueError(f"unknown beta schedule {beta_schedule}")


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32))


class _SchedulerBase:
    _default_clip_sample = True

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.0001, beta_end: float = 0.02,
                 beta_schedule: str = "scaled_linear",
                 prediction_type: str = "epsilon",
                 steps_offset: int = 0,
                 clip_sample: bool | None = None,
                 set_alpha_to_one: bool = True,
                 **ignored):
        self.num_train_timesteps = int(num_train_timesteps)
        self.prediction_type = prediction_type
        self.steps_offset = int(steps_offset)
        self.clip_sample = (self._default_clip_sample if clip_sample is None
                            else bool(clip_sample))
        betas = _make_betas(self.num_train_timesteps, beta_start, beta_end,
                            beta_schedule)
        alphas = 1.0 - betas
        self.betas = _f32(betas)
        self.alphas = _f32(alphas)
        self.alphas_cumprod = _f32(np.cumprod(alphas))
        # diffusers: the "previous alpha-bar" below the last step is 1.0
        # with set_alpha_to_one, else alphas_cumprod[0] (SD configs: False).
        self.final_alpha_cumprod = _f32(
            1.0 if set_alpha_to_one else float(np.cumprod(alphas)[0]))
        if ignored:
            logging.getLogger("nesr.diffusion").debug(
                "%s: ignoring scheduler-config keys %s",
                type(self).__name__, sorted(ignored))

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Leading-spaced inference timesteps (diffusers 'leading' rule)."""
        step = self.num_train_timesteps // num_inference_steps
        return (np.arange(num_inference_steps) * step).round()[::-1].astype(
            np.int32) + self.steps_offset

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: int) -> torch.Tensor:
        """q(x_t | x_0): sqrt(a_bar) x0 + sqrt(1 - a_bar) eps."""
        a_bar = self.alphas_cumprod[t]
        return torch.sqrt(a_bar) * sample + torch.sqrt(1.0 - a_bar) * noise

    def _predict_x0(self, sample, model_output, a_bar):
        if self.prediction_type == "epsilon":
            return (sample - torch.sqrt(1.0 - a_bar) * model_output) / \
                torch.sqrt(a_bar)
        if self.prediction_type == "v_prediction":
            return torch.sqrt(a_bar) * sample - \
                torch.sqrt(1.0 - a_bar) * model_output
        raise ValueError(self.prediction_type)


class DDPMScheduler(_SchedulerBase):
    """Ancestral DDPM sampling step (and the low-res image noiser)."""

    def step(self, model_output: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_{t-1} from x_t; ``noise`` supplies the stochastic term."""
        a_bar_t = self.alphas_cumprod[t]
        a_bar_prev = (self.alphas_cumprod[prev_t] if prev_t >= 0
                      else _f32(1.0))
        current_alpha = a_bar_t / a_bar_prev
        current_beta = 1.0 - current_alpha

        x0 = self._predict_x0(sample, model_output, a_bar_t)
        if self.clip_sample:
            x0 = torch.clamp(x0, -1.0, 1.0)

        pred_prev_coeff = torch.sqrt(a_bar_prev) * current_beta / (
            1.0 - a_bar_t)
        cur_coeff = torch.sqrt(current_alpha) * (1.0 - a_bar_prev) / \
            (1.0 - a_bar_t)
        mean = pred_prev_coeff * x0 + cur_coeff * sample

        var = (1.0 - a_bar_prev) / (1.0 - a_bar_t) * current_beta
        var = torch.clamp(var, min=1e-20)
        sigma = torch.sqrt(var) if t > 0 else _f32(0.0)
        return mean + sigma * noise


class DDIMScheduler(_SchedulerBase):
    """Deterministic DDIM step (eta = 0, as SD pipelines default)."""

    _default_clip_sample = False  # SD-era DDIM configs set clip_sample=False

    def step(self, model_output: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor) -> torch.Tensor:
        a_bar_t = self.alphas_cumprod[t]
        a_bar_prev = (self.alphas_cumprod[prev_t] if prev_t >= 0
                      else self.final_alpha_cumprod)
        x0 = self._predict_x0(sample, model_output, a_bar_t)
        if self.clip_sample:
            x0 = torch.clamp(x0, -1.0, 1.0)
        if self.prediction_type == "epsilon" and not self.clip_sample:
            eps = model_output
        else:  # diffusers recomputes eps from (possibly clipped) x0
            eps = (sample - torch.sqrt(a_bar_t) * x0) / torch.sqrt(
                1.0 - a_bar_t)
        return torch.sqrt(a_bar_prev) * x0 + torch.sqrt(1.0 - a_bar_prev) * eps
