"""Diffusion mel decoders of AAS-VC (mirrors seq2seq_vc_tpu/nn/diffusion.py):
DiffSinger's eps-prediction Gaussian diffusion (``GaussianDiffusion``, its
ancestral DDPM sampler and the DDIM few-step sampler) and ProDiff's
x0-prediction denoiser (``SpectogramDenoiser``, the upstream spelling),
both over ``DiffNet``, a non-causal WaveNet of gated dilated convs.

Every computation here runs in float32 whatever the model's compute dtype,
as in JAX: the layers hold float32 parameters and take no compute dtype, so
a bfloat16 conditioner is promoted. The schedules are computed in float32
in JAX's order of operations and kept as non-persistent buffers (they are
not parameters, so a state dict does not carry them).

Randomness: every draw comes from the ``torch.Generator`` the caller
passes, on that generator's device (a CPU generator gives a model on the
card and one on the CPU the same numbers), or from torch's default
generator without one. A sampler draws its whole noise at its start: the
initial sample, then one tensor of every step's ``z``. Each draw can be
given instead (``t``, ``eps``, ``x_init``, ``z``), so a test can feed the
JAX package's draws.

Submodule names are the flax module names (``Dense_0``, ``Dense_1``,
``Conv_0``, ``step_proj_{i}``, ``dilated_{i}``, ``cond_proj_{i}``,
``out_proj_{i}``, ``skip_proj``, ``final_proj``): the reference has no
diffusion classes to take names from, so ``convert.py`` carries the JAX
tree across by name.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Conv1d, Linear


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal diffusion-step embedding: t (B,) integers -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace`` in float32 as XLA computes it on the CPU: ``start *
    (1 - s) + stop * s`` with ``s = i * (1 / (num - 1))`` (XLA multiplies by
    the reciprocal where the source divides), and ``stop`` itself last. The
    DDIM steps, ``linspace(T - 1, 0, k + 1)`` rounded, then equal JAX's at
    every T up to 1000 and k up to 40 (a rounding half-way case decides)."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    s = torch.arange(div, dtype=torch.float32) * (torch.ones((), dtype=torch.float32) / div)
    out = torch.tensor(start, dtype=torch.float32) * (1 - s) + torch.tensor(
        stop, dtype=torch.float32) * s
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)])


def make_beta_schedule(schedule: str, timesteps: int, max_beta: float = 0.06,
                       min_beta: float = 0.1) -> torch.Tensor:
    """Beta schedules (float32, on the CPU). ``linear``: DiffSinger's
    (1e-4 .. max_beta). ``cosine``: Nichol & Dhariwal's. ``vpsde``: the
    discretised VP-SDE, the espnet2 ProDiff default (min_beta 0.1,
    max_beta 40)."""
    if schedule == "linear":
        return _linspace(1e-4, max_beta, timesteps)
    if schedule == "cosine":
        s = 0.008
        steps = torch.arange(timesteps + 1, dtype=torch.float32) / timesteps
        f = torch.cos((steps + s) / (1 + s) * math.pi / 2) ** 2
        alphas_bar = f / f[0]
        return torch.clamp(1.0 - alphas_bar[1:] / alphas_bar[:-1], 0.0, 0.999)
    if schedule == "vpsde":
        t = torch.arange(1, timesteps + 1, dtype=torch.float32)
        return 1.0 - torch.exp(
            -min_beta / timesteps - 0.5 * (max_beta - min_beta) * (2 * t - 1) / timesteps ** 2
        )
    raise ValueError(f"unknown beta schedule: {schedule!r}")


def _normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A float32 standard-normal draw from ``generator`` on its device (the
    default generator on ``like``'s device without one), on ``like``'s
    device."""
    device = like.device if generator is None else generator.device
    z = torch.randn(*shape, generator=generator, device=device)
    return z.to(like.device, non_blocking=True)


def _given(x: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x).to(like.device, torch.float32)


class DiffNet(torch.nn.Module):
    """Non-causal WaveNet denoiser (DiffWave/DiffSinger): x (B, T, out_dim)
    noisy features, t (B,) steps, cond (B, T, cond_dim) -> (B, T, out_dim).
    A swish MLP of the sinusoidal step embedding; per layer a step
    projection added to the input, a gated dilated conv (flax SAME), a 1x1
    conditioner projection and a 1x1 output split into the residual and the
    skip; the skip sum over sqrt(layers) -> 1x1, ReLU -> a zero-initialised
    1x1."""

    def __init__(self, out_dim: int, cond_dim: int, residual_channels: int = 256,
                 layers: int = 20, kernel_size: int = 3, dilation_cycle_length: int = 4,
                 device=None):
        super().__init__()
        rc = residual_channels
        kw = dict(device=device)
        self.layers = layers
        self.Dense_0 = Linear(rc, rc * 4, **kw)
        self.Dense_1 = Linear(rc * 4, rc, **kw)
        self.Conv_0 = Conv1d(out_dim, rc, 1, **kw)
        for i in range(layers):
            dil = 2 ** (i % dilation_cycle_length)
            setattr(self, f"step_proj_{i}", Linear(rc, rc, **kw))
            setattr(self, f"dilated_{i}", Conv1d(rc, 2 * rc, kernel_size, dilation=dil, **kw))
            setattr(self, f"cond_proj_{i}", Conv1d(cond_dim, 2 * rc, 1, **kw))
            setattr(self, f"out_proj_{i}", Conv1d(rc, 2 * rc, 1, **kw))
        self.skip_proj = Conv1d(rc, rc, 1, **kw)
        # zero-initialised output: the identity-noise prediction at init
        # (DiffWave's convention)
        self.final_proj = Conv1d(rc, out_dim, 1, **kw)
        torch.nn.init.zeros_(self.final_proj.weight)
        torch.nn.init.zeros_(self.final_proj.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        rc = self.Dense_1.out_features
        temb = self.Dense_1(F.silu(self.Dense_0(timestep_embedding(t, rc))))
        h = F.relu(self.Conv_0(x))
        skips = 0.0
        for i in range(self.layers):
            y = h + getattr(self, f"step_proj_{i}")(temb)[:, None, :]
            y = getattr(self, f"dilated_{i}")(y) + getattr(self, f"cond_proj_{i}")(cond)
            gate, filt = y.chunk(2, dim=-1)
            y = getattr(self, f"out_proj_{i}")(torch.tanh(filt) * torch.sigmoid(gate))
            res, skip = y.chunk(2, dim=-1)
            h = (h + res) / math.sqrt(2.0)
            skips = skips + skip
        h = F.relu(self.skip_proj(skips / math.sqrt(self.layers)))
        return self.final_proj(h)


class _Schedule(torch.nn.Module):
    """The betas and the cumulative product of 1 - beta as float32
    buffers that a state dict does not carry."""

    def _set_schedule(self, betas: torch.Tensor) -> None:
        self.timesteps = int(betas.shape[0])
        self.register_buffer("betas", betas, persistent=False)
        self.register_buffer("alphas_bar", torch.cumprod(1.0 - betas, 0), persistent=False)
        prev = torch.cat([torch.ones(1), self.alphas_bar[:-1]])
        self.register_buffer("alphas_bar_prev", prev, persistent=False)
        # the posterior variance beta~_t
        self.register_buffer("post_var", betas * (1.0 - prev) / (1.0 - self.alphas_bar),
                             persistent=False)

    def _draw_t_eps(self, x0, t, eps, generator):
        """The training draw: one step an item and the noise."""
        t = _given(t, x0)
        if t is None:
            dev = x0.device if generator is None else generator.device
            t = torch.randint(0, self.timesteps, (x0.shape[0],), generator=generator,
                              device=dev).to(x0.device)
        eps = _given(eps, x0)
        if eps is None:
            eps = _normal(x0.shape, x0, generator)
        return t.long(), eps

    def _noised(self, x0, t, eps, masks):
        ab = self.alphas_bar[t][:, None, None]
        x_t = torch.sqrt(ab) * x0.float() + torch.sqrt(1.0 - ab) * eps
        if masks is not None:
            x_t = torch.where(masks[..., None], x_t, 0.0)
        return x_t

    def _sampler_noise(self, cond, out_dim, n_steps, x_init, z, generator):
        """The sampler's initial sample and its (n_steps, B, T, out_dim)
        per-step noise (None for ``n_steps`` 0), drawn in that order."""
        shape = (cond.shape[0], cond.shape[1], out_dim)
        x = _given(x_init, cond)
        if x is None:
            x = _normal(shape, cond, generator)
        if n_steps:
            z = _given(z, cond)
            if z is None:
                z = _normal((n_steps, *shape), cond, generator)
        return x, z


def _masked(x: torch.Tensor, masks: Optional[torch.Tensor]) -> torch.Tensor:
    return x if masks is None else torch.where(masks[..., None], x, 0.0)


class GaussianDiffusion(_Schedule):
    """DiffSinger's eps-prediction diffusion decoder.

    ``forward(cond, x0, masks)`` draws one step an item, noises x0 and
    returns ``(eps, eps_hat)`` for the masked L2 loss. ``inference(cond,
    masks)`` samples x0: ancestral DDPM over ``timesteps``, or with
    ``inference_steps`` k in (0, timesteps) deterministic DDIM (eta 0) over
    k evenly spaced steps."""

    def __init__(self, in_dim: int, out_dim: int, residual_channels: int = 256,
                 denoiser_layers: int = 20, timesteps: int = 100, beta_schedule: str = "linear",
                 max_beta: float = 0.06, inference_steps: Optional[int] = None, device=None):
        super().__init__()
        self.out_dim = out_dim
        self.inference_steps = inference_steps
        self.denoise_fn = DiffNet(out_dim, in_dim, residual_channels, denoiser_layers,
                                  device=device)
        self._set_schedule(make_beta_schedule(beta_schedule, timesteps, max_beta=max_beta))
        self.to(device or "cpu")

    def forward(self, cond, x0, masks=None, t=None, eps=None,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """cond (B, T, in_dim), x0 (B, T, out_dim), masks (B, T) valid
        frames -> (eps, eps_hat), both (B, T, out_dim) float32."""
        t, eps = self._draw_t_eps(x0, t, eps, generator)
        return eps, self.denoise_fn(self._noised(x0, t, eps, masks), t, cond)

    def ddim_steps(self, k: int):
        """The DDIM (t, t_prev) pairs: ``linspace(T - 1, 0, k + 1)`` rounded
        half to even, as JAX rounds it."""
        ts = _linspace(self.timesteps - 1, 0, k + 1).round().long().tolist()
        return list(zip(ts[:-1], ts[1:]))

    @torch.no_grad()
    def inference(self, cond, masks=None, x_init=None, z=None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sample x0 conditioned on ``cond`` -> (B, T, out_dim) float32,
        zero past ``masks``. ``x_init`` (B, T, out_dim) and the ancestral
        sampler's ``z`` (timesteps, B, T, out_dim), step T-1 first, replace
        the draws."""
        k = self.inference_steps
        if k and 0 < k < self.timesteps:
            return self._ddim(cond, masks, k, x_init, generator)
        B = cond.shape[0]
        betas, ab = self.betas, self.alphas_bar
        alphas = 1.0 - betas
        x, z = self._sampler_noise(cond, self.out_dim, self.timesteps, x_init, z, generator)
        for n, t in enumerate(range(self.timesteps - 1, -1, -1)):
            eps_hat = self.denoise_fn(x, torch.full((B,), t, device=cond.device), cond)
            mean = (x - betas[t] / torch.sqrt(1.0 - ab[t]) * eps_hat) / torch.sqrt(alphas[t])
            x = mean + torch.sqrt(self.post_var[t]) * z[n] if t > 0 else mean
        return _masked(x, masks)

    def _ddim(self, cond, masks, k, x_init, generator):
        """Deterministic DDIM: x_{t'} = sqrt(ab_t') x0_hat + sqrt(1 - ab_t')
        eps_hat, x0_hat = (x - sqrt(1 - ab_t) eps_hat) / sqrt(ab_t); the
        last transition targets the clean sample (ab_t' := 1)."""
        B, ab = cond.shape[0], self.alphas_bar
        one = torch.ones((), device=ab.device)
        x, _ = self._sampler_noise(cond, self.out_dim, 0, x_init, None, generator)
        for t, t_prev in self.ddim_steps(k):
            eps_hat = self.denoise_fn(x, torch.full((B,), t, device=cond.device), cond)
            ab_t, ab_p = ab[t], ab[t_prev] if t_prev > 0 else one
            x0_hat = (x - torch.sqrt(1.0 - ab_t) * eps_hat) / torch.sqrt(ab_t)
            x = torch.sqrt(ab_p) * x0_hat + torch.sqrt(1.0 - ab_p) * eps_hat
        return _masked(x, masks)


class SpectogramDenoiser(_Schedule):
    """ProDiff's x0-prediction denoiser.

    Training noises the target to a random step and predicts the clean
    features, which the trainer's L1 loss reads as ``before_outs``.
    Inference samples from the posterior q(x_{t-1} | x_t, x0_hat) every
    ``timescale`` steps (``timesteps`` 4 and ``timescale`` 1: the paper's
    4-iteration generator)."""

    def __init__(self, idim: int, adim: int = 256, layers: int = 20, channels: int = 256,
                 timesteps: int = 1000, timescale: int = 1, max_beta: float = 40.0,
                 scheduler: str = "vpsde", cycle_length: int = 1, device=None):
        super().__init__()
        self.idim, self.timescale = idim, timescale
        self.denoiser = DiffNet(idim, adim, channels, layers,
                                dilation_cycle_length=max(1, cycle_length), device=device)
        betas = make_beta_schedule(scheduler, timesteps, max_beta=max_beta)
        self._set_schedule(betas)
        self.register_buffer("c0", torch.sqrt(self.alphas_bar_prev) * betas
                             / (1.0 - self.alphas_bar), persistent=False)
        self.register_buffer("c1", torch.sqrt(1.0 - betas) * (1.0 - self.alphas_bar_prev)
                             / (1.0 - self.alphas_bar), persistent=False)
        self.to(device or "cpu")

    def steps(self):
        return list(range(self.timesteps - 1, -1, -self.timescale))

    def forward(self, cond, ys=None, masks=None, is_inference: bool = False, t=None, eps=None,
                x_init=None, z=None, generator: Optional[torch.Generator] = None):
        """cond (B, T, adim); ys (B, T, idim) clean targets (training) ->
        the x0 prediction (B, T, idim) float32."""
        if is_inference:
            return self.inference(cond, masks, x_init, z, generator)
        t, eps = self._draw_t_eps(ys, t, eps, generator)
        return self.denoiser(self._noised(ys, t, eps, masks), t, cond)

    @torch.no_grad()
    def inference(self, cond, masks=None, x_init=None, z=None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x_init`` (B, T, idim) and ``z`` (len(steps()), B, T, idim)
        replace the draws."""
        B = cond.shape[0]
        steps = self.steps()
        x, z = self._sampler_noise(cond, self.idim, len(steps), x_init, z, generator)
        for n, t in enumerate(steps):
            x0_hat = self.denoiser(x, torch.full((B,), t, device=cond.device), cond)
            mean = self.c0[t] * x0_hat + self.c1[t] * x
            x = mean + torch.sqrt(self.post_var[t]) * z[n] if t > 0 else mean
        return _masked(x, masks)
