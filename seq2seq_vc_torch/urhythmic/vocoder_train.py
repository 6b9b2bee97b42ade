"""HiFi-GAN (fine-)tuning for Urhythmic (mirrors
seq2seq_vc_tpu/urhythmic/vocoder_train.py).

One step: the discriminators' LSGAN update on detached fakes, then the
generator's update on 45 * L1 log-mel + 2 * feature matching +
adversarial, against the updated discriminators. AdamW (lr 5e-5, betas
(0.8, 0.99), weight decay 1e-2 on every parameter, as ``optax.adamw``
with no mask), the learning rate ``5e-5 * 0.999 ** (t / 1000)`` at update
``t`` (counted from 0, optax's ``exponential_decay`` without staircase).
Both models keep flax's weight norm and train (scale, kernel) unfolded.

The log-mel loss uses the urhythmic analysis (n_fft 1024, win 1024, hop
320, 80 mels, no centring: a (win - hop) / 2 reflect pad, magnitude
``|rfft|``, log of the mel values clamped at 1e-5).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dsp.mel import mel_filterbank
from ..dsp.stft import hann_window
from ..vocoder.hifigan import (
    HifiganDiscriminator,
    HifiganGenerator,
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)

BATCH_SIZE = 8
SEGMENT_LENGTH = 8320
HOP_LENGTH = 320
SAMPLE_RATE = 16000
FINETUNE_LEARNING_RATE = 5e-5
BETAS = (0.8, 0.99)
LEARNING_RATE_DECAY = 0.999
DECAY_STEPS = 1000
WEIGHT_DECAY = 1e-2


def make_logmel_fn(sr: int = SAMPLE_RATE, n_fft: int = 1024, win_length: int = 1024,
                   hop: int = HOP_LENGTH, n_mels: int = 80, device=None):
    """wav (B, T) -> log-mel (B, 1 + (T - hop) // hop, n_mels): windows of
    ``win_length`` at ``hop`` over the (win - hop) / 2 reflect-padded wave."""
    window = torch.from_numpy(hann_window(win_length, n_fft)).to(device)
    mel_t = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels).T.copy()).to(device)
    pad = (win_length - hop) // 2

    def logmel(wav: torch.Tensor) -> torch.Tensor:
        x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        spec = torch.fft.rfft(x.unfold(1, win_length, hop) * window, dim=-1).abs()
        return torch.log(torch.clamp(spec @ mel_t, min=1e-5))

    return logmel


def learning_rate(t: int, lr: float = FINETUNE_LEARNING_RATE) -> float:
    """The rate of update ``t`` (0 for the first)."""
    return lr * LEARNING_RATE_DECAY ** (t / DECAY_STEPS)


class HifiganTrainer:
    """The GAN trainer: ``train_step`` on (units, wavs) batches, ``save``
    and ``load``. Fresh models are drawn from seed 0 (the JAX trainer's
    ``PRNGKey(0)``) with flax's initial weight-norm scales (1) and biases
    (0), on ``device`` (default: the card)."""

    def __init__(self, generator: Optional[HifiganGenerator] = None,
                 discriminator: Optional[HifiganDiscriminator] = None,
                 lr: float = FINETUNE_LEARNING_RATE, device=None):
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.generator = (generator or HifiganGenerator(weight_norm=True)).to(self.device)
            self.discriminator = (discriminator or HifiganDiscriminator()).to(self.device)
        self.lr = lr
        self.logmel = make_logmel_fn(device=self.device)
        self.g_opt = self._optimizer(self.generator)
        self.d_opt = self._optimizer(self.discriminator)
        self.steps = 0

    def _optimizer(self, model: torch.nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(model.parameters(), lr=self.lr, betas=BETAS, eps=1e-8,
                                 weight_decay=WEIGHT_DECAY)

    def _update(self, opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = learning_rate(self.steps, self.lr)
        opt.step()

    def train_step(self, units, wavs) -> Dict[str, float]:
        """units (B, T, D); wavs (B, T * HOP_LENGTH). Returns the losses."""
        units = torch.as_tensor(np.asarray(units, np.float32), device=self.device)
        wavs = torch.as_tensor(np.asarray(wavs, np.float32), device=self.device)
        gen, disc = self.generator.train(), self.discriminator.train()
        with torch.no_grad():
            tgt_mel = self.logmel(wavs)
        fake = gen(units)

        # the discriminators, on detached fakes
        real_s, _ = disc(wavs)
        fake_s, _ = disc(fake.detach())
        d_loss = discriminator_loss(real_s, fake_s)
        self._update(self.d_opt, d_loss)

        # the generator, against the updated discriminators
        disc.requires_grad_(False)
        try:
            fake_mel = self.logmel(fake)
            # generated audio may be a frame short of the target slice
            T = min(fake_mel.shape[1], tgt_mel.shape[1])
            loss_mel = torch.mean(torch.abs(fake_mel[:, :T] - tgt_mel[:, :T]))
            fake_s, fake_f = disc(fake)
            with torch.no_grad():
                _, real_f = disc(wavs)
            loss_fm = feature_matching_loss(real_f, fake_f)
            loss_adv = generator_adversarial_loss(fake_s)
            g_loss = 45.0 * loss_mel + 2.0 * loss_fm + loss_adv
            self._update(self.g_opt, g_loss)
        finally:
            disc.requires_grad_(True)
        self.steps += 1
        losses = {"loss_discriminator": d_loss, "loss_generator": g_loss, "loss_mel": loss_mel,
                  "loss_fm": loss_fm, "loss_adv": loss_adv}
        return {k: float(v.detach()) for k, v in losses.items()}

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        torch.save({"model": {"generator": self.generator.state_dict(),
                              "discriminator": self.discriminator.state_dict()},
                    "optimizer": {"generator": self.g_opt.state_dict(),
                                  "discriminator": self.d_opt.state_dict()},
                    "steps": self.steps}, path)

    def load(self, path: str, finetune: bool = False) -> None:
        """Parameters, and unless ``finetune`` the optimizers' state and the
        step count (``finetune`` keeps fresh optimizers and ``steps`` 0)."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.generator.load_state_dict(state["model"]["generator"])
        self.discriminator.load_state_dict(state["model"]["discriminator"])
        if not finetune:
            self.g_opt.load_state_dict(state["optimizer"]["generator"])
            self.d_opt.load_state_dict(state["optimizer"]["discriminator"])
            self.steps = int(state["steps"])
