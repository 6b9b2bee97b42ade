"""AAS-VC trainer (mirrors seq2seq_vc_tpu/train/aas_vc.py): L1 (where the
criteria name it) + ``DiffSingerL2Loss`` between the diffusion decoder's
injected and predicted noise on the reduced frame grid (where they name
it) + lambda_align * (forward-sum + binarisation) + the duration loss,
gated by ``dp_train_start_steps``: ``DurationPredictorLoss`` of the
deterministic predictor against the MAS durations where the criteria name
it, else the stochastic predictor's NLL. The diffusion decoder's step and
noise come from the trainer's generator, as the duration noise does.

The forward-sum prior depends only on the lengths, so it is built on the
host from the numpy batch (cached per length pair) and goes to the device
with the batch; the CTC takes the same host lengths. At each evaluation,
``generate_intermediate`` runs ``AASVC.inference`` on the first dev batch
(the duration noise and a diffusion decoder's samples from a CPU generator
seeded 0, as JAX's ``PRNGKey(0)``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.forward_sum import beta_binomial_prior, forward_sum_loss
from ..parallel import mesh
from .trainer import Trainer, save_intermediate


class AASVCTrainer(Trainer):
    def _flags(self):
        # whether the duration-predictor loss is active
        return (self.steps >= self.config.get("dp_train_start_steps", 0),)

    def _reduced_lengths(self, batch):
        """Host-side replica of the model's length reductions (the prior
        and the CTC lengths are built outside the model): frame stacking,
        and a ``conv2d`` input layer's x4 subsampling."""
        m = self.model
        dr = m.decoder_reduction_factor
        olens = batch["olens"].astype(np.int64) // dr
        return (m.text_frames(batch["ilens"].astype(np.int64)), olens,
                m.text_frames(batch["xs"].shape[1]), batch["ys"].shape[1] // dr)

    def _array_batch(self, batch):
        ilens_r, olens_r, t_text, t_feats = self._reduced_lengths(batch)
        arrays = super()._array_batch(
            dict(batch, bb_prior=beta_binomial_prior(ilens_r, olens_r, t_text, t_feats))
        )
        arrays["ctc_lens"] = (ilens_r.tolist(), olens_r.tolist())
        return arrays

    def loss_fn(self, batch: Dict[str, Any], flags, generator):
        (dp_active,) = flags
        out = self.model(
            batch["xs"], batch["ilens"], batch["ys"], batch["olens"],
            batch.get("dp_inputs"), batch.get("dplens"), generator=generator,
        )
        metrics: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), device=out["bin_loss"].device)
        if "L1Loss" in self.criterion:
            l1 = self.criterion["L1Loss"](
                out["after_outs"], out["before_outs"], out["ys"], out["olens"]
            )
            loss = loss + l1
            metrics["l1_loss"] = l1
        if "DiffSingerL2Loss" in self.criterion:
            l2 = self.criterion["DiffSingerL2Loss"](
                out["noise"], out["x_recon"], out["olens_reduced"])
            loss = loss + l2
            metrics["diffsinger_l2_loss"] = l2
        ilens_r, olens_r = batch["ctc_lens"]
        fsum = forward_sum_loss(out["log_p_attn"] + batch["bb_prior"], ilens_r, olens_r)
        bin_loss = out["bin_loss"]
        loss = loss + self.config.get("lambda_align", 2.0) * (fsum + bin_loss)
        metrics["forward_sum_loss"] = fsum
        metrics["binary_loss"] = bin_loss
        if dp_active:
            if "DurationPredictorLoss" in self.criterion:
                dur = self.criterion["DurationPredictorLoss"](
                    out["d_outs"], out["ds"], out["ilens"])
            else:  # stochastic: the NLL comes from the forward pass
                dur = out["dur_nll"]
            loss = loss + dur
            metrics["duration_loss"] = dur
        return loss, metrics

    def generate_intermediate(self, batch: Dict[str, Any], outdir: str):
        n, rows = self._intermediate_items(batch), self._intermediate_rows(batch)
        xs = torch.from_numpy(batch["xs"][rows]).to(self.device)
        ilens = torch.from_numpy(batch["ilens"][rows]).long().to(self.device)
        dp = batch.get("dp_inputs")
        dp = None if dp is None else torch.from_numpy(dp[rows]).to(self.device)
        out = self.model.inference(xs, ilens, dp, max_output_frames=2 * xs.shape[1] + 8,
                                   generator=torch.Generator().manual_seed(0))
        if mesh.is_coordinator():
            save_intermediate(outdir, batch, out["outs"][:n].float().cpu().numpy(),
                              out["out_lens"][:n].tolist())
