"""AAS-VC trainer (mirrors seq2seq_vc_tpu/train/aas_vc.py): L1 +
lambda_align * (forward-sum + binarisation) + the duration loss, gated by
``dp_train_start_steps``: ``DurationPredictorLoss`` of the deterministic
predictor against the MAS durations where the criteria name it, else the
stochastic predictor's NLL.

The forward-sum prior depends only on the lengths, so it is built on the
host from the numpy batch (cached per length pair) and goes to the device
with the batch; the CTC takes the same host lengths. At each evaluation,
``generate_intermediate`` runs ``AASVC.inference`` on the first dev batch
(the duration noise from a CPU generator seeded 0).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.common import conv2d_subsampled_lengths
from ..ops.forward_sum import beta_binomial_prior, forward_sum_loss
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
        ilens = batch["ilens"].astype(np.int64) // m.encoder_reduction_factor
        t_text = batch["xs"].shape[1] // m.encoder_reduction_factor
        if m.encoder_input_layer == "conv2d":
            ilens, t_text = conv2d_subsampled_lengths(ilens), conv2d_subsampled_lengths(t_text)
        ilens = ilens // m.post_encoder_reduction_factor
        t_text = t_text // m.post_encoder_reduction_factor
        olens = batch["olens"].astype(np.int64) // dr
        return ilens, olens, t_text, batch["ys"].shape[1] // dr

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
        loss = torch.zeros((), device=out["after_outs"].device)
        if "L1Loss" in self.criterion:
            l1 = self.criterion["L1Loss"](
                out["after_outs"], out["before_outs"], out["ys"], out["olens"]
            )
            loss = loss + l1
            metrics["l1_loss"] = l1
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
        n = self._intermediate_items(batch)
        xs = torch.from_numpy(batch["xs"][:n]).to(self.device)
        ilens = torch.from_numpy(batch["ilens"][:n]).long().to(self.device)
        dp = batch.get("dp_inputs")
        dp = None if dp is None else torch.from_numpy(dp[:n]).to(self.device)
        out = self.model.inference(xs, ilens, dp, max_output_frames=2 * xs.shape[1] + 8,
                                   generator=torch.Generator().manual_seed(0))
        save_intermediate(outdir, batch, out["outs"].float().cpu().numpy(),
                          out["out_lens"].tolist())
