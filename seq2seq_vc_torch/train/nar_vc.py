"""FastSpeech-VC trainer (mirrors seq2seq_vc_tpu/train/nar_vc.py): L1 +
``DurationPredictorLoss`` against the teacher durations.

Like the JAX trainer it has no ``generate_intermediate``, so an evaluation
writes no predictions. Every random draw of its step is a dropout, from
torch's default generators (``train/trainer.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch.nn.functional as F

from .trainer import Trainer


class NARVCTrainer(Trainer):
    def loss_fn(self, batch: Dict[str, Any], flags, generator):
        out = self.model(
            batch["xs"], batch["ilens"], batch["ys"], batch["olens"], batch["durations"],
            batch.get("duration_lens"), batch.get("dp_inputs"), batch.get("dplens"),
        )
        l1 = self.criterion["L1Loss"](
            out["after_outs"], out["before_outs"], out["ys"], out["olens"]
        )
        # teacher durations are frame counts, the predictor's output is in
        # the log domain; the separately padded durations are cropped or
        # padded to the predictor's grid
        T_d = out["d_outs"].shape[1]
        ds = batch["durations"][:, :T_d]
        if ds.shape[1] < T_d:
            ds = F.pad(ds, (0, T_d - ds.shape[1]))
        dur = self.criterion["DurationPredictorLoss"](out["d_outs"], ds, out["ilens"])
        return l1 + dur, {"l1_loss": l1, "duration_loss": dur}
