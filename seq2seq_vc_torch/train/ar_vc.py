"""AR VC trainer (mirrors seq2seq_vc_tpu/train/ar_vc.py): the VTN's
teacher-forced step with Seq2SeqLoss (L1 + stop BCE). The guided-attention
term and dev-sample generation (``generate_intermediate``) are not ported
yet and refuse loudly."""

from __future__ import annotations

from typing import Any, Dict

from .trainer import Trainer


class ARVCTrainer(Trainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.config.get("use_guided_attn_loss", False):
            raise NotImplementedError("the guided-attention loss is not ported yet")

    def loss_fn(self, batch: Dict[str, Any], flags, generator):
        out = self.model(batch["xs"], batch["ilens"], batch["ys"], batch["labels"],
                         batch["olens"], generator=generator)
        l1_loss, bce_loss = self.criterion["Seq2SeqLoss"](
            out["after_outs"], out["before_outs"], out["logits"], out["ys"], out["labels"],
            out["olens"],
        )
        return l1_loss + bce_loss, {"l1_loss": l1_loss, "bce_loss": bce_loss}
