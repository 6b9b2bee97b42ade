"""AR VC trainer (mirrors seq2seq_vc_tpu/train/ar_vc.py): the VTN's
teacher-forced step with Seq2SeqLoss (L1 + stop BCE), and at each
evaluation ``generate_intermediate``: the chunked AR decode of the first
dev batch with the config's ``inference`` block (the prenet's dropout from a
CPU generator seeded 0). The guided-attention term is not ported yet and
refuses loudly."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.ar_driver import ChunkedARDecoder
from .trainer import Trainer, save_intermediate


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

    def generate_intermediate(self, batch: Dict[str, Any], outdir: str):
        n = self._intermediate_items(batch)
        xs = torch.from_numpy(batch["xs"][:n]).to(self.device)
        ilens = torch.from_numpy(batch["ilens"][:n]).long().to(self.device)
        drv = ChunkedARDecoder.from_config(self.model, self.config.get("inference"))
        out = drv(xs, ilens, torch.Generator().manual_seed(0),
                  est_steps=drv.expected_steps(int(batch["ilens"][:n].max())))
        save_intermediate(outdir, batch, out["outs"].float().cpu().numpy(),
                          out["out_lens"].tolist(), out["probs"].float().cpu().numpy())
