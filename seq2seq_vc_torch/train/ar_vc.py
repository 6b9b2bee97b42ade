"""AR VC trainer (mirrors seq2seq_vc_tpu/train/ar_vc.py): the VTN's
teacher-forced step with Seq2SeqLoss (L1 + stop BCE), plus the
guided-attention term when the config sets ``use_guided_attn_loss`` and
the criteria hold ``guided_attn`` (all L x H cross-attention maps, against
the subsampled source lengths ``ilens_ds_st``); the model builds the maps
only then. At each evaluation ``generate_intermediate`` runs the chunked
AR decode of the first dev batch with the config's ``inference`` block
(the prenet's dropout from a CPU generator seeded 0)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.ar_driver import ChunkedARDecoder
from .trainer import Trainer, save_intermediate


class ARVCTrainer(Trainer):
    def guided_attn(self):
        """The guided-attention criterion, or None when the loss is off."""
        if not self.config.get("use_guided_attn_loss", False):
            return None
        return self.criterion.get("guided_attn")

    def model_outputs(self, batch: Dict[str, Any], guided: bool,
                generator) -> Tuple[Dict[str, Any], Optional[Tuple[Any, Any]]]:
        """The model's outputs and, with ``guided``, (the maps the guided
        loss reads, (B, heads..., T_out, T_in), their input lengths)."""
        out = self.model(batch["xs"], batch["ilens"], batch["ys"], batch["labels"],
                         batch["olens"], need_att_ws=guided, generator=generator)
        # (L, B, H, T_out, T_in) viewed as (B, L, H, ...): every map, every head
        return out, ((out["att_ws"].transpose(0, 1), out["ilens_ds_st"]) if guided else None)

    def loss_fn(self, batch: Dict[str, Any], flags, generator):
        ga = self.guided_attn()
        out, att = self.model_outputs(batch, ga is not None, generator)
        l1_loss, bce_loss = self.criterion["Seq2SeqLoss"](
            out["after_outs"], out["before_outs"], out["logits"], out["ys"], out["labels"],
            out["olens"],
        )
        loss = l1_loss + bce_loss
        metrics = {"l1_loss": l1_loss, "bce_loss": bce_loss}
        if ga is not None:
            ga_loss = ga(att[0], att[1], out["olens_in"])
            loss = loss + ga_loss
            metrics["guided_attn_loss"] = ga_loss
        return loss, metrics

    def generate_intermediate(self, batch: Dict[str, Any], outdir: str):
        n = self._intermediate_items(batch)
        xs = torch.from_numpy(batch["xs"][:n]).to(self.device)
        ilens = torch.from_numpy(batch["ilens"][:n]).long().to(self.device)
        drv = ChunkedARDecoder.from_config(self.model, self.config.get("inference"))
        out = drv(xs, ilens, torch.Generator().manual_seed(0),
                  est_steps=drv.expected_steps(int(batch["ilens"][:n].max())))
        save_intermediate(outdir, batch, out["outs"].float().cpu().numpy(),
                          out["out_lens"].tolist(), out["probs"].float().cpu().numpy())
