"""AR TTS trainer (mirrors seq2seq_vc_tpu/train/ar_tts.py): the loss of
the AR VC trainer on ``TransformerTTS``, whose forward takes token ids and
already selects the guided maps (the first heads of the last layers,
(B, H' * L', T_out, T_in)), read against the token lengths with eos."""

from __future__ import annotations

from typing import Any, Dict

from .ar_vc import ARVCTrainer


class ARTTSTrainer(ARVCTrainer):
    def model_outputs(self, batch: Dict[str, Any], guided: bool, generator):
        out = self.model(batch["xs"], batch["ilens"], batch["ys"], batch["labels"],
                         batch["olens"], generator=generator)
        return out, ((out["att_ws"], out["ilens"]) if guided else None)
