"""Chunked AR-decode methods of the AR models (mirrors
seq2seq_vc_tpu/models/chunked_decode.py).

A model whose constructor defines ``encode``, ``dprenet``/``dprenet_proj``,
``decoder`` (with ``init_cache``/``precompute_memory``/``step``),
``feat_out``, ``prob_out`` and ``postnet`` gets the chunked surface from
this mixin:

- ``decode_init``: encoder memory, projected cross K/V, the K/V caches and
  the per-item progress flags;
- ``decode_chunk``: ``chunk`` decode steps from step ``t0``, a Python loop
  whose stop flags stay on the device (the host reads nothing per step);
- ``decode_postnet`` / ``decode_out_lens``: final refinement and lengths.

``models/ar_driver.ChunkedARDecoder`` decides on the host when to stop.
Decoding runs with dropout off (the model in ``eval()`` mode), but for the
prenet's, which is always on and draws from the ``generator`` passed in.
"""

from typing import Any, Dict, Optional

import torch


def _budget(hlens: torch.Tensor, ratio: float, r: int) -> torch.Tensor:
    """Per-item step budget (hlens * ratio) // r in float32, as int32."""
    return torch.floor_divide(hlens.float() * ratio, r).to(torch.int32)


def step_stop(prob_r, t: int, threshold: float, minlen_b, maxlen_b, finished, out_len):
    """One step's stop bookkeeping (the JAX package's ``_decode_body``): an
    item finishes when a stop probability of its r frames reaches the
    threshold at a step of at least its minimum length, or at its maximum;
    its output length is the step count when it first finishes. Returns
    (finished, out_len)."""
    stop_now = (prob_r >= threshold).any(-1)
    done_now = (stop_now & (t + 1 >= minlen_b)) | (t + 1 >= maxlen_b)
    out_len = torch.where(~finished & done_now, t + 1, out_len)
    return finished | done_now, out_len


class ChunkedARDecodeMixin:
    def decode_init(self, xs, ilens, maxlenratio: float = 10.0,
                    round_budget_to: int = 1, spembs=None) -> Dict[str, Any]:
        """The chunked-decode state. The cache length (``state["maxlen"]``)
        is the step budget, rounded up to a multiple of ``round_budget_to``
        so that the chunk schedule can cover it with chunk sizes from a fixed set;
        each item's own stop point comes from its true encoder length.
        ``spembs`` (B, spk_embed_dim): the speaker embeddings, for a model
        with them (``encode``)."""
        if self.training:
            raise ValueError("decoding runs in eval() mode")
        r = self.decoder_reduction_factor
        B = xs.shape[0]
        hs, h_masks = self.encode(xs, ilens, spembs)
        t_mem = hs.shape[1]
        hlens = h_masks.sum(-1).to(torch.int32)
        maxlen = max(int(t_mem * maxlenratio / r), 1)
        rb = max(int(round_budget_to), 1)
        maxlen = -(-maxlen // rb) * rb
        return {
            "y_prev": torch.zeros(B, 1, self.odim, device=hs.device),
            "cache": self.decoder.init_cache(B, maxlen, hs.device),
            "mem_kv": self.decoder.precompute_memory(hs),
            "h_masks": h_masks,
            "hlens": hlens,
            "finished": torch.zeros(B, dtype=torch.bool, device=hs.device),
            "out_len": torch.zeros(B, dtype=torch.int32, device=hs.device),
            "maxlen": maxlen,
        }

    def decode_chunk(self, state: Dict[str, Any], t0: int, chunk: int,
                     threshold: float = 0.5, minlenratio: float = 0.0,
                     maxlenratio: float = 10.0, generator: Optional[torch.Generator] = None):
        """``chunk`` decode steps from step ``t0``. Returns (new state, outs
        (B, chunk*r, odim), probs (B, chunk*r), att (L, B, H, chunk, Tmem));
        the caches in ``state`` are written in place."""
        r = self.decoder_reduction_factor
        B = state["y_prev"].shape[0]
        maxlen_b = _budget(state["hlens"], maxlenratio, r).clamp_min(1)
        minlen_b = _budget(state["hlens"], minlenratio, r)
        y_prev, finished, out_len = state["y_prev"], state["finished"], state["out_len"]
        outs, probs, atts = [], [], []
        for t in range(t0, t0 + chunk):
            emb = self.dprenet_proj(self.dprenet(y_prev, generator))
            z, ca_w = self.decoder.step(emb, t, state["cache"], state["mem_kv"],
                                        state["h_masks"])
            out_r = self.feat_out(z).reshape(B, r, self.odim)
            prob_r = torch.sigmoid(self.prob_out(z))
            finished, out_len = step_stop(prob_r, t, threshold, minlen_b, maxlen_b, finished,
                                          out_len)
            y_prev = out_r[:, -1:, :]
            outs.append(out_r)
            probs.append(prob_r)
            atts.append(ca_w[:, :, :, 0, :])
        new_state = dict(state, y_prev=y_prev, finished=finished, out_len=out_len)
        return (new_state, torch.cat(outs, 1), torch.cat(probs, 1),
                torch.stack(atts, dim=3))

    def decode_postnet(self, outs, out_lens=None):
        """Postnet refinement of the assembled frames. ``out_lens`` (B,)
        valid frame counts: frames past an item's stop are zeroed before the
        postnet and after each of its layers, as the reference's postnet
        sees exactly the generated frames (zero padding past the stop)."""
        if self.postnet is None:
            return outs
        if out_lens is None:
            return outs + self.postnet(outs)
        valid = torch.arange(outs.shape[1], device=outs.device)[None, :] < out_lens[:, None]
        outs = torch.where(valid[..., None], outs, 0.0)
        return outs + self.postnet(outs, mask=valid)

    def decode_out_lens(self, state: Dict[str, Any], maxlenratio: float):
        """Final per-item output lengths in frames (steps * r)."""
        r = self.decoder_reduction_factor
        maxlen_b = _budget(state["hlens"], maxlenratio, r).clamp_min(1)
        return torch.where(state["finished"], state["out_len"], maxlen_b) * r
