"""Host-side loop of the chunked AR decode (mirrors
seq2seq_vc_tpu/models/ar_driver.py): geometric chunk growth and
speculative reads of the stop flags.

- **Geometric schedule**: chunk sizes double from ``base_chunk`` up to
  ``max_chunk``, each a power-of-two multiple of ``base_chunk``, so a decode
  of T steps makes O(log T) host decisions; an expected-length first chunk
  (``est_steps``) usually covers the whole decode.
- **Speculative reads**: after chunk i is enqueued, the all-finished flag
  of chunk i is copied to pinned host memory behind it and an event is
  recorded; the host waits on that event only after enqueuing chunk i + 1,
  so the card keeps working while the host reads. A chunk enqueued past the
  stop produces only dead frames (finished items keep their ``out_len``)
  and is dropped, so the result equals the serial loop's, frame for frame.
- **The chunk hook** (``on_chunk``, the streamed vocoder's synthesis of
  the decoded prefix) is called after the chunk's flag copy is enqueued,
  so no flag read waits on the work the hook enqueues.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch


def chunk_schedule(maxlen: int, base: int, max_chunk: int, first: int = 0) -> List[int]:
    """Chunk sizes covering ``maxlen`` steps: doubling from ``base``, capped
    at ``max_chunk``, shrunk to the largest power-of-two multiple of ``base``
    that fits the remainder. ``maxlen`` must be a multiple of ``base``.

    ``first`` > 0 asks for an expected-length first chunk: the smallest
    power-of-two multiple of ``base`` >= ``first``, clamped to the budget;
    the tail continues doubling from ``base``."""
    assert maxlen % base == 0 and maxlen > 0, (maxlen, base)
    sizes = []
    cur = base
    t0 = 0
    if first > 0:
        f = base
        while f < first and f < maxlen:
            f *= 2
        while f > maxlen:
            f //= 2
        sizes.append(f)
        t0 = f
    while t0 < maxlen:
        s = min(cur, max_chunk, maxlen - t0)
        p2 = base
        while p2 * 2 <= s:
            p2 *= 2
        sizes.append(p2)
        t0 += p2
        cur = min(cur * 2, max_chunk)
    return sizes


def _enqueue_all_finished(finished: torch.Tensor):
    """Start reading ``finished.all()`` on the host: (host value, event or
    None). On the card the copy goes to pinned memory behind the work
    enqueued so far; ``_read`` waits for it."""
    done = finished.all()
    if done.device.type != "cuda":
        return done, None
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(done, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _read(pending) -> bool:
    host, event = pending
    if event is not None:
        event.synchronize()
    return bool(host)


class ChunkedARDecoder:
    """Drives a model's ``decode_init``/``decode_chunk``/``decode_postnet``/
    ``decode_out_lens`` with the geometric and speculative host loop.
    Returns the dict of the model's single-loop ``inference``: outs, probs,
    att_ws, out_lens, and ``n_chunks_kept``."""

    def __init__(self, model, threshold: float = 0.5, minlenratio: float = 0.0,
                 maxlenratio: float = 6.0, base_chunk: int = 32, max_chunk: int = 256,
                 speculate: bool = True, est_len_ratio: float = 1.2):
        self.model = model
        self.thr = float(threshold)
        self.minr = float(minlenratio)
        self.maxr = float(maxlenratio)
        self.base = int(base_chunk)
        self.max_chunk = max(int(max_chunk), self.base)
        self.speculate = speculate
        self.est_len_ratio = float(est_len_ratio)

    @classmethod
    def from_config(cls, model, inference: Optional[Dict[str, Any]] = None) -> "ChunkedARDecoder":
        """The decoder of a config's ``inference`` block: ``threshold``,
        ``minlenratio``, ``maxlenratio``, ``decode_chunk_steps``,
        ``decode_max_chunk_steps`` and ``decode_est_len_ratio`` (the JAX
        package's keys and defaults)."""
        inf = inference or {}
        return cls(model, threshold=inf.get("threshold", 0.5),
                   minlenratio=inf.get("minlenratio", 0.0),
                   maxlenratio=inf.get("maxlenratio", 6.0),
                   base_chunk=int(inf.get("decode_chunk_steps", 32)),
                   max_chunk=int(inf.get("decode_max_chunk_steps", 256)),
                   est_len_ratio=float(inf.get("decode_est_len_ratio", 1.2)))

    def expected_steps(self, max_ilen: int) -> int:
        """The first chunk's expected step count for sources of at most
        ``max_ilen`` frames: ``est_len_ratio`` times the source length in
        decoder steps (0: the geometric schedule alone)."""
        return int(np.ceil(self.est_len_ratio * max_ilen / self.model.decoder_reduction_factor))

    @torch.no_grad()
    def __call__(self, xs, ilens, generator: Optional[torch.Generator] = None,
                 est_steps: int = 0, on_chunk=None) -> Dict[str, Any]:
        """``est_steps`` > 0: the expected step count, which sizes the first
        chunk. ``on_chunk(chunk_idx, outs_list, state)`` runs right after
        each chunk and its flag copy are enqueued, before the host waits on
        any flag; it must only enqueue device work."""
        m = self.model
        st = m.decode_init(xs, ilens, self.maxr, round_budget_to=self.base)
        sizes = chunk_schedule(st["maxlen"], self.base, self.max_chunk, est_steps)
        outs_c, probs_c, att_c = [], [], []
        pending = None  # the flags from before the most recently enqueued chunk
        t0 = 0
        for si, s in enumerate(sizes):
            st, outs, probs, att = m.decode_chunk(st, t0, s, self.thr, self.minr, self.maxr,
                                                  generator)
            outs_c.append(outs)
            probs_c.append(probs)
            att_c.append(att)
            t0 += s
            flag = _enqueue_all_finished(st["finished"])  # ahead of the hook's work
            if on_chunk is not None:
                on_chunk(si, list(outs_c), st)
            if self.speculate:
                # everything had finished before this chunk: it was dead work
                if pending is not None and _read(pending):
                    outs_c.pop(), probs_c.pop(), att_c.pop()
                    break
                pending = flag
            elif _read(flag):
                break
        out_lens = m.decode_out_lens(st, self.maxr)
        return {
            "outs": m.decode_postnet(torch.cat(outs_c, 1), out_lens),
            "probs": torch.cat(probs_c, 1),
            "att_ws": torch.cat(att_c, 3),
            "out_lens": out_lens,
            "n_chunks_kept": len(outs_c),
        }
