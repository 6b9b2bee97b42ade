"""wav-in / wav-out conversion on the card (mirrors
seq2seq_vc_tpu/pipeline.py: ``Wav2WavConverter``, :26-302, and
``Wav2WavARConverter``, :305-560).

A NAR request (AAS-VC or FastSpeech-VC) runs log-mel analysis ->
normalisation -> the model's ``inference`` -> de-normalisation and vocoder
re-normalisation -> chunked HiFi-GAN, all on one device, with one host fetch of the predicted
length between the model and the synthesis stage. An AR request (VTN)
replaces the model stage with the chunked AR decode of
``models/ar_driver.ChunkedARDecoder``, whose host reads one stop flag per
chunk, and streams its vocoder by default: the synthesis of the decoded
prefix is enqueued after every chunk.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .device import resolve_device
from .dsp.features import _logmel
from .dsp.mel import mel_filterbank
from .dsp.stft import hann_window, num_frames
from .models.aas_vc import AASVC
from .models.ar_driver import ChunkedARDecoder
from .vocoder.hifigan import HifiganGenerator, chunked_generate


def _geom_bucket(n_frames: int, cap: int, base: int) -> int:
    """Smallest ``base * 2^k`` >= ``n_frames``, capped at ``cap``: the
    synthesis length ladder keeps the set of synthesis shapes small."""
    b = base
    while b < min(n_frames, cap):
        b *= 2
    return min(b, cap)


def _synth_ladder(cap: int, base: int) -> List[int]:
    """All bucket lengths ``_geom_bucket`` can produce for a given cap."""
    out = []
    b = base
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


class Wav2WavConverter:
    """End-to-end NAR VC + HiFi-GAN converter on one device.

    ``model`` (an ``AASVC`` or a ``FastSpeechVC``) and ``vocoder`` carry
    their weights; they are moved to ``device`` (default: the card) and put
    in eval mode.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        vocoder: HifiganGenerator,
        src_stats: Dict[str, np.ndarray],
        trg_stats: Dict[str, np.ndarray],
        config: Dict[str, Any],
        vocoder_stats: Optional[Dict[str, np.ndarray]] = None,
        bucket_frames: int = 128,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()
        self.config = config
        self.bucket_frames = bucket_frames
        self.fft_size = config.get("fft_size", 1024)
        self.hop_size = config.get("hop_size", 256)
        self.sr = config.get("sampling_rate", 16000)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self._window = dev(hann_window(config.get("win_length") or self.fft_size, self.fft_size))
        self._mel_t = dev(mel_filterbank(
            self.sr, self.fft_size, config.get("num_mels", 80),
            config.get("fmin") or 0, config.get("fmax") or self.sr / 2,
        ).T)
        self._src_mean, self._src_scale = dev(src_stats["mean"]), dev(src_stats["scale"])
        self._trg_mean, self._trg_scale = dev(trg_stats["mean"]), dev(trg_stats["scale"])
        voc = vocoder_stats if vocoder_stats is not None else trg_stats
        self._voc_mean, self._voc_scale = dev(voc["mean"]), dev(voc["scale"])
        self.last_out_frames = 0
        self.last_synth_cap = 0

    def _frame_geometry(self, padded_lens):
        """Shared bucket geometry for a set of reflect-padded lengths."""
        m = self.model
        pr, er, dr = (getattr(m, f"{k}_reduction_factor", 1)
                      for k in ("post_encoder", "encoder", "decoder"))
        q = int(np.lcm(np.lcm(self.bucket_frames, max(pr, 1) * max(er, 1)), max(dr, 1)))
        n_raw = max(1 + (L - self.fft_size) // self.hop_size for L in padded_lens)
        n_padded = ((n_raw + q - 1) // q) * q
        target_len = self.fft_size + (n_padded - 1) * self.hop_size
        max_out = (2 * n_padded) // max(dr, 1) + 8
        return n_padded, target_len, max_out

    def _generator(self, generator):
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    @torch.no_grad()
    def _convert(self, batch: np.ndarray, n_trues, max_out, generator):
        """(B, target_len) padded audio -> vocoder-normalised feats, out_lens."""
        x = torch.as_tensor(batch, device=self.device)
        mel = _logmel(x, self._window, self._mel_t, self.fft_size, self.hop_size, 10.0)
        mel = (mel - self._src_mean) / self._src_scale
        lens = torch.as_tensor(np.asarray(n_trues, np.int64), device=self.device)
        # only AAS-VC draws (its duration noise); FastSpeech-VC takes no generator
        noise = ({"generator": self._generator(generator)} if isinstance(self.model, AASVC)
                 else {})
        out = self.model.inference(
            mel, lens, mel,  # dp_input = source mel (melmelmel config)
            max_output_frames=max_out, **noise,
        )
        feats = out["outs"] * self._trg_scale + self._trg_mean
        feats = (feats - self._voc_mean) / self._voc_scale
        return feats, out["out_lens"].cpu().numpy()

    @torch.no_grad()
    def _synth(self, feats_i: torch.Tensor, n_frames: int) -> np.ndarray:
        n_bucket = _geom_bucket(n_frames, feats_i.shape[0], self.bucket_frames)
        wav = chunked_generate(self.vocoder, feats_i[:n_bucket])
        n_samples = min(n_frames * self.hop_size, wav.shape[0])
        return wav[:n_samples].cpu().numpy()

    def __call__(self, audio: np.ndarray, generator: Optional[torch.Generator] = None) -> np.ndarray:
        """audio (T,) float32 in [-1, 1] -> converted waveform (T',)."""
        return self.convert_batch([audio], generator=generator)[0]

    def convert_batch(self, audios, generator: Optional[torch.Generator] = None):
        """Convert several waveforms in ONE batched model call; each item
        then synthesises on its own length bucket. Returns waveforms in
        input order."""
        audios = [np.asarray(a, np.float32) for a in audios]
        if not audios:
            return []
        pad = self.fft_size // 2
        xs = [np.pad(a, (pad, pad), mode="reflect") for a in audios]
        n_trues = [num_frames(len(a), self.hop_size) for a in audios]
        n_padded, target_len, max_out = self._frame_geometry([len(x) for x in xs])
        batch = np.zeros((len(xs), target_len), np.float32)
        for i, x in enumerate(xs):
            n = min(len(x), target_len)
            batch[i, :n] = x[:n]
        feats, out_lens = self._convert(batch, n_trues, max_out, generator)
        self.last_synth_cap = int(feats.shape[1])
        wavs = []
        for i in range(len(audios)):
            self.last_out_frames = max(1, int(out_lens[i]))
            wavs.append(self._synth(feats[i], self.last_out_frames))
        return wavs

    def warmup_synth(self) -> int:
        """Run the whole ``_geom_bucket`` synthesis ladder once for the most
        recent conversion's feats budget, so no later request meets a
        synthesis shape for the first time. Returns the number of buckets."""
        cap = self.last_synth_cap
        if cap <= 0:
            return 0
        d = self.model.odim
        n = 0
        with torch.no_grad():
            for b in _synth_ladder(cap, self.bucket_frames):
                chunked_generate(self.vocoder, torch.zeros((b, d), device=self.device)).cpu()
                n += 1
        return n


class Wav2WavARConverter(Wav2WavConverter):
    """Wav->wav conversion through an AR model (VTN): batched log-mel
    analysis, the chunked AR decode (geometric chunks, speculative flag
    reads, an expected-length first chunk), the stat chain and chunked
    HiFi-GAN. Same serving surface as ``Wav2WavConverter`` (``__call__``,
    ``convert_batch``, ``warmup_synth``), and ``warmup_stream``.

    ``generator`` draws the prenet's always-on dropout; by default a
    generator on the device seeded with 0 per request.

    The vocoder streams by default, as the JAX package's converter does
    (``inference.stream_vocoder`` absent or true): after each decode chunk
    the postnet, the stat chain and a batched chunked HiFi-GAN of the
    decoded prefix are enqueued (``_stream_synth``), on the card on a
    second CUDA stream that waits on an event recorded after the chunk, so
    the synthesis overlaps the next chunk's decode and no stop-flag read
    waits on it. The speculation whose chunk count is the decode's kept
    count is the result; each item's waveform is trimmed to its
    ``out_lens[i] * hop`` samples. Each item's frames past its synthesis
    bucket repeat the bucket's last frame, the serial path's edge padding,
    so the two paths synthesise the same windows. A prefix is synthesised
    at ``_geom_bucket`` of its length under the decode's budget: its
    window counts come from the budget's ladder (below the budget, the
    same for every request), which ``warmup_stream`` runs.
    ``stream_vocoder=False`` (or ``inference.stream_vocoder: false``) is
    the serial path: each item synthesises after the decode, on its own
    length bucket.
    """

    def __init__(self, model, vocoder: HifiganGenerator, src_stats: Dict[str, np.ndarray],
                 trg_stats: Dict[str, np.ndarray], config: Dict[str, Any],
                 vocoder_stats: Optional[Dict[str, np.ndarray]] = None,
                 bucket_frames: int = 64, device=None):
        super().__init__(model, vocoder, src_stats, trg_stats, config, vocoder_stats,
                         bucket_frames, device)
        self._r = int(model.decoder_reduction_factor)
        self.ar_decode = ChunkedARDecoder.from_config(self.model, config.get("inference"))
        self.last_decode_steps = 0  # AR steps the last request's decode ran
        self.last_stream_budget = 0  # the last request's decode budget, in frames
        # the last streamed request: the kept speculation supplied the result,
        # and each chunk's synthesis-end event on the card
        self.last_stream_kept = False
        self.last_synth_done: List[Any] = []

    def warmup_stream(self, batch_sizes=(1,)) -> int:
        """Run the streamed synthesis's ladder (``_synth_ladder`` of the
        most recent streamed request's decode budget) at each of
        ``batch_sizes``, so that no later request meets a streamed synthesis
        shape for the first time below that budget. Returns the number of
        shapes run."""
        if self.last_stream_budget <= 0:
            return 0
        d = self.model.odim
        n = 0
        with torch.no_grad():
            for b in batch_sizes:
                for length in _synth_ladder(self.last_stream_budget, self.bucket_frames):
                    zeros = torch.zeros((b, length, d), device=self.device)
                    chunked_generate(self.vocoder, zeros).cpu()
                    n += 1
        return n

    def _prepare(self, audios):
        """Reflect-padded audio batch, true frame counts and the padded
        frame count (a multiple of the bucket and of r)."""
        pad = self.fft_size // 2
        xs = [np.pad(a, (pad, pad), mode="reflect") for a in audios]
        n_trues = [num_frames(len(a), self.hop_size) for a in audios]
        n_raw = max(1 + (len(x) - self.fft_size) // self.hop_size for x in xs)
        q = int(np.lcm(self.bucket_frames, max(self._r, 1)))
        n_padded = -(-n_raw // q) * q
        target_len = self.fft_size + (n_padded - 1) * self.hop_size
        batch = np.zeros((len(xs), target_len), np.float32)
        for i, x in enumerate(xs):
            n = min(len(x), target_len)
            batch[i, :n] = x[:n]
        return batch, n_trues

    def _voc_feats(self, outs: torch.Tensor) -> torch.Tensor:
        """De-normalised, then vocoder-normalised decoder features."""
        return (outs * self._trg_scale + self._trg_mean - self._voc_mean) / self._voc_scale

    def _stream_synth(self, outs_list, state):
        """The decoded prefix's waveforms on the device, with no host read:
        (wavs (B, T * hop), out_lens (B,) frames). Postnet over the
        concatenated chunks (``decode_out_lens`` masks each item's dead
        tail), the stat chain, the prefix gathered to ``_geom_bucket`` of
        its length under the decode's budget with each item's frames past
        its synthesis bucket (``_geom_bucket`` of its length, on the
        device) replaced by the bucket's last frame, then one batched
        chunked HiFi-GAN."""
        m = self.model
        lens = m.decode_out_lens(state, self.ar_decode.maxr)
        feats = self._voc_feats(m.decode_postnet(torch.cat(outs_list, 1), lens))
        B, cap, D = feats.shape
        n = _geom_bucket(cap, int(state["maxlen"]) * self._r, self.bucket_frames)
        # the bucket ladder made on the device (a host-to-device copy would
        # wait for the decode)
        steps = torch.arange(len(_synth_ladder(cap, self.bucket_frames)), device=feats.device)
        ladder = torch.clamp(self.bucket_frames * 2 ** steps, max=cap)
        need = torch.clamp(lens, min=1, max=cap).to(ladder.dtype)
        bucket = ladder[torch.searchsorted(ladder, need)]
        idx = torch.minimum(torch.arange(n, device=feats.device)[None, :], bucket[:, None] - 1)
        feats = torch.gather(feats, 1, idx[..., None].expand(B, n, D))
        return chunked_generate(self.vocoder, feats), lens

    @torch.no_grad()
    def convert_batch(self, audios, generator: Optional[torch.Generator] = None,
                      stream_vocoder: Optional[bool] = None):
        """Convert several waveforms with one batched AR decode (each item
        stops on its own). ``stream_vocoder`` (default: the config's
        ``inference.stream_vocoder``, else True) overlaps the synthesis
        with the decode; without it each item synthesises after the decode
        on its own length bucket. Returns waveforms in input order."""
        audios = [np.asarray(a, np.float32) for a in audios]
        if not audios:
            return []
        if stream_vocoder is None:
            stream_vocoder = bool((self.config.get("inference") or {}).get("stream_vocoder", True))
        batch, n_trues = self._prepare(audios)
        x = torch.as_tensor(batch, device=self.device)
        mel = _logmel(x, self._window, self._mel_t, self.fft_size, self.hop_size, 10.0)
        mel = (mel - self._src_mean) / self._src_scale
        lens = torch.as_tensor(np.asarray(n_trues, np.int64), device=self.device)
        spec: Dict[int, Any] = {}
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.last_synth_done = []

        def on_chunk(si, outs_list, state):
            self.last_stream_budget = int(state["maxlen"]) * self._r
            if side is None:
                wav, out_lens = self._stream_synth(outs_list, state)
                spec[len(outs_list)] = (wav.cpu(), out_lens.cpu(), None)
                return
            start = torch.cuda.Event()
            start.record()  # after the chunk (and its flag copy) on the decode's stream
            with torch.cuda.stream(side):
                side.wait_event(start)
                wav, out_lens = self._stream_synth(outs_list, state)
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in (wav, out_lens)]
                for h, t in zip(host, (wav, out_lens)):
                    h.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            # the decode's tensors that the second stream reads stay
            # allocated until its work is done
            for t in (*outs_list, state["finished"], state["out_len"], state["hlens"]):
                t.record_stream(side)
            self.last_synth_done.append(done)
            spec[len(outs_list)] = (*host, done)

        out = self.ar_decode(mel, lens, self._generator(generator),
                             est_steps=self.ar_decode.expected_steps(max(n_trues)),
                             on_chunk=on_chunk if stream_vocoder else None)
        self.last_decode_steps = int(out["outs"].shape[1]) // self._r
        self.last_synth_cap = int(out["outs"].shape[1])
        kept = spec.get(out["n_chunks_kept"])
        self.last_stream_kept = kept is not None
        if kept is not None:
            wavs, out_lens, done = kept
            if done is not None:
                done.synchronize()
            self.last_out_frames = max(1, int(out_lens[-1]))
            return [wavs[i, :max(1, int(out_lens[i])) * self.hop_size].numpy()
                    for i in range(len(audios))]
        feats = self._voc_feats(out["outs"])
        out_lens = out["out_lens"].cpu().numpy()
        wavs = []
        for i in range(len(audios)):
            self.last_out_frames = max(1, int(out_lens[i]))
            wavs.append(self._synth(feats[i], self.last_out_frames))
        return wavs
