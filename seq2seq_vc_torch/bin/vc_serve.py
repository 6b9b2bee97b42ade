"""Resident wav->wav conversion server (mirrors
seq2seq_vc_tpu/bin/vc_serve.py:46-449).

    python -m seq2seq_vc_torch.bin.vc_serve --checkpoint exp/checkpoint-<N>steps.pt \
        --src-stats src.npz --trg-stats trg.npz --vocoder-checkpoint hifigan.pt \
        [--vocoder-config hifigan.yaml] [--port N --max-batch B]

AAS-VC and FastSpeech-VC checkpoints ride ``pipeline.Wav2WavConverter``
(log-mel -> normalisation -> conversion -> stat chain -> chunked HiFi-GAN
on the card); VTN checkpoints ride ``pipeline.Wav2WavARConverter`` (the
chunked AR decode), which streams its vocoder as the JAX server does: the
synthesis of the decoded prefix runs beside the decode, and the config's
``inference.stream_vocoder: false`` turns that off (synthesis after the
decode). The model loads once; every request after the warm-up finds its
weights and kernels on the card.

Protocols (one ``<in_wav> <out_wav>`` request per line, one JSON result
line per request):

- stdio (default): requests on stdin, results on stdout; an empty line or
  EOF ends the session.
- TCP (``--port N``): the same per connection; the card runs one request
  (or micro-batch) at a time behind a lock. With ``--max-batch B``,
  requests that arrive within ``--batch-window-ms`` of each other run as one
  ``convert_batch``, padded to the next power of two (at most B) by
  repeating the first; the warm-up runs every batch size that padding can
  form. SIGTERM/SIGINT drain (no new work, wait for the lock) and exit;
  ``--max-idle-seconds`` exits after that long without a request, but
  never while one runs (``ConversionService.busy``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import sys
import threading
import time
from typing import List

import numpy as np
import torch

from ..core.config import load_config
from ..device import resolve_device
from ..pipeline import Wav2WavARConverter, Wav2WavConverter
from ..utils.audio import read_wav, resample, write_wav
from ..utils.io import read_stats
from ..vocoder.hifigan import load_hifigan_model
from . import setup
from .vc_decode import load_model


def build_converter(args) -> Wav2WavConverter:
    """Checkpoint, config, stats and vocoder -> the converter on ``args.device``."""
    device = resolve_device(args.device)
    config = load_config(args.config or os.path.join(os.path.dirname(args.checkpoint),
                                                     "config.yml"))
    model_type = config["model_type"]
    if model_type not in ("AASVC", "FastSpeechVC", "VTN"):
        raise NotImplementedError(f"vc_serve hosts AASVC and FastSpeechVC (NAR pipeline) and "
                                  f"VTN (chunked AR pipeline) in the port; got {model_type!r}")
    model = load_model(config, args.checkpoint, "cpu")
    logging.info("restored model from %s", args.checkpoint)
    vocoder = load_hifigan_model(args.vocoder_checkpoint, args.vocoder_config, "cpu")
    logging.info("restored vocoder from %s", args.vocoder_checkpoint)
    cls = Wav2WavARConverter if model_type == "VTN" else Wav2WavConverter
    return cls(model, vocoder, read_stats(args.src_stats, args.feat_type),
               read_stats(args.trg_stats, args.feat_type), config,
               vocoder_stats=read_stats(args.vocoder_stats) if args.vocoder_stats else None,
               bucket_frames=args.bucket_frames, device=device)


def padded_batch(n: int, max_batch: int) -> int:
    """The batch size ``n`` queued requests run at: the next power of two,
    at most ``max_batch`` (the fewer distinct batch shapes, the fewer the
    cold ones)."""
    p = 1
    while p < n:
        p *= 2
    return min(p, max_batch)


def batch_sizes(max_batch: int) -> List[int]:
    """Every batch size above 1 that the dispatcher can form."""
    return sorted({padded_batch(n, max_batch) for n in range(2, max_batch + 1)})


class _Request:
    __slots__ = ("audio", "event", "result", "error", "batch_n")

    def __init__(self, audio):
        self.audio = audio
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batch_n = 1


class ConversionService:
    """Thread-safe wrapper: one conversion on the card at a time, with
    micro-batching of concurrent requests when ``max_batch > 1``. Each
    dispatch draws its noise from a CPU generator seeded with its count."""

    def __init__(self, converter, sr: int, max_batch: int = 1, batch_window_ms: float = 8.0):
        self.converter = converter
        self.sr = sr
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = float(batch_window_ms) / 1e3
        self._lock = threading.Lock()
        self._n = 0
        self._queue = None
        self.last_activity = time.time()
        if self.max_batch > 1:
            self._queue = queue.Queue()
            threading.Thread(target=self._dispatch_loop, daemon=True).start()

    def _next_generator(self) -> torch.Generator:
        self._n += 1
        return torch.Generator().manual_seed(self._n)

    def busy(self) -> bool:
        """True while a conversion runs or requests are queued: the idle
        watchdog must not count a long request as idleness."""
        if self._lock.locked():
            return True
        return self._queue is not None and not self._queue.empty()

    def _run(self, audio):
        """Convert one waveform; returns (wav, the batch size it rode in)."""
        self.last_activity = time.time()
        try:
            if self._queue is None:
                with self._lock:
                    return self.converter(audio, generator=self._next_generator()), 1
            req = _Request(audio)
            self._queue.put(req)
            req.event.wait()
            if req.error is not None:
                raise req.error
            return req.result, req.batch_n
        finally:
            # idleness counts from the end of the last request, not its start
            self.last_activity = time.time()

    def _dispatch_loop(self):
        while True:
            batch = [self._queue.get()]
            deadline = time.time() + self.batch_window_s
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get(timeout=max(0.0, deadline - time.time())))
                except queue.Empty:
                    break
            try:
                with self._lock:
                    generator = self._next_generator()
                    if len(batch) == 1:
                        outs = [self.converter(batch[0].audio, generator=generator)]
                    else:
                        audios = [r.audio for r in batch]
                        audios += [audios[0]] * (padded_batch(len(batch), self.max_batch)
                                                 - len(batch))
                        outs = self.converter.convert_batch(audios, generator=generator)
                for req, out in zip(batch, outs):
                    req.result = out
                    req.batch_n = len(batch)
                    req.event.set()
            except Exception as e:  # deliver the failure to every waiter, keep serving
                for req in batch:
                    req.error = e
                    req.event.set()

    def warmup(self, seconds):
        """Convert silence of each duration once, run the synthesis ladder
        (and an AR converter's streamed ladder at every batch size the
        dispatcher can form), and every batch size the dispatcher can form."""
        for s in seconds:
            silence = np.zeros(int(self.sr * s), np.float32)
            t0 = time.time()
            self.converter(silence)
            logging.info("warmup %.1fs bucket: %.1fs", s, time.time() - t0)
            t0 = time.time()
            n = self.converter.warmup_synth()
            logging.info("warmup %.1fs synth ladder (%d buckets): %.1fs", s, n, time.time() - t0)
            warmup_stream = getattr(self.converter, "warmup_stream", None)  # an AR converter's
            if warmup_stream is not None:
                t0 = time.time()
                n = warmup_stream([1] + batch_sizes(self.max_batch))
                logging.info("warmup %.1fs streamed synth ladder (%d shapes): %.1fs", s, n,
                             time.time() - t0)
            if self.max_batch > 1:
                for b in batch_sizes(self.max_batch):
                    t0 = time.time()
                    self.converter.convert_batch([silence] * b)
                    logging.info("warmup %.1fs bucket B=%d: %.1fs", s, b, time.time() - t0)

    def convert_file(self, in_path: str, out_path: str) -> dict:
        t0 = time.time()
        audio, sr = read_wav(in_path)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        if sr != self.sr:
            audio = resample(audio.astype(np.float32), sr, self.sr)
        in_secs = len(audio) / self.sr
        y, batch_n = self._run(audio.astype(np.float32))
        write_wav(out_path, y, self.sr)
        dt = time.time() - t0
        return {
            "ok": True,
            "out": out_path,
            "input_seconds": round(in_secs, 3),
            "output_seconds": round(len(y) / self.sr, 3),
            "wall_ms": round(dt * 1e3, 1),
            "rtf": round(dt / max(in_secs, 1e-6), 4),
            "batch": batch_n,
        }

    def handle_line(self, line: str) -> str:
        parts = line.split()
        if len(parts) != 2:
            return json.dumps({"ok": False, "error": "expected '<in_wav> <out_wav>'"})
        try:
            return json.dumps(self.convert_file(parts[0], parts[1]))
        except Exception as e:  # report the failure to the client, keep serving
            logging.exception("request failed: %s", line)
            return json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"})


def serve_stdio(service: ConversionService):
    logging.info("serving on stdio (one '<in_wav> <out_wav>' per line)")
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            break
        print(service.handle_line(line), flush=True)


def serve_tcp(service: ConversionService, host: str, port: int, max_idle_seconds: float = 0.0):
    """TCP line server. SIGTERM/SIGINT (in the main thread) drain and
    return; ``max_idle_seconds > 0`` shuts the server down after that long
    without a request, never during one."""
    import signal
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    break
                self.wfile.write((service.handle_line(line) + "\n").encode())
                self.wfile.flush()

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as srv:
        def _graceful(signum, frame):
            logging.info("signal %d: draining and shutting down", signum)
            threading.Thread(target=srv.shutdown, daemon=True).start()

        old_handlers = {}
        if threading.current_thread() is threading.main_thread():
            old_handlers = {s: signal.signal(s, _graceful) for s in (signal.SIGTERM, signal.SIGINT)}
        if max_idle_seconds and max_idle_seconds > 0:
            def _watchdog():
                while True:
                    time.sleep(min(30.0, max_idle_seconds / 2))
                    if service.busy():
                        continue
                    idle = time.time() - service.last_activity
                    if idle > max_idle_seconds:
                        logging.info("idle %.0fs > --max-idle-seconds %.0f: exiting", idle,
                                     max_idle_seconds)
                        threading.Thread(target=srv.shutdown, daemon=True).start()
                        return

            threading.Thread(target=_watchdog, daemon=True).start()
        logging.info("serving on %s:%d", host, srv.server_address[1])
        print(json.dumps({"ready": True, "port": srv.server_address[1]}), flush=True)
        srv.serve_forever()
        with service._lock:  # drain: the conversion in flight finishes first
            pass
        for s, h in old_handlers.items():
            signal.signal(s, h)
        logging.info("drained; exiting cleanly")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Resident wav->wav VC server (PyTorch port). A VTN streams its vocoder "
                    "beside the decode unless the config says inference.stream_vocoder: false.")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None, help="defaults to <ckpt_dir>/config.yml")
    parser.add_argument("--src-stats", required=True, help=".npz or .h5")
    parser.add_argument("--trg-stats", required=True, help=".npz or .h5")
    parser.add_argument("--vocoder-checkpoint", required=True,
                        help="HiFi-GAN state dict in the port's format (torch.save)")
    parser.add_argument("--vocoder-config", default=None,
                        help="YAML with the generator's generator_params")
    parser.add_argument("--vocoder-stats", default=None)
    parser.add_argument("--feat-type", default="mel")
    parser.add_argument("--bucket-frames", type=int, default=128,
                        help="input length quantum of the converter")
    parser.add_argument("--warmup-seconds", default="2",
                        help="comma-separated durations to warm up ('' = none)")
    parser.add_argument("--max-batch", type=int, default=1,
                        help="micro-batch concurrent requests (TCP mode; 1 = off)")
    parser.add_argument("--batch-window-ms", type=float, default=8.0,
                        help="how long the dispatcher waits for co-riders")
    parser.add_argument("--port", type=int, default=None,
                        help="TCP port (0 = ephemeral); default stdio mode")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--max-idle-seconds", type=float, default=0.0,
                        help="TCP mode: exit after this long without a request (0 = never)")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)

    converter = build_converter(args)
    service = ConversionService(converter, converter.sr, max_batch=args.max_batch,
                                batch_window_ms=args.batch_window_ms)
    if args.warmup_seconds:
        service.warmup([float(s) for s in args.warmup_seconds.split(",") if s])
    if args.port is None:
        serve_stdio(service)
    else:
        serve_tcp(service, args.host, args.port, max_idle_seconds=args.max_idle_seconds)


if __name__ == "__main__":
    main()
