#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``seq2seq_vc_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed on lines of its own:

1. the card (``nvidia-smi`` name and power limit), the TF32 switches (both
   off), and the build of every CUDA kernel from ``seq2seq_vc_torch/csrc``
   (one ``nvcc`` per source, started together);
2. warm-up: a full-width ``Wav2WavConverter`` (the AAS-VC flagship of
   ``egs/arctic/vc2/conf/aas_vc.melmelmel.v1.yaml`` and the HiFi-GAN that
   ``bench.py`` serves) with seeded random weights serves a 3.8 s clip, a
   batch of 4 and a 30 s clip whose decoder key length crosses the flash
   gate, then runs its synthesis ladder once;
3. each kernel against its plain PyTorch version on the same inputs, in
   float32 and bfloat16 at the flagship's two head dims (encoder D 192 at
   T 640, decoder D 768 at T 1300), and in bfloat16 at every shape and key
   length that the main path gave it in phase 2: max abs error against the
   stated tolerance, the kernel's time, the plain version's, the library
   yardstick's and the bound (bytes over 3.35 TB/s or operations over the
   type's peak);
4. the main path: the same requests again, timed. The kernels' launch
   counts are set to 0 just before and read just after; each must equal
   what the routing predicts, and be above 0;
5. a reference check: the same weights in float32 convert one short clip on
   the card (through both kernels) and on the CPU (through their plain
   versions), and the waveforms must agree;
6. a profile of the 30 s request: device time by kernel (torch.profiler)
   and the device's busy share of the request's untraced latency.

Then the ``kernels`` JSON line, the card line again, and last the result
line. Any failed check makes the script exit with 1 without the result line;
with no CUDA device it exits at once.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores

# model_params of egs/arctic/vc2/conf/aas_vc.melmelmel.v1.yaml (keys that
# only training reads are accepted and ignored by AASVC)
FLAGSHIP = dict(
    idim=80, odim=80, adim=384, aheads=2, elayers=4, eunits=1536, dlayers=4,
    dunits=1536, positionwise_layer_type="linear", positionwise_conv_kernel_size=1,
    duration_predictor_use_encoder_outputs=False, duration_predictor_input_dim=80,
    duration_predictor_layers=2, duration_predictor_chans=256,
    duration_predictor_kernel_size=3, postnet_layers=5, postnet_filts=5,
    postnet_chans=256, use_masking=True, encoder_normalize_before=True,
    decoder_normalize_before=True, encoder_reduction_factor=1,
    post_encoder_reduction_factor=4, decoder_reduction_factor=1,
    encoder_type="conformer", decoder_type="conformer",
    duration_predictor_type="stochastic", encoder_input_layer="linear",
    conformer_pos_enc_layer_type="rel_pos", conformer_self_attn_layer_type="rel_selfattn",
    use_macaron_style_in_conformer=True, use_cnn_in_conformer=True,
    conformer_enc_kernel_size=15, conformer_dec_kernel_size=15,
    init_type="xavier_uniform", attention_backend="flash", compute_dtype="bfloat16",
    transformer_enc_dropout_rate=0.2, transformer_enc_positional_dropout_rate=0.2,
    transformer_enc_attn_dropout_rate=0.2, transformer_dec_dropout_rate=0.2,
    transformer_dec_positional_dropout_rate=0.2, transformer_dec_attn_dropout_rate=0.2,
)
# the feature settings of the same file
FEATS = {"sampling_rate": 16000, "fft_size": 1024, "hop_size": 256, "win_length": None,
         "num_mels": 80, "fmin": 80, "fmax": 7600}
# bench.py's serving vocoder: HiFi-GAN V1 widths with hop 256
HIFIGAN = dict(in_channels=80, upsample_channels=512, upsample_factors=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4), resblock_kernel_sizes=(3, 7, 11),
               resblock_dilation_sizes=((1, 3, 5),) * 3)

KERNELS = {
    "fused_rel_scores": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_scores.cu",
        replaces="seq2seq_vc_tpu/ops/rel_scores.py:95",
    ),
    "rel_flash_attention": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_flash.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:578",
    ),
}
# kernel vs plain version. Scores: float32 arithmetic on both sides (bf16
# inputs are widened), sums of D products taken in another order. Flash in
# bf16: the float32 result is rounded once to bf16 on both sides, so a
# value next to a rounding edge may differ by one bf16 ulp (2^-7 relative).
TOLERANCE = {
    ("fused_rel_scores", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("fused_rel_scores", torch.bfloat16): dict(atol=1e-4, rtol=1e-4),
    ("rel_flash_attention", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("rel_flash_attention", torch.bfloat16): dict(atol=1e-3, rtol=1e-2),
}
REFERENCE_ATOL = 1e-3  # phase 4 waveforms, float32 on both devices
# the full-width model's weights: its init, then seeded noise of this scale,
# so that zero-initialised parts (flow projections, affine flows) take part
WEIGHT_NOISE = 0.02
KEY_PADDING = torch.ones(1, 1, 1, dtype=torch.bool)  # a (B, 1, T) mask, for routing


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, min_total_ms: float = 200.0, max_iters: int = 50) -> float:
    """Mean device time of ``fn`` over back-to-back launches (CUDA events),
    after one warm-up call; inputs stay where the last call left them."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = int(min(max_iters, max(3, min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# ---------------------------------------------------------------- kernels
def kernel_inputs(B, H, T, D, dtype, seed, lens=None):
    """Seeded inputs; ``lens`` are the key lengths (default: the first batch
    row sees every key, the others two thirds of them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    qu, qv, k, v = (rand(B, H, T, D) for _ in range(4))
    pos = rand(H, 2 * T - 1, D)
    if lens is None:
        lens = [T] + [max(1, 2 * T // 3)] * (B - 1)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return qu, qv, k, v, pos, lens


def bound(name, B, H, T, D, dtype, lens):
    """(bound_ms, bound_by): each input read once, each output written once;
    the flash kernel's work counts only the keys each batch row has."""
    e = torch.finfo(dtype).bits // 8
    table = H * (2 * T - 1) * D * e
    if name == "fused_rel_scores":
        n_bytes = 3 * B * H * T * D * e + table + B * H * T * T * 4
        ops = 4 * B * H * T * T * D  # q_u.k and the band q_v.pos, 2 per multiply-add
    else:
        keys = int(lens.sum())
        n_bytes = 2 * B * H * T * D * e + 2 * H * keys * D * e + table + 4 * B + B * H * T * D * e
        ops = 6 * H * T * keys * D  # scores, band and P.V
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, B, H, T, D, dtype, seed, label, lens=None):
    """One kernel against its plain version on the same card inputs."""
    from seq2seq_vc_torch.ops.flash_attention import (
        rel_flash_attention, rel_flash_attention_plain,
    )
    from seq2seq_vc_torch.ops.rel_scores import (
        fused_rel_scores, fused_rel_scores_plain, rel_band,
    )

    qu, qv, k, v, pos, lens = kernel_inputs(B, H, T, D, dtype, seed, lens)
    library_ms = None
    if name == "fused_rel_scores":
        def kernel():
            return fused_rel_scores(qu, qv, k, pos)

        def plain():
            return fused_rel_scores_plain(qu, qv, k, pos)
    else:
        def kernel():
            return rel_flash_attention(qu, qv, k, v, pos, lens)

        def plain():
            return rel_flash_attention_plain(qu, qv, k, v, pos, lens)

        # yardstick only: PyTorch's fused attention with the rel-pos band
        # materialised as an additive bias (the port never calls it)
        valid = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        bias = (rel_band(qv, pos) / math.sqrt(D)).masked_fill(~valid, float("-inf")).to(dtype)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, k, v, attn_mask=bias))
        del bias
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOLERANCE[(name, dtype)]
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(), **tol)
    del got, want
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    bound_ms, bound_by = bound(name, B, H, T, D, dtype, lens)
    row = dict(name=name, label=label, shape=(B, H, T, D), kv_lens=lens.tolist(),
               dtype=str(dtype).split(".")[1],
               ok=ok, max_abs_err=err, atol=tol["atol"], rtol=tol["rtol"], ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    log(f"check {name} {label} B,H,T,D={B},{H},{T},{D} kv_lens={row['kv_lens']} {row['dtype']}: "
        f"{'ok' if ok else 'FAIL'} max_abs_err={err:.3e} (atol {tol['atol']}, rtol "
        f"{tol['rtol']}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={'none (no single PyTorch call)' if library_ms is None else f'{library_ms:.4f}'} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return row


# ------------------------------------------------------------- main path
def clip(seconds: float, seed: int) -> np.ndarray:
    """A voiced-speech-like test signal: a gliding harmonic series under a
    syllable-rate envelope, plus a little noise."""
    sr = FEATS["sampling_rate"]
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    f0 = 110 + 25 * rng.random() + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(h * phase) / h for h in range(1, 9))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.random() * 6.28)
    x = 0.15 * env * voiced + 0.01 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def perturb_(module: torch.nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(WEIGHT_NOISE * torch.randn(p.shape, generator=g).to(p.device, p.dtype))


def build_models(seed: int):
    """The flagship AAS-VC and the serving HiFi-GAN on the CPU, seeded."""
    from seq2seq_vc_torch.models.aas_vc import AASVC
    from seq2seq_vc_torch.vocoder.hifigan import HifiganGenerator

    torch.manual_seed(seed)
    model = AASVC(**FLAGSHIP)
    perturb_(model, seed)
    vocoder = HifiganGenerator(**HIFIGAN)
    perturb_(vocoder, seed + 1)
    return model.eval(), vocoder.eval()


def stats(seed: int):
    rng = np.random.default_rng(seed)
    return {"mean": (-4 + rng.standard_normal(80)).astype(np.float32),
            "scale": (1 + 0.5 * rng.random(80)).astype(np.float32)}


def planned_calls(conv, requests, out_frames):
    """For each request, the attention calls its conformer layers make:
    (kernel name, B, H, T, D, key lengths), from the converter's frame
    geometry, each layer's routing, the input lengths and the output
    lengths ``out_frames`` that a run of the same requests gave."""
    from seq2seq_vc_torch.dsp.stft import num_frames

    m = conv.model
    calls = []
    for (_, clips), outs in zip(requests, out_frames):
        padded = [len(c) + 2 * (conv.fft_size // 2) for c in clips]
        n_padded, _, max_out = conv._frame_geometry(padded)
        enc_lens = tuple(num_frames(len(c), conv.hop_size) // m.encoder_reduction_factor
                         for c in clips)
        dec_lens = tuple(n // m.decoder_reduction_factor for n in outs)
        for stack, T, lens in ((m.encoder, n_padded // m.encoder_reduction_factor, enc_lens),
                               (m.decoder, max_out, dec_lens)):
            for layer in stack.encoders:
                att = layer.self_attn
                path = att.route(T, T, 2 * T - 1, KEY_PADDING)
                name = {"fused": "fused_rel_scores", "flash": "rel_flash_attention"}.get(path)
                if name:
                    calls.append((name, len(clips), att.n_head, T, att.d_k, lens))
    return calls


def serve(conv, requests):
    """Drive the converter through its entry points. Returns the failures
    and, for each request, its latency and output lengths in frames."""
    failures, results = [], []
    sr = FEATS["sampling_rate"]
    for label, clips in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = [conv(clips[0])] if len(clips) == 1 else conv.convert_batch(clips)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        secs = sum(len(c) for c in clips) / sr
        lens = [len(w) for w in wavs]
        ok = all(n > 0 and n % conv.hop_size == 0 and np.isfinite(w).all()
                 for n, w in zip(lens, wavs))
        log(f"request {label}: {len(clips)} clip(s), {secs:.2f} s of audio, latency "
            f"{dt * 1e3:.1f} ms, RTF {dt / secs:.5f}, output samples {lens} "
            f"(multiples of {conv.hop_size}, finite: {'yes' if ok else 'NO'})")
        if not ok:
            failures.append(f"request {label}: bad output {lens}")
        results.append(dict(ms=dt * 1e3, out_frames=[n // conv.hop_size for n in lens]))
    return failures, results


def profile_request(conv, request, latency_ms):
    """Device time by kernel for one request (torch.profiler, CUPTI), beside
    the request's untraced latency: what the device does and how much of the
    request it is busy."""
    from torch.profiler import ProfilerActivity, profile

    label, clips = request
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        conv.convert_batch(clips)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if busy == 0:
        log(f"profile {label}: the trace holds no device time: not measured")
        return
    port = {n: sum(ms for k, ms, _ in kernels if n in k)
            for n in ("rel_scores_fwd_kernel", "rel_flash_fwd_kernel")}
    log(f"profile {label}: device busy {busy:.3f} ms in kernels; untraced latency "
        f"{latency_ms:.1f} ms, so busy share {busy / latency_ms:.3f}; port kernels (ms) {port}")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms {ms / busy:6.1%} x{n:<4d} {key[:100]}")


def kernel_wrappers():
    """The kernel wrappers of the main path, by name; each counts its launches."""
    from seq2seq_vc_torch.ops.flash_attention import rel_flash_attention
    from seq2seq_vc_torch.ops.rel_scores import fused_rel_scores

    return {"fused_rel_scores": fused_rel_scores, "rel_flash_attention": rel_flash_attention}


def launch_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def reference_check(model, vocoder, src, trg):
    """Float32 copies of the same weights convert one clip on the card and
    on the CPU; the decoder's flash gate is lowered so that both kernels
    (and on the CPU both plain versions) run. One CPU generator draws the
    duration noise for both."""
    from seq2seq_vc_torch.models.aas_vc import AASVC
    from seq2seq_vc_torch.pipeline import Wav2WavConverter

    m32 = AASVC(**dict(FLAGSHIP, compute_dtype="float32", flash_min_len=256))
    m32.load_state_dict(model.state_dict())
    v32 = copy.deepcopy(vocoder)
    v32.compute_dtype = torch.float32
    audio = clip(1.0, seed=7)
    wavs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        conv = Wav2WavConverter(copy.deepcopy(m32), copy.deepcopy(v32), src, trg, FEATS,
                                device=dev)
        before = launch_counts()
        wavs[dev] = conv(audio, generator=torch.Generator().manual_seed(0))
        counts[dev] = {k: v - before[k] for k, v in launch_counts().items()}
    a, b = wavs["cuda"], wavs["cpu"]
    same_len = len(a) == len(b)
    err = float(np.abs(a - b).max()) if same_len else float("inf")
    ok = same_len and err <= REFERENCE_ATOL and all(counts["cuda"].values()) \
        and not any(counts["cpu"].values())
    log(f"reference float32 1.0 s clip: card {len(a)} samples, cpu {len(b)} samples, "
        f"max abs diff {err:.3e} (atol {REFERENCE_ATOL}); launches card {counts['cuda']}, "
        f"cpu {counts['cpu']}: {'ok' if ok else 'FAIL'}")
    return [] if ok else [f"reference check: card vs cpu diff {err}, lengths {len(a)} {len(b)}"]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(REPO))
    from seq2seq_vc_torch.ops import native
    from seq2seq_vc_torch.pipeline import Wav2WavConverter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"tf32: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    built = native.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)} "
        f"(per kernel: { {k: round(v['seconds'], 1) for k, v in built.items()} })")
    for name, res in built.items():
        for line in res["log"].splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    failures = []
    with torch.no_grad():
        model, vocoder = build_models(seed=0)
        src, trg = stats(1), stats(2)
        conv = Wav2WavConverter(model, vocoder, src, trg, FEATS)  # on the card
        requests = [
            ("single 3.8 s", [clip(3.8, 10)]),
            ("batch of 4", [clip(s, 11 + i) for i, s in enumerate((2.2, 3.0, 3.8, 4.6))]),
            ("single 30 s", [clip(30.0, 15)]),
        ]
        log("warm-up: each request once, then the synthesis ladder")
        fails, warm = serve(conv, requests)
        failures += fails
        log(f"warm-up synthesis buckets: {conv.warmup_synth()}")
        calls = planned_calls(conv, requests, [r["out_frames"] for r in warm])
        expected = {n: sum(c[0] == n for c in calls) for n in KERNELS}

        rows = []
        for name in KERNELS:
            for D, T in ((192, 640), (768, 1300)):
                for dtype in (torch.float32, torch.bfloat16):
                    rows.append(check_kernel(name, 2, 2, T, D, dtype, seed=T + D, label="head-dim"))
            for B, H, T, D, lens in sorted({c[1:] for c in calls if c[0] == name}):
                rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T,
                                         label="main-path", lens=lens))
        failures += [f"check {r['name']} {r['shape']} {r['dtype']}: err {r['max_abs_err']}"
                     for r in rows if not r["ok"]]

        log("main path: the same requests again")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        fails, timed = serve(conv, requests)
        launches = launch_counts()
        failures += fails
        log(f"main path launches {launches}, expected from the routing {expected}; "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for name in KERNELS:
            if launches[name] == 0 or launches[name] != expected[name]:
                failures.append(f"{name}: {launches[name]} launches, expected {expected[name]}")

        failures += reference_check(model, vocoder, src, trg)
        profile_request(conv, requests[-1], timed[-1]["ms"])

    table = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        main_rows = [r for r in mine if r["label"] == "main-path"]
        top = max(main_rows, key=lambda r: r["shape"][0] * r["shape"][2] ** 2 * r["shape"][3])
        table.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            shape_bhtd=list(top["shape"]), kv_lens=top["kv_lens"], dtype=top["dtype"],
        ))
    log(json.dumps({"kernels": table}))
    log(card)  # nvidia-smi's name and power limit, as it gives them
    if failures:
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
