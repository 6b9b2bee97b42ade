"""Port: the VTN (seq2seq_vc_torch/models/vtn.py, models/chunked_decode.py,
models/ar_driver.py, nn/transformer.py, the standard ``MultiHeadedAttention``
and ``pipeline.Wav2WavARConverter``) against the JAX package.

The tiny VTN of ``tests/_torch_port.py`` (vtn.v1.yaml's structure at adim
32) is built in the port from a seed; its weights go to flax through the
JAX package's ``convert_vtn`` and back through the port's
``vtn_state_dict``. The prenet's dropout, always on in both packages, is
set to 0 on both sides: its bits cannot be reproduced across frameworks
(a separate test holds the port's keep rate and scale). AR decodes run
with threshold 1.1, which never stops, over a few steps, as bench.py
times them; the stop logic is tested on its own with forced
probabilities.

Tolerances (float32): attention outputs and weights atol 1e-5; encoder,
decoder and teacher-forced outputs atol 2e-5 (sums of up to 64 products
in another order through a few layers; measured under 3e-6); AR decodes
atol 1e-4 (each step feeds the last one's frame back); waveforms atol
1e-4 with equal lengths, as tests/test_torch_pipeline.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    TINY_VTN,
    assert_state_dicts_equal,
    release_jax_executables,
    vtn_pair,
)
from seq2seq_vc_tpu.models import VTN as JaxVTN
from seq2seq_vc_tpu.models import ar_driver as jax_ar_driver
from seq2seq_vc_tpu.nn.attention import MultiHeadedAttention as JaxMHA
from seq2seq_vc_tpu.ops.masks import target_mask as jax_target_mask
from seq2seq_vc_tpu.pipeline import Wav2WavARConverter as JaxWav2WavAR
from seq2seq_vc_tpu.vocoder.convert_torch import torch_hifigan_to_flax
from seq2seq_vc_tpu.vocoder.hifigan import HifiganGenerator as JaxHifigan
from seq2seq_vc_torch.convert import vtn_state_dict
from seq2seq_vc_torch.models.ar_driver import ChunkedARDecoder, chunk_schedule
from seq2seq_vc_torch.models.chunked_decode import step_stop
from seq2seq_vc_torch.models.vtn import VTN
from seq2seq_vc_torch.nn.attention import MultiHeadedAttention
from seq2seq_vc_torch.nn.pre_postnets import Prenet
from seq2seq_vc_torch.ops.masks import target_mask
from seq2seq_vc_torch.pipeline import Wav2WavARConverter
from seq2seq_vc_torch.vocoder.hifigan import HifiganGenerator

ATT_TOL = dict(atol=1e-5, rtol=0)
TOL = dict(atol=2e-5, rtol=0)
AR_TOL = dict(atol=1e-4, rtol=0)
KEY = jax.random.PRNGKey(0)


def _batch(seed=0, B=2, Tin=48, L=40):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, Tin, 80)).astype(np.float32)
    ys = rng.standard_normal((B, L, 80)).astype(np.float32)
    ilens = np.array([Tin, Tin - 11], np.int32)
    olens = np.array([L, L - 11], np.int32)
    labels = (np.arange(L)[None, :] >= olens[:, None] - 1).astype(np.float32)
    return xs, ilens, ys, labels, olens


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def pair():
    return vtn_pair(seed=0)


def test_weights_round_trip(pair):
    port, _, flax = pair
    assert_state_dicts_equal(vtn_state_dict(flax, port), port.state_dict())
    assert "decoder.embed.0.0.prenet.1.0.weight" in port.state_dict()
    assert "encoder.embed.out.1.alpha" in port.state_dict()


@pytest.mark.parametrize("kind", ["key_padding", "target", "cross"])
def test_attention_dense_route_matches_jax(kind):
    B, Tq, F, H = 2, 11, 32, 2
    Tk = 17 if kind == "cross" else Tq
    rng = np.random.default_rng(1)
    q, kv = (rng.standard_normal((B, t, F)).astype(np.float32) for t in (Tq, Tk))
    lens = np.array([Tk, Tk - 5])
    mask = (np.arange(Tk)[None, :] < lens[:, None])[:, None, :]
    if kind == "target":
        mask = np.array(jax_target_mask(jnp.asarray(lens), Tk))
    jax_att = JaxMHA(H, F)
    params = jax_att.init(KEY, q, kv, kv, mask)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    want, want_w = jax_att.apply(params, q, kv, kv, mask, return_weights=True)
    port = MultiHeadedAttention(H, F).eval()
    port.load_state_dict(vtn_state_dict(params, port))
    got, w = port(*_t(q, kv, kv, mask), return_weights=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATT_TOL)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(want_w), **ATT_TOL)
    if kind == "target":
        np.testing.assert_array_equal(target_mask(torch.from_numpy(lens), Tk).numpy(), mask)


def test_encoder_matches_jax(pair):
    port, jax_model, flax = pair
    xs, ilens = _batch()[:2]
    want, want_mask = jax_model.apply(flax, xs, ilens, method=JaxVTN.encode)
    got, mask = port.encode(*_t(xs, ilens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_decoder_matches_jax(pair):
    port, jax_model, flax = pair
    xs, ilens, ys, _, olens = _batch()
    hs, h_masks = port.encode(*_t(xs, ilens))
    y_masks = target_mask(torch.from_numpy(olens // 4), 10)
    ys_in = torch.from_numpy(ys[:, 3::4])
    got, got_w = port.decoder(ys_in, y_masks, hs, h_masks, return_attns=True)

    def jax_decoder(m, ys_in, y_masks, hs, h_masks):
        return m.decoder(m.dprenet_proj(m.dprenet(ys_in)), y_masks, hs, h_masks,
                         return_attns=True)

    want, _, want_w = jax_model.apply(
        flax, ys_in.numpy(), y_masks.numpy(), hs.detach().numpy(), h_masks.numpy(),
        method=jax_decoder, rngs={"dropout": KEY})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for a, b in zip(got_w, want_w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **ATT_TOL)


def test_teacher_forced_forward_matches_jax(pair):
    port, jax_model, flax = pair
    batch = _batch()
    want = jax_model.apply(flax, *batch, deterministic=True, rngs={"dropout": KEY})
    port.postnet.dropout_rate = 0.0  # the JAX model's deterministic postnet
    got = port(*_t(*batch), need_att_ws=True)
    assert set(got) == set(want)
    for k in ("after_outs", "before_outs", "logits", "att_ws"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **TOL)
    for k in ("labels", "olens", "ilens_ds_st", "olens_in"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert "att_ws" not in port(*_t(*batch))


def test_inference_matches_jax(pair):
    port, jax_model, flax = pair
    xs, ilens = _batch()[:2]
    want = jax_model.apply(flax, xs, ilens, KEY, 1.1, 0.0, 2.0, method=JaxVTN.inference)
    got = port.inference(*_t(xs, ilens), None, 1.1, 0.0, 2.0)
    for k in ("outs", "probs", "att_ws"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **AR_TOL)
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(want["out_lens"]))


def _force_stop_probability(port, flax, logit: float):
    """prob_out gives sigmoid(logit) for every frame of every step."""
    with torch.no_grad():
        port.prob_out.weight.zero_()
        port.prob_out.bias.fill_(logit)
    params = jax.tree_util.tree_map(np.asarray, flax)
    params["params"]["prob_out"] = {"kernel": np.zeros_like(params["params"]["prob_out"]["kernel"]),
                                    "bias": np.full_like(params["params"]["prob_out"]["bias"], logit)}
    return params


@pytest.mark.parametrize("speculate", [True, False])
@pytest.mark.parametrize("threshold,logit,minlenratio", [(1.1, 0.0, 0.0), (0.5, 3.0, 1.0)])
def test_chunked_decoder_matches_jax(speculate, threshold, logit, minlenratio):
    port, jax_model, flax = vtn_pair(seed=2)
    params = _force_stop_probability(port, flax, logit) if logit else flax
    xs, ilens = _batch(seed=3)[:2]
    kw = dict(threshold=threshold, minlenratio=minlenratio, maxlenratio=3.0, base_chunk=4,
              max_chunk=8, speculate=speculate)
    want = jax_ar_driver.ChunkedARDecoder(jax_model, JaxVTN, **kw)(params, xs, ilens, KEY,
                                                                    est_steps=5)
    got = ChunkedARDecoder(port, **kw)(*_t(xs, ilens), est_steps=5)
    assert got["n_chunks_kept"] == want["n_chunks_kept"]
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(want["out_lens"]))
    for k in ("outs", "probs", "att_ws"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **AR_TOL)
    if threshold < 1.0:
        # every step proposes to stop: each item stops at its minimum length
        hlens = port.encode(*_t(xs, ilens))[1].sum(-1).numpy()
        np.testing.assert_array_equal(got["out_lens"].numpy(), hlens * 1.0 // 4 * 4)


def test_step_stop_holds_each_items_first_stop():
    minlen_b, maxlen_b = torch.tensor([0, 3, 0]), torch.tensor([9, 9, 2])
    finished = torch.zeros(3, dtype=torch.bool)
    out_len = torch.zeros(3, dtype=torch.int32)
    probs = [[0.1, 0.9, 0.1], [0.9, 0.9, 0.1], [0.1, 0.1, 0.1], [0.9, 0.9, 0.9]]
    seen = []
    for t, p in enumerate(probs):
        prob_r = torch.tensor(p)[:, None].repeat(1, 4)
        finished, out_len = step_stop(prob_r, t, 0.5, minlen_b, maxlen_b, finished, out_len)
        seen.append((finished.tolist(), out_len.tolist()))
    # item 0 stops at step 1 (its first stop) and keeps out_len 2, item 1 not
    # before its minimum of 3 steps (so at step 3), item 2 at its maximum of 2
    # steps (step 1) whatever its probabilities
    assert seen == [([False, False, False], [0, 0, 0]), ([True, False, True], [2, 0, 2]),
                    ([True, False, True], [2, 0, 2]), ([True, True, True], [2, 4, 2])]


@pytest.mark.parametrize("maxlen,base,max_chunk,first", [
    (32, 32, 256, 0), (96, 32, 256, 0), (512, 32, 256, 0), (2112, 32, 256, 2532),
    (2112, 32, 256, 40), (64, 4, 8, 5), (4, 4, 8, 100), (1024, 16, 64, 300)])
def test_chunk_schedule_matches_jax(maxlen, base, max_chunk, first):
    got = chunk_schedule(maxlen, base, max_chunk, first)
    assert got == jax_ar_driver.chunk_schedule(maxlen, base, max_chunk, first)
    assert sum(got) == maxlen


def test_prenet_dropout_is_always_on_with_its_keep_rate_and_scale():
    torch.manual_seed(0)
    prenet = Prenet(80, n_layers=1, n_units=4096, dropout_rate=0.5).eval()
    with torch.no_grad():
        prenet.prenet[0][0].weight.zero_()
        prenet.prenet[0][0].bias.fill_(1.0)  # every unit 1 before the drop
    x = torch.zeros(4, 8, 80)
    out = prenet(x, torch.Generator().manual_seed(3))
    kept = out != 0
    assert 0.48 < kept.float().mean().item() < 0.52  # in eval() mode too
    assert torch.all(out[kept] == 2.0)  # scaled by 1 / (1 - rate)
    torch.testing.assert_close(out, prenet(x, torch.Generator().manual_seed(3)), rtol=0, atol=0)


def test_vtn_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        VTN(**dict(TINY_VTN, encoder_type="rnn"))
    # the linear input layer builds now (tests/test_torch_item8.py holds it
    # against JAX): linear, LayerNorm, dropout, ReLU, then the encoding
    linear = VTN(**dict(TINY_VTN, encoder_input_layer="linear"))
    assert linear.encoder.conv_subsampling_factor == 1
    assert [type(m).__name__ for m in linear.encoder.embed] == [
        "Linear", "LayerNorm", "Dropout", "ReLU", "ScaledPositionalEncoding"]
    port = VTN(**TINY_VTN).train()
    with pytest.raises(ValueError, match="eval"):
        port.inference(*_t(*_batch()[:2]))


SR = 16000
CONFIG = {"sampling_rate": SR, "fft_size": 1024, "hop_size": 256, "num_mels": 80, "fmin": 80,
          "fmax": 7600, "inference": {"threshold": 1.1, "maxlenratio": 2.0,
                                      "decode_chunk_steps": 8, "decode_max_chunk_steps": 16}}
VOC = dict(in_channels=80, upsample_channels=32, upsample_kernel_sizes=(16, 16, 4, 4),
           upsample_factors=(8, 8, 2, 2), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))


def test_wav2wav_ar_converter_matches_jax(pair):
    port, jax_model, flax = pair
    torch.manual_seed(0)
    port_voc = HifiganGenerator(**VOC, compute_dtype=torch.float32).eval()
    jax_voc = JaxHifigan(**VOC, dtype=jnp.float32)
    template = jax_voc.init(KEY, jnp.zeros((1, 8, 80)))
    voc_flax = torch_hifigan_to_flax({k: v.numpy() for k, v in port_voc.state_dict().items()},
                                     jax.tree_util.tree_map(np.asarray, template), num_kernels=1)
    rng = np.random.default_rng(4)
    src, trg = ({"mean": (-5 + rng.standard_normal(80)).astype(np.float32),
                 "scale": (1 + 0.5 * rng.random(80)).astype(np.float32)} for _ in range(2))
    t = np.arange(int(SR * 0.6)) / SR
    audios = [(0.3 * np.sin(2 * np.pi * f * t[:n]) + 0.02 * rng.standard_normal(n)).astype(
        np.float32) for f, n in ((220, len(t)), (330, len(t) * 2 // 3))]
    jax_conv = JaxWav2WavAR(jax_model, flax, jax_voc, voc_flax, src, trg, CONFIG)
    port_conv = Wav2WavARConverter(port, port_voc, src, trg, CONFIG, device="cpu")
    want = jax_conv.convert_batch(audios, stream_vocoder=False)
    got = port_conv.convert_batch(audios)  # the streamed vocoder, the default
    assert port_conv.last_stream_kept
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) % 256 == 0 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4)
    np.testing.assert_allclose(port_conv(audios[0]), want[0], atol=1e-4)
    assert port_conv.warmup_synth() == jax_conv.warmup_synth()
    serial = port_conv.convert_batch(audios, stream_vocoder=False)
    assert not port_conv.last_stream_kept
    for g, w in zip(serial, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4)
