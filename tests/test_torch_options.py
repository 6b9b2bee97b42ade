"""Port: the model options of ROADMAP.md queue 1 item 4 against the JAX
package: the conv positionwise layers (``conv1d``, ``conv1d-linear``), the
batch-norm postnet and conformer conv module in eval mode, speaker
embeddings (``add``, ``concat``) in the four models, the conformer VTN
encoder, and the ``concat_after`` decode step.

Each model is built in the port from a seed (its batch norms' running
statistics drawn too), carried to flax by the JAX package's converters
(``seq2seq_vc_tpu/convert/reference.py``, which read the reference's
names: ``feed_forward.w_1``/``w_2``, ``postnet.postnet.N.1.running_mean``,
``projection``), and back through the port's converter, which must give
the same state dict (``batch_stats`` included). Dropout is off on both
sides; the JAX modules run in deterministic mode (running statistics).

Tolerances (float32): encoder states atol 2e-5 (sums of up to 192
products in another order through two layers); decoder outputs and AR
decodes atol 1e-4 (each step feeds the last frame back), as
tests/test_torch_vtn.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    NO_DROPOUT,
    TINY_AASVC,
    TINY_TTS,
    TINY_VTN,
    assert_state_dicts_equal,
    perturb_,
    release_jax_executables,
)
from seq2seq_vc_tpu.convert.reference import (
    convert_aasvc,
    convert_fastspeech_vc,
    convert_transformer_tts,
    convert_vtn,
)
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models import VTN as JaxVTN
from seq2seq_vc_tpu.models import FastSpeechVC as JaxFastSpeechVC
from seq2seq_vc_tpu.models import TransformerTTS as JaxTransformerTTS
from seq2seq_vc_tpu.ops.masks import target_mask as jax_target_mask
from seq2seq_vc_torch.convert import (
    aasvc_state_dict,
    fastspeech_vc_state_dict,
    transformer_tts_state_dict,
    vtn_state_dict,
)
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.models.ar_driver import ChunkedARDecoder
from seq2seq_vc_torch.models.fastspeech_vc import FastSpeechVC
from seq2seq_vc_torch.models.transformer_tts import TransformerTTS
from seq2seq_vc_torch.models.vtn import VTN
from seq2seq_vc_torch.nn.conformer import ConvBatchNorm
from seq2seq_vc_torch.train.ar_vc import ARVCTrainer
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.train.state import TrainState

TOL = dict(atol=2e-5, rtol=0)
AR_TOL = dict(atol=1e-4, rtol=0)
KEY = jax.random.PRNGKey(0)
# (port class, JAX class, JAX converter, port converter, tiny config)
MODELS = {
    "VTN": (VTN, JaxVTN, convert_vtn, vtn_state_dict, dict(TINY_VTN, **NO_DROPOUT)),
    "TransformerTTS": (TransformerTTS, JaxTransformerTTS, convert_transformer_tts,
                       transformer_tts_state_dict, dict(TINY_TTS, **NO_DROPOUT)),
    "AASVC": (AASVC, JaxAASVC, convert_aasvc, aasvc_state_dict,
              dict(TINY_AASVC, **NO_DROPOUT, postnet_dropout_rate=0.0)),
    "FastSpeechVC": (FastSpeechVC, JaxFastSpeechVC, convert_fastspeech_vc,
                     fastspeech_vc_state_dict,
                     dict(idim=80, odim=80, adim=32, aheads=2, elayers=1, eunits=64, dlayers=1,
                          dunits=64, postnet_layers=2, postnet_chans=16,
                          duration_predictor_chans=16, positionwise_layer_type="linear",
                          encoder_type="conformer", decoder_type="conformer",
                          conformer_enc_kernel_size=7, conformer_dec_kernel_size=7,
                          encoder_normalize_before=True, decoder_normalize_before=True,
                          teacher_model_decoder_reduction_factor=1, **NO_DROPOUT,
                          duration_predictor_dropout_rate=0.0, postnet_dropout_rate=0.0)),
}
# the conformer VTN: vtn.v1.yaml's structure with ``encoder_type: conformer``
# and new-style relative positions (the fused and flash kernels' form)
CONFORMER_VTN = dict(encoder_type="conformer", conformer_rel_pos_type="latest",
                     conformer_enc_kernel_size=5)


def _stats_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Running statistics away from 0 and 1 in every batch norm."""
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvBatchNorm):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return model


def _pair(name: str, seed: int = 0, **over):
    """(port model, JAX model, flax variables) with the port's weights
    carried to flax by the JAX converter; the port's converter must carry
    them back unchanged."""
    port_cls, jax_cls, to_flax, to_port, cfg = MODELS[name]
    cfg = dict(cfg, **over)
    torch.manual_seed(seed)
    port = _stats_(perturb_(port_cls(**cfg).eval(), seed), seed)
    jax_model = jax_cls(**{k: v for k, v in cfg.items() if k != "flash_min_len"})
    flax = to_flax(port.state_dict(), jax_model)
    assert_state_dicts_equal(to_port(flax, port), port.state_dict())
    return port, jax_model, flax


def _feats(seed=0, B=2, T=48, idim=80):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, T, idim)).astype(np.float32)
    return xs, np.array([T, T - 11], np.int64)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 19, (2, 12)), np.array([12, 9], np.int64)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jit(jax_model, flax, *arrays, method=None, **static):
    """``jax_model.apply`` jitted over the variables and ``arrays`` (eager
    application of a whole model takes ~10x as long on the CPU)."""
    return jax.jit(lambda v, *a: jax_model.apply(v, *a, method=method, **static))(flax, *arrays)


def _encode(name, port, jax_model, flax, xs, ilens, spembs=None):
    """(port, JAX) encoder states (float32 numpy) and the valid lengths."""
    sp = None if spembs is None else torch.from_numpy(spembs)
    with torch.no_grad():
        if name in ("VTN", "TransformerTTS"):
            got, masks = port.encode(*_t(xs, ilens), sp)
            want, _ = jax_model.apply(flax, xs, ilens, spembs, True, method=jax_model.encode)
            lens = masks.sum(-1).numpy()
        else:
            got, lens = port._encode(*_t(xs, ilens), sp)
            want, _ = jax_model.apply(flax, xs, ilens, spembs, True, method=jax_model._encode)
            lens = lens.numpy()
    return got.numpy(), np.asarray(want), lens


def _assert_valid_close(got, want, lens, **tol):
    assert got.shape == want.shape
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **tol)


@pytest.mark.parametrize("kind,kernel", [("conv1d", 1), ("conv1d", 3), ("conv1d-linear", 1),
                                         ("conv1d-linear", 3), ("conv1d", 4)])
def test_conv_positionwise_transformer_layer_matches_jax(kind, kernel):
    """The VTN's transformer encoder with the conv positionwise layers;
    kernel 4 is even: flax's SAME puts its odd pad sample on the right."""
    port, jax_model, flax = _pair("VTN", positionwise_layer_type=kind,
                                  positionwise_conv_kernel_size=kernel)
    xs, ilens = _feats()
    _assert_valid_close(*_encode("VTN", port, jax_model, flax, xs, ilens), **TOL)


@pytest.mark.parametrize("kind,kernel", [("conv1d", 1), ("conv1d", 3), ("conv1d-linear", 1),
                                         ("conv1d-linear", 3)])
def test_conv_positionwise_conformer_layer_matches_jax(kind, kernel):
    """AAS-VC's conformer encoder (macaron: both feed-forwards take the
    kind) with the conv positionwise layers."""
    port, jax_model, flax = _pair("AASVC", positionwise_layer_type=kind,
                                  positionwise_conv_kernel_size=kernel)
    assert port.encoder.encoders[0].feed_forward_macaron.w_1.kernel_size == (kernel,)
    xs, ilens = _feats(seed=1)
    _assert_valid_close(*_encode("AASVC", port, jax_model, flax, xs, ilens), **TOL)


def test_batch_norm_postnet_and_conv_module_in_eval_match_jax():
    """AAS-VC with the batch-norm postnet and conformer conv module, the
    running statistics from ``batch_stats``: the NAR inference."""
    port, jax_model, flax = _pair("AASVC", postnet_norm_type="batch_norm",
                                  conformer_conv_norm_type="batch_norm",
                                  duration_predictor_type="deterministic")
    assert set(flax) == {"params", "batch_stats"}
    assert {"postnet", "encoder", "decoder"} <= set(flax["batch_stats"])
    xs, ilens = _feats(seed=2)
    want = _jit(jax_model, flax, xs, ilens, xs, max_output_frames=64, method=JaxAASVC.inference)
    got = port.inference(*_t(xs, ilens, xs), max_output_frames=64)
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(want["out_lens"]))
    _assert_valid_close(got["outs"].numpy(), np.asarray(want["outs"]), got["out_lens"].numpy(),
                        **AR_TOL)


def test_batch_norm_postnet_decode_matches_jax():
    """The VTN with the batch-norm postnet: the AR inference (postnet over
    the decoded frames, masked past each item's stop)."""
    port, jax_model, flax = _pair("VTN", postnet_norm_type="batch_norm")
    assert set(flax["batch_stats"]) == {"postnet"}
    xs, ilens = _feats(seed=3)
    want = _jit(jax_model, flax, xs, ilens, KEY,
                method=lambda m, *a: m.inference(*a, 1.1, 0.0, 1.0))
    got = port.inference(*_t(xs, ilens), None, 1.1, 0.0, 1.0)
    for k in ("outs", "probs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **AR_TOL)


@pytest.mark.parametrize("kind", ["add", "concat"])
@pytest.mark.parametrize("name", list(MODELS))
def test_speaker_embeddings_match_jax(name, kind):
    port, jax_model, flax = _pair(name, spk_embed_dim=12, spk_embed_integration_type=kind)
    idim = 12 if kind == "add" else 32 + 12
    assert port.projection.in_features == idim
    spembs = np.random.default_rng(4).standard_normal((2, 12)).astype(np.float32)
    spembs[1] *= 1e-14  # below the norm's floor of 1e-12
    xs, ilens = _tokens() if name == "TransformerTTS" else _feats(seed=4)
    got, want, lens = _encode(name, port, jax_model, flax, xs, ilens, spembs)
    _assert_valid_close(got, want, lens, **TOL)
    if name == "FastSpeechVC":  # the NAR inference, speaker embeddings through it
        want = _jit(jax_model, flax, xs, ilens, xs, spembs, max_output_frames=64,
                    method=JaxFastSpeechVC.inference)
        out = port.inference(*_t(xs, ilens, xs, spembs), max_output_frames=64)
        np.testing.assert_allclose(out["d_outs"].numpy(), np.asarray(want["d_outs"]), **AR_TOL)


def test_conformer_vtn_forward_and_chunked_decode_match_jax():
    """The conformer VTN (batch-norm conv module, conv1d positionwise
    layers, concat_after in the encoder): the teacher-forced forward and a
    chunked decode against the JAX model's inference."""
    over = dict(CONFORMER_VTN, conformer_conv_norm_type="batch_norm",
                positionwise_layer_type="conv1d", positionwise_conv_kernel_size=3,
                encoder_concat_after=True)
    port, jax_model, flax = _pair("VTN", **over)
    xs, ilens = _feats(seed=5)
    rng = np.random.default_rng(5)
    ys = rng.standard_normal((2, 40, 80)).astype(np.float32)
    labels = np.zeros((2, 40), np.float32)
    olens = np.array([40, 32])
    want = _jit(jax_model, flax, xs, ilens, ys, labels, olens, deterministic=True,
                rngs={"dropout": KEY})  # the prenet's, at rate 0
    with torch.no_grad():
        got = port(*_t(xs, ilens, ys, labels, olens), need_att_ws=True)
    for k in ("after_outs", "before_outs", "logits", "att_ws"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **AR_TOL)
    np.testing.assert_array_equal(got["ilens_ds_st"].numpy(), np.asarray(want["ilens_ds_st"]))
    want = _jit(jax_model, flax, xs, ilens, KEY,
                method=lambda m, *a: m.inference(*a, 1.1, 0.0, 2.0))
    got = ChunkedARDecoder(port, threshold=1.1, maxlenratio=2.0, base_chunk=4, max_chunk=8)(
        *_t(xs, ilens), est_steps=3)
    assert got["n_chunks_kept"] > 1
    n = want["outs"].shape[1]
    np.testing.assert_allclose(got["outs"].numpy()[:, :n], np.asarray(want["outs"]), **AR_TOL)
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(want["out_lens"]))


def test_concat_after_step_decode_matches_jax_teacher_forced_decoder():
    """A step-by-step decode of the port's decoder with ``concat_after``
    against the JAX teacher-forced ``Decoder.__call__`` on the same prefix
    under the causal mask (the JAX step leaves the concat out, ROADMAP.md
    §3, so its own decode is not this function)."""
    port, jax_model, flax = _pair("VTN", decoder_concat_after=True, encoder_concat_after=True)
    xs, ilens = _feats(seed=6)
    L = 10
    emb = np.random.default_rng(6).standard_normal((2, L, 32)).astype(np.float32)
    hs, h_masks = jax_model.apply(flax, xs, ilens, method=JaxVTN.encode)
    mask = jax_target_mask(jnp.array([L, L]), L)
    want = jax_model.apply(flax, jnp.asarray(emb), mask, hs, h_masks,
                           method=lambda m, *a: m.decoder(*a, deterministic=True))
    dec = port.decoder
    with torch.no_grad():
        hs_p, hm_p = port.encode(*_t(xs, ilens))
        np.testing.assert_allclose(hs_p.numpy(), np.asarray(hs), **TOL)
        cache, mem_kv = dec.init_cache(2, L), dec.precompute_memory(hs_p)
        got = np.stack([dec.step(torch.from_numpy(emb[:, t:t + 1]), t, cache, mem_kv, hm_p)[0]
                        .numpy() for t in range(L)], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), **AR_TOL)
    # the JAX step of the same layers, which omits concat_linear1/2, differs
    jax_cache = jax_model.apply(flax, 2, L, method=lambda m, b, n: m.decoder.init_cache(b, n))
    mem = jax_model.apply(flax, hs, method=lambda m, h: m.decoder.precompute_memory(h))
    z0 = jax_model.apply(flax, jnp.asarray(emb[:, :1]), 0, jax_cache, mem, h_masks,
                         method=lambda m, *a: m.decoder.step(*a))[0]
    assert np.abs(np.asarray(z0).reshape(got[:, 0].shape) - got[:, 0]).max() > 1e-3


def test_trainers_refuse_batch_norm_as_jax_does():
    """The JAX trainers keep no ``batch_stats``: a train-mode apply of a
    batch-norm model raises there, and the port's trainers refuse it."""
    port, jax_model, flax = _pair("VTN", postnet_norm_type="batch_norm")
    xs, ilens = _feats(seed=7)
    ys, labels, olens = np.zeros((2, 40, 80), np.float32), np.zeros((2, 40)), np.array([40, 32])
    with pytest.raises(Exception, match="batch_stats"):
        jax_model.apply(flax, xs, ilens, ys, labels, olens, deterministic=False,
                        rngs={"dropout": KEY})
    state = TrainState(port.train(), build_optimizer(port.parameters()))
    with pytest.raises(NotImplementedError, match="batch_stats"):
        ARVCTrainer(state, {}, {}, [], device="cpu")
