"""JAX parameter trees -> state_dicts of the port's modules.

The inverse of ``seq2seq_vc_tpu/convert/reference.py:convert_aasvc``,
``convert_vtn``, ``convert_fastspeech_vc`` and ``convert_transformer_tts``
and of ``seq2seq_vc_tpu/vocoder/convert_torch.py:torch_hifigan_to_flax``,
written here so the port needs nothing of the JAX package; ``flax_paths``
names each port parameter by its flax path, which ``init-mods`` and
``freeze-mods`` match (``core/checkpoint.py``, ``train/optim.py``). A
tree is nested dicts of numpy arrays (``{"params": ...}``, with a
``batch_stats`` collection or without, or the inner dict). Every tensor of
the port module is looked up by name; a missing leaf raises ``KeyError``
and leftover leaves raise ``ValueError``. A batch norm (the postnet's and
the conformer conv module's with ``batch_norm``) takes ``scale`` and
``bias`` from the parameters and ``running_mean``/``running_var`` from
``batch_stats`` (``mean``, ``var``); its ``num_batches_tracked`` is set to
``NUM_BATCHES_TRACKED`` (0), as flax counts no batches.

Layout transforms (flax -> torch): Dense ``kernel (in, out)`` -> Linear
``weight (out, in)``; Conv ``kernel (k, in/groups, out)`` -> Conv1d
``weight (out, in/groups, k)``; Conv 2-D ``(kh, kw, in, out)`` ->
``(out, in, kh, kw)``; ConvTranspose ``(k, in, out)`` -> ``(in, out, k)``
with the taps reversed; the Conv2dSubsampling output Dense reads its input
freq-major in flax and channel-major in torch, so its rows are permuted.
Weight norm (HiFi-GAN) is folded into the plain weight where the port's
layer holds one, else kept as ``weight_g`` (the flax scale) and
``weight_v`` (the kernel). ``hubert_soft_state_dict`` is the inverse of
``seq2seq_vc_tpu/urhythmic/hubert.py:convert_torch_hubert``'s bshall branch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

Path_ = Tuple[str, ...]


class _Tree:
    """Flattened parameter tree that tracks which leaves were consumed. A
    tree of variables (``{"params": ...}``, with a ``batch_stats``
    collection or without) keeps that collection's leaves apart
    (``pop_stat``)."""

    def __init__(self, tree: Dict[str, Any]):
        stats = {}
        if "params" in tree and set(tree) <= {"params", "batch_stats"}:
            tree, stats = tree["params"], tree.get("batch_stats", {})
        self.leaves: Dict[Path_, np.ndarray] = {}
        self._flatten(tree, (), self.leaves)
        self.stats: Dict[Path_, np.ndarray] = {}
        self._flatten(stats, (), self.stats)

    def _flatten(self, node, prefix: Path_, out):
        for k, v in node.items():
            if isinstance(v, dict):
                self._flatten(v, prefix + (k,), out)
            else:
                out[prefix + (k,)] = np.asarray(v)

    @staticmethod
    def _pop(leaves, path: Path_, what: str) -> np.ndarray:
        try:
            return leaves.pop(path)
        except KeyError:
            raise KeyError(
                f"flax {what} {'/'.join(path)!r} not found "
                f"(remaining: {['/'.join(p) for p in sorted(leaves)][:10]}...)"
            ) from None

    def pop(self, path: Path_) -> np.ndarray:
        return self._pop(self.leaves, path, "parameter")

    def pop_stat(self, path: Path_) -> np.ndarray:
        """A leaf of the ``batch_stats`` collection (``mean``, ``var``)."""
        return self._pop(self.stats, path, "batch_stats leaf")

    def finish(self):
        left = sorted(self.leaves) + sorted(self.stats)
        if left:
            raise ValueError(f"unconverted flax parameters: {['/'.join(p) for p in left]}")


def _dds_name(m: re.Match) -> str:
    i, j = int(m.group(2)), int(m.group(3))
    kind = "Conv" if j in (0, 5) else "LayerNorm"
    return f"{m.group(1)}.{kind}_{2 * i + (j >= 5)}"


def _flow_name(m: re.Match) -> str:
    branch = "post_flows" if m.group(1) else "main_flows"
    return f"duration_predictor.{branch}_{(int(m.group(2)) + 1) // 2}"


# the conv2d input layer of a conformer or transformer encoder
_SUBSAMPLE_RENAMES = [
    (r"(^|\.)embed\.conv\.0$", r"\1subsample.Conv_0"),
    (r"(^|\.)embed\.conv\.2$", r"\1subsample.Conv_1"),
    (r"(^|\.)embed\.out\.0$", r"\1subsample.Dense_0"),
    (r"(^|\.)embed\.out\.1$", r"\1pos_enc"),
]

# torch module path -> flax module path, applied in order
_AASVC_RENAMES = _SUBSAMPLE_RENAMES + [
    (r"(^|\.)embed\.0$", r"\1pre"),
    (r"(^|\.)embed\.1$", r"\1pre_norm"),
    (r"(^|\.)encoders\.(\d+)\.", r"\1layers_\2."),
    (r"\.feed_forward(_macaron)?\.w_1$", r".feed_forward\1.Dense_0"),
    (r"\.feed_forward(_macaron)?\.w_2$", r".feed_forward\1.Dense_1"),
    (r"\.conv_module\.pointwise_conv1$", ".conv_module.Conv_0"),
    (r"\.conv_module\.depthwise_conv$", ".conv_module.Conv_1"),
    (r"\.conv_module\.pointwise_conv2$", ".conv_module.Conv_2"),
    (r"\.conv_module\.norm$", ".conv_module.MaskedGroupNorm_0"),
    (r"(dds|dds_conv)\.convs\.(\d+)\.(\d)$", _dds_name),
    (r"^duration_predictor\.(post_)?flows\.(\d+)", _flow_name),
    # the deterministic duration predictor
    (r"^duration_predictor\.conv\.(\d+)\.0$", r"duration_predictor.Conv_\1"),
    (r"^duration_predictor\.conv\.(\d+)\.2$", r"duration_predictor.LayerNorm_\1"),
    (r"^duration_predictor\.linear$", "duration_predictor.Dense_0"),
    (r"^duration_predictor_projection\.conv\.0$", "duration_predictor_projection.Conv_0"),
    (r"^duration_predictor_projection\.conv\.2$", "duration_predictor_projection.Conv_1"),
    (r"^duration_predictor_projection\.out$", "duration_predictor_projection.Dense_0"),
    (r"^postnet\.postnet\.(\d+)\.0$", r"postnet.Conv_\1"),
    (r"^postnet\.postnet\.(\d+)\.1$", r"postnet.GroupNorm_\1"),
]

_VTN_RENAMES = _SUBSAMPLE_RENAMES + [
    (r"^decoder\.embed\.0\.0\.prenet\.(\d+)\.0$", r"dprenet.Dense_\1"),
    (r"^decoder\.embed\.0\.1$", "dprenet_proj"),
    (r"^decoder\.embed\.1$", "decoder.pos_enc"),
    (r"(^|\.)(encoders|decoders)\.(\d+)\.", r"\1layers_\3."),
    (r"\.feed_forward(_macaron)?\.w_1$", r".feed_forward\1.Dense_0"),
    (r"\.feed_forward(_macaron)?\.w_2$", r".feed_forward\1.Dense_1"),
    # the conformer encoder (``encoder_type: conformer``)
    (r"\.conv_module\.pointwise_conv1$", ".conv_module.Conv_0"),
    (r"\.conv_module\.depthwise_conv$", ".conv_module.Conv_1"),
    (r"\.conv_module\.pointwise_conv2$", ".conv_module.Conv_2"),
    (r"\.conv_module\.norm$", ".conv_module.MaskedGroupNorm_0"),
    (r"^postnet\.postnet\.(\d+)\.0$", r"postnet.Conv_\1"),
    (r"^postnet\.postnet\.(\d+)\.1$", r"postnet.GroupNorm_\1"),
]

# Transformer-TTS: the token embedding and the scaled encoding of the
# encoder's ``embed`` input layer, then the VTN's names
_TTS_RENAMES = [(r"^encoder\.embed\.0$", "encoder.embed_tokens"),
                (r"^encoder\.embed\.1$", "encoder.pos_enc")] + _VTN_RENAMES

# FastSpeech-VC: a transformer decoder's scaled encoding is ``embed.0``,
# then the conformer's and the transformer's names as AAS-VC's
_FASTSPEECH_VC_RENAMES = [(r"^decoder\.embed\.0$", "decoder.pos_enc")] + _AASVC_RENAMES

# each Conv2dSubsampling output Linear of AAS-VC and FastSpeech-VC, and the
# conv whose channels order its input rows
_SUBSAMPLE_OUTS = {"encoder.embed.out.0": "encoder.embed.conv.2",
                   "duration_predictor_projection.out": "duration_predictor_projection.conv.2",
                   "embed.out.0": "embed.conv.2"}  # a conformer encoder on its own

# the SDP's 1x1 convs are Dense layers in flax
_SDP_DENSE = re.compile(r"^duration_predictor\.(pre|proj|post_pre|post_proj)$")


def _flax_module(mod_path: str, renames, model=None) -> str:
    """The flax module path (dotted) of a torch module path; with the port
    ``model``, the names that depend on a module's kind: a batch norm is
    flax's ``BatchNorm_<i>``, and the conv forms of the positionwise layer
    name their layers ``Conv_0``, ``Conv_1`` (``MultiLayeredConv1d``) or
    ``Conv_0``, ``Dense_0`` (``Conv1dLinear``)."""
    from .nn.conformer import ConformerEncoder, ConvBatchNorm
    from .nn.transformer import Conv1dLinear, Encoder, MultiLayeredConv1d

    flax_path = mod_path
    for pat, rep in renames:
        flax_path = re.sub(pat, rep, flax_path)
    if model is None or not mod_path:
        return flax_path
    parent, _, name = mod_path.rpartition(".")
    encoder, _, attr = parent.rpartition(".")
    try:
        mod, outer = model.get_submodule(mod_path), model.get_submodule(parent)
        owner = model.get_submodule(encoder) if attr == "embed" else None
    except AttributeError:  # a key of another layout (flax_paths' keys)
        return flax_path
    if isinstance(owner, Encoder):
        # a transformer encoder's input layer ``embed.<i>``, by kind
        kind = _EMBED_KINDS.get(type(mod).__name__)
        if kind is not None:
            return ".".join(filter(None, (_flax_module(encoder, renames), kind)))
    if isinstance(outer, ConformerEncoder) and name == "embed" and isinstance(
            mod, torch.nn.Embedding):
        return flax_path.rpartition(".")[0] + ".embed_tokens" if parent else "embed_tokens"
    if isinstance(mod, ConvBatchNorm):
        flax_path = re.sub(r"(Masked)?GroupNorm_(\d+)$", r"BatchNorm_\2", flax_path)
    elif isinstance(outer, MultiLayeredConv1d):
        kind = ("Dense_0" if name == "w_2" and isinstance(outer, Conv1dLinear)
                else f"Conv_{int(name == 'w_2')}")
        flax_path = flax_path.rpartition(".")[0] + "." + kind
    return flax_path


# the flax names of a transformer encoder's input-layer modules (``linear``:
# pre, pre_norm; ``embed``: embed_tokens; the encoding: pos_enc)
_EMBED_KINDS = {"Linear": "pre", "LayerNorm": "pre_norm", "Embedding": "embed_tokens",
                "PositionalEncoding": "pos_enc", "ScaledPositionalEncoding": "pos_enc",
                "RelPositionalEncoding": "pos_enc", "LegacyRelPositionalEncoding": "pos_enc"}


def _renames_of(model: torch.nn.Module):
    return {"VTN": _VTN_RENAMES, "TransformerTTS": _TTS_RENAMES, "AASVC": _AASVC_RENAMES,
            "FastSpeechVC": _FASTSPEECH_VC_RENAMES}[type(model).__name__]


def flax_paths(model: torch.nn.Module, keys=None) -> Dict[str, str]:
    """{torch state_dict key: its flax parameter path, '/'-joined} for a
    VTN, TransformerTTS, AASVC or FastSpeechVC ``model`` (``keys``: other
    keys of the same layout, e.g. a checkpoint's; default the model's own).
    The leaf is named as in flax: ``kernel``, ``scale`` (norms),
    ``embedding``, ``bias``, ``mean`` and ``var`` (a batch norm's running
    statistics, of the ``batch_stats`` collection) or the torch name
    (``alpha``, ...)."""
    renames = _renames_of(model)
    modules = dict(model.named_modules())
    out = {}
    for key in (model.state_dict() if keys is None else keys):
        mod_path, _, leaf = key.rpartition(".")
        mod = modules.get(mod_path)
        if leaf == "weight":
            leaf = ("scale" if isinstance(mod, _norm_kinds())
                    else "embedding" if isinstance(mod, torch.nn.Embedding) else "kernel")
        leaf = _STATS.get(leaf, leaf)
        out[key] = "/".join(_flax_module(mod_path, renames, model).split(".") + [leaf])
    return out


def _norm_kinds():
    from .nn.conformer import ConvBatchNorm, MaskedGroupNorm

    return (torch.nn.LayerNorm, MaskedGroupNorm, ConvBatchNorm)


# a batch norm's running statistics: their leaves in flax's ``batch_stats``
_STATS = {"running_mean": "mean", "running_var": "var"}
# what a converted batch norm's ``num_batches_tracked`` holds (flax counts
# no batches; with a momentum set, torch reads the counter nowhere)
NUM_BATCHES_TRACKED = 0


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C")).to(like.dtype)  # a writable copy
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not match {tuple(like.shape)}")
    return t


def _state_dict(tree: Dict[str, Any], model: torch.nn.Module, renames,
                subsample_outs: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """Every tensor of ``model`` looked up in the flax ``tree`` by its module
    path after ``renames``. ``subsample_outs`` maps each Conv2dSubsampling
    output Linear to the conv whose channels order its input rows."""
    src = _Tree(tree)
    out: Dict[str, torch.Tensor] = {}
    for key, like in model.state_dict().items():
        mod_path, _, leaf = key.rpartition(".")
        mod = model.get_submodule(mod_path)
        flax_mod = _flax_module(mod_path, renames, model)
        path = tuple(flax_mod.split(".")) if flax_mod else ()
        if leaf == "num_batches_tracked":  # flax counts no batches
            arr = np.full(like.shape, NUM_BATCHES_TRACKED)
        elif leaf in _STATS:
            arr = src.pop_stat(path + (_STATS[leaf],))
        elif leaf == "bias":
            arr = src.pop(path + ("bias",))
        elif leaf != "weight":  # pos_bias_u/v, alpha, flow m/logs: same layout
            arr = src.pop(path + (leaf,)).reshape(like.shape)
        elif isinstance(mod, _norm_kinds()):
            arr = src.pop(path + ("scale",))
        elif isinstance(mod, torch.nn.Embedding):
            arr = src.pop(path + ("embedding",))
        elif isinstance(mod, torch.nn.Conv1d) and _SDP_DENSE.match(mod_path):
            arr = src.pop(path + ("kernel",)).T[:, :, None]
        elif isinstance(mod, torch.nn.Conv1d):
            arr = src.pop(path + ("kernel",)).transpose(2, 1, 0)
        elif isinstance(mod, torch.nn.Conv2d):
            arr = src.pop(path + ("kernel",)).transpose(3, 2, 0, 1)
        elif mod_path in subsample_outs:
            k = src.pop(path + ("kernel",))  # (F*C, A), row f*C + c
            C = model.get_submodule(subsample_outs[mod_path]).out_channels
            F = k.shape[0] // C
            arr = k.reshape(F, C, -1).transpose(2, 1, 0).reshape(-1, C * F)
        elif isinstance(mod, torch.nn.Linear):
            arr = src.pop(path + ("kernel",)).T
        else:
            raise TypeError(f"no conversion rule for {key} ({type(mod).__name__})")
        out[key] = _to_torch(arr, like)
    src.finish()
    return out


def aasvc_state_dict(tree: Dict[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax AASVC params -> a state_dict for the port's ``AASVC`` ``model``.

    ``model`` may also be one of its parts on its own (a ``ConformerEncoder``
    or a ``RelPositionMultiHeadedAttention``) with the matching flax tree.
    """
    return _state_dict(tree, model, _AASVC_RENAMES, _SUBSAMPLE_OUTS)


def vtn_state_dict(tree: Dict[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax VTN params -> a state_dict for the port's ``VTN`` ``model``.

    ``model`` may also be one of its parts on its own (an ``Encoder`` or a
    ``MultiHeadedAttention``) with the matching flax tree.
    """
    return _state_dict(tree, model, _VTN_RENAMES, {
        f"{p}embed.out.0": f"{p}embed.conv.2" for p in ("encoder.", "")})


def transformer_tts_state_dict(tree: Dict[str, Any],
                               model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax TransformerTTS params -> a state_dict for the port's
    ``TransformerTTS`` ``model`` (the embedding's table as it is: flax's
    ``embedding`` is (idim, adim), as torch's ``weight``)."""
    return _state_dict(tree, model, _TTS_RENAMES, {})


def fastspeech_vc_state_dict(tree: Dict[str, Any],
                             model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax FastSpeechVC params -> a state_dict for the port's
    ``FastSpeechVC`` ``model`` (transformer or conformer encoder and
    decoder)."""
    return _state_dict(tree, model, _FASTSPEECH_VC_RENAMES, _SUBSAMPLE_OUTS)


def _wn_weight(src: _Tree, mod: Path_, wn: Path_, conv: str) -> np.ndarray:
    """Effective kernel of a flax WeightNorm-wrapped conv: scale * k / ||k||
    over all axes but the output feature axis (when the scale is the
    kernel's own norm, the kernel comes back bit for bit)."""
    k = src.pop(mod + ("kernel",)).astype(np.float32)
    scale = src.pop(wn + (f"{conv}/kernel/scale",)).astype(np.float32)
    norm = np.linalg.norm(k.reshape(-1, k.shape[-1]), axis=0).astype(np.float32)
    return k * (scale / norm).astype(np.float32)


def _wn_conv(src: _Tree, sd, out, tkey: str, mod: Path_, wn: Path_, name: str, layout):
    """One flax WeightNorm-wrapped conv -> ``tkey``'s tensors: ``weight_v``
    (the kernel) and ``weight_g`` (the scale) where the port's layer keeps
    the weight norm, else the folded ``weight``; ``layout`` turns a flax
    kernel into the torch weight's layout."""
    if f"{tkey}.weight_v" in sd:
        g = sd[f"{tkey}.weight_g"]
        out[f"{tkey}.weight_v"] = _to_torch(layout(src.pop(mod + ("kernel",))),
                                            sd[f"{tkey}.weight_v"])
        out[f"{tkey}.weight_g"] = _to_torch(
            src.pop(wn + (f"{name}/kernel/scale",)).reshape(g.shape), g)
    else:
        out[f"{tkey}.weight"] = _to_torch(layout(_wn_weight(src, mod, wn, name)),
                                          sd[f"{tkey}.weight"])
    out[f"{tkey}.bias"] = _to_torch(src.pop(mod + ("bias",)), sd[f"{tkey}.bias"])


def _conv1d(k):
    return k.transpose(2, 1, 0)


def _conv_transpose1d(k):
    return k[::-1].transpose(1, 2, 0)


def _conv2d(k):
    return k.transpose(3, 2, 0, 1)


def _filled(sd, out) -> Dict[str, torch.Tensor]:
    missing = set(sd) - set(out)
    if missing:
        raise KeyError(f"port parameters left unfilled: {sorted(missing)}")
    return out


def hifigan_state_dict(tree: Dict[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax HifiganGenerator params -> a state_dict for the port's
    ``HifiganGenerator`` ``model``: weight norm folded for the inference
    form, kept (scale -> ``weight_g``, kernel -> ``weight_v``) for the
    training form (``weight_norm=True``)."""
    src = _Tree(tree)
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    nk = model.num_kernels
    _wn_conv(src, sd, out, "conv_pre", ("conv_pre",), ("WeightNorm_0",), "conv_pre", _conv1d)
    for i in range(len(model.ups)):
        up = (f"up_{i}",)
        _wn_conv(src, sd, out, f"ups.{i}", up + ("ConvTranspose_0",), up + ("WeightNorm_0",),
                 "ConvTranspose_0", _conv_transpose1d)
        for j in range(nk):
            r = i * nk + j
            rb = (f"resblock_{i}_{j}",)
            for d in range(len(model.resblocks[r].convs1)):
                for n, t in ((2 * d, f"convs1.{d}"), (2 * d + 1, f"convs2.{d}")):
                    _wn_conv(src, sd, out, f"resblocks.{r}.{t}", rb + (f"Conv_{n}",),
                             rb + (f"WeightNorm_{n}",), f"Conv_{n}", _conv1d)
    _wn_conv(src, sd, out, "conv_post", ("conv_post",), ("WeightNorm_1",), "conv_post", _conv1d)
    src.finish()
    return _filled(sd, out)


def hifigan_discriminator_state_dict(tree: Dict[str, Any],
                                     model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax HifiganDiscriminator params -> a state_dict for the port's
    ``HifiganDiscriminator`` ``model`` (weight norm kept: scale ->
    ``weight_g``, kernel -> ``weight_v``)."""
    src = _Tree(tree)
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for i, d in enumerate(model.mpd.discriminators):
        mod = ("mpd", f"period_{d.period}")
        for j in range(len(d.convs) + 1):
            tkey = f"mpd.discriminators.{i}." + (f"convs.{j}" if j < len(d.convs) else "conv_post")
            _wn_conv(src, sd, out, tkey, mod + (f"Conv_{j}",), mod + (f"WeightNorm_{j}",),
                     f"Conv_{j}", _conv2d)
    for i, d in enumerate(model.msd.discriminators):
        mod = ("msd", f"scale_{i}")
        for j in range(len(d.convs) + 1):
            tkey = f"msd.discriminators.{i}." + (f"convs.{j}" if j < len(d.convs) else "conv_post")
            _wn_conv(src, sd, out, tkey, mod + (f"Conv_{j}",), mod + (f"WeightNorm_{j}",),
                     f"Conv_{j}", _conv1d)
    src.finish()
    return _filled(sd, out)


def hubert_soft_state_dict(tree: Dict[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax HubertSoft params (seq2seq_vc_tpu/urhythmic/hubert.py) -> a
    state_dict for the port's ``HubertSoft`` ``model`` (bshall names; q, k
    and v packed into ``in_proj``)."""
    src = _Tree(tree)
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = _to_torch(arr, sd[key])

    def dense(tkey, path):
        put(f"{tkey}.weight", src.pop(path + ("kernel",)).T)
        put(f"{tkey}.bias", src.pop(path + ("bias",)))

    def norm(tkey, path):
        put(f"{tkey}.weight", src.pop(path + ("scale",)))
        put(f"{tkey}.bias", src.pop(path + ("bias",)))

    fe = ("feature_extractor",)
    for i in range(sum(k.startswith("feature_extractor.conv") for k in sd)):
        put(f"feature_extractor.conv{i}.weight", _conv1d(src.pop(fe + (f"conv{i}", "kernel"))))
    norm("feature_extractor.norm0", fe + ("group_norm",))
    norm("feature_projection.norm", ("fp_norm",))
    dense("feature_projection.projection", ("fp_proj",))
    put("positional_embedding.conv.weight", _conv1d(src.pop(("pos_conv", "kernel"))))
    put("positional_embedding.conv.bias", src.pop(("pos_conv", "bias")))
    norm("norm", ("enc_norm",))
    for i in range(len(model.encoder.layers)):
        t, f = f"encoder.layers.{i}", (f"layer_{i}",)
        att = f + ("attention",)
        put(f"{t}.self_attn.in_proj_weight", np.concatenate(
            [src.pop(att + (f"{n}_proj", "kernel")).T for n in "qkv"]))
        put(f"{t}.self_attn.in_proj_bias", np.concatenate(
            [src.pop(att + (f"{n}_proj", "bias")) for n in "qkv"]))
        dense(f"{t}.self_attn.out_proj", att + ("out_proj",))
        norm(f"{t}.norm1", f + ("layer_norm",))
        norm(f"{t}.norm2", f + ("final_layer_norm",))
        dense(f"{t}.linear1", f + ("ffn_in",))
        dense(f"{t}.linear2", f + ("ffn_out",))
    dense("proj", ("proj",))
    put("label_embedding.weight", src.pop(("label_embedding",)))
    src.finish()
    return _filled(sd, out)
