"""Port: the rest of ROADMAP.md queue 1 item 5 but ``parallel/`` against the
JAX package: ``MLELoss``, the ``adamw`` and ``sgd`` optimizers, kaldi-ark
features and ``vc_decode``'s diagnostic plots.

Tolerances: ``MLELoss`` rtol 1e-6 (float32 sums in another order); the
optimizers' parameters after three steps atol 1e-6 (a few float32 ulps of
parameters near 1), as tests/test_torch_train.py holds Adam; kaldi-ark
reads exact.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from _torch_port import aasvc_pair, release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.train.data import _make_loader as jax_make_loader
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.utils.io import write_kaldi_ark as jax_write_kaldi_ark
from seq2seq_vc_tpu.utils.io import write_hdf5 as jax_write_hdf5
from seq2seq_vc_torch.bin import vc_decode
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.losses import get_criterion
from seq2seq_vc_torch.train.data import KaldiArkScpLoader, ParallelVCMelDataset, make_loader
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.utils.io import write_kaldi_ark


def test_mle_loss_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((3, 17, 6)).astype(np.float32)
    logdet = rng.standard_normal(3).astype(np.float32)
    mask = np.arange(17)[None] < np.array([17, 9, 1])[:, None]
    want = float(jax_criterion("MLELoss")(jnp.asarray(z), jnp.asarray(logdet), mask))
    got = get_criterion("MLELoss")(torch.from_numpy(z), torch.from_numpy(logdet),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# --------------------------------------------------------------- optimizers
# the tiny AAS-VC with fewer parameter tensors (no postnet, conv module or
# macaron feed-forward, the deterministic duration predictor), so that
# optax's update compiles quickly
LEAN = dict(duration_predictor_type="deterministic", postnet_layers=0,
            use_cnn_in_conformer=False, use_macaron_style_in_conformer=False,
            duration_predictor_use_encoder_outputs=True)


@pytest.mark.parametrize("kind,params", [
    ("AdamW", {}),  # optax's default weight decay 1e-4
    ("AdamW", {"weight_decay": 0.05, "b1": 0.8, "b2": 0.99}),
    ("SGD", {}),
    ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True}),
])
def test_optimizers_match_optax(kind, params):
    """Three updates with the warmup schedule, clipping by the global norm
    (the first step's gradients over the limit, the others under it),
    gradient accumulation of 2 and the encoder frozen, from the same random
    gradients. Each gradient element is 0.5-1.5 times its scale with a
    random sign, the same in both micro-batches of an update: no
    accumulated element lies within rounding of 0, where Adam's normalised
    step g / (|g| + eps) would turn float32 noise into a step of the
    learning rate."""
    port, _, flax = aasvc_pair(seed=0, **LEAN)
    cfg = dict(optimizer_type=kind, optimizer_params=dict(params, lr=0.05),
               scheduler_params={"warmup_steps": 3}, grad_norm=1.0,
               gradient_accumulate_steps=2, freeze_mods=["encoder"])
    opt = build_optimizer(port, **cfg)
    tx, _ = jax_build_optimizer(**cfg)
    state = jax.jit(tx.init)(flax)
    update, apply = jax.jit(tx.update), jax.jit(optax.apply_updates)
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree_util.tree_flatten(flax)
    jp = flax
    for step in range(3):
        scale = (3.0 if step == 0 else 0.3) / np.sqrt(sum(np.size(a) for a in leaves))
        signs = [scale * rng.choice([-1.0, 1.0], np.shape(a)) for a in leaves]
        for _ in range(2):  # micro-batches
            grads = jax.tree_util.tree_unflatten(treedef, [
                (s * rng.uniform(0.5, 1.5, np.shape(s))).astype(np.float32) for s in signs])
            for name, g in aasvc_state_dict(grads, port).items():
                p = port.get_parameter(name)
                if p.requires_grad:
                    p.grad = g.clone() if p.grad is None else p.grad + g
            upd, state = update(grads, state, jp)
            jp = apply(jp, upd)
        norm = opt.step()
        assert (norm.item() > 1.0) == (step == 0)
    assert opt.count == 3
    frozen = 0
    for name, w in aasvc_state_dict(jp, port).items():
        p = port.state_dict()[name]
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)
        frozen += name.startswith("encoder.")
    assert frozen > 0 and not any(p.requires_grad for n, p in port.named_parameters()
                                  if n.startswith("encoder."))


def test_unknown_optimizer_and_optimizer_params_raise():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="unknown optimizer_type"):
        build_optimizer(p, optimizer_type="Lion")
    with pytest.raises(TypeError, match="momentum"):
        build_optimizer(p, optimizer_type="AdamW", optimizer_params={"momentum": 0.9})


# ----------------------------------------------------------------- kaldi ark
def test_kaldi_ark_reads_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    arrays = {f"utt{i}": rng.standard_normal((20 + 7 * i, 80)).astype(np.float32)
              for i in range(3)}
    scps = {}
    for side, writer in (("port", write_kaldi_ark), ("jax", jax_write_kaldi_ark)):
        scp = writer(str(tmp_path / side / "feats.ark"), arrays)
        scps[side] = tmp_path / side / "feats.scp"
        scps[side].write_text("".join(f"{k} {v}\n" for k, v in scp.items()))
    # the two writers write the same bytes
    assert (tmp_path / "port/feats.ark").read_bytes() == (tmp_path / "jax/feats.ark").read_bytes()
    loader, ref = make_loader(str(scps["port"])), jax_make_loader(str(scps["port"]))
    assert isinstance(loader, KaldiArkScpLoader) and type(ref).__name__ == "KaldiArkScpLoader"
    for utt, arr in arrays.items():
        np.testing.assert_array_equal(loader[utt], ref[utt])
        np.testing.assert_array_equal(loader[utt], arr)
        assert loader.length(utt) == len(arr)
    # a float64 (DM) entry, as kaldi writes one
    with open(tmp_path / "dm.ark", "wb") as f:
        f.write(b"u ")
        off = f.tell()
        f.write(b"\x00BDM \x04" + (2).to_bytes(4, "little") + b"\x04" + (3).to_bytes(4, "little"))
        f.write(np.arange(6, dtype=np.float64).tobytes())
    (tmp_path / "dm.scp").write_text(f"u {tmp_path / 'dm.ark'}:{off}\n")
    np.testing.assert_array_equal(make_loader(str(tmp_path / "dm.scp"))["u"],
                                  jax_make_loader(str(tmp_path / "dm.scp"))["u"])
    # a paired dataset reads arks through its loaders
    ds = ParallelVCMelDataset(str(scps["port"]), str(scps["jax"]))
    assert len(ds) == 3 and ds.length(0) == 20
    np.testing.assert_array_equal(ds[1]["src_feat"], arrays["utt1"])


# -------------------------------------------------------- vc_decode's plots
def _decode_setup(tmp_path, with_jax: bool = True):
    """JAX's vc_decode test set-up (tests/test_vc_decode_cli.py) with a
    small ProDiff decoder: a tiny AAS-VC, 3 utterances, the port's
    checkpoint and, ``with_jax``, a flax one (weights of its own: only the
    plot files are compared)."""
    from seq2seq_vc_tpu.bin.vc_train import init_model_params
    from seq2seq_vc_tpu.core.checkpoint import save_checkpoint
    from seq2seq_vc_tpu.models import AASVC as JaxAASVC
    from seq2seq_vc_torch.models.aas_vc import AASVC

    d = 20
    rng = np.random.default_rng(0)
    for i in range(3):
        jax_write_hdf5(str(tmp_path / "dump" / f"utt{i}.h5"), "feats",
                       rng.standard_normal((20 + 8 * i, d)).astype(np.float32))
    model_params = dict(
        idim=d, odim=d, adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32,
        postnet_layers=0, post_encoder_reduction_factor=2, decoder_reduction_factor=2,
        duration_predictor_type="deterministic", conformer_enc_kernel_size=7,
        conformer_dec_kernel_size=7, decoder_type="prodiff", prodiff_denoiser_layers=2,
        prodiff_denoiser_channels=8, prodiff_diffusion_steps=2)
    config = {"sampling_rate": 16000, "fft_size": 256, "hop_size": 128, "num_mels": d,
              "fmin": 80, "fmax": 7600, "model_type": "AASVC", "model_params": model_params,
              "collater_type": "NARVCCollater", "inference": {}}
    exp = tmp_path / "exp"
    os.makedirs(exp)
    (exp / "config.yml").write_text(yaml.safe_dump(config))
    torch.manual_seed(0)
    port = AASVC(**model_params)
    torch.save({"model": port.state_dict(), "steps": 1}, exp / "checkpoint-1steps.pt")
    if with_jax:
        dummy = {"xs": np.zeros((1, 64, d), np.float32), "ilens": np.asarray([64], np.int32),
                 "ys": np.zeros((1, 64, d), np.float32), "olens": np.asarray([64], np.int32)}
        params = init_model_params(JaxAASVC(**model_params), config, dummy)
        save_checkpoint(str(exp / "checkpoint-1steps.ckpt"), params, {}, 1, 1)
    return exp


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".png"))


def test_vc_decode_writes_the_plots_jax_writes(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    from seq2seq_vc_tpu.bin import vc_decode as jax_vc_decode

    exp = _decode_setup(tmp_path)
    monkeypatch.setenv("S2S_JAX_CACHE_DIR", "")
    monkeypatch.setattr(sys, "argv", ["vc_decode", "--dumpdir", str(tmp_path / "dump"),
                                      "--checkpoint", str(exp / "checkpoint-1steps.ckpt"),
                                      "--outdir", str(tmp_path / "jax"), "--feat-type", "feats"])
    jax_vc_decode.main()
    port_args = ["--dumpdir", str(tmp_path / "dump"), "--checkpoint",
                 str(exp / "checkpoint-1steps.pt"), "--feat-type", "feats", "--device", "cpu"]
    vc_decode.main(port_args + ["--outdir", str(tmp_path / "port")])
    want = _pngs(tmp_path / "jax")
    assert want == ["outs/utt0.png", "outs/utt1.png", "outs/utt2.png"]
    assert _pngs(tmp_path / "port") == want
    vc_decode.main(port_args + ["--outdir", str(tmp_path / "skip"), "--skip-plots"])
    assert _pngs(tmp_path / "skip") == [] and len(os.listdir(tmp_path / "skip" / "wav")) == 3


def test_vc_decode_plots_are_best_effort_without_matplotlib(tmp_path, monkeypatch, caplog):
    """A missing plot library is logged; the decode carries on."""
    exp = _decode_setup(tmp_path, with_jax=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    r = vc_decode.main(["--dumpdir", str(tmp_path / "dump"), "--checkpoint",
                        str(exp / "checkpoint-1steps.pt"), "--feat-type", "feats",
                        "--device", "cpu", "--outdir", str(tmp_path / "out")])
    assert r["frames"] > 0 and len(os.listdir(tmp_path / "out" / "wav")) == 3
    assert _pngs(tmp_path / "out") == []
    assert "plot_2d failed" in caplog.text
