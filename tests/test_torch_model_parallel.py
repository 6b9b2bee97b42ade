"""Port: tensor, sequence and pipeline parallelism (seq2seq_vc_torch/parallel/
tp.py, ring_attention.py, pp.py and plan.py) on the CPU, over ``gloo``
ranks launched by ``torchrun`` (tests/_torch_mp_worker.py).

Two launches serve the whole file, each run once a session (a file lock
shares its results between the test workers) and each with its own
timeout: two ranks run the ring functions, ``pipeline_apply`` and one
``vc_train`` step of the tiny AAS-VC in each mode (``tensor_parallel``,
``sequence_parallel``, ``pipeline_parallel`` with 2 microbatches); four
ranks run the compositions (TP x SP, FastSpeech-VC under SP x DP, PP x DP,
``tts_train`` of a tiny Transformer-TTS under TP x DP).

The ring functions and ``pipeline_apply`` are held against the JAX
package's ``shard_map`` versions on a mesh of the suite's fake CPU devices
(tests/conftest.py), forward and input gradients, to 1e-5. Each step's
logged loss terms and checkpoint are held against the port's
single-process step on the same (padded) batch and, for the three modes,
against the JAX trainer's step on the same mesh layout: losses rtol 1e-5,
parameters atol 1e-5, as tests/test_torch_parallel.py holds data
parallelism. Dropout is off and the duration loss waits
(``dp_train_start_steps``), so that no draw differs. Checkpoints hold the
single-process layout, and ``vc_decode`` decodes from one.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from filelock import FileLock
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from _torch_port import NO_DROPOUT, TINY_AASVC, release_jax_executables  # noqa: F401
from seq2seq_vc_tpu.convert.reference import convert_aasvc
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.parallel import get_mesh as jax_get_mesh
from seq2seq_vc_tpu.parallel import shard_params as jax_shard_params
from seq2seq_vc_tpu.parallel.pp import pipeline_apply as jax_pipeline_apply
from seq2seq_vc_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from seq2seq_vc_tpu.parallel.ring_attention import ring_rel_attention as jax_ring_rel
from seq2seq_vc_tpu.train.aas_vc import AASVCTrainer as JaxAASVCTrainer
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.bin import tokenize_text, tts_train, vc_decode, vc_train
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.models import get_model_class
from seq2seq_vc_torch.parallel import shard_batch
from seq2seq_vc_torch.parallel.pp import pipeline_module_stack
from seq2seq_vc_torch.parallel.ring_attention import ring_attention, ring_rel_attention
from seq2seq_vc_torch.parallel.tp import split_dim
from seq2seq_vc_torch.train.data import DataLoader, ParallelVCMelDataset
from seq2seq_vc_torch.train.tts_data import ARTTSCollater, TTSDataset
from test_torch_cli import SYNTH, _conf, _write_feats
from test_torch_fastspeech_vc import ARCTIC as FS2_ARCTIC
from test_torch_fastspeech_vc import NO_DROPOUT as FS2_NO_DROPOUT
from test_torch_fastspeech_vc import SMALL as FS2_SMALL
from test_torch_fastspeech_vc import _corpus as fs2_corpus

REPO = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 300  # seconds a torchrun launch may take (a hang fails its tests)
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
# the compositions' optimizer: plain SGD at lr 1 after the global-norm clip,
# so that a parameter's update is its gradient (Adam's first step is the
# gradient's sign, blind to a gradient counted twice)
SGD = dict(optimizer_type="SGD", optimizer_params={"lr": 1.0}, scheduler_params={"warmup_steps": 1},
           grad_norm=1.0)
# the tiny AAS-VC with 2 + 2 layers (so that 2 stages split them) and the
# deterministic duration predictor (its JAX step compiles in a third of
# the stochastic one's time; the compositions take the stochastic one)
MODEL = dict(TINY_AASVC, **NO_DROPOUT, elayers=2, dlayers=2, postnet_dropout_rate=0.0,
             stochastic_duration_predictor_dropout_rate=0.0, compute_dtype="float32",
             attention_backend="xla", duration_predictor_type="deterministic",
             duration_predictor_chans=16)
STOCHASTIC = dict(duration_predictor_type="stochastic")
TERMS = ("loss", "l1_loss", "forward_sum_loss", "binary_loss")
MODES = {"tp": {"tensor_parallel": 2}, "sp": {"sequence_parallel": 2},
         "pp": {"pipeline_parallel": 2, "pipeline_microbatches": 2}}
# the compositions on 4 ranks: (entry point, config overlay, model overlay).
# TP x SP (one data rank) trains the stochastic duration predictor from
# the first step: its noise, drawn on every rank of the replica, must be
# the single process's draw
COMPOSED = {"tp_sp": ("vc_train", {"tensor_parallel": 2, "sequence_parallel": 2,
                                   "dp_train_start_steps": 0}, STOCHASTIC),
            "fs2_sp": ("vc_train", {"sequence_parallel": 2}, None),
            "pp_dp": ("vc_train", {"pipeline_parallel": 2}, STOCHASTIC),
            "tts_tp": ("tts_train", {"tensor_parallel": 2}, None)}
TTS_SYNTH = REPO / "egs/synth/tts1/conf/tts.synth.yaml"
TTS_NO_DROPOUT = dict(transformer_enc_dropout_rate=0.0, transformer_enc_positional_dropout_rate=0.0,
                      transformer_enc_attn_dropout_rate=0.0, transformer_dec_dropout_rate=0.0,
                      transformer_dec_positional_dropout_rate=0.0,
                      transformer_dec_attn_dropout_rate=0.0, dprenet_dropout_rate=0.0,
                      postnet_layers=0)  # the postnet's dropout is fixed at 0.5: no postnet
CONV_GRADS = ("conv_module.depthwise_conv.weight", "conv_module.pointwise_conv1.weight")


# ------------------------------------------------------------------ launches
def _torchrun(n: int, jobs, root: Path):
    (root / "jobs.json").write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(n), str(REPO / "tests/_torch_mp_worker.py"),
                          str(root / "jobs.json")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=LAUNCH_TIMEOUT)
    assert run.returncode == 0, run.stderr[-6000:]


def _shared(tmp_path_factory, name: str, make):
    """``make(root)`` once a session across the test workers."""
    base = tmp_path_factory.getbasetemp()
    base = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    root = base / name
    with FileLock(str(base / f"{name}.lock")):
        if not (root / "done").exists():
            root.mkdir(exist_ok=True)
            make(root)
            (root / "done").write_text("")
    return root


def _config(path=SYNTH, **over):
    config = _conf(path, **dict(MODEL, **over)) if path == SYNTH else _conf(path, **over)
    config.update(OPT, batch_size=3, train_max_steps=1, log_interval_steps=1, seed=0,
                  eval_interval_steps=1000, save_interval_steps=1000, dp_train_start_steps=100,
                  num_save_intermediate_results=0)
    return config


def _corpus(root: Path):
    # 3 utterances of unequal lengths: the batch pads to the pipeline's
    # microbatches, and a rank's time block holds padded frames
    return (_write_feats(root, "src", [40, 47, 33], seed=4),
            _write_feats(root, "trg", [44, 50, 36], seed=5))


def _vc_args(root: Path, src, trg, conf: Path, out: Path):
    return ["--src-train-dumpdir", src, "--src-dev-dumpdir", src, "--trg-train-dumpdir", trg,
            "--trg-dev-dumpdir", trg, "--train-dp-input-dir", src, "--dev-dp-input-dir", src,
            "--outdir", str(out), "--config", str(conf), "--device", "cpu"]


def _inputs(seed: int = 0):
    """The ring functions' and the pipeline's inputs, from numpy."""
    rng = np.random.default_rng(seed)
    B, H, T, D = 2, 2, 16, 8

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ring = dict(q=a(B, H, T, D), qv=a(B, H, T, D), k=a(B, H, T, D), v=a(B, H, T, D),
                dy=a(B, H, T, D), p=a(H, 2 * T - 1, D), lens=np.array([16, 11], np.int32))
    pipe = dict(w=a(4, D, D) * 0.5, xs=a(2, 3, D), dy=a(2, 3, D))
    return ring, pipe


@pytest.fixture
def two_ranks(tmp_path_factory):
    def make(root):
        src, trg = _corpus(root / "corpus")
        ring, pipe = _inputs()
        np.savez(root / "ring_in.npz", **ring)
        np.savez(root / "pipe_in.npz", **pipe)
        jobs = [{"kind": "ring", "in": str(root / "ring_in.npz"), "out": str(root / "ring.npz")},
                {"kind": "pipeline", "in": str(root / "pipe_in.npz"),
                 "out": str(root / "pipe.npz")}]
        for mode, over in MODES.items():
            config = dict(_config(), **over)
            (root / f"{mode}.yaml").write_text(yaml.safe_dump(config))
            jobs.append({"kind": "vc_train", "out": str(root / f"{mode}.json"),
                         "argv": _vc_args(root, src, trg, root / f"{mode}.yaml", root / mode)})
        # --resume of the TP checkpoint under PP: the single-process layout
        # split again another way, one more step
        resume = dict(_config(), train_max_steps=2, **MODES["pp"])
        (root / "resume.yaml").write_text(yaml.safe_dump(resume))
        jobs.append({"kind": "vc_train", "out": str(root / "resume.json"),
                     "argv": _vc_args(root, src, trg, root / "resume.yaml", root / "resume")
                     + ["--resume", str(root / "tp" / "checkpoint-1steps.pt")]})
        _torchrun(2, jobs, root)

    return _shared(tmp_path_factory, "model_parallel_two", make)


def _tts_corpus(root: Path):
    from test_torch_tts import _write_corpus

    root.mkdir(parents=True, exist_ok=True)
    text, scp = _write_corpus(root, n=4)
    tokens = root / "tokens.txt"
    tokenize_text.main(["--input", str(text), "--output", str(tokens), "--token_type", "phn",
                        "--g2p", "g2p_en", "--cleaner", "tacotron"])
    return text, scp, tokens


def _tts_args(text, scp, tokens, conf: Path, out: Path):
    return ["--train-dumpdir", str(scp), "--dev-dumpdir", str(scp), "--train-text", str(text),
            "--dev-text", str(text), "--token-list", str(tokens), "--token-type", "phn",
            "--g2p", "g2p_en", "--config", str(conf), "--outdir", str(out), "--device", "cpu"]


def _composed_config(name: str):
    return dict(_composed_base(name), **SGD)


def _composed_base(name: str):
    entry, over, model = COMPOSED[name]
    if name == "tts_tp":
        config = _conf(TTS_SYNTH, **TTS_NO_DROPOUT)
        config.update(OPT, batch_size=4, train_max_steps=1, log_interval_steps=1, seed=0,
                      eval_interval_steps=1000, save_interval_steps=1000)
    elif name == "fs2_sp":  # the conformer layout: conv2d input layer, conformer decoder
        config = _config(FS2_ARCTIC, **FS2_NO_DROPOUT, **FS2_SMALL, conformer_enc_kernel_size=7,
                         conformer_dec_kernel_size=7, attention_backend="xla")
        config["batch_size"] = 4
    else:
        config = _config(**model)
        config["batch_size"] = 4
    return dict(config, **over)


@pytest.fixture
def four_ranks(tmp_path_factory):
    def make(root):
        src, trg = _corpus(root / "corpus")
        text, scp, tokens = _tts_corpus(root / "tts")
        fs2 = _composed_config("fs2_sp")
        fs2_src, fs2_trg, dur = fs2_corpus(
            root / "fs2", fs2["model_params"]["teacher_model_decoder_reduction_factor"])
        jobs = []
        for name, (entry, _, _) in COMPOSED.items():
            (root / f"{name}.yaml").write_text(yaml.safe_dump(_composed_config(name)))
            if entry == "tts_train":
                argv = _tts_args(text, scp, tokens, root / f"{name}.yaml", root / name)
            elif name == "fs2_sp":
                argv = _vc_args(root, fs2_src, fs2_trg, root / f"{name}.yaml", root / name) + [
                    "--train-duration-dir", dur, "--dev-duration-dir", dur]
            else:
                argv = _vc_args(root, src, trg, root / f"{name}.yaml", root / name)
            jobs.append({"kind": entry, "out": str(root / f"{name}.json"), "argv": argv})
        _torchrun(4, jobs, root)

    return _shared(tmp_path_factory, "model_parallel_four", make)


# ---------------------------------------------------------- single process
def _loader_batch(config, src, trg, batch_size, durations=None):
    dataset = ParallelVCMelDataset(src, trg, dp_feats=src, feat_key="mel",
                                   durations_dir=durations)
    return next(iter(DataLoader(dataset, vc_train.build_collater(config), batch_size,
                                shuffle=True, seed=0)))


def _one_process(config):
    """``config`` without its model-parallel modes: the single-process run."""
    return {k: v for k, v in config.items() if k not in (
        "tensor_parallel", "sequence_parallel", "pipeline_parallel", "pipeline_microbatches")}


def _single(config, batches):
    """The port's single-process steps on ``batches``: the first step's
    history and the updated state_dict, from the initial weights
    ``vc_train`` builds."""
    config = _one_process(config)
    torch.manual_seed(config.get("seed", 0))
    model = get_model_class(config["model_type"])(**config["model_params"])
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    from seq2seq_vc_torch.train import get_trainer_class

    trainer = get_trainer_class(config.get("trainer_type"))(
        vc_train.build_state(model, config, "", "cpu"),
        vc_train.build_criterion(config), config, batches, device="cpu")
    trainer.run()
    return trainer.history[0], model.state_dict(), state0, model


def _padded(batch, multiple):
    return shard_batch(batch, 0, 1, multiple)


def _data_ranks_rows(batch, data: int, n_micro: int = 1):
    """The global batch as ``data`` ranks pad and hold it, their rows in
    rank order."""
    parts = [shard_batch(batch, r, data, n_micro) for r in range(data)]
    return {k: (np.concatenate([h[k] for h in parts]) if isinstance(v, np.ndarray)
                else sum((h[k] for h in parts), [])) for k, v in batch.items()}


def _history(root: Path, name: str):
    return json.loads((root / f"{name}.json").read_text())[0]


def _ckpt(root: Path, name: str, steps: int = 1):
    return torch.load(root / name / f"checkpoint-{steps}steps.pt", weights_only=True)


def _assert_losses(got, want, terms=TERMS):
    for name in terms:
        np.testing.assert_allclose(got[f"train/{name}"], want[f"train/{name}"], rtol=1e-5,
                                   err_msg=name)


def _assert_params(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def _mode_batch(root: Path, mode: str):
    config = dict(_config(), **MODES[mode])
    src, trg = str(root / "corpus/src.scp"), str(root / "corpus/trg.scp")
    batch = _loader_batch(config, src, trg, 3)
    return config, _padded(batch, 2 if mode == "pp" else 1)


# ------------------------------------------------------------------- JAX side
def _jax_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jax_get_mesh(devices=jax.devices()[:n], **dict(dict(data=1), **axes))


def _jax_step(mode: str, state0, padded, config):
    """The JAX trainer's loss terms and updated parameters on the same mesh
    layout (data 1 and the mode's axis 2), from the port's weights."""
    plain = JaxAASVC(**MODEL, alignment_dist_form="direct")
    flax = convert_aasvc(state0, plain)
    if mode == "tp":
        mesh = _jax_mesh(model=2)
        jax_model = plain
        flax = jax_shard_params(flax, mesh)
    elif mode == "sp":
        mesh = _jax_mesh(seq=2)
        jax_model = JaxAASVC(**MODEL, alignment_dist_form="direct", sp_mesh=mesh)
    else:
        mesh = _jax_mesh(pipe=2)
        jax_model = JaxAASVC(**MODEL, alignment_dist_form="direct", pipe_mesh=mesh,
                             pipe_microbatches=2)
    tx, _ = jax_build_optimizer(**OPT)
    trainer = JaxAASVCTrainer(jax_model, JaxTrainState.create(flax, tx),
                              {"L1Loss": jax_criterion("L1Loss")}, dict(config), [],
                              mesh=mesh, writer=False)
    arrays = trainer._array_batch(padded)
    rngs = {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: trainer.loss_fn(p, arrays, rngs, trainer._flags()), has_aux=True))(flax)
    # the update jitted: eager optax takes ~10x as long on the CPU
    params = jax.jit(lambda st, g: st.apply_gradients(g).params)(trainer.state, grads)
    return ({f"train/{k}": float(v) for k, v in dict(metrics, loss=loss).items()}, params)


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("case", ["causal", "masked", "rel"])
def test_ring_functions_match_jax_shard_map(two_ranks, case):
    got = np.load(two_ranks / "ring.npz")
    ring, _ = _inputs()
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("sp",))
    t = P(None, None, "sp", None)
    lens = jnp.asarray(ring["lens"])
    if case == "rel":
        def f(q, qv, k, v, p):
            return shard_map(lambda *a: jax_ring_rel(*a, axis_name="sp"), mesh=mesh,
                             in_specs=(t, t, t, t, P(), P()), out_specs=t,
                             check_rep=False)(q, qv, k, v, p, lens)
        names = ("q", "qv", "k", "v", "p")
    else:
        def f(q, k, v):
            fn = lambda q_, k_, v_, l_: jax_ring_attention(  # noqa: E731
                q_, k_, v_, None if case == "causal" else l_, axis_name="sp",
                causal=case == "causal")
            return shard_map(fn, mesh=mesh, in_specs=(t, t, t, P()), out_specs=t,
                             check_rep=False)(q, k, v, lens)
        names = ("q", "k", "v")
    out, grads = jax.jit(lambda *a: (f(*a), jax.vjp(f, *a)[1](jnp.asarray(ring["dy"]))))(
        *(jnp.asarray(ring[n]) for n in names))
    np.testing.assert_allclose(got[f"{case}/out"], np.asarray(out), rtol=0, atol=1e-5)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(got[f"{case}/d{n}"], np.asarray(g), rtol=0, atol=1e-5,
                                   err_msg=n)


def test_ring_of_one_rank_is_plain_attention():
    ring, _ = _inputs(1)
    q, k, v, qv = (torch.from_numpy(ring[n]) for n in ("q", "k", "v", "qv"))
    lens = torch.from_numpy(ring["lens"])
    mask = torch.arange(16)[None, :] < lens[:, None]
    w = torch.softmax((q @ k.transpose(-1, -2) / 8 ** 0.5).masked_fill(~mask[:, None, None], -1e9),
                      -1)
    np.testing.assert_allclose(ring_attention(q, k, v, lens).numpy(), (w @ v).numpy(),
                               atol=1e-6, rtol=0)
    causal = torch.ones(16, 16).tril().bool()
    w = torch.softmax((q @ k.transpose(-1, -2) / 8 ** 0.5).masked_fill(~causal, -1e9), -1)
    np.testing.assert_allclose(ring_attention(q, k, v, causal=True).numpy(), (w @ v).numpy(),
                               atol=1e-6, rtol=0)
    from seq2seq_vc_torch.nn.attention import rel_shift

    p = torch.from_numpy(ring["p"])
    s = (q @ k.transpose(-1, -2) + rel_shift(torch.einsum("bhqd,hpd->bhqp", qv, p))) / 8 ** 0.5
    w = torch.softmax(s.masked_fill(~mask[:, None, None], -1e9), -1)
    np.testing.assert_allclose(ring_rel_attention(q, qv, k, v, p, lens).numpy(),
                               (w @ v).numpy(), atol=1e-5, rtol=0)


def test_pipeline_apply_matches_jax(two_ranks):
    got = np.load(two_ranks / "pipe.npz")
    _, pipe = _inputs()
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("pipe",))

    def f(w, xs):
        return jax_pipeline_apply(lambda wj, x: jnp.tanh(x @ wj), w, xs, mesh=mesh)

    out, vjp = jax.vjp(f, jnp.asarray(pipe["w"]), jnp.asarray(pipe["xs"]))
    dw, dxs = vjp(jnp.asarray(pipe["dy"]))
    np.testing.assert_allclose(got["out"], np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["dw"], np.asarray(dw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["dxs"], np.asarray(dxs), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_step_matches_single_process(two_ranks, mode):
    config, padded = _mode_batch(two_ranks, mode)
    one, params, state0, _ = _single(config, [padded])
    _assert_losses(_history(two_ranks, mode), one)
    ckpt = _ckpt(two_ranks, mode)
    _assert_params(ckpt["model"], params)
    assert any(not torch.equal(ckpt["model"][k], state0[k]) for k in state0)  # a step was taken


@pytest.mark.parametrize("mode", list(MODES))
def test_step_matches_jax_on_the_same_mesh(two_ranks, mode):
    config, padded = _mode_batch(two_ranks, mode)
    torch.manual_seed(0)
    model = get_model_class("AASVC")(**MODEL)
    want, jax_params = _jax_step(mode, model.state_dict(), padded, config)
    _assert_losses(_history(two_ranks, mode), want)
    jax_sd = aasvc_state_dict(jax.device_get(jax_params), model)
    ckpt = _ckpt(two_ranks, mode)["model"]
    for name in ckpt:
        np.testing.assert_allclose(ckpt[name].numpy(), jax_sd[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode,full", [("tp", False), ("sp", True), ("pp", False)])
def test_each_rank_holds_its_slice_or_stage(two_ranks, mode, full):
    torch.manual_seed(0)
    n = sum(p.numel() for p in get_model_class("AASVC")(**MODEL).parameters())
    counts = [int((two_ranks / f"{mode}.json.rank{r}.params").read_text()) for r in range(2)]
    if full:  # sequence parallelism splits the activations, not the weights
        assert counts == [n, n]
    else:
        assert all(c < n for c in counts), (counts, n)
        if mode == "pp":  # the stages share the replicated parameters
            assert counts[0] == counts[1]


def _ranks_agree(root: Path, name: str, n: int):
    held = [torch.load(f"{root / name}.json.rank{r}.pt", weights_only=True) for r in range(n)]
    shared = set.intersection(*(set(h) for h in held))
    replicated = [k for k in shared if split_dim(k) is None]
    assert replicated
    for k in replicated:
        for h in held[1:]:
            assert torch.equal(h[k], held[0][k]), k


@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_agree_on_replicated_parameters(two_ranks, mode):
    """After the step every rank holds the same replicated parameters
    (rank 0 alone writes the checkpoint: a rank whose replicated
    gradients were not whole would drift from it unseen)."""
    _ranks_agree(two_ranks, mode, 2)


def test_resumed_checkpoint_is_split_again(two_ranks):
    """One TP step, then ``--resume`` of its checkpoint under PP for one
    more: the single-process run of the same two steps."""
    config, padded = _mode_batch(two_ranks, "pp")
    config["train_max_steps"] = 2
    _, unpadded = _mode_batch(two_ranks, "tp")
    # the loader's one batch each epoch: as it is in the TP step, padded to
    # the microbatches in the PP step
    _, params, _, _ = _single(config, [unpadded, padded])
    ckpt = _ckpt(two_ranks, "resume", 2)
    assert ckpt["steps"] == 2
    _assert_params(ckpt["model"], params)


def test_vc_decode_reads_a_model_parallel_checkpoint(two_ranks, tmp_path):
    exp = tmp_path / "exp"
    exp.mkdir()
    config = dict(_config(), **MODES["tp"])
    (exp / "config.yml").write_text(yaml.safe_dump(config))
    ckpt = two_ranks / "tp" / "checkpoint-1steps.pt"
    src = str(two_ranks / "corpus/src.scp")
    vc_decode.main(["--dumpdir", src, "--dp-input-dir", src, "--checkpoint", str(ckpt),
                    "--outdir", str(tmp_path / "dec"), "--batch-size", "2", "--skip-plots",
                    "--device", "cpu", "--config", str(exp / "config.yml")])
    feats = sorted((tmp_path / "dec").glob("*.npy"))
    assert len(feats) == 3 and all(np.isfinite(np.load(f)).all() for f in feats)


@pytest.mark.parametrize("name", list(COMPOSED))
def test_composed_step_matches_single_process(four_ranks, name):
    entry, over, _ = COMPOSED[name]
    config = _composed_config(name)
    got = _history(four_ranks, name)
    ckpt = _ckpt(four_ranks, name)["model"]
    if entry == "tts_train":
        one, params = _single_tts(four_ranks, config)
        _assert_losses(got, one, ("loss", "l1_loss", "bce_loss", "guided_attn_loss"))
    else:
        corpus = "fs2" if name == "fs2_sp" else "corpus"
        src, trg = (str(four_ranks / f"{corpus}/{k}.scp") for k in ("src", "trg"))
        dur = str(four_ranks / "fs2/durations") if name == "fs2_sp" else None
        data = 4 // int(np.prod([config.get(k, 1) for k in (
            "tensor_parallel", "sequence_parallel", "pipeline_parallel")]))
        batch = _loader_batch(config, src, trg, 4, dur)
        one, params, state0, _ = _single(config, [_data_ranks_rows(
            batch, data, int(config.get("pipeline_parallel", 1)))])
        terms = [k[6:] for k in one if k.startswith("train/") and k[6:] in
                 ("loss", "l1_loss", "forward_sum_loss", "binary_loss", "duration_loss",
                  "pitch_loss", "energy_loss")]
        _assert_losses(got, one, terms)
    _assert_params(ckpt, params)
    _ranks_agree(four_ranks, name, 4)
    if name == "tp_sp":  # the conformer conv kernels' gradients (the SGD updates), by name
        names = [k for k in ckpt if k.endswith(CONV_GRADS)]
        assert len(names) == 2 * 4  # both kernels of the 2 + 2 layers
        for k in names:
            want = (params[k] - state0[k]).numpy()
            assert np.abs(want).max() > 1e-4, k
            np.testing.assert_allclose((ckpt[k] - state0[k]).numpy(), want, rtol=0,
                                       atol=1e-6, err_msg=k)


def _single_tts(root: Path, config):
    from seq2seq_vc_torch.train import get_trainer_class

    tokens = [t for t in (root / "tts/tokens.txt").read_text().split("\n") if t.strip()]
    ds = TTSDataset(str(root / "tts/feats.scp"), str(root / "tts/text"),
                    non_linguistic_symbols=None, cleaner="tacotron", g2p="g2p_en",
                    token_list=tokens, token_type="phn", feat_key="mel", allow_cache=False)
    mp = config["model_params"]
    collater = ARTTSCollater(config.get("pad_multiple", 32), mp.get("decoder_reduction_factor", 1))
    batch = next(iter(DataLoader(ds, collater, config["batch_size"], shuffle=True, seed=0)))
    padded = _data_ranks_rows(batch, 2)
    torch.manual_seed(0)
    model = get_model_class("TransformerTTS")(**dict(mp, idim=len(tokens)))
    config = _one_process(config)
    trainer = get_trainer_class("ARTTSTrainer")(
        vc_train.build_state(model, config, "", "cpu"),
        vc_train.build_criterion(config), config, [padded], device="cpu")
    trainer.run()
    return trainer.history[0], model.state_dict()


# ------------------------------------------------------------------ refusals
def _refusal_main(tmp_path, over, model=None):
    src, trg = _corpus(tmp_path / "corpus")
    model = dict(model or {})
    conf = model.pop("conf", SYNTH)
    config = dict(_config(conf, **model), **over)
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(config))
    vc_train.main(_vc_args(tmp_path, src, trg, tmp_path / "conf.yaml", tmp_path / "exp"))


@pytest.mark.parametrize("over,model,error,match", [
    ({"pipeline_parallel": 2, "tensor_parallel": 2}, None, ValueError, "data parallelism only"),
    ({"pipeline_parallel": 2, "sequence_parallel": 2}, None, ValueError,
     "data parallelism only"),
    ({"sequence_parallel": 2}, {"conformer_rel_pos_type": "legacy"}, NotImplementedError,
     "new-style rel-pos"),
    ({"sequence_parallel": 2, "tensor_parallel": 4}, None, ValueError, "must divide"),
    ({"pipeline_parallel": 2}, {"elayers": 3}, ValueError, "not divisible by pipe"),
    ({"tensor_parallel": 2}, None, ValueError, "mesh 0x2x1x1 != 1 ranks"),
    ({"sequence_parallel": 2}, dict(conf=FS2_ARCTIC, decoder_type="transformer"),
     NotImplementedError, "requires conformer encoder and decoder"),
    ({"sequence_parallel": 2}, dict(conf=REPO / "egs/synth/vc1/conf/vtn.synth.yaml"),
     ValueError, "acts on conformer stacks"),
])
def test_model_parallel_refusals(tmp_path, over, model, error, match):
    with pytest.raises(error, match=match):
        _refusal_main(tmp_path, over, model)


def test_a_trainer_in_a_group_takes_its_state_from_build_state():
    # build_state is the one place a model is laid out over the mesh: in a
    # process group a trainer refuses a state that has no plan
    import socket

    import torch.distributed as dist

    from seq2seq_vc_torch.train.aas_vc import AASVCTrainer
    from seq2seq_vc_torch.train.optim import build_optimizer
    from seq2seq_vc_torch.train.state import TrainState

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    config = _config()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        torch.manual_seed(0)
        model = get_model_class("AASVC")(**MODEL)
        with pytest.raises(ValueError, match="build_state"):
            AASVCTrainer(TrainState(model, build_optimizer(model.parameters())), {}, config, [],
                         device="cpu")
        trainer = AASVCTrainer(vc_train.build_state(model, config, "", "cpu"), {}, config, [],
                               device="cpu")
        assert trainer.plan.mesh.shape == dict(data=1, model=1, seq=1, pipe=1)
        assert not trainer.model_parallel
    finally:
        dist.destroy_process_group()


def test_pipeline_refuses_an_indivisible_batch():
    with pytest.raises(ValueError, match="batch 3 not divisible by n_micro=2"):
        pipeline_module_stack(lambda h, m: h, torch.zeros(3, 4, 2), None, None, 2)
