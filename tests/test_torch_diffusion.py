"""Port: the diffusion decoders of AAS-VC (seq2seq_vc_torch/nn/diffusion.py,
losses/diffsinger_l2.py, the AASVC ``diffsinger`` and ``prodiff`` branches
and their trainer) against the JAX package on the CPU.

The JAX modules are initialised by flax, their parameters perturbed by
seeded noise (so the zero-initialised output projection takes part) and
carried to the port by the port's ``convert.py``. JAX's draws are captured
in the test: the JAX diffusion module's ``jax`` is replaced by a namespace
whose ``random.randint`` and ``random.normal`` record what they return
through an ordered host callback (so inside the jitted ``lax.scan`` of a
sampler too), and the recorded draws are given to the port's modules
(``t``, ``eps``, ``x_init``, ``z``; ``diffusion_draws`` at the model).

Tolerances (float32): the beta schedules rtol 1e-6 (the same float32
operations in the same order), with an atol of 3 ulps of 1.0 (3.6e-7)
for ``cosine`` and ``vpsde``: their betas are 1 minus a number near 1 (a
ratio of cosines, an exponential), so the one-ulp differences of XLA's and
torch's transcendental functions come out as up to 2.5 ulps of 1.0
(measured at 2 to 2000 steps); the step embedding atol 1e-4 (the sine of
t times an exponential: the one-ulp differences of the frequencies reach
the argument times t, and an ulp of the argument is 6.1e-5 at t 999); ``DiffNet`` atol 1e-5 (sums of up to 2.5k
products in another order); the training draw's prediction atol 1e-5; the
samplers atol 1e-4 (each step feeds the last, dividing by sqrt(alpha)); the
model outputs on their valid frames atol 1e-4; one trainer step's loss
terms rtol 1e-5, gradients within 1e-4 of each tensor's largest magnitude
and the parameters after a clipped Adam step (lr 1e-3) atol 1e-5, as
tests/test_torch_train.py holds them, except the ``linear_k`` biases, whose
true gradient is 0 (a softmax does not see a constant added to every key
score): their gradients are rounding noise, held to atol 1e-7. Adam's first
step is lr * g / (|g| + eps), so a parameter whose gradient lies within the
gradient's tolerance of 0 may step up to the learning rate either way on
each side: those are held to twice the first step's learning rate.
"""

import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port import NO_DROPOUT, release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models import aas_vc as jax_aas_vc
from seq2seq_vc_tpu.nn import diffusion as jdiff
from seq2seq_vc_tpu.train.aas_vc import AASVCTrainer as JaxAASVCTrainer
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.bin import convert_checkpoint, vc_decode, vc_train
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.core.config import load_config
from seq2seq_vc_torch.losses import get_criterion
from seq2seq_vc_torch.models import aas_vc as port_aas_vc
from seq2seq_vc_torch.models import get_model_class
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.nn import diffusion
from seq2seq_vc_torch.train.aas_vc import AASVCTrainer
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.train.schedulers import warmup_lr_schedule
from seq2seq_vc_torch.train.state import TrainState

REPO = Path(__file__).resolve().parents[1]
SCHED_TOL = dict(rtol=1e-6)
ONE_MINUS_ATOL = 3 * float(np.finfo(np.float32).eps)
NET_TOL = dict(atol=1e-5, rtol=0)
EMB_ATOL = 1e-4  # sin, cos of t * f: an ulp of the argument is 6.1e-5 at t 999
SAMPLE_TOL = dict(atol=1e-4, rtol=0)
KEY = jax.random.PRNGKey(0)
# the flagship's structure at toy widths, the deterministic duration
# predictor as the synth confs use it, every dropout off
TINY = dict(
    idim=20, odim=20, adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32,
    postnet_layers=2, postnet_chans=8, post_encoder_reduction_factor=2,
    decoder_reduction_factor=2, duration_predictor_type="deterministic",
    duration_predictor_chans=16, positionwise_layer_type="linear",
    conformer_enc_kernel_size=7, conformer_dec_kernel_size=7,
    encoder_normalize_before=True, decoder_normalize_before=True,
    duration_predictor_dropout_rate=0.0, postnet_dropout_rate=0.0,
    diffsinger_denoiser_residual_channels=8, diffsinger_diffusion_steps=6,
    prodiff_denoiser_layers=3, prodiff_denoiser_channels=8, prodiff_diffusion_steps=4,
    **NO_DROPOUT,
)


# the DiffSinger denoiser's depth in the model-level tests: AASVC builds it
# at the JAX default of 20 layers, whose XLA compiles would dominate this
# file; DiffNet's layer structure is held at 5 layers on its own, and the
# 20-layer decoder on the card by chip_smoke.py's phase 29
DIFFSINGER_LAYERS = 4


@pytest.fixture(autouse=True, scope="module")
def small_diffsinger():
    """Both packages' AASVC build their DiffSinger decoder with
    DIFFSINGER_LAYERS layers while this file runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_aas_vc, "GaussianDiffusion", functools.partial(
            jdiff.GaussianDiffusion, denoiser_layers=DIFFSINGER_LAYERS))
        mp.setattr(port_aas_vc, "GaussianDiffusion", functools.partial(
            diffusion.GaussianDiffusion, denoiser_layers=DIFFSINGER_LAYERS))
        yield


# --------------------------------------------------------- capturing draws
def _capture(monkeypatch):
    """Record every randint / normal of the JAX diffusion module, in
    order, through an ordered host callback (so under ``jax.jit`` and
    inside ``lax.scan`` too); read after ``jax.effects_barrier()``."""
    draws = []

    def record(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            jax.debug.callback(lambda v: draws.append(np.asarray(v)), out, ordered=True)
            return out
        return wrapped

    shim = types.SimpleNamespace(
        random=types.SimpleNamespace(split=jax.random.split, randint=record(jax.random.randint),
                                     normal=record(jax.random.normal)),
        lax=jax.lax)
    monkeypatch.setattr(jdiff, "jax", shim)
    return draws


def _run(fn, *args):
    """``fn`` under ``jax.jit``, its recorded draws flushed."""
    out = jax.jit(fn)(*args)
    jax.effects_barrier()
    return out


def _perturbed(tree, seed: int, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------- schedules
@pytest.mark.parametrize("schedule,kw", [("linear", {}), ("cosine", {}),
                                         ("vpsde", {"max_beta": 40.0})])
def test_beta_schedules_match_jax(schedule, kw):
    for steps in (4, 100, 1000):
        want = np.asarray(jdiff.make_beta_schedule(schedule, steps, **kw))
        got = diffusion.make_beta_schedule(schedule, steps, **kw).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **dict(SCHED_TOL, atol=0 if schedule == "linear"
                                                     else ONE_MINUS_ATOL))
    with pytest.raises(ValueError):
        diffusion.make_beta_schedule("nope", 10)


def test_ddim_steps_and_timestep_embedding_match_jax():
    for T in (4, 6, 25, 100, 1000):
        for k in range(1, min(T, 12)):
            ts = np.asarray(jnp.linspace(T - 1, 0, k + 1).round().astype(jnp.int32)).tolist()
            gd = diffusion.GaussianDiffusion(4, 4, residual_channels=4, denoiser_layers=1,
                                             timesteps=T)
            assert gd.ddim_steps(k) == list(zip(ts[:-1], ts[1:])), (T, k)
    t = np.array([0, 3, 99, 999], np.int32)
    for dim in (8, 9, 256):
        np.testing.assert_allclose(diffusion.timestep_embedding(_t(t), dim).numpy(),
                                   np.asarray(jdiff._timestep_embedding(jnp.asarray(t), dim)),
                                   atol=EMB_ATOL, rtol=0)


# ------------------------------------------------------------------ DiffNet
@pytest.mark.parametrize("cycle", [4, 1])
def test_diffnet_matches_jax(cycle):
    rng = np.random.default_rng(cycle)
    x = rng.standard_normal((2, 13, 12)).astype(np.float32)
    cond = rng.standard_normal((2, 13, 16)).astype(np.float32)
    t = np.array([3, 97], np.int32)
    net = jdiff.DiffNet(out_dim=12, cond_dim=16, residual_channels=8, layers=5,
                        dilation_cycle_length=cycle)
    params = _perturbed(net.init(KEY, x, t, cond)["params"], seed=cycle)
    want = np.asarray(net.apply({"params": params}, x, t, cond))
    port = diffusion.DiffNet(12, 16, residual_channels=8, layers=5, dilation_cycle_length=cycle)
    port.load_state_dict(aasvc_state_dict(params, port))
    got = port(_t(x), _t(t), _t(cond)).detach().numpy()
    np.testing.assert_allclose(got, want, **NET_TOL)
    # a bf16 conditioner is promoted: the denoiser stays float32
    assert port(_t(x), _t(t), _t(cond).bfloat16()).dtype == torch.float32


# ----------------------------------------------- the training draw and loss
def _gd_pair(**over):
    kw = dict(in_dim=16, out_dim=12, residual_channels=8, denoiser_layers=4, timesteps=8, **over)
    jax_gd = jdiff.GaussianDiffusion(**kw)
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((2, 10, 16)).astype(np.float32)
    x0 = rng.standard_normal((2, 10, 12)).astype(np.float32)
    masks = np.array([[True] * 10, [True] * 7 + [False] * 3])
    params = jax_gd.init({"params": KEY, "noise": KEY}, cond, x0, masks)["params"]
    params = _perturbed(params, seed=2)
    port = diffusion.GaussianDiffusion(**kw)
    port.load_state_dict(aasvc_state_dict(params, port))
    return jax_gd, {"params": params}, port, cond, x0, masks


def test_training_draw_and_l2_loss_match_jax(monkeypatch):
    jax_gd, params, port, cond, x0, masks = _gd_pair()
    draws = _capture(monkeypatch)
    noise, eps_hat = _run(lambda p: jax_gd.apply(p, cond, x0, masks,
                                                 rngs={"noise": jax.random.PRNGKey(5)}), params)
    t, eps = draws
    got_noise, got_hat = port(_t(cond), _t(x0), _t(masks), t=_t(t), eps=_t(eps))
    np.testing.assert_array_equal(got_noise.numpy(), np.asarray(noise))
    np.testing.assert_allclose(got_hat.detach().numpy(), np.asarray(eps_hat), **NET_TOL)
    olens = np.array([10, 7])
    for masking in (True, False):
        want = jax_criterion("DiffSingerL2Loss", use_masking=masking)(noise, eps_hat, olens)
        got = get_criterion("DiffSingerL2Loss", use_masking=masking)(
            got_noise, got_hat, _t(olens))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # without given draws the port draws from the generator, on its device
    a = port(_t(cond), _t(x0), generator=torch.Generator().manual_seed(3))
    b = port(_t(cond), _t(x0), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ----------------------------------------------------------------- samplers
@pytest.mark.parametrize("sampler", ["ancestral", "ddim", "prodiff", "prodiff_timescale2"])
def test_samplers_match_jax(monkeypatch, sampler):
    if sampler in ("ancestral", "ddim"):
        jax_mod, params, port, cond, _, masks = _gd_pair(
            inference_steps=3 if sampler == "ddim" else None)
        method = jdiff.GaussianDiffusion.inference
    else:
        kw = dict(idim=12, adim=16, layers=3, channels=8, timesteps=4,
                  timescale=2 if sampler == "prodiff_timescale2" else 1, max_beta=40.0)
        jax_mod = jdiff.SpectogramDenoiser(**kw)
        rng = np.random.default_rng(6)
        cond = rng.standard_normal((2, 10, 16)).astype(np.float32)
        masks = np.array([[True] * 10, [True] * 6 + [False] * 4])
        ys = rng.standard_normal((2, 10, 12)).astype(np.float32)
        params = {"params": _perturbed(jax_mod.init({"params": KEY, "noise": KEY}, cond, ys,
                                                    masks)["params"], seed=7)}
        port = diffusion.SpectogramDenoiser(**kw)
        port.load_state_dict(aasvc_state_dict(params, port))
        method = jdiff.SpectogramDenoiser.inference
    draws = _capture(monkeypatch)
    want = np.asarray(_run(lambda p: jax_mod.apply(p, cond, masks, method=method,
                                                   rngs={"noise": jax.random.PRNGKey(9)}), params))
    n_z = {"ancestral": 8, "ddim": 0, "prodiff": 4, "prodiff_timescale2": 2}[sampler]
    assert len(draws) == 1 + n_z
    z = _t(np.stack(draws[1:])) if len(draws) > 1 else None
    got = port.inference(_t(cond), _t(masks), x_init=_t(draws[0]), z=z).numpy()
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    assert np.abs(want).max() > 0 and np.all(got[1, int(masks[1].sum()):] == 0)


# -------------------------------------------------------------------- model
def _batch(seed=4):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((2, 16, 20)).astype(np.float32)
    ys = rng.standard_normal((2, 24, 20)).astype(np.float32)
    return xs, np.array([16, 12]), ys, np.array([24, 16])


@functools.lru_cache(maxsize=None)
def _model_pair(decoder_type):
    jax_model = JaxAASVC(**TINY, decoder_type=decoder_type, alignment_dist_form="direct")
    xs, ilens, ys, olens = _batch()
    keys = {"params": KEY, "dropout": KEY, "noise": KEY}
    init = jax.jit(lambda k: jax_model.init(k, xs, ilens, ys, olens, xs, ilens,
                                            deterministic=True))
    params = {"params": _perturbed(init(keys)["params"], seed=11)}
    port = AASVC(**TINY, decoder_type=decoder_type).eval()
    port.load_state_dict(aasvc_state_dict(params, port))
    return jax_model, params, port


@pytest.mark.parametrize("decoder_type", ["diffsinger", "prodiff"])
def test_aasvc_forward_and_inference_match_jax(monkeypatch, decoder_type):
    jax_model, params, port = _model_pair(decoder_type)
    xs, ilens, ys, olens = _batch()
    draws = _capture(monkeypatch)
    ref = _run(lambda p: jax_model.apply(p, xs, ilens, ys, olens, xs, ilens, deterministic=True,
                                         rngs={"noise": jax.random.PRNGKey(3)}), params)
    t, eps = draws
    got = port(_t(xs), _t(ilens), _t(ys), _t(olens), _t(xs), _t(ilens),
               diffusion_draws={"t": _t(t), "eps": _t(eps)})
    n_red = np.asarray(ref["olens_reduced"])
    np.testing.assert_array_equal(got["olens_reduced"].numpy(), n_red)
    np.testing.assert_array_equal(got["ds"].numpy(), np.asarray(ref["ds"]))
    if decoder_type == "diffsinger":
        assert got["before_outs"] is None and got["after_outs"] is None
        pairs = [("noise", SAMPLE_TOL), ("x_recon", SAMPLE_TOL)]
        lens = n_red
    else:
        assert port.feat_out is None and port.postnet is not None
        pairs = [("before_outs", SAMPLE_TOL), ("after_outs", SAMPLE_TOL)]
        lens = np.asarray(ref["olens"])
    for key, tol in pairs:
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[key][b, :n].detach().numpy(),
                                       np.asarray(ref[key])[b, :n], err_msg=key, **tol)

    draws.clear()
    ref = _run(lambda p: jax_model.apply(p, xs, ilens, xs, max_output_frames=20,
                                         method=JaxAASVC.inference,
                                         rngs={"noise": jax.random.PRNGKey(4)}), params)
    z = _t(np.stack(draws[1:])) if len(draws) > 1 else None
    got = port.inference(_t(xs), _t(ilens), _t(xs), max_output_frames=20,
                         diffusion_draws={"x_init": _t(draws[0]), "z": z})
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(ref["out_lens"]))
    for b, n in enumerate(np.asarray(ref["out_lens"])):
        np.testing.assert_allclose(got["outs"][b, :n].numpy(), np.asarray(ref["outs"])[b, :n],
                                   **SAMPLE_TOL)


# ---------------------------------------------------------- a trainer step
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
CONFIG = dict(train_max_steps=1, log_interval_steps=1, lambda_align=2.0,
              dp_train_start_steps=0, seed=0)
CRITERIA = ("DiffSingerL2Loss", "ForwardSumLoss", "DurationPredictorLoss")  # no L1Loss
TERMS = ("diffsinger_l2_loss", "forward_sum_loss", "binary_loss", "duration_loss")


def _train_batch():
    xs, ilens, ys, olens = _batch(seed=8)
    return dict(xs=xs, ilens=ilens.astype(np.int32), ys=ys, olens=olens.astype(np.int32),
                dp_inputs=xs, dplens=ilens.astype(np.int32), utt_ids=["a", "b"])


def test_trainer_step_matches_jax(monkeypatch):
    jax_model, params, _ = _model_pair("diffsinger")
    tx, _ = jax_build_optimizer(**OPT)
    trainer = JaxAASVCTrainer(jax_model, JaxTrainState.create(params, tx),
                              {n: jax_criterion(n) for n in CRITERIA}, dict(CONFIG), [],
                              mesh=None, writer=False)
    arrays = trainer._array_batch(_train_batch())
    draws = _capture(monkeypatch)
    rngs = {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    (_, want), grads = _run(jax.value_and_grad(
        lambda p: trainer.loss_fn(p, arrays, rngs, trainer._flags()), has_aux=True), params)
    new = jax.jit(lambda s, g: s.apply_gradients(g).params)(trainer.state, grads)
    t, eps = draws[:2]

    model = AASVC(**TINY, decoder_type="diffsinger")
    model.load_state_dict(aasvc_state_dict(params, model))
    model.decoder.forward = functools.partial(model.decoder.forward, t=_t(t), eps=_t(eps))
    state = TrainState(model, build_optimizer(model.parameters(), **OPT))
    port = AASVCTrainer(state, {n: get_criterion(n) for n in CRITERIA}, dict(CONFIG), [],
                        device="cpu")
    port.model.train()
    loss, got = port.loss_fn(port._array_batch(_train_batch()), port._flags(), port.generator)
    loss.backward()
    for name in TERMS:
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5, err_msg=name)
    assert "l1_loss" not in got
    want_grads = aasvc_state_dict(grads, model)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want_grads[name].numpy()
        atol = 1e-7 if name.endswith("linear_k.bias") else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    assert np.abs(model.decoder.denoise_fn.final_proj.weight.grad.numpy()).max() > 0
    port.state.apply_gradients()
    step0 = warmup_lr_schedule(OPT["optimizer_params"]["lr"],
                               OPT["scheduler_params"]["warmup_steps"])(0)
    for name, w in aasvc_state_dict(new, model).items():
        # Adam's first step is lr * g / (|g| + eps): an element whose
        # gradient lies within the gradient's tolerance of 0 may step by
        # up to lr either way on each side
        g = np.abs(want_grads[name].numpy())
        near_zero = g <= (1e-7 if name.endswith("linear_k.bias") else 1e-4 * g.max())
        diff = np.abs(model.state_dict()[name].numpy() - w.numpy())
        assert np.all(diff <= np.where(near_zero, 2 * step0, 1e-5)), (name, diff.max())


# ------------------------------------------ the CLIs on the shipped confs
def _write_feats(root, name, lens, seed):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, n in enumerate(lens):
        np.save(root / f"{name}_{i}.npy", (-4 + rng.standard_normal((n, 80))).astype(np.float32))
        lines.append(f"utt{i} {root / f'{name}_{i}.npy'}")
    (root / f"{name}.scp").write_text("\n".join(lines) + "\n")
    return str(root / f"{name}.scp")


@pytest.mark.parametrize("conf", ["aas_vc_diffsinger", "aas_vc_prodiff"])
def test_vc_train_resumes_with_the_same_noise_and_vc_decode_samples(tmp_path, conf):
    """The shipped conf (its dropouts on) at B 2 on 4 utterances: a run
    stopped after step 1 (mid-epoch) and resumed to 3 equals a straight
    run to 3, so the resumed trainer draws the diffusion noise that the
    straight one drew; vc_decode's features equal ``AASVC.inference`` with
    the utterance's generator."""
    src = _write_feats(tmp_path / "corpus", "src", [40, 47, 33, 52], seed=4)
    trg = _write_feats(tmp_path / "corpus", "trg", [44, 50, 36, 49], seed=5)
    config = load_config(str(REPO / f"egs/synth/vc1/conf/{conf}.synth.yaml"))
    config["model_params"].update(compute_dtype="float32", diffsinger_diffusion_steps=4)
    config.update(batch_size=2, eval_interval_steps=2, save_interval_steps=1,
                  log_interval_steps=1, num_save_intermediate_results=2)
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(config))
    args = ["--src-train-dumpdir", src, "--src-dev-dumpdir", src, "--trg-train-dumpdir", trg,
            "--trg-dev-dumpdir", trg, "--train-dp-input-dir", src, "--dev-dp-input-dir", src,
            "--device", "cpu", "--config", str(tmp_path / "conf.yaml")]

    def run(n, out, *extra):
        (tmp_path / f"steps{n}.yaml").write_text(yaml.safe_dump({"train_max_steps": n}))
        return vc_train.main(args + ["--additional-config", str(tmp_path / f"steps{n}.yaml"),
                                     "--outdir", str(tmp_path / out), *extra])

    run(1, "first")
    resumed = run(3, "resumed", "--resume", str(tmp_path / "first" / "checkpoint-1steps.pt"))
    straight = run(3, "straight")
    assert resumed.steps == straight.steps == 3
    assert len(list((tmp_path / "straight" / "predictions" / "2steps").glob("*.npy"))) == 2
    a = torch.load(tmp_path / "resumed" / "checkpoint-3steps.pt", weights_only=True)["model"]
    b = torch.load(tmp_path / "straight" / "checkpoint-3steps.pt", weights_only=True)["model"]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    name = "diffsinger_l2_loss" if "diffsinger" in conf else "l1_loss"
    assert all(np.isfinite(h[f"train/{name}"]) for h in straight.history if "train/loss" in h)

    ckpt = str(tmp_path / "straight" / "checkpoint-3steps.pt")
    r = vc_decode.main(["--dumpdir", src, "--dp-input-dir", src, "--checkpoint", ckpt,
                        "--outdir", str(tmp_path / "dec"), "--device", "cpu", "--skip-plots"])
    assert r["frames"] > 0 and len(list((tmp_path / "dec" / "wav").glob("*.wav"))) == 4
    cfg = load_config(str(tmp_path / "straight" / "config.yml"))
    model = vc_decode.load_model(cfg, ckpt, "cpu")
    dataset = vc_decode.SourceVCMelDataset(src, dp_feats=src)
    first = vc_decode.decode_batches(dataset, 1)[0][0]
    item = dataset[first]
    xs = _t(vc_decode.pad_batch([item["src_feat"]], vc_decode.frame_multiple(model)))
    out = model.inference(xs, torch.tensor([len(item["src_feat"])]), xs,
                          max_output_frames=2 * xs.shape[1],
                          generator=vc_decode.utterance_generator(cfg.get("seed", 0), first))
    want = out["outs"][0, : int(out["out_lens"][0])].numpy()
    np.testing.assert_allclose(np.load(tmp_path / "dec" / f"{item['utt_id']}.npy"), want,
                               atol=1e-5, rtol=0)


def test_every_egs_model_conf_builds_and_convert_checkpoint_refuses_diffusion(tmp_path):
    """Every conf under egs/ with a model builds through the port's
    registry (a TTS conf's vocabulary size, which comes from its token
    list, set to 40); a diffusion conf has no reference checkpoint."""
    built = []
    for path in sorted(REPO.glob("egs/*/*/conf/*.yaml")):
        cfg = yaml.safe_load(path.read_text()) or {}
        if "model_type" not in cfg or "model_params" not in cfg:
            continue
        mp = dict(cfg["model_params"])
        mp.setdefault("idim", 40)
        get_model_class(cfg["model_type"])(**mp, device="meta")  # shapes only, no storage
        built.append(path.name)
    assert {"aas_vc_diffsinger.synth.yaml", "aas_vc_prodiff.synth.yaml"} <= set(built)
    conf = REPO / "egs/synth/vc1/conf/aas_vc_diffsinger.synth.yaml"
    with pytest.raises(ValueError, match="no diffusion classes"):
        convert_checkpoint.main(["--torch-checkpoint", str(tmp_path / "x.pkl"), "--config",
                                 str(conf), "--outpath", str(tmp_path / "y.pt")])
