"""The port's generative CTViT path against ctpa's, on the CPU, at the tiny
configurations: ``vq_lookup``, the decoder (``decode_from_codebook_indices``,
``reconstruct``), the discriminator, the perceptual net (and its VGG16
import), the GAN losses with R1, two VQGAN steps, and the ``train_vqgan``
CLI with ``--resume``.

Inputs are numpy draws from a seed; weights are ctpa's parameter shapes
(``jax.eval_shape``) filled from numpy and carried into the port by
``ctpa_torch.convert``.

Tolerances, fp32 on both sides, differing in the order of sums:
  * lookups, decoded voxels, features, logits and losses: 1e-5 (relative
    for the losses, with 1e-6 abs for values near zero);
  * R1's gradient with respect to the discriminator's parameters: 1e-5 abs
    + 1e-4 relative (a second-order gradient);
  * the VQGAN steps: every metric 1e-5 relative + 1e-6 abs; the VQ state
    1e-5 abs; every parameter after two Adam steps (lr 1e-3, b1 0.5, b2 0.9)
    1e-6 abs, but where a step's gradient is fp32 noise (below 1e-5 in
    magnitude: Adam's first update is lr * g / |g| there, so noise moves it
    by up to a few lr), which must stay under 5% of the elements (the
    discriminator's Dense_0 has about 3% such gradients under BCE);
  * the CLI: per-step metrics against ctpa's jitted step on the same
    batches 1e-5 relative + 1e-6 abs; the resumed run's step 3 against an
    uninterrupted run's 1e-5 relative (its batch holds the same volumes in
    another order).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctpa.core import config as jc
from ctpa.data import datasets as jdata
from ctpa.data import hf_import as jhf
from ctpa.models import discriminator as jdisc
from ctpa.models.ctvit import CTViT as JViT
from ctpa.ops import vq as jvq
from ctpa.train import gan_losses as jgan
from ctpa.train.vqgan_trainer import VQGANState as JState
from ctpa.train.vqgan_trainer import make_vqgan_train_step as j_make_step
from ctpa_torch.cli import train_vqgan as tv_cli
from ctpa_torch.convert import flax_to_state_dict, load_flax_params, vq_state_from_numpy
from ctpa_torch.core import config as tc
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.data import hf_import as thf
from ctpa_torch.models import discriminator as tdisc
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.ops import vq as tvq
from ctpa_torch.train import gan_losses as tgan
from ctpa_torch.train.vqgan_trainer import VQGANState, adam, make_vqgan_train_step

torch.set_num_threads(1)
KEY = jax.random.key(0)
VIT = dataclasses.replace(tc.CTViTConfig.tiny(), use_decoder=True)
JVIT = dataclasses.replace(jc.CTViTConfig.tiny(), use_decoder=True)
TOL = 1e-5
ATOL0 = 1e-6            # absolute floor for metrics near zero
NOISE = 1e-5            # gradients below this are fp32 noise for Adam's steps
LR = 1e-3
DISC_KW = dict(base_dim=8, num_layers=2)
STAGES = (8, 16)
GAINS = ("scale", "gamma", "q_scale", "k_scale", "norm_in_scale")
METRICS = ("gen_loss", "disc_loss", "recon", "perceptual", "gen_gan", "commit", "r1")


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), requires_grad=requires_grad)


def _fill(shapes, seed):
    """Numpy weights for a flax param tree: gains near 1, Dense and Conv
    kernels at 1/sqrt(fan_in), the rest at 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in GAINS:
            return np.asarray(1 + 0.1 * rng.normal(size=shape), np.float32)
        if name == "kernel" and len(shape) in (2, 4):
            return np.asarray(rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1])), np.float32)
        return np.asarray(0.1 * rng.normal(size=shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _video(seed, b=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, size=(b, 1, VIT.temporal_size, VIT.image_size, VIT.image_size)).astype(np.float32)


def _vq(seed=5):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(VIT.codebook_size, VIT.dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    return cb, np.abs(rng.normal(size=VIT.codebook_size)).astype(np.float32), cb.copy()


def _close(got, ref, atol=TOL, rtol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


@pytest.fixture(scope="module")
def nets():
    """ctpa's tiny generator, discriminator and perceptual net with numpy
    weights, and the VQ state."""
    video, vq = _video(0), _vq()
    jm = JViT(JVIT)
    jvq_state = jvq.VQState(*map(jnp.asarray, vq))
    gen = _fill(jax.eval_shape(lambda: jm.init(KEY, video, jvq_state,
                                               method=JViT.reconstruct))["params"], 1)
    mid = np.zeros((1, VIT.image_size, VIT.image_size, 1), np.float32)
    jd, jp = jdisc.Discriminator(**DISC_KW), jdisc.PerceptualNet(stages=STAGES)
    disc = _fill(jax.eval_shape(lambda: jd.init(KEY, mid))["params"], 2)
    perc = _fill(jax.eval_shape(lambda: jp.init(KEY, np.repeat(mid, 3, -1)))["params"], 3)
    return dict(jm=jm, jd=jd, jp=jp, gen=gen, disc=disc, perc=perc, vq=vq)


def _port_nets(nets, vit=VIT):
    model = load_flax_params(CTViT(vit, device="cpu"), _np(nets["gen"]))
    disc = load_flax_params(tdisc.Discriminator(image_size=VIT.image_size, device="cpu",
                                                **DISC_KW), _np(nets["disc"]))
    perc = load_flax_params(tdisc.PerceptualNet(stages=STAGES, device="cpu"), _np(nets["perc"]))
    return model, disc, perc


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


# ------------------------------------------------------------- the decoder

def test_vq_lookup_matches_ctpa():
    vq = _vq()
    idx = np.random.default_rng(6).integers(0, VIT.codebook_size, size=(2, 7))
    ref = jvq.vq_lookup(jvq.VQState(*map(jnp.asarray, vq)), jnp.asarray(idx))
    got = tvq.vq_lookup(vq_state_from_numpy(vq, device="cpu"), _t(idx))
    _close(got, ref)


def test_decode_from_codebook_indices_and_reconstruct_match_ctpa(nets):
    video, vq = _video(7), nets["vq"]
    jvq_state = jvq.VQState(*map(jnp.asarray, vq))

    @jax.jit
    def ref_fn(params, video, vq_state):
        recon, out = nets["jm"].apply(params, video, vq_state, method=JViT.reconstruct)
        return recon, out, nets["jm"].apply(params, out.indices.reshape(2, -1), vq_state,
                                            method=JViT.decode_from_codebook_indices)

    ref_recon, ref_out, ref_dec = ref_fn({"params": nets["gen"]}, video, jvq_state)
    model, _, _ = _port_nets(nets)
    tvq_state = vq_state_from_numpy(vq, device="cpu")
    with torch.no_grad():
        recon, out = model.reconstruct(_t(video), tvq_state)
        dec = model.decode_from_codebook_indices(out.indices.reshape(2, -1), tvq_state)
    assert recon.shape == video.shape
    _close(out.indices, ref_out.indices, 0)
    _close(recon, ref_recon)
    _close(out.commit_loss, ref_out.commit_loss, 0, TOL)
    _close(dec, ref_dec)


def test_fused_decoder_tree_loads_strictly(nets):
    """A fused_attention + use_decoder tree (ctpa builds the position bias
    for the decoder) loads strictly, and its decode matches ctpa's."""
    jcfg = dataclasses.replace(JVIT, fused_attention=True, fused_depth=1)
    jm = JViT(jcfg)
    video, vq = _video(8), nets["vq"]
    jvq_state = jvq.VQState(*map(jnp.asarray, vq))
    params = _fill(jax.eval_shape(lambda: jm.init(KEY, video, jvq_state,
                                                  method=JViT.reconstruct))["params"], 9)
    assert "spatial_rel_pos_bias" in params and "enc_spatial_transformer" not in params
    model = load_flax_params(CTViT(dataclasses.replace(VIT, fused_attention=True, fused_depth=1),
                                   device="cpu"), _np(params))
    idx = np.random.default_rng(10).integers(0, VIT.codebook_size, size=(2, 64))
    ref = jm.apply({"params": params}, jnp.asarray(idx), jvq_state,
                   method=JViT.decode_from_codebook_indices)
    with torch.no_grad():
        got = model.decode_from_codebook_indices(_t(idx), vq_state_from_numpy(vq, device="cpu"))
    _close(got, ref)
    with pytest.raises(ValueError, match="use_decoder"):
        CTViT(tc.CTViTConfig.tiny(), device="cpu").decode_tokens(torch.zeros(1, 4, 4, 4, 64))


# ------------------------------------------- discriminator and perceptual net

def test_discriminator_matches_ctpa(nets):
    x = np.random.default_rng(11).normal(size=(3, 1, VIT.image_size, VIT.image_size))
    x = x.astype(np.float32)
    ref = nets["jd"].apply({"params": nets["disc"]}, _nhwc(x))
    _, disc, _ = _port_nets(nets)
    with torch.no_grad():
        got = disc(_t(x))
    assert got.shape == (3,)
    _close(got, ref)


@pytest.mark.parametrize("final_only", [False, True])
def test_perceptual_loss_matches_ctpa(nets, final_only):
    rng = np.random.default_rng(12)
    real, fake = (rng.normal(size=(2, 1, 32, 32)).astype(np.float32) for _ in range(2))
    ref = jdisc.perceptual_loss({"params": nets["perc"]}, nets["jp"], _nhwc(real), _nhwc(fake),
                                final_only=final_only)
    _, _, perc = _port_nets(nets)
    with torch.no_grad():
        got = tdisc.perceptual_loss(perc, _t(real), _t(fake), final_only=final_only)
        feats = perc(_t(real).repeat(1, 3, 1, 1))
        assert float(tdisc.perceptual_loss(perc, _t(real), _t(real))) == 0.0
    _close(got, ref, 0, TOL)
    ref_feats = nets["jp"].apply({"params": nets["perc"]}, np.repeat(_nhwc(real), 3, -1))
    for f, r in zip(feats, ref_feats):
        _close(f.permute(0, 2, 3, 1), r)


def test_vgg16_perceptual_net_imports_torchvision_features():
    """A seeded torchvision ``vgg16().features`` state dict through both
    packages' ``import_vgg_features`` into ``PerceptualNet.vgg16()``."""
    rng = np.random.default_rng(13)
    sd, c_in = {}, 3
    for stage, convs in enumerate(thf.VGG16_FEATURE_CONV_INDICES):
        c_out = (64, 128, 256, 512, 512)[stage]
        for t in convs:
            sd[f"features.{t}.weight"] = (rng.normal(size=(c_out, c_in, 3, 3))
                                          / np.sqrt(9 * c_in)).astype(np.float32)
            sd[f"features.{t}.bias"] = (0.1 * rng.normal(size=c_out)).astype(np.float32)
            c_in = c_out
    x = rng.normal(size=(1, 3, 16, 16)).astype(np.float32)
    jnet = jdisc.PerceptualNet.vgg16()
    ref = jnet.apply(jhf.import_vgg_features(sd), _nhwc(x))
    net = load_flax_params(tdisc.PerceptualNet.vgg16(device="cpu"),
                           thf.import_vgg_features(sd)["params"])
    assert net.conv_4c.weight.shape == (512, 512, 3, 3)
    with torch.no_grad():
        feats = net(_t(x))
    assert len(feats) == 5
    for f, r in zip(feats, ref):
        _close(f.permute(0, 2, 3, 1), r, TOL, TOL)


# ------------------------------------------------------------- GAN losses

@pytest.mark.parametrize("name", ["hinge_d_loss", "bce_d_loss", "hinge_g_loss", "bce_g_loss"])
def test_gan_losses_match_ctpa(name):
    rng = np.random.default_rng(14)
    real, fake = (rng.normal(size=5).astype(np.float32) * 2 for _ in range(2))
    args = (real, fake) if name.endswith("d_loss") else (fake,)
    ref = getattr(jgan, name)(*map(jnp.asarray, args))
    _close(getattr(tgan, name)(*map(_t, args)), ref, 0, TOL)


def test_r1_penalty_and_its_gradient_match_ctpa(nets):
    """R1 and its gradient with respect to the discriminator's parameters
    against ctpa's (jax.grad of a penalty that holds jax.grad)."""
    x = np.random.default_rng(15).normal(size=(2, 1, VIT.image_size, VIT.image_size))
    x = x.astype(np.float32)
    jd = nets["jd"]

    def jr1(params):
        return jgan.r1_gradient_penalty(lambda v: jd.apply({"params": params}, v), _nhwc(x), 10.0)

    ref, ref_grad = jax.jit(jax.value_and_grad(jr1))(nets["disc"])
    _, disc, _ = _port_nets(nets)
    r1 = tgan.r1_gradient_penalty(disc, _t(x), 10.0)
    r1.backward()
    _close(r1, ref, 0, TOL)
    ref_grad = flax_to_state_dict(_np(ref_grad))
    for name, p in disc.named_parameters():
        # the penalty does not depend on the last bias: no gradient reaches it
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close(grad, ref_grad[name], TOL, 1e-4, msg=name)


def test_adaptive_gan_weight_and_middle_frames_match_ctpa():
    for r, g in ((2.0, 0.5), (3.0, 0.0), (1e9, 1e-6)):
        _close(tgan.adaptive_gan_weight(torch.tensor(r), torch.tensor(g)),
               jgan.adaptive_gan_weight(jnp.float32(r), jnp.float32(g)), 0, TOL)
    video = _video(16)
    _close(tgan.pick_middle_frames(_t(video)).permute(0, 2, 3, 1),
           jgan.pick_middle_frames(jnp.asarray(video)), 0)


# ------------------------------------------------------------ the VQGAN step

def _jstate(nets, gen_tx, disc_tx, vq):
    gen = {"params": nets["gen"]}
    disc, perc = {"params": nets["disc"]}, {"params": nets["perc"]}
    return JState(gen_params=gen, disc_params=disc, perc_params=perc,
                  gen_opt=gen_tx.init(gen), disc_opt=disc_tx.init(disc),
                  vq_state=jvq.VQState(*map(jnp.asarray, vq)), step=jnp.zeros((), jnp.int32))


def _jax_steps(nets, step, videos, counters=None):
    """ctpa's jitted ``step`` over ``videos`` from the fixture's weights:
    the metrics of each and the final state.  ``counters``: the step count
    each step reads (its R1 branch), by default 0, 1, ..."""
    gen_tx, disc_tx = optax.adam(LR, b1=0.5, b2=0.9), optax.adam(LR, b1=0.5, b2=0.9)
    state, metrics = _jstate(nets, gen_tx, disc_tx, nets["vq"]), []
    for i, video in enumerate(videos):
        if counters is not None:
            state = state.replace(step=jnp.asarray(counters[i], jnp.int32))
        state, m = step(state, jnp.asarray(video))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.fixture(scope="module")
def jax_step(nets):
    """ctpa's step with R1 every 2 steps, jitted once per loss form (optax's
    adam at LR, b1 0.5, b2 0.9, as ctpa's CLI builds it)."""
    cache = {}

    def get(use_hinge):
        if use_hinge not in cache:
            tx = optax.adam(LR, b1=0.5, b2=0.9)
            cache[use_hinge] = jax.jit(j_make_step(nets["jm"], nets["jd"], nets["jp"], tx, tx,
                                                   use_hinge=use_hinge, apply_r1_every=2))
        return cache[use_hinge]

    return get


def _port_state(nets):
    model, disc, perc = _port_nets(nets)
    gen_tx, disc_tx = adam(model, LR), adam(disc, LR)
    state = VQGANState(gen=model, disc=disc, perc=perc, gen_opt=gen_tx, disc_opt=disc_tx,
                       vq_state=vq_state_from_numpy(nets["vq"], device="cpu"))
    return state, gen_tx, disc_tx


def _check_params(module, ref_tree, grads, steps):
    """Every parameter within 1e-6 of ctpa's where each step's gradient is
    0 or at least NOISE; within 4 lr a step where it is noise-sized."""
    ref = flax_to_state_dict(_np(ref_tree))
    got = dict(module.named_parameters())
    assert set(got) == set(ref)
    noisy_total = total = 0
    for name, p in got.items():
        noisy = np.zeros(p.shape, bool)
        for g in grads:
            noisy |= (g[name] != 0) & (np.abs(g[name]) < NOISE)
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff[~noisy].max(initial=0) <= 1e-6, name
        assert diff[noisy].max(initial=0) <= 4 * LR * steps, name
        noisy_total, total = noisy_total + noisy.sum(), total + noisy.size
    assert noisy_total <= 0.05 * total, (noisy_total, total)


def _grads(module):
    return {n: p.grad.detach().numpy().copy() for n, p in module.named_parameters()}


@pytest.mark.parametrize("use_hinge", [True, False], ids=["hinge", "bce"])
def test_vqgan_steps_match_ctpa(nets, jax_step, use_hinge):
    """Two steps of make_vqgan_train_step (R1 at step 0, none at step 1)
    from the same weights and VQ state on the same volumes."""
    ref_metrics, ref_state = _jax_steps(nets, jax_step(use_hinge), [_video(20), _video(21)])
    state, gen_tx, disc_tx = _port_state(nets)
    step = make_vqgan_train_step(state.gen, state.disc, state.perc, gen_tx, disc_tx,
                                 use_hinge=use_hinge, apply_r1_every=2)
    gen_grads, disc_grads = [], []
    for i, seed in enumerate((20, 21)):
        state, m = step(state, _t(_video(seed)))
        for key in METRICS:
            _close(m[key], ref_metrics[i][key], ATOL0, TOL, msg=f"step {i} {key}")
        gen_grads.append(_grads(state.gen))
        disc_grads.append(_grads(state.disc))
    assert ref_metrics[0]["r1"] > 0 and ref_metrics[1]["r1"] == 0 and state.step == 2
    for g, r in zip(state.vq_state, ref_state.vq_state):
        _close(g, r)
    _check_params(state.gen, ref_state.gen_params["params"], gen_grads, 2)
    _check_params(state.disc, ref_state.disc_params["params"], disc_grads, 2)
    for name, p in state.perc.named_parameters():
        assert not p.requires_grad and p.grad is None, name


_SYNCS = ("__bool__", "item", "tolist", "numpy", "__float__", "__int__", "__index__")


def test_vqgan_step_makes_no_host_sync(nets, monkeypatch):
    """No bool(), if, .item() or float() on a tensor inside the step, R1 step
    or not.  The one exception is Adam's step counter, which PyTorch keeps on
    the host and reads with .item()."""
    state, gen_tx, disc_tx = _port_state(nets)
    step = make_vqgan_train_step(state.gen, state.disc, state.perc, gen_tx, disc_tx,
                                 apply_r1_every=2)
    state, _ = step(state, _t(_video(22)))             # creates Adam's state
    counters = {id(s["step"]) for tx in (gen_tx, disc_tx) for s in tx.opt.state.values()}
    calls = []

    def guard(name):
        original = getattr(torch.Tensor, name)

        def patched(self, *args, **kwargs):
            if id(self) not in counters:
                calls.append(name)
                raise AssertionError(f"host sync: Tensor.{name} in the VQGAN step")
            return original(self, *args, **kwargs)
        return patched

    videos = [_t(_video(23)), _t(_video(24))]
    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name, guard(name))
    for video in videos:                               # no R1, then R1
        state, m = step(state, video)
    monkeypatch.undo()
    assert not calls and state.step == 3
    assert float(m["r1"]) > 0 and all(math.isfinite(float(v)) for v in m.values())


# ------------------------------------------------------------------ the CLI

def test_train_vqgan_cli_resumes_and_matches_ctpa_step(nets, jax_step, tmp_path, monkeypatch):
    """train_vqgan.main --tiny on two canonical-grid volumes at batch 2: two
    steps and a checkpoint, --resume to step 3 against an uninterrupted
    3-step run, and every step's metrics against ctpa's jitted step (its
    CLI's hinge losses; R1 at the first step only, as every 16 steps) on
    the same batches from the same weights."""
    cfg = tc.CTViTConfig.tiny()
    rng = np.random.default_rng(30)
    data = tmp_path / "vols"
    data.mkdir()
    for i in range(2):
        np.savez(data / f"v{i}.npz", rng.uniform(
            -1, 1, size=(cfg.temporal_size, cfg.image_size, cfg.image_size)).astype(np.float32))
    # the CLI's nets are ctpa's tiny ones with the fixture's weights
    vq = nets["vq"]

    def init_state(model, disc, perc, seed=0):
        load_flax_params(model, _np(nets["gen"]))
        load_flax_params(disc, _np(nets["disc"]))
        load_flax_params(perc, _np(nets["perc"]))
        return vq_state_from_numpy(vq, device="cpu")

    runs = []

    def recording(*args, **kwargs):
        inner = make_vqgan_train_step(*args, **kwargs)
        record = []
        runs.append(record)

        def step(state, video):
            state, m = inner(state, video)
            record.append((state.step, {k: float(v) for k, v in m.items()}))
            return state, m
        return step

    monkeypatch.setattr(tv_cli, "init_state", init_state)
    monkeypatch.setattr(tv_cli, "make_vqgan_train_step", recording)

    def run(ckpt, steps, *extra):
        argv = ["--data-dir", str(data), "--tiny", "--batch-size", "2", "--lr", str(LR),
                "--disc-lr", str(LR), "--num-steps", str(steps), "--save-every", "2", "--log-every", "1", "--checkpoint-dir",
                str(tmp_path / ckpt), *extra]
        assert tv_cli.main(argv, device="cpu") == 0
        return runs[-1]

    first = run("a", 2)
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [2]
    resumed = run("a", 3, "--resume")
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [2, 3]
    whole = run("c", 3)
    assert [s for s, _ in first] == [1, 2] and [s for s, _ in resumed] == [3]
    assert [s for s, _ in whole] == [1, 2, 3]
    for key in METRICS:
        _close(resumed[0][1][key], whole[2][1][key], ATOL0, TOL, msg=f"resumed {key}")
    saved = CheckpointManager(str(tmp_path / "a")).restore()
    assert saved["step"] == 3 and set(saved) == {"gen_params", "disc_params", "perc_params",
                                                 "gen_opt", "disc_opt", "vq_state", "step"}

    # ctpa's step on the CLI's batches (the port's loader is ctpa's order)
    dataset = jdata.VolumeDataset(str(data))
    batches = jdata.batch_iterator(dataset, 2, tv_cli.collate)
    videos = [next(batches)["video"] for _ in range(3)]
    # the CLI applies R1 every 16 steps: at the first of three only
    ref, _ = _jax_steps(nets, jax_step(True), videos, counters=(0, 1, 3))
    for i, (_, m) in enumerate(whole):
        for key in METRICS:
            _close(m[key], ref[i][key], ATOL0, TOL, msg=f"step {i + 1} {key}")
