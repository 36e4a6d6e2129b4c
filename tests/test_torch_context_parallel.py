"""Context-parallel attention of the port (``ctpa_torch/parallel/context.py``)
against ctpa's, on the CPU.

The parent process computes ctpa's ``context_parallel_attention`` on 2 or 4
of the virtual CPU devices of ``tests/conftest.py`` (``impl="dense"``, and
``impl="flash"`` with its Pallas kernel interpreted) and ctpa's gradients
of sum(out * w) through it; the port's side runs in 2 or 4 torch-only gloo
workers (``tests/test_torch_parallel_worker.py``), its flash form on the
wrapper's plain version.  One spawn per rank count carries every form.

Bounds, fp32 on both sides: outputs and gradients within 1e-5 abs + 1e-5
rel; the fused encoder's tokens within 1e-4 abs, the bound of the
unsharded fused encoder's test (``tests/test_torch_clip_variants.py``).
The planted fault (every rank's causal mask unshifted, q_offset 0) must
miss the reference by more than 100 times the bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

from ctpa.core import config as jc
from ctpa.models.ctvit import CTViT as JViT
from ctpa.parallel.context import context_parallel_attention as j_cp
from ctpa_torch.convert import flax_to_state_dict
from test_torch_parallel_worker import spawn

torch.set_num_threads(1)
ATOL = RTOL = 1e-5
ENC_ATOL = 1e-4
B, H, N, D = 1, 2, 64, 32


def _mesh(p):
    return Mesh(np.asarray(jax.devices()[:p]).reshape(p, 1), ("data", "model"))


def _inputs(seed, bias=False, kvm=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    form = {"q": f(B, H, N, D), "k": f(B, H, N, D), "v": f(B, H, N, D), "w": f(B, H, N, D)}
    form["bias"] = 0.1 * f(H, N, N) if bias else None
    form["kv_mask"] = (np.arange(N)[None] < 48).astype(np.int32) if kvm else None
    return form


def _ctpa(form, mesh, impl, causal, grad):
    """ctpa's output and (dense) gradients of sum(out * w)."""
    args = [jnp.asarray(form[k]) for k in ("q", "k", "v")]
    bias = None if form["bias"] is None else jnp.asarray(form["bias"])
    kvm = None if form["kv_mask"] is None else jnp.asarray(form["kv_mask"])

    def fn(q, k, v, bias, impl):
        return j_cp(q, k, v, mesh, "data", bias=bias, kv_mask=kvm, impl=impl, causal=causal)

    names = ["dq", "dk", "dv"] + (["dbias"] if bias is not None else [])

    def dense(q, k, v, b):
        out, vjp = jax.vjp(lambda *a: fn(*a, "dense"), q, k, v, b)
        return out, vjp(jnp.asarray(form["w"]))[:len(names)] if grad else ()

    out, grads = jax.jit(dense)(*args, bias)
    if impl == "flash":
        with pltpu.force_tpu_interpret_mode():
            out = jax.jit(lambda *a: fn(*a, "flash"))(*args, bias)
            jax.block_until_ready(out)
            jax.effects_barrier()
    res = {"out": np.asarray(out)}
    res.update({n: np.asarray(x) for n, x in zip(names, grads)})
    return res


# (name, seed, bias, kv_mask, port impl, ctpa impl, causal, grad)
FORMS = {
    2: [("dense", 1, False, False, "dense", "dense", False, True),
        ("dense_bias_kvm", 2, True, True, "dense", "dense", False, True),
        ("flash", 3, False, False, "flash", "flash", False, True),
        ("flash_bias_kvm", 4, True, True, "flash", "dense", False, True),
        ("causal_dense", 5, False, False, "dense", "dense", True, True),
        ("causal_flash", 6, False, False, "flash", "flash", True, True)],
    4: [("dense_bias_kvm", 7, True, True, "dense", "dense", False, True),
        ("flash", 8, False, False, "flash", "dense", False, True),
        ("causal_dense", 9, False, False, "dense", "dense", True, True),
        ("causal_flash", 10, False, False, "flash", "dense", True, True)],
}


def _encoder_job():
    """ctpa's fused CTViT (depth 1) with numpy weights and a volume; its
    encoder's tokens under a 2-way cp_mesh, its flash kernel interpreted."""
    cfg = dataclasses.replace(jc.CTViTConfig.tiny(), fused_attention=True, fused_depth=1)
    jm = JViT(cfg)
    rng = np.random.default_rng(11)
    video = rng.uniform(-1, 1, size=(1, 1, cfg.temporal_size, cfg.image_size,
                                     cfg.image_size)).astype(np.float32)
    tree = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(video)))["params"]

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = np.shape(leaf)
        val = (1 + 0.1 * rng.normal(size=shape)) if name in (
            "gamma", "scale", "q_scale", "k_scale", "norm_in_scale") else (
            rng.normal(size=shape) / np.sqrt(shape[0]) if len(shape) == 2
            else 0.1 * rng.normal(size=shape))
        return jnp.asarray(val, jnp.float32)

    params = jax.tree_util.tree_map_with_path(fill, tree)
    cp = JViT(cfg, cp_mesh=_mesh(2), cp_axis="data")

    def encode(m, v):
        return m.encode_tokens(m.patch_embed(v))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, v: cp.apply({"params": p}, v, method=encode))(
            params, jnp.asarray(video))
        jax.block_until_ready(want)
        jax.effects_barrier()
    state = flax_to_state_dict(jax.tree.map(np.asarray, params))
    return {"depth": 1, "state": state, "video": video}, np.asarray(want)


_RUNS = {}


def cp_run(p, tmp_path_factory):
    """ctpa's references and the p workers' results, computed once per p."""
    if p in _RUNS:
        return _RUNS[p]
    forms, refs = {}, {}
    for name, seed, bias, kvm, impl, jimpl, causal, grad in FORMS[p]:
        form = _inputs(seed, bias, kvm)
        refs[name] = _ctpa(form, _mesh(p), jimpl, causal, grad)
        forms[name] = dict(form, impl=impl, causal=causal, grad=grad)
    job = {"forms": forms, "cp_faults": [n for n in forms if n.startswith("causal")],
           "indivisible": N + 2 if p == 4 else N + 1, "encoder": None}
    enc_ref = None
    if p == 2:
        job["encoder"], enc_ref = _encoder_job()
    outs = spawn("cp", p, job, tmp_path_factory.mktemp(f"cp{p}"))
    _RUNS[p] = (refs, outs, enc_ref)
    return _RUNS[p]


@pytest.mark.parametrize("p", [2, 4])
def test_cp_forward_and_gradients_match_ctpa(p, tmp_path_factory):
    """Every form's output and gradients (q, k, v and the bias) on every rank
    against ctpa's: dense and plain-flash forms, with the CPB-style bias and
    the key mask, causal with each rank's q_offset."""
    refs, outs, _ = cp_run(p, tmp_path_factory)
    for r, out in enumerate(outs):
        for name, ref in refs.items():
            for key, want in ref.items():
                np.testing.assert_allclose(out[name][key], want, atol=ATOL, rtol=RTOL,
                                           err_msg=f"p {p} rank {r} {name} {key}")


@pytest.mark.parametrize("p", [2, 4])
def test_cp_planted_zero_offset_is_rejected(p, tmp_path_factory):
    """Every rank's queries taken as rows 0 .. n/p - 1 (q_offset 0 on every
    rank): the causal forms' outputs (gathered, so the same on every rank)
    miss ctpa's by far more than the bound."""
    refs, outs, _ = cp_run(p, tmp_path_factory)
    for r, out in enumerate(outs):
        for name, got in out["faults"].items():
            err = np.abs(got["out"] - refs[name]["out"]).max()
            assert err > 100 * (ATOL + RTOL), (p, r, name, err)


@pytest.mark.parametrize("p", [2, 4])
def test_cp_rejects_an_indivisible_sequence(p, tmp_path_factory):
    _, outs, _ = cp_run(p, tmp_path_factory)
    for out in outs:
        assert out["indivisible"] is not None and "not divisible" in out["indivisible"]
    q = jnp.zeros((1, 1, N + 2 if p == 4 else N + 1, 16))
    with pytest.raises(ValueError, match="not divisible"):
        j_cp(q, q, q, _mesh(p), "data", impl="dense")


def test_fused_encoder_under_cp_mesh_matches_ctpa(tmp_path_factory):
    """CTViT(cp_mesh=...) with the fused encoder (depth 1) on 2 ranks against
    ctpa's CTViT under a 2-way cp_mesh (its flash kernel interpreted): the
    encoder's tokens on both ranks."""
    _, outs, enc_ref = cp_run(2, tmp_path_factory)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["encoder"], enc_ref, atol=ENC_ATOL, err_msg=f"rank {r}")
