"""The port's continuous-batched report serving against ctpa's, on the CPU:
``ContinuousBatcher`` (its plain ring tier, its speculative tier and the
auto policy), ``StreamingReportPipeline`` and the scan ingest it reads
(``ctpa/pipelines/streaming.py``, ``ctpa/data/{ingest,nifti,dicom}.py``).

The same numpy weights (carried into the port by ``ctpa_torch.convert``)
and the same numpy-seeded prompts and volumes go through both.  ctpa's
``generate`` (greedy, without flash_decode) at batch 12 is the reference:
its tokens for a request are the tokens every serving path must give,
greedy and token for token (the speculative tier and every admission form
included), with the fp32, int8 and int4 caches.  The port runs flash_decode,
so its ring steps go through the decode-attention wrapper's plain version.
The auto policy's tier choices, demotions and re-probes are ctpa's
(``tests/test_streaming_spec.py``); the window checks raise ctpa's messages.
A chunk reads the device once: its wire tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.core import config as jc
from ctpa.data import ingest as jingest
from ctpa.data import nifti as jnifti
from ctpa.data.dicom import save_series as jsave_series
from ctpa.data.tokenizer import SimpleWordTokenizer as JTokenizer
from ctpa.models import report_generator as jrg
from ctpa.pipelines import streaming as jstream
from ctpa_torch.convert import load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.core.mesh import single_device_mesh
from ctpa_torch.data import ingest, nifti
from ctpa_torch.data.dicom import save_series
from ctpa_torch.data.tokenizer import SimpleWordTokenizer
from ctpa_torch.models import report_generator as trg
from ctpa_torch.pipelines import streaming
from ctpa_torch.pipelines.streaming import ContinuousBatcher, Request, StreamingReportPipeline

torch.set_num_threads(1)
JLLM, TLLM = jc.LLMConfig.tiny(), tc.LLMConfig.tiny()
JVIT, TVIT = jc.CTViTConfig.tiny(), tc.CTViTConfig.tiny()
VDIM, N, NEW = 24, 6, 10
PROMPT = "generate report"


def _t(x):
    return torch.from_numpy(np.array(x))


def np_params(tree, seed, scale=0.2):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "weight", "norm_in_scale", "gamma", "q_scale", "k_scale"):
            val = 1 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            val = scale * rng.normal(size=shape)
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


class World:
    """12 requests: rows 0-5 with prompts of their own, rows 6-11 sharing the
    tokenized PROMPT (right-padded: 4 real tokens of 6), each with a volume
    of its own; ctpa's greedy tokens for each with the fp32, int8 and int4
    caches; the port's models."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.videos = rng.uniform(-1, 1, size=(12, 1, TVIT.temporal_size, TVIT.image_size,
                                               TVIT.image_size)).astype(np.float32)
        shared = SimpleWordTokenizer(vocab_size=JLLM.vocab_size, max_length=N)([PROMPT])
        assert np.array_equal(shared["input_ids"],
                              JTokenizer(vocab_size=JLLM.vocab_size, max_length=N)([PROMPT])
                              ["input_ids"])
        self.ids = np.concatenate([rng.integers(3, JLLM.vocab_size, size=(6, N)),
                                   np.repeat(shared["input_ids"], 6, 0)]).astype(np.int32)
        self.mask = np.concatenate([np.ones((6, N), np.int32),
                                    np.repeat(shared["attention_mask"], 6, 0)])
        jm = jrg.CTReportGenerator(JLLM, JVIT, jc.ReportGenConfig(vision_dim=VDIM))
        self.params = np_params(jax.eval_shape(lambda: jm.init(
            jax.random.key(0), jnp.asarray(self.videos[:1]), jnp.asarray(self.ids[:1]),
            jnp.asarray(self.mask[:1])))["params"], 5)
        self.jparams = {"params": self.params}
        self.ref, self.models = {}, {}
        for kv in (None, "int8", "int4"):
            jcfg = dataclasses.replace(JLLM, kv_quant=kv)
            out = jrg.CTReportGenerator(jcfg, JVIT, jc.ReportGenConfig(vision_dim=VDIM)).apply(
                self.jparams, jnp.asarray(self.videos), jnp.asarray(self.ids),
                jnp.asarray(self.mask), NEW, eos_token_id=-1, greedy=True,
                method=jrg.CTReportGenerator.generate)
            self.ref[kv] = np.asarray(out.tokens)
            self.models[kv] = self.port(kv_quant=kv, flash_decode=kv != "int4")
        self.jm = jm
        with torch.no_grad():
            self.vision = self.models[None].extract_vision(_t(self.videos))

    def port(self, **llm):
        tm = trg.CTReportGenerator(dataclasses.replace(TLLM, **llm), TVIT,
                                   tc.ReportGenConfig(vision_dim=VDIM), device="cpu")
        return load_flax_params(tm, jax.tree.map(np.asarray, self.params))

    def request(self, rid, row, max_new=8, shared=False):
        return Request(request_id=rid, input_ids=None if shared else self.ids[row],
                       attention_mask=None if shared else self.mask[row],
                       vision=self.vision[row], max_new_tokens=max_new)

    def batcher(self, kv=None, **kw):
        kw = dict(dict(num_lanes=2, max_len=32, eos_token_id=-1, greedy=True), **kw)
        return ContinuousBatcher(self.models[kv], **kw)


@pytest.fixture(scope="module")
def world():
    return World()


def _serve(batcher, requests, shared_prompt=None):
    if shared_prompt is not None:
        batcher.set_shared_prefix(*shared_prompt)
    for req in requests:
        batcher.submit(req)
    results = batcher.run_until_done()
    assert all(results[r.request_id].finished for r in requests)
    return results


def _check(world, results, rows, max_new=8, kv=None):
    for rid, row in rows.items():
        assert results[rid].tokens == world.ref[kv][row, :max_new].tolist(), (rid, row)


# ------------------------------------------------------- the plain ring tier

@pytest.mark.parametrize("steps_per_sync", [1, 4])
def test_plain_batcher_matches_ctpa(world, steps_per_sync):
    """3 requests through 2 lanes: a lane is reused."""
    b = world.batcher(steps_per_sync=steps_per_sync)
    results = _serve(b, [world.request(i, i) for i in range(3)])
    _check(world, results, {i: i for i in range(3)})


def test_ring_wraps_and_matches_ctpa(world):
    """12 requests through 2 lanes of a 20-slot cache (a request's window is
    6 + 8 + 1 = 15): the clock passes twice the cache length and every
    request still gets ctpa's tokens."""
    b = world.batcher(max_len=20)
    results = _serve(b, [world.request(i, i) for i in range(12)])
    assert b.clock > 2 * b.max_len
    _check(world, results, {i: i for i in range(12)})


def test_shared_prefix_matches_ctpa(world):
    """The shared prompt prefilled once, 6 volumes through 2 lanes of a
    20-slot ring: each request gets ctpa's tokens for its own volume."""
    b = world.batcher(max_len=20)
    results = _serve(b, [world.request(i, 6 + i, shared=True) for i in range(6)],
                     (world.ids[6], world.mask[6]))
    assert b.clock > b.max_len
    _check(world, results, {i: 6 + i for i in range(6)})
    assert len({tuple(r.tokens) for r in results.values()}) > 1


def test_shared_prefix_requires_registration(world):
    with pytest.raises(ValueError, match="shared prefix"):
        world.batcher().submit(world.request(0, 6, shared=True))


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_batcher_with_quantized_cache_matches_ctpa(world, kv):
    b = world.batcher(kv)
    assert b.cache.k.dtype == torch.int8
    results = _serve(b, [world.request(i, i) for i in range(3)])
    _check(world, results, {i: i for i in range(3)}, kv=kv)


def test_eos_frees_a_lane(world):
    """EOS = request 0's first greedy token: it finishes with no token at its
    admission, and request 1 is served in the freed lane up to its budget or
    its own EOS."""
    eos = int(world.ref[None][0, 0])
    b = world.batcher(num_lanes=1, eos_token_id=eos)
    results = _serve(b, [world.request(0, 0, max_new=6), world.request(1, 1, max_new=4)])
    assert results[0].tokens == []
    want = world.ref[None][1, :4].tolist()
    assert results[1].tokens == (want[:want.index(eos)] if eos in want else want)


def test_pipeline_burst_admits_every_request_before_the_first_chunk(world):
    tok = SimpleWordTokenizer(vocab_size=TLLM.vocab_size, max_length=N)
    model = world.models[None]
    b = world.batcher(num_lanes=4, steps_per_sync=4)

    def encode_fn(vol, slope, intercept, spacing):
        return model.extract_vision(vol[None])[0]

    pipe = StreamingReportPipeline(encode_fn, b, tok, prompt=PROMPT, max_new_tokens=5,
                                   prompt_len=N)
    live, step = [], b.step

    def counting_step():
        b._fill_lanes()
        live.append(int(b.active.sum()))
        return step()

    b.step = counting_step
    results = pipe.run([{"volume": world.videos[6 + i], "slope": 1.0, "intercept": 0.0,
                         "spacing": (1.0, 1.0, 1.0)} for i in range(4)])
    assert live == [4]                # 5 tokens: the first, then 4 in the one chunk
    _check(world, results, {i: 6 + i for i in range(4)}, max_new=5)


def test_pipeline_streams_a_source_and_relays_its_error(world):
    tok = SimpleWordTokenizer(vocab_size=TLLM.vocab_size, max_length=N)
    model = world.models[None]

    def encode_fn(vol, slope, intercept, spacing):
        return model.extract_vision(vol[None])[0]

    def scans(fail):
        for i in range(3):
            yield {"volume": world.videos[6 + i], "slope": 1.0, "intercept": 0.0,
                   "spacing": (1.0, 1.0, 1.0)}
        if fail:
            raise OSError("scan 3 is unreadable")

    pipe = StreamingReportPipeline(encode_fn, world.batcher(), tok, prompt=PROMPT,
                                   max_new_tokens=5, prompt_len=N)
    _check(world, pipe.run(scans(False)), {i: 6 + i for i in range(3)}, max_new=5)
    pipe = StreamingReportPipeline(encode_fn, world.batcher(), tok, prompt=PROMPT,
                                   max_new_tokens=5, prompt_len=N)
    with pytest.raises(OSError, match="unreadable"):
        pipe.run(scans(True))


# ------------------------------------------------------- the speculative tier

@pytest.mark.parametrize("steps_per_sync", [1, 2])
def test_spec_batcher_matches_ctpa(world, steps_per_sync):
    b = world.batcher(spec_lookup=3, steps_per_sync=steps_per_sync)
    assert b.spec_steps == 1
    results = _serve(b, [world.request(i, i) for i in range(3)])
    _check(world, results, {i: i for i in range(3)})
    # the device's budgets ran out with the host's: each lane's history holds
    # its last request's prompt and 8 tokens, no more
    assert b.remaining.tolist() == [0, 0] and b.cur_len.tolist() == [N + 8, N + 8]


def test_spec_batcher_with_shared_prefix_matches_ctpa(world):
    """The padded shared prompt (4 real tokens of 6), K = 4, 4 volumes
    through 2 lanes."""
    b = world.batcher(spec_lookup=4, steps_per_sync=10)
    assert b.spec_steps == 2
    results = _serve(b, [world.request(i, 6 + i, shared=True) for i in range(4)],
                     (world.ids[6], world.mask[6]))
    _check(world, results, {i: 6 + i for i in range(4)})


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_spec_serving_with_quantized_cache_matches_ctpa(world, kv):
    """The speculative batcher and generate_speculative: both roll the
    quantized rows and their scales back with the rejected drafts."""
    b = world.batcher(kv, spec_lookup=3, steps_per_sync=2)
    results = _serve(b, [world.request(i, i) for i in range(2)])
    _check(world, results, {i: i for i in range(2)}, kv=kv)
    got = world.models[kv].generate_speculative(
        _t(world.videos[:2]), _t(world.ids[:2]).long(), _t(world.mask[:2]).long(), NEW,
        eos_token_id=-1, draft_len=3)
    assert np.array_equal(got.tokens.numpy(), world.ref[kv][:2])


def test_spec_batcher_full_acceptance_takes_few_chunks(world):
    """A zeroed lm_head makes the fallback drafts always right: 24 tokens in
    ceil(23 / 5) = 5 chunks of one verify (the first chunk also carries the
    first token)."""
    model = world.port(flash_decode=True)
    with torch.no_grad():
        model.llm.lm_head.weight.zero_()
    b = ContinuousBatcher(model, num_lanes=1, max_len=64, eos_token_id=-1, greedy=True,
                          spec_lookup=4)
    b.submit(world.request(0, 0, max_new=24))
    chunks = 0
    while b.has_work:
        b.step()
        chunks += 1
    assert chunks == 5 and b.results[0].tokens == [0] * 24


def test_spec_batcher_budget_and_eos_edges(world):
    b = world.batcher(num_lanes=1, spec_lookup=3)
    results = _serve(b, [world.request(0, 0, max_new=1)])
    assert results[0].tokens == world.ref[None][0, :1].tolist()
    b = world.batcher(num_lanes=1, spec_lookup=3, eos_token_id=int(world.ref[None][0, 0]))
    assert _serve(b, [world.request(0, 0)])[0].tokens == []


def test_spec_batcher_sampling(world):
    """Sampled acceptance near temperature 0 gives the greedy tokens; at 0.7
    with top-p every request fills its budget with valid ids."""
    b = world.batcher(greedy=False, temperature=1e-4, spec_lookup=3, steps_per_sync=2,
                      generator=torch.Generator().manual_seed(3), max_len=64)
    _check(world, _serve(b, [world.request(i, i, max_new=10) for i in range(3)]),
           {i: i for i in range(3)}, max_new=10)
    b = world.batcher(greedy=False, temperature=0.7, top_p=0.9, spec_lookup=3, steps_per_sync=2,
                      generator=torch.Generator().manual_seed(4), max_len=64)
    for res in _serve(b, [world.request(i, i) for i in range(3)]).values():
        assert len(res.tokens) == 8 and all(0 <= t < TLLM.vocab_size for t in res.tokens)


# ------------------------------------------------------- the auto policy

def _wave(b, world, rid, count=1, row=0):
    for i in range(count):
        b.submit(world.request(rid + i, row, max_new=6))
    b.step()
    mode = b._mode
    b.run_until_done()
    return mode


def test_auto_policy_picks_the_tier_by_occupancy(world):
    """One waiting request: the speculative tier; a burst of 4 over the
    threshold: the plain tier (the ring's meta reset); one again: back to
    speculation.  Every request gets ctpa's tokens."""
    b = world.batcher(num_lanes=4, max_len=40, steps_per_sync=2, spec_lookup=3,
                      spec_policy="auto", spec_auto_threshold=1, spec_accept_floor=None)
    assert [_wave(b, world, 0), _wave(b, world, 1, 4), _wave(b, world, 5)] == \
        ["spec", "plain", "spec"]
    _check(world, b.results, {i: 0 for i in range(6)}, max_new=6)


def test_auto_policy_demotes_and_reprobes(world):
    """A floor above K + 1 demotes every wave after the first probe; every
    3rd demoted wave probes again; an EWMA above the floor restores the
    occupancy rule.  ctpa's sequence, and ctpa's tokens throughout."""
    b = world.batcher(num_lanes=4, max_len=40, steps_per_sync=2, spec_lookup=3,
                      spec_policy="auto", spec_auto_threshold=1, spec_accept_floor=5.0,
                      spec_reprobe_every=3)
    modes = [_wave(b, world, 0)]
    assert b._spec_accept_ewma is not None and b._spec_accept_ewma < 5.0
    modes += [_wave(b, world, i) for i in (1, 2, 3)]
    b._spec_accept_ewma = 10.0
    modes.append(_wave(b, world, 4))
    assert modes == ["spec", "plain", "plain", "spec", "spec"]
    _check(world, b.results, {i: 0 for i in range(5)}, max_new=6)
    assert b.spec_accept_floor == 5.0
    assert world.batcher(spec_lookup=4, spec_policy="auto").spec_accept_floor == 0.6 * 5


# ------------------------------------------------------- checks and host reads

@pytest.mark.parametrize("kw", [dict(steps_per_sync=4), dict(spec_lookup=4),
                                dict(spec_lookup=2, spec_policy="auto", steps_per_sync=5)])
def test_window_checks_raise_ctpas_messages(world, kw):
    req = dict(request_id=0, input_ids=np.ones(6, np.int32), attention_mask=np.ones(6, np.int32),
               vision=np.zeros(VDIM, np.float32), max_new_tokens=8)
    ours = ContinuousBatcher(world.models[None], num_lanes=1, max_len=16, **kw)
    theirs = jstream.ContinuousBatcher(world.jm, world.jparams, num_lanes=1, max_len=16, **kw)
    with pytest.raises(ValueError) as ref:
        theirs.submit(jstream.Request(**req))
    with pytest.raises(ValueError) as got:
        ours.submit(Request(**req))
    assert str(got.value) == str(ref.value) and "exceeds max_len 16" in str(got.value)
    ours.submit(Request(**dict(req, max_new_tokens=1)))           # a window that fits


def test_batcher_refuses_what_is_not_ported(world):
    # tensor-parallel serving is ported (tests/test_torch_tp.py) but for
    # ctpa's own refusal of the single-card decode kernel under a mesh
    with pytest.raises(ValueError, match="flash_decode"):
        ContinuousBatcher(world.models[None], mesh=single_device_mesh("cpu"))
    with pytest.raises(ValueError):
        ContinuousBatcher(world.models[None], spec_policy="auto")


_SYNCS = ("__bool__", "item", "__float__", "__int__", "__index__", "tolist", "numpy",
          "__array__")


@pytest.mark.parametrize("kw", [dict(steps_per_sync=4), dict(spec_lookup=3, steps_per_sync=8)])
def test_a_chunk_reads_the_device_once(world, monkeypatch, kw):
    """Inside step() no tensor is read back (no bool(), .item(), int(),
    .tolist(), .numpy()) but for the chunk's one wire tensor (``fetch``),
    admission included."""
    b = world.batcher(**kw)
    b.set_shared_prefix(world.ids[6], world.mask[6])
    for i in range(3):
        b.submit(world.request(i, 6 + i, shared=i == 0))
    fetches, allowed = [], []

    def guard(name):
        original = getattr(torch.Tensor, name)

        def patched(self, *args, **kwargs):
            if not allowed:
                raise AssertionError(f"host read: Tensor.{name} in a chunk")
            return original(self, *args, **kwargs)
        return patched

    real_fetch = streaming.fetch

    def counted_fetch(t):
        fetches.append(tuple(t.shape))
        allowed.append(1)
        try:
            return real_fetch(t)
        finally:
            allowed.pop()

    chunks = 0
    while b.has_work:
        with monkeypatch.context() as mp:
            guards = {name: guard(name) for name in _SYNCS}
            for name, patched in guards.items():
                mp.setattr(torch.Tensor, name, patched)
            mp.setattr(streaming, "fetch", counted_fetch)
            b.step()
        chunks += 1
    assert len(fetches) == chunks
    _check(world, b.results, {i: 6 + i for i in range(3)})


# ------------------------------------------------------- ingest

def test_load_scan_reads_every_format_as_ctpa(tmp_path):
    rng = np.random.default_rng(0)
    vol = rng.integers(-100, 3000, size=(4, 6, 7)).astype(np.int16)
    d = str(tmp_path / "series")
    save_series(d, vol, spacing=(1.5, 0.8, 0.8), slope=2.0, intercept=-10.0, shuffle=True)
    jsave_series(str(tmp_path / "series_ctpa"), vol, spacing=(1.5, 0.8, 0.8), slope=2.0,
                 intercept=-10.0, shuffle=True)
    npz = str(tmp_path / "v.npz")
    np.savez(npz, arr_0=vol, spacing=np.asarray([2.0, 1.0, 1.0]), slope=np.asarray(3.0),
             intercept=np.asarray(-5.0))
    npy = str(tmp_path / "v.npy")
    np.save(npy, vol)
    nii = str(tmp_path / "v.nii.gz")
    nifti.save(nii, np.transpose(vol, (2, 1, 0)).astype(np.float32), spacing=(0.7, 0.8, 1.5),
               scl_slope=1.0, scl_inter=-1024.0)
    for path, kw in ((d, {}), (str(tmp_path / "series_ctpa"), {}), (npz, {}),
                     (npy, dict(slope=1.5, spacing=(9.0, 1.0, 1.0))), (nii, {})):
        got, ref = ingest.load_scan(path, **kw), jingest.load_scan(path, **kw)
        assert np.array_equal(got["volume"], ref["volume"])
        assert np.array_equal(np.asarray(got["volume"]).astype(np.int16), vol)
        for key in ("slope", "intercept", "spacing"):
            assert got[key] == ref[key], (path, key)
    assert jnifti.load(nii).scl_inter == -1024.0
    with pytest.raises(ValueError, match="unrecognized"):
        ingest.load_scan(str(tmp_path / "v.txt"))


def test_run_paths_serves_dicom_series(world, tmp_path):
    """Explicit-VR DICOM series through the threaded ingest: the rescale
    tags reach encode_fn with the raw int16 values."""
    rng = np.random.default_rng(7)
    dirs, seen = [], []
    for i in range(3):
        d = str(tmp_path / f"series_{i}")
        save_series(d, rng.integers(0, 3000, size=(TVIT.temporal_size, TVIT.image_size,
                                                   TVIT.image_size)).astype(np.int16),
                    spacing=(2.0, 0.7, 0.7), slope=1.0, intercept=-1024.0, shuffle=i == 1)
        dirs.append(d)
    model = world.models[None]

    def encode_fn(vol, slope, intercept, spacing):
        seen.append((vol.dtype, slope, intercept, spacing))
        return model.extract_vision(((vol.float() * slope + intercept) / 1000)[None, None])[0]

    tok = SimpleWordTokenizer(vocab_size=TLLM.vocab_size, max_length=N)
    pipe = StreamingReportPipeline(encode_fn, world.batcher(), tok, prompt=PROMPT,
                                   max_new_tokens=5, prompt_len=N)
    results = pipe.run_paths(dirs, num_threads=2)
    assert len(results) == 3 and all(r.finished and len(r.tokens) == 5 for r in results.values())
    for dtype, slope, intercept, spacing in seen:
        assert dtype == torch.int16 and (slope, intercept) == (1.0, -1024.0)
        np.testing.assert_allclose(spacing, (2.0, 0.7, 0.7), rtol=1e-5)
