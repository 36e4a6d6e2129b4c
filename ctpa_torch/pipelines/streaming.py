"""Streaming report serving: scan ingest -> preprocess -> vision encode ->
continuous-batched report decoding (port of ``ctpa/pipelines/streaming.py``).

``ContinuousBatcher`` serves fixed lanes of one batched KV cache.  A request
is prefilled at batch 1 (or takes the shared prompt's prefill,
``set_shared_prefix``), its first token is sampled on the device, and its
cache is copied into a free lane; every ``step`` then advances all live
lanes by a chunk of ``steps_per_sync`` tokens with ONE read of the device:
the chunk's token rows (the wire tensor).  Done flags, budgets and EOS stay
on the device inside a chunk; the host does its bookkeeping on the fetched
rows.  Finished lanes are refilled from the queue at once.

Plain tier: the cache is a ring on one shared, unwrapped clock.  At
admission a lane's prefilled rows are rotated so its last prompt token sits
at slot (clock - 1) mod m (``models/llm.py:align_lane_to_clock``); every
lane's write_offset is then the clock and a decode step writes all lanes at
one slot (``shared_kv_offset``).  Single-token attention is validity-based,
so slot order need not be token order.

Speculative tier (``spec_lookup=K``): every step of a chunk is a
prompt-lookup verify of K drafted tokens per lane (``_spec_fns``), with
per-lane offsets and no wrap (the K + 1-row verify mask needs slot order to
be token order).  ``spec_policy="auto"`` picks the tier per wave from the
queue's length and an acceptance EWMA.

The cache is written in place (the port's LLM writes each layer's rows
into the buffers): the offsets, validity and meta taken before a verify are
separate tensors, never views the verify overwrites.  Randomness comes from
one ``torch.Generator`` on the model's device; JAX's per-step keys cannot be
matched bit for bit, so sampled serving equals ctpa's in law, greedy
serving token for token.

Tensor-parallel serving (``mesh``): the batcher serves a copy of the model
whose LLM is split over the mesh's 'model' axis (``parallel/sharding.py:
tensor_parallel_copy``; one process per rank, each running the same
batcher on the same requests), and every KV cache it makes holds the
rank's kv heads.  The logits are all-gathered before sampling, so every
rank samples the same tokens.  Both tiers run under it.  As ctpa's, it
refuses ``flash_decode`` and quantized weights on the kernels
(``quant_impl="pallas"``): those kernels are single-card programs.

Not ported: ``negotiate_param_formats`` (it negotiates XLA AOT parameter
layouts; eager PyTorch has no counterpart)."""

from __future__ import annotations

import collections
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ctpa_torch.core.config import LLMConfig
from ctpa_torch.core.mesh import MODEL_AXIS
from ctpa_torch.models.llm import align_lane_to_clock, insert_lane, insert_lanes
from ctpa_torch.models.report_generator import (CTReportGenerator, _draft_lookup, _rollback,
                                                _scatter_drop, _spec_accept)
from ctpa_torch.ops.sampling import sample_logits
from ctpa_torch.parallel.sharding import rank_kv_cache, tensor_parallel_copy


@dataclass
class Request:
    request_id: int
    input_ids: Optional[np.ndarray] = None       # (Lp,) right-padded prompt; None = the
    # batcher's shared prefix (set_shared_prefix): admission then runs no LLM prefill
    attention_mask: Optional[np.ndarray] = None  # (Lp,)
    vision: Any = None                           # (d,) vision feature (a tensor or an array)
    max_new_tokens: int = 256


@dataclass
class Result:
    request_id: int
    tokens: list[int] = field(default_factory=list)
    finished: bool = False
    latency_s: float = 0.0


def fetch(t: torch.Tensor) -> np.ndarray:
    """The one read of the device a chunk makes: its wire tensor."""
    return t.cpu().numpy()


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: through
    pinned memory, asynchronously, on a CUDA device (a copy from pageable
    memory synchronizes the stream)."""
    t = torch.as_tensor(np.asarray(array), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _decode_fns(model: CTReportGenerator, *, eos_token_id: int, pad_token_id: int,
                temperature: float, greedy: bool, steps_per_sync: int,
                top_k: Optional[int] = None, top_p: Optional[float] = None):
    """(prefill, decode_chunk, prefix_prefill, first_token) of the plain tier.
    Each takes the ``torch.Generator`` that draws its samples."""

    def sample(logits, generator):
        return sample_logits(logits, generator, temperature=temperature, top_k=top_k,
                             top_p=top_p, greedy=greedy)

    def prefix_prefill(ids, mask, lane_cache):
        """The LLM half of a prefill: the prompt's KV and last hidden state
        do not depend on the request (vision enters only at the fused
        logits), so a shared prompt computes them once."""
        hidden, lane_cache = model.llm.model(ids, mask, lane_cache)
        last = torch.clamp(mask.sum(-1) - 1, min=0).long()
        return hidden[torch.arange(ids.shape[0], device=ids.device), last][:, None], lane_cache

    def first_token(h, vision, generator):
        """The vision-conditioned first token from (q, 1, hidden) last hidden
        states: the only per-request work of a shared-prefix admission."""
        return sample(model._fused_logits(h, vision)[:, 0], generator)

    def prefill(ids, mask, vision, lane_cache, generator):
        """Prefill and the first token, both on the device: admission reads
        nothing back."""
        h, lane_cache = prefix_prefill(ids, mask, lane_cache)
        return first_token(h, vision, generator), lane_cache

    def one_step(cache, tok, vision, generator, done):
        # every lane's write_offset is the ring clock: one shared write slot
        hidden, cache = model.llm.model(tok[:, None], None, cache, shared_kv_offset=True)
        nxt = sample(model._fused_logits(hidden, vision)[:, 0], generator)
        nxt = torch.where(done, pad_token_id, nxt)
        return nxt, cache, done | (nxt == eos_token_id)

    def decode_chunk(cache, tok, vision, generator, done):
        """steps_per_sync decode steps -> ((steps + 1, lanes) tokens, cache,
        last tokens, done).  Row 0 is the carry token, so a freshly admitted
        lane's first token reaches the host with the chunk; a carry token
        equal to EOS marks its lane done at once."""
        done = done | (tok == eos_token_id)
        rows = [tok]
        for _ in range(steps_per_sync):
            tok, cache, done = one_step(cache, tok, vision, generator, done)
            rows.append(tok)
        return torch.stack(rows), cache, tok, done

    return prefill, decode_chunk, prefix_prefill, first_token


def _spec_fns(model: CTReportGenerator, *, eos_token_id: int, K: int, ngram: int,
              steps_per_sync: int, greedy: bool = True, temperature: float = 0.7,
              top_k: Optional[int] = None, top_p: Optional[float] = None):
    """The speculative tier's chunk: ``steps_per_sync`` verify steps over all
    lanes, each ``generate_speculative``'s step (draft K tokens from the
    lane's history, one cached forward over the pending token and the
    drafts, accept a prefix, roll the rest back), with per-lane offsets and
    each lane's budget ``remaining`` on the device.  Greedy acceptance is
    token-exact against greedy decoding, sampled acceptance exact in law."""

    def spec_chunk(cache, tok, vision, generator, done, buf, cur_len, remaining):
        lanes, dev = tok.shape[0], tok.device
        idx = torch.arange(K + 1, device=dev)[None]
        entry = tok
        done = done | (tok == eos_token_id)
        blocks = []
        for _ in range(steps_per_sync):
            draft = _draft_lookup(buf, cur_len, tok, ngram, K)
            pre_off, pre_tl = cache.write_offset, cache.true_len
            hidden, verified = model.llm.model(torch.cat([tok[:, None], draft], 1), None, cache)
            g, a = _spec_accept(model._fused_logits(hidden, vision), draft, generator,
                                greedy=greedy, temperature=temperature, top_k=top_k,
                                top_p=top_p)
            eos_hit = (g == eos_token_id) & (idx <= a[:, None])
            has_eos = eos_hit.any(1)
            c = torch.where(has_eos, eos_hit.long().argmax(1) + 1, a + 1)      # committed
            c = torch.where(done, 0, c)
            emit = torch.minimum(c, remaining)                                 # budget clamp
            cache = _rollback(verified, pre_off, pre_tl, c, K)
            keep = (idx < emit[:, None]) & ~done[:, None]
            buf = _scatter_drop(buf, cur_len[:, None] + idx, keep, g)
            nxt = g.gather(1, torch.clamp(c - 1, 0, K)[:, None])[:, 0]
            tok = torch.where(done, tok, nxt)
            remaining = remaining - emit
            done = done | has_eos | (remaining <= 0)
            cur_len = cur_len + emit
            blocks.append(torch.cat([emit[:, None], g], 1))                    # (lanes, K+2)
        # the one-fetch wire format: row 0 the entry pending token of each
        # lane (a freshly admitted lane's first token), then a block of K + 2
        # rows a step: [emit count, g_0 .. g_K]
        wire = torch.cat([entry[None],
                          torch.stack(blocks).transpose(1, 2).reshape(-1, lanes)], 0)
        return wire, cache, tok, done, buf, cur_len, remaining

    return spec_chunk


class ContinuousBatcher:
    """Slot-based continuous batching over a CTReportGenerator's LLM."""

    def __init__(self, model: CTReportGenerator, num_lanes: int = 4, max_len: int = 1024,
                 eos_token_id: int = 2, pad_token_id: int = 0, temperature: float = 0.7,
                 greedy: bool = False, generator: Optional[torch.Generator] = None,
                 steps_per_sync: int = 1, mesh=None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, spec_lookup: Optional[int] = None,
                 spec_ngram: int = 2,
                 spec_policy: str = "manual", spec_auto_threshold: Optional[int] = None,
                 spec_accept_floor="auto", spec_reprobe_every: int = 8):
        """``steps_per_sync`` decode steps run between two host reads; a lane
        finishing mid-chunk wastes at most steps - 1 of them, so ``max_len``
        wants that much slack past prompt + budget.

        ``spec_lookup=K`` makes every step a prompt-lookup verify of K drafts
        per lane (``_spec_fns``), ``spec_steps = ceil(steps_per_sync / (K +
        1))`` of them a chunk.  The cache takes the model's ``cache_dtype()``.

        ``spec_policy="auto"`` picks the tier per wave: when every lane is
        idle and requests wait, the speculative tier if at most
        ``spec_auto_threshold`` (default max(1, lanes // 4)) wait, else the
        plain tier (the two index the cache differently, so they cannot mix
        within a wave).  A wave that qualifies by occupancy is demoted to
        plain while the EWMA of tokens emitted per verify is below
        ``spec_accept_floor`` ("auto": 0.6 (K + 1); None: occupancy alone);
        every ``spec_reprobe_every``-th demoted wave runs speculatively
        anyway to refresh the EWMA.

        ``generator`` (on the model's device) draws every sample; with the
        same seed on every rank, every rank draws the same.  ``mesh``
        serves the LLM tensor-parallel over its 'model' axis (the module
        docstring); the caller's model is left as it was."""
        self.mesh = mesh
        if mesh is not None:
            cfg = model.llm_cfg
            # the serving kernels are single-card programs (ctpa's refusals)
            if cfg.flash_decode:
                raise ValueError("TP serving (mesh=...) does not compose with flash_decode "
                                 "(single-chip pallas kernel); disable one")
            if cfg.weight_quant and cfg.quant_impl == "pallas":
                raise ValueError("TP serving (mesh=...) requires quant_impl='xla' for "
                                 "quantized weights (the pallas dequant kernels are "
                                 "single-chip)")
            model = tensor_parallel_copy(model, mesh, MODEL_AXIS)
        self.model = model
        self.cfg: LLMConfig = model.llm_cfg
        weight = model.llm.model.embed_tokens.weight
        self.device = weight.device
        self.num_lanes, self.max_len = num_lanes, max_len
        self.eos, self.pad = eos_token_id, pad_token_id
        self.temperature, self.greedy = temperature, greedy
        self.steps_per_sync = max(1, steps_per_sync)
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(0))
        self.cache_dtype = model.cache_dtype()
        self.cache = self._new_cache(num_lanes)
        self.vision = torch.zeros(num_lanes, model.gen_cfg.vision_dim, device=self.device)
        self.cur_tok = torch.zeros(num_lanes, dtype=torch.long, device=self.device)
        self.active = np.zeros(num_lanes, bool)
        # the device's copy of ``active``, kept by fill_ (a Python scalar
        # assigned into a CUDA tensor is a host-to-device copy, which waits
        # for the device)
        self._live = torch.zeros(num_lanes, dtype=torch.bool, device=self.device)
        # lanes whose device-sampled first token has not reached the host
        # yet (it comes as row 0 of the next chunk's fetch)
        self._first_pending = np.zeros(num_lanes, bool)
        self.budget = np.zeros(num_lanes, np.int64)
        self.lane_req: list[Optional[Request]] = [None] * num_lanes
        self.results: dict[int, Result] = {}
        self.queue: collections.deque[Request] = collections.deque()
        self._t_start: dict[int, float] = {}
        self._prefix = None      # set_shared_prefix: (h_last, lane cache, Lp, plen, ids)
        (self._prefill, self._decode_chunk, self._prefix_prefill,
         self._first_token) = _decode_fns(model, eos_token_id=eos_token_id,
                                          pad_token_id=pad_token_id, temperature=temperature,
                                          greedy=greedy, steps_per_sync=self.steps_per_sync,
                                          top_k=top_k, top_p=top_p)

        self.spec_lookup, self.spec_ngram = spec_lookup, spec_ngram
        if spec_policy not in ("manual", "auto"):
            raise ValueError(f"spec_policy must be 'manual' or 'auto', got {spec_policy!r}")
        if spec_policy == "auto" and not spec_lookup:
            raise ValueError("spec_policy='auto' needs spec_lookup=K (the draft length of "
                             "the speculative tier)")
        self.spec_policy = spec_policy
        self.spec_auto_threshold = (spec_auto_threshold if spec_auto_threshold is not None
                                    else max(1, num_lanes // 4))
        if spec_accept_floor == "auto":
            spec_accept_floor = 0.6 * (int(spec_lookup) + 1) if spec_lookup else None
        self.spec_accept_floor = spec_accept_floor
        self.spec_reprobe_every = max(1, int(spec_reprobe_every))
        # EWMA of tokens emitted per verify (1..K+1) over the spec chunks;
        # None until the first one runs
        self._spec_accept_ewma: Optional[float] = None
        self._demoted_waves = 0
        # the chunk discipline: fixed by spec_lookup under "manual"; under
        # "auto" _fill_lanes decides it again whenever every lane is idle
        self._mode = "spec" if spec_lookup and spec_policy == "manual" else "plain"
        if spec_lookup:
            self.spec_steps = math.ceil(self.steps_per_sync / (int(spec_lookup) + 1))
            self._spec_chunk = _spec_fns(model, eos_token_id=eos_token_id, K=int(spec_lookup),
                                         ngram=int(spec_ngram), steps_per_sync=self.spec_steps,
                                         greedy=greedy, temperature=temperature, top_k=top_k,
                                         top_p=top_p)
            # each lane's history (prompt and emissions from slot 0) for the
            # drafts, and its budget on the device
            self.buf = torch.zeros(num_lanes, max_len, dtype=torch.long, device=self.device)
            self.cur_len = torch.zeros(num_lanes, dtype=torch.long, device=self.device)
            self.remaining = torch.zeros(num_lanes, dtype=torch.long, device=self.device)
        # the unwrapped ring clock: every lane's write_offset equals it
        # (zeros at clock 0; chunks advance all lanes together; admissions
        # stamp their lane with it)
        self.clock = 0

    # -------------------------------------------------------------- public

    def set_shared_prefix(self, input_ids, attention_mask) -> None:
        """Prefill a prompt shared by every request once; requests submitted
        with input_ids=None reuse its KV and last hidden state, so their
        admission is one fused-logits sample.  Exact: vision enters only at
        the fused logits, so the prompt's KV is the same for every request."""
        ids_np = np.asarray(input_ids, np.int64)
        mask_np = np.asarray(attention_mask)
        lane_cache = self._new_cache(1)
        with torch.no_grad():
            h, lane_cache = self._prefix_prefill(
                to_device(ids_np[None], self.device),
                to_device(mask_np[None], self.device, torch.long), lane_cache)
        # (last hidden, prefilled lane cache, padded slots it used, real
        # tokens, the prompt for the draft history)
        self._prefix = (h, lane_cache, int(ids_np.size), int(mask_np.sum()), ids_np)

    @property
    def has_work(self) -> bool:
        """Requests in lanes or waiting in the queue."""
        return bool(self.active.any() or self.queue)

    def _new_cache(self, lanes: int):
        """An empty cache of ``lanes`` lanes (this rank's kv heads under a
        mesh)."""
        return rank_kv_cache(self.model.llm, lanes, self.max_len, self.cache_dtype, self.device)

    def submit(self, req: Request) -> int:
        """Check and queue a request; it is admitted at the next step (so a
        burst submitted one by one admits together)."""
        if req.input_ids is None and self._prefix is None:
            raise ValueError("request has input_ids=None but no shared prefix is registered "
                             "(set_shared_prefix)")
        prompt_len = self._prefix[2] if req.input_ids is None else int(np.size(req.input_ids))
        # speculative lanes never wrap: padded prompt + budget + the K + 1
        # rows of a verify in flight
        spec_window = prompt_len + req.max_new_tokens + (self.spec_lookup or 0) + 1
        # ring lanes: padded prompt + budget + up to a chunk of overshoot
        # (a lane finishing mid-chunk writes until the chunk ends)
        ring_window = prompt_len + req.max_new_tokens + self.steps_per_sync
        if self.spec_lookup and self.spec_policy == "manual":
            window, kind = spec_window, f"draft window ({self.spec_lookup + 1})"
        elif self.spec_lookup:          # auto: either tier may serve it
            window = max(spec_window, ring_window)
            kind = (f"max(draft window {self.spec_lookup + 1}, "
                    f"steps_per_sync {self.steps_per_sync})")
        else:
            window, kind = ring_window, f"steps_per_sync ({self.steps_per_sync})"
        if window > self.max_len:
            raise ValueError(f"prompt ({prompt_len}) + max_new_tokens ({req.max_new_tokens}) + "
                             f"{kind} = {window} exceeds max_len {self.max_len}: the lane's "
                             f"slot window would wrap onto its own live KV")
        self.results[req.request_id] = Result(req.request_id)
        self._t_start[req.request_id] = time.time()
        self.queue.append(req)
        return req.request_id

    @torch.no_grad()
    def step(self) -> list[int]:
        """Admit queued requests, then advance every live lane by one chunk
        with one host read; -> the ids of the requests that finished."""
        self._fill_lanes()
        if not self.active.any():
            return []
        if self._mode == "spec":
            return self._step_spec()
        done0 = ~self._live
        toks_dev, self.cache, self.cur_tok, _ = self._decode_chunk(
            self.cache, self.cur_tok, self.vision, self.generator, done0)
        self.clock += self.steps_per_sync                  # the device's write_offset
        toks = fetch(toks_dev)                             # (steps + 1, lanes)
        finished: list[int] = []
        for lane in range(self.num_lanes):
            if not self.active[lane]:
                continue
            # row 0 is the carry token: a fresh lane's first token, already
            # consumed by a continuing lane
            start = 0 if self._first_pending[lane] else 1
            self._first_pending[lane] = False
            for k in range(start, toks.shape[0]):
                if self._consume(lane, int(toks[k, lane]), finished):
                    break
        if finished:
            self._fill_lanes()
        return finished

    def run_until_done(self, max_steps: int = 100000) -> dict[int, Result]:
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.results

    # -------------------------------------------------------------- internals

    def _consume(self, lane: int, t: int, finished: list) -> bool:
        """One token of ``lane``'s request; True once the request is done."""
        req = self.lane_req[lane]
        res = self.results[req.request_id]
        self.budget[lane] -= 1
        hit_eos = t == self.eos
        if not hit_eos:
            res.tokens.append(t)
        if hit_eos or self.budget[lane] <= 0:
            res.finished = True
            res.latency_s = time.time() - self._t_start[req.request_id]
            finished.append(req.request_id)
            self.active[lane] = False
            self._live[lane].fill_(False)
            self.lane_req[lane] = None
        return res.finished

    def _step_spec(self) -> list[int]:
        """A speculative chunk: spec_steps verifies, each emitting 1..K+1
        tokens a lane, one host read (the wire format of ``_spec_fns``)."""
        done0 = ~self._live
        (wire, self.cache, self.cur_tok, _, self.buf, self.cur_len,
         self.remaining) = self._spec_chunk(self.cache, self.cur_tok, self.vision,
                                            self.generator, done0, self.buf, self.cur_len,
                                            self.remaining)
        w = fetch(wire)
        K, S = self.spec_lookup, self.spec_steps
        entry, rest = w[0], w[1:].reshape(S, K + 2, self.num_lanes)
        finished: list[int] = []
        verifies = emitted = 0
        for lane in range(self.num_lanes):
            if not self.active[lane]:
                continue
            if self._first_pending[lane]:
                self._first_pending[lane] = False
                if self._consume(lane, int(entry[lane]), finished):
                    continue
            for s in range(S):
                # the device's emit count feeds the EWMA whether or not the
                # budget lets the host take every token
                verifies += 1
                emitted += int(rest[s, 0, lane])
                done = False
                for k in range(int(rest[s, 0, lane])):
                    if self._consume(lane, int(rest[s, 1 + k, lane]), finished):
                        done = True
                        break
                if done:
                    break
        if verifies:
            a = emitted / verifies
            self._spec_accept_ewma = (a if self._spec_accept_ewma is None
                                      else 0.5 * self._spec_accept_ewma + 0.5 * a)
        if finished:
            self._fill_lanes()
        return finished

    def _reset_meta(self) -> None:
        """Back to the shared-clock invariant after a speculative wave: the
        offsets and validity zeroed (new tensors), the K/V buffers kept."""
        self.cache = self.cache._replace(write_offset=torch.zeros_like(self.cache.write_offset),
                                         true_len=torch.zeros_like(self.cache.true_len),
                                         valid=torch.zeros_like(self.cache.valid))
        self.clock = 0

    def _fill_lanes(self) -> None:
        """Admit queued requests into free lanes with no host read: the
        first token is sampled on the device and reaches the host with the
        next chunk.  Shared-prefix admissions of the plain tier go through
        one batched admission (``_admit_shared_batch``)."""
        if self.spec_policy == "auto" and self.queue and not self.active.any():
            want = "spec" if len(self.queue) <= self.spec_auto_threshold else "plain"
            if (want == "spec" and self.spec_accept_floor is not None
                    and self._spec_accept_ewma is not None
                    and self._spec_accept_ewma < self.spec_accept_floor):
                # the drafts are not accepting: serve this wave plain, and
                # probe speculation again every spec_reprobe_every-th time
                self._demoted_waves += 1
                if self._demoted_waves >= self.spec_reprobe_every:
                    self._demoted_waves = 0
                else:
                    want = "plain"
            if want != self._mode:
                if want == "plain":
                    self._reset_meta()
                self._mode = want
        spec_now = self._mode == "spec"
        batch: list[tuple[int, Request]] = []
        for lane in range(self.num_lanes):
            if self.active[lane] or not self.queue:
                continue
            req = self.queue.popleft()
            if req.input_ids is None and not spec_now:
                batch.append((lane, req))
            else:
                self._admit_one(lane, req)
        if batch:
            self._admit_shared_batch(batch)

    def _vision_row(self, req: Request) -> torch.Tensor:
        vision = req.vision if torch.is_tensor(req.vision) else to_device(req.vision, self.device)
        return vision.to(self.device).float().reshape(-1)

    def _admit_shared_batch(self, batch: list[tuple[int, Request]]) -> None:
        """One admission for a burst of shared-prefix requests: their first
        tokens in one fused-logits call, the aligned prefix copied into all
        their lanes at once.  The lane, token and vision vectors are padded
        to num_lanes by repeating the last real entry (duplicate writes of
        the same content)."""
        h, lane_cache = self._prefix[:2]
        q, pad = len(batch), self.num_lanes - len(batch)
        lanes = to_device([ln for ln, _ in batch] + [batch[-1][0]] * pad, self.device)
        viss = torch.stack([self._vision_row(r) for _, r in batch])
        firsts = self._first_token(h.expand(q, *h.shape[1:]), viss, self.generator)
        firsts = torch.cat([firsts, firsts[-1:].expand(pad)])
        viss = torch.cat([viss, viss[-1:].expand(pad, -1)])
        self.cache = insert_lanes(self.cache, align_lane_to_clock(lane_cache, self.clock), lanes)
        self.cur_tok = self.cur_tok.index_put((lanes,), firsts)
        self.vision = self.vision.index_put((lanes,), viss)
        for lane, req in batch:
            self._activate(lane, req)

    def _activate(self, lane: int, req: Request) -> None:
        self.active[lane] = True
        self._live[lane].fill_(True)
        self._first_pending[lane] = True
        self.budget[lane] = req.max_new_tokens
        self.lane_req[lane] = req

    def _admit_one(self, lane: int, req: Request) -> None:
        vis = self._vision_row(req)[None]
        if req.input_ids is None:
            # the shared prefix: one fused-logits sample and the lane copy
            h, lane_cache, _, plen, ids_np = self._prefix
            first = self._first_token(h, vis, self.generator)
        else:
            ids_np = np.asarray(req.input_ids, np.int64)
            plen = int(np.asarray(req.attention_mask).sum())
            lane_cache = self._new_cache(1)
            first, lane_cache = self._prefill(
                to_device(ids_np[None], self.device),
                to_device(np.asarray(req.attention_mask)[None], self.device, torch.long),
                vis, lane_cache, self.generator)
        if self._mode == "spec":
            # per-lane offsets with slot order = token order: a plain copy,
            # and the lane's history seeds the drafts
            self.cache = insert_lane(self.cache, lane_cache, lane)
            self.buf[lane].fill_(0)
            self.buf[lane, : ids_np.size] = to_device(ids_np, self.device)
            self.buf[lane, plen] = first[0]
            self.cur_len[lane].fill_(plen + 1)
            # the device-sampled first token takes one unit of the budget
            self.remaining[lane].fill_(req.max_new_tokens - 1)
        else:
            self.cache = insert_lane(self.cache, align_lane_to_clock(lane_cache, self.clock), lane)
        self.cur_tok[lane] = first[0]
        self.vision[lane] = vis[0]
        self._activate(lane, req)


class StreamingReportPipeline:
    """ingest -> preprocess and encode -> continuous decode.

    ``encode_fn(volume_raw, slope, intercept, spacing)`` -> the (d,) vision
    feature: the preprocess op and the vision trunk."""

    def __init__(self, encode_fn: Callable, batcher: ContinuousBatcher, tokenizer, prompt: str,
                 max_new_tokens: int = 256, prompt_len: int = 64):
        self.encode_fn = encode_fn
        self.batcher = batcher
        toks = tokenizer([prompt], max_length=prompt_len)
        self.prompt_ids = toks["input_ids"][0]
        self.prompt_mask = toks["attention_mask"][0]
        self.max_new_tokens = max_new_tokens
        self._next_id = 0
        # one prompt serves every scan: its KV is prefilled once, and each
        # admission is one fused-logits sample
        batcher.set_shared_prefix(self.prompt_ids, self.prompt_mask)

    def run_paths(self, paths, num_threads: int = 4, **defaults) -> dict[int, Result]:
        """Serve scans from their sources (DICOM series directories, NIfTI
        files, npz/npy volumes; ``data/ingest.py:load_scan``), decoded ahead
        on a thread pool (``scan_stream``)."""
        from ctpa_torch.data.ingest import scan_stream

        return self.run(scan_stream(paths, num_threads=num_threads, **defaults))

    def _admit(self, scan: dict) -> None:
        dev = self.batcher.device
        with torch.no_grad():
            vis = self.encode_fn(torch.as_tensor(np.asarray(scan["volume"]), device=dev),
                                 float(scan.get("slope", 1.0)), float(scan.get("intercept", 0.0)),
                                 tuple(float(s) for s in scan.get("spacing", (1.0, 1.0, 1.0))))
        rid = self._next_id
        self._next_id += 1
        self.batcher.submit(Request(request_id=rid, vision=vis,
                                    max_new_tokens=self.max_new_tokens))

    def run(self, scans: Iterator[dict]) -> dict[int, Result]:
        """``scans`` yield {volume, slope, intercept, spacing}.

        Admission first: a feeder thread drains the source into a bounded
        queue (backpressure: about two waves of raw volumes at most), the
        loop admits whenever a scan is ready and runs a chunk only when none
        is; with no work it blocks on the queue.  An ingest error is relayed
        through the queue and raised here.  A list or tuple is a burst that
        is all submitted before the first chunk."""
        import queue as queue_mod
        import threading

        if isinstance(scans, (list, tuple)):
            for scan in scans:
                self._admit(scan)
            return self.batcher.run_until_done()

        q: queue_mod.Queue = queue_mod.Queue(maxsize=max(2 * self.batcher.num_lanes, 4))
        end = object()

        def feed():
            try:
                for s in scans:
                    q.put(s)
            except BaseException as e:          # noqa: BLE001 - relayed, not handled
                q.put(e)
            finally:
                q.put(end)

        threading.Thread(target=feed, daemon=True).start()
        feeding = True
        while feeding:
            if self.batcher.has_work:
                try:
                    scan = q.get_nowait()
                except queue_mod.Empty:
                    self.batcher.step()          # nothing admissible: one chunk
                    continue
            else:
                scan = q.get()
            if scan is end:
                feeding = False
                continue
            if isinstance(scan, BaseException):
                raise scan
            self._admit(scan)
        return self.batcher.run_until_done()
