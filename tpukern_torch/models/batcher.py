"""Continuous batching: a slot scheduler over the paged serving path.

The port of tpukern/models/batcher.py's ContinuousBatcher and
SpeculativeBatcher: B_max slots share one paged KV pool; requests are
admitted into free slots mid-stream (a single-slot prefill writes the
new sequence's pages while the other slots keep their state), every step
decodes all slots in one batched paged-decode call, and finished
sequences (EOS or token budget) free their slot at once. Prompts are
padded to a bucket length, as in the JAX batcher.

- chunked_prefill=C admits a prompt longer than C in C-token chunks
  through verify_step (the paged prefix-prefill kernel), so admission
  memory is O(C), not O(prompt).
- prefix_cache=True aliases the full pages of the longest prompt prefix
  a resident slot shares (share_prefix) and scores only the rest; a slot
  whose pages an active slot still aliases is not recycled.
- greedy=False samples at `temperature`: through ops/sampling.py's
  sample (#27's thresholds, then #26) when top_k, top_p or min_p is set,
  else with torch.multinomial, as JAX's _sample dispatches. The seed of
  each sampling call is drawn on the host from np.random.default_rng(
  seed), where JAX draws a device scalar: reading one back would wait on
  the device every step.
- SpeculativeBatcher drafts gamma tokens per slot with a small model,
  scores each slot's gamma + 1 candidates in one batched verify_step and
  keeps the longest prefix the target agrees with (greedy: the streams
  equal ContinuousBatcher's), or, with greedy=False, accepts by
  rejection sampling on the host (models/speculative.py), so each slot's
  stream is distributed as target-only sampling.

- cache_dtype=torch.int8 or torch.float8_e4m3fn serves from the
  quantized KV tier (models/serving.py), through every admission path,
  greedy and sampled; SpeculativeBatcher's draft cache takes the
  target's tier. Each step passes decode_step JAX's length-aware
  pages_per_block (_pick_ppb, from a host mirror of the lengths), on
  which Config.pv_int8's function depends.

- ring=True serves from ring pools (serving.init_cache; Config.window
  required): a sequence may run to Config.max_seq tokens over pages that
  hold the window. As in JAX, the prefix cache and chunked admission
  refuse ring pools, and a prompt bucket must fit one lap of the ring
  (a padded prefill's tail would wrap over live slots); SpeculativeBatcher
  keeps its draft on a flat pool, whose writes clamp at its end.
- Params may be w8a16 (serving.quantize_model_weights), the target's
  and the draft's: the batchers only pass them on.

The batchers run on the device of their params, and their caches follow
them.

Not ported: the tensor-parallel batchers (ROADMAP.md queue 1 item 13).
"""

import dataclasses

import numpy as np
import torch

from tpukern_torch.models.serving import (_pages_per_block, decode_step,
                                          init_cache, prefill, rollback,
                                          share_prefix, verify_step)
from tpukern_torch.models.speculative import (SpecStats, _host_probs,
                                              rejection_accept)
from tpukern_torch.ops.sampling import sample


def _bucket(n, buckets, cap=None):
    """Padded prefill length for an n-token prompt: the smallest
    configured bucket that fits, else a power of two, capped by the page
    pool."""
    for b in buckets:
        if n <= b:
            return b
    b = 1 << max(int(n) - 1, 0).bit_length()
    if cap is not None:
        b = min(b, int(cap))
    if n <= b:
        return b
    raise ValueError(f"prompt length {n} exceeds the page pool ({cap})")


def _padded(tokens, n, device):
    """tokens zero-padded to n, as a (1, n) int32 tensor on device."""
    out = np.zeros(n, np.int32)
    out[:len(tokens)] = tokens
    return torch.from_numpy(out[None]).to(device)


class ContinuousBatcher:
    """Admit / step / collect loop over a fixed slot pool.

    >>> cb = ContinuousBatcher(params, cfg, n_slots=4, pages_per_seq=8)
    >>> cb.add_request("a", prompt_ids)       # any time a slot is free
    >>> cb.step()                             # one token for every slot
    >>> cb.finished                           # {request_id: [token, ...]}
    """

    def __init__(self, params, cfg, n_slots, pages_per_seq, page_size=128,
                 eos_id=None, max_new_tokens=64, prompt_buckets=(64, 128),
                 greedy=True, temperature=1.0, seed=0, top_k=0, top_p=1.0,
                 min_p=0.0, cache_dtype=torch.bfloat16,
                 chunked_prefill=None, ring=False, prefix_cache=False):
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0: {temperature}")
        if chunked_prefill is not None and chunked_prefill < 1:
            raise ValueError(f"chunked_prefill must be >= 1: "
                             f"{chunked_prefill}")
        if ring:
            # JAX's asserts (tpukern/models/batcher.py:84-104): a padded
            # prefill's tail or a chunk's padded tail would wrap over live
            # slots, and sharing pages with a wrapping slot is unsafe
            cap = pages_per_seq * page_size
            if prefix_cache:
                raise ValueError("the prefix cache needs flat pools")
            if chunked_prefill is not None:
                raise ValueError("chunked admission is not supported on "
                                 "ring pools")
            if max(prompt_buckets) > cap:
                raise ValueError(f"ring pool: prompt bucket "
                                 f"{max(prompt_buckets)} > ring capacity "
                                 f"{cap} would wrap padded prefill writes")
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.max_new = max_new_tokens
        self.buckets = tuple(sorted(prompt_buckets))
        self.device = params["embed"].device
        self.greedy = greedy
        self.temperature = temperature
        # the support of sampled decoding; all off: torch.multinomial over
        # the temperature-scaled distribution
        self.top_k, self.top_p, self.min_p = top_k, top_p, min_p
        self._seeds = np.random.default_rng(seed)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self.cache = init_cache(cfg, n_slots, pages_per_seq, page_size,
                                dtype=cache_dtype, device=self.device,
                                ring=ring)
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        # a ring bounds a sequence by the RoPE tables, not by its pages
        self.max_len = cfg.max_seq if ring else pages_per_seq * page_size
        self.chunk = chunked_prefill
        self.prefix_cache = prefix_cache
        self.slot_prompt = [None] * n_slots  # the prefix cache's prompts
        self.active = np.zeros(n_slots, bool)
        self.last_tok = np.zeros(n_slots, np.int32)
        self.n_generated = np.zeros(n_slots, np.int32)
        # host mirror of each slot's live tokens: the length-aware page
        # block of a step without a device readback
        self.host_len = np.zeros(n_slots, np.int64)
        self.slot_request = [None] * n_slots
        self.outputs = {}      # request_id -> [tokens so far]
        self.finished = {}     # request_id -> [tokens]

    def _pick_ppb(self, max_live):
        """JAX's length-aware page block: the largest that fits the
        longest live sequence (tpukern/models/batcher.py:138-143)."""
        return _pages_per_block(self.pages_per_seq,
                                -(-int(max_live) // self.page_size))

    def free_slots(self):
        idle = [i for i in range(self.n_slots) if not self.active[i]]
        if not self.prefix_cache:
            return idle
        # a slot is recyclable only if no active slot still aliases a page
        # it owns (identity allocator: page p belongs to slot p // pps)
        table = self.cache.page_table.cpu().numpy()
        owners = {int(p) // self.pages_per_seq
                  for j in range(self.n_slots) if self.active[j]
                  for p in table[j]}
        return [i for i in idle if i not in owners]

    def _view(self, cache, slot, start):
        """A single-sequence view of cache: slot's page-table row, and
        lengths [start]."""
        return dataclasses.replace(
            cache, page_table=cache.page_table[slot:slot + 1],
            lengths=torch.tensor([start], dtype=torch.int32,
                                 device=self.device))

    def _prefill_slot(self, tokens, true_len, slot, params=None, cfg=None,
                      cache=None):
        """Prefill one slot of cache (default: the target's) from a zero
        start; returns (vocab,) logits at the last true token."""
        cache = self.cache if cache is None else cache
        last = torch.tensor([true_len - 1], device=self.device)
        logits, _ = prefill(params or self.params, cfg or self.cfg, tokens,
                            self._view(cache, slot, 0), last_index=last)
        cache.lengths[slot] = true_len
        return logits[0]

    def _admit_tokens(self, tokens, slot, start):
        """Score tokens (a prompt's tail) into slot from position start, in
        chunks of self.chunk (default: one chunk of max(64, n)) padded to
        that length, through verify_step; the slot's length advances by
        each chunk's true tokens. Returns the logits of the last one."""
        C = self.chunk or max(64, len(tokens))
        logits = None
        for off in range(0, len(tokens), C):
            piece = tokens[off:off + C]
            out, _ = verify_step(self.params, self.cfg,
                                 _padded(piece, C, self.device),
                                 self._view(self.cache, slot, start))
            logits = out[0, len(piece) - 1]
            start += len(piece)
            self.cache.lengths[slot] = start
        return logits

    def _find_shared_prefix(self, prompt_ids, slot):
        """Longest common prompt prefix with any slot whose pages are still
        resident (active or not yet recycled): (src_slot, share_len), or
        (None, 0) below one page. share_len is capped at len(prompt) - 1,
        so admission always scores at least one token."""
        best, best_n = None, 0
        for j, pj in enumerate(self.slot_prompt):
            if j == slot or pj is None:
                continue
            n = min(len(pj), len(prompt_ids))
            eq = pj[:n] == prompt_ids[:n]
            common = n if eq.all() else int(np.argmin(eq))
            common = min(common, len(prompt_ids) - 1)
            if common > best_n:
                best, best_n = j, common
        return (best, best_n) if best_n >= self.page_size else (None, 0)

    def add_request(self, request_id, prompt_ids):
        """Admit a prompt into a free slot (raises if none free)."""
        slots = self.free_slots()
        if not slots:
            raise RuntimeError("no free slot")
        slot = slots[0]
        prompt_ids = np.asarray(prompt_ids, np.int32)
        true_len = len(prompt_ids)
        if true_len + self.max_new > self.max_len:
            raise ValueError(f"prompt of {true_len} + {self.max_new} new "
                             f"tokens exceeds the slot's {self.max_len}")
        src, share = None, 0
        if self.prefix_cache:
            src, share = self._find_shared_prefix(prompt_ids, slot)
            self.slot_prompt[slot] = prompt_ids
        if src is not None:
            self.cache = share_prefix(self.cache, src, [slot], share)
            logits = self._admit_tokens(prompt_ids[share:], slot, share)
        else:
            if self.prefix_cache:
                # a recycled row may still alias another slot's pages:
                # back to its own before this admission writes
                pps = self.pages_per_seq
                self.cache.page_table[slot] = torch.arange(
                    slot * pps, (slot + 1) * pps, dtype=torch.int32,
                    device=self.device)
            if self.chunk is not None and true_len > self.chunk:
                logits = self._admit_tokens(prompt_ids, slot, 0)
            else:
                bucket = _bucket(true_len, self.buckets, cap=self.max_len)
                logits = self._prefill_slot(
                    _padded(prompt_ids, bucket, self.device), true_len, slot)
        self.active[slot] = True
        self.n_generated[slot] = 0
        self.host_len[slot] = true_len
        self.slot_request[slot] = request_id
        self.outputs[request_id] = []
        self.last_tok[slot] = int(self._sample(logits[None])[0])
        return slot

    def _sample(self, logits):
        """(B,) int32 numpy tokens of logits (B, vocab): argmax, or a
        draw at the temperature (JAX's _sample, batcher.py:328-342)."""
        if self.greedy:
            return self._argmax(logits)
        if self.top_k or self.top_p < 1.0 or self.min_p > 0.0:
            tok = sample(logits, int(self._seeds.integers(0, 2**31 - 1)),
                         temperature=self.temperature, top_k=self.top_k,
                         top_p=self.top_p, min_p=self.min_p)
        else:
            probs = torch.softmax(logits.float() / self.temperature, -1)
            tok = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return tok.to(torch.int32).cpu().numpy()

    @staticmethod
    def _argmax(logits):
        return torch.argmax(logits, -1).to(torch.int32).cpu().numpy()

    def _emit(self, slot, tokens):
        """Append tokens to slot's request until EOS or the budget; frees
        the slot then. Returns (number emitted, whether it finished)."""
        rid = self.slot_request[slot]
        n = 0
        for tok in tokens:
            self.outputs[rid].append(int(tok))
            self.n_generated[slot] += 1
            n += 1
            if ((self.eos_id is not None and tok == self.eos_id)
                    or self.n_generated[slot] >= self.max_new):
                self.active[slot] = False
                self.finished[rid] = self.outputs.pop(rid)
                self.slot_request[slot] = None
                return n, True
        return n, False

    def step(self):
        """One decode step across all slots; collects tokens for active
        slots and frees slots that hit EOS or the token budget."""
        if not self.active.any():
            return 0
        # attention sees each slot's history and the token written now
        ppb = self._pick_ppb(self.host_len[self.active].max() + 1)
        logits, self.cache = decode_step(
            self.params, self.cfg,
            torch.from_numpy(self.last_tok).to(self.device), self.cache,
            active=torch.from_numpy(self.active).to(self.device),
            pages_per_block=ppb)
        self.host_len[self.active] += 1
        next_tok = self._sample(logits)
        n_emitted = 0
        for slot in np.flatnonzero(self.active):
            n, done = self._emit(slot, [self.last_tok[slot]])
            n_emitted += n
            if not done:
                self.last_tok[slot] = next_tok[slot]
        return n_emitted

    def run(self, requests, max_steps=10_000):
        """Drive a full workload: requests is [(id, prompt_ids), ...];
        admits whenever a slot frees up, steps until all finish."""
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self.free_slots():
                rid, prompt = pending.pop(0)
                self.add_request(rid, prompt)
            if not pending and not self.active.any():
                break
            self.step()
        return self.finished


class SpeculativeBatcher(ContinuousBatcher):
    """Continuous batching with batched speculative decoding.

    Every step: all active slots draft gamma tokens with the small model
    (gamma batched draft decode steps), the target scores every slot's
    gamma + 1 candidates in one batched verify_step (the paged prefix-
    prefill kernel), and each slot accepts a prefix of its drafts, so a
    slot emits 1 to gamma + 1 tokens per target pass. Greedy: the longest
    prefix equal to the target's greedy choices, so the streams equal
    target-only greedy decoding. greedy=False: the drafts are drawn from
    the draft's distributions at `temperature` and accepted by rejection
    sampling (models/speculative.py rejection_accept), all on the host
    from np.random.default_rng(accept_seed), as in JAX; each slot's
    emitted tokens are then distributed as target-only sampling.

    Cache discipline per round (both pools, per-slot lengths): n -> draft
    to n + gamma -> verify to n + gamma + 1 -> accept j -> both rolled back
    to n + j + 1 (full-accept slots first run one masked draft catch-up
    step for the last draft). `stats` counts the rounds (target passes)
    and the drafted and accepted tokens."""

    def __init__(self, params, cfg, draft_params, draft_cfg, n_slots,
                 pages_per_seq, gamma=4, page_size=128, accept_seed=0,
                 **kw):
        super().__init__(params, cfg, n_slots, pages_per_seq,
                         page_size=page_size, **kw)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.gamma = gamma
        self.stats = SpecStats()
        # the host generator of the sampled drafts and acceptance draws
        # (greedy rounds never touch it)
        self._accept_rng = np.random.default_rng(accept_seed)
        # the draft's cache in the target's tier (pool dtype, and scales),
        # on a flat pool even for a ring target, as in JAX: past its end
        # the draft's writes clamp (its proposals get worse, the target's
        # verification keeps the streams)
        self.dcache = init_cache(draft_cfg, n_slots, pages_per_seq,
                                 page_size, dtype=self.cache.k_pages.dtype,
                                 device=self.device)

    def add_request(self, request_id, prompt_ids):
        prompt_ids = np.asarray(prompt_ids, np.int32)
        if len(prompt_ids) + self.max_new + self.gamma + 1 > self.max_len:
            raise ValueError(f"prompt of {len(prompt_ids)} + {self.max_new} "
                             f"new + gamma+1 {self.gamma + 1} tokens exceeds "
                             f"the slot's {self.max_len}")
        slot = super().add_request(request_id, prompt_ids)
        # the draft's prefill of the same slot (its logits are unused: the
        # first proposal starts from the target's first token)
        bucket = _bucket(len(prompt_ids), self.buckets, cap=self.max_len)
        self._prefill_slot(_padded(prompt_ids, bucket, self.device),
                           len(prompt_ids), slot, self.draft_params,
                           self.draft_cfg, self.dcache)
        return slot

    def step(self):
        """One speculative round across all active slots; returns the
        number of tokens emitted."""
        if not self.active.any():
            return 0
        g = self.gamma
        act = torch.from_numpy(self.active).to(self.device)
        n_before = self.cache.lengths.cpu().numpy().astype(np.int64)
        # one page block for the round: up to n + gamma + 1 tokens
        ppb = self._pick_ppb(n_before[self.active].max() + g + 1)

        # 1. gamma batched draft decode steps (sampled: every slot draws
        # from its draft distribution, which the acceptance needs again)
        sampled = not self.greedy
        drafts = np.zeros((self.n_slots, g), np.int32)
        q_all = [None] * g
        cur = self.last_tok.copy()
        for i in range(g):
            dl, self.dcache = decode_step(
                self.draft_params, self.draft_cfg,
                torch.from_numpy(cur).to(self.device), self.dcache,
                active=act, pages_per_block=ppb)
            if sampled:
                q_all[i] = _host_probs(dl, self.temperature)
                cur = np.array([self._accept_rng.choice(q.shape[-1], p=q)
                                for q in q_all[i]], np.int32)
            else:
                cur = self._argmax(dl)
            drafts[:, i] = cur

        # 2. one batched target verification of gamma + 1 candidates
        cand = np.concatenate([self.last_tok[:, None], drafts], axis=1)
        vl, self.cache = verify_step(self.params, self.cfg,
                                     torch.from_numpy(cand).to(self.device),
                                     self.cache, pages_per_block=ppb)
        if sampled:
            p_all = _host_probs(vl, self.temperature)    # (B, g + 1, V)
            q_all = np.stack(q_all, axis=1)              # (B, g, V)
        else:
            greedy = self._argmax(vl)                    # (B, g + 1)
        self.stats.rounds += 1

        # 3. per-slot acceptance, emission, EOS and budget
        new_len = n_before.copy()      # inactive and finished slots
        full_accept = np.zeros(self.n_slots, bool)
        n_emitted = 0
        for slot in np.flatnonzero(self.active):
            if sampled:
                j, nxt = rejection_accept(drafts[slot], q_all[slot],
                                          p_all[slot], self._accept_rng)
            else:
                j = 0
                while j < g and drafts[slot, j] == greedy[slot, j]:
                    j += 1
                nxt = greedy[slot, j]
            full_accept[slot] = j == g
            self.stats.drafted += g
            self.stats.accepted += j
            n, done = self._emit(slot, [self.last_tok[slot],
                                        *drafts[slot, :j]])
            n_emitted += n
            if not done:
                self.last_tok[slot] = nxt
                new_len[slot] = n_before[slot] + j + 1

        # 4. target rollback to the accepted lengths
        self.cache = rollback(self.cache, new_len)

        # 5. the draft's catch-up for full-accept slots (it never saw the
        # last draft), then its rollback
        catch = full_accept & self.active
        if catch.any():
            _, self.dcache = decode_step(
                self.draft_params, self.draft_cfg,
                torch.from_numpy(drafts[:, -1].copy()).to(self.device),
                self.dcache, active=torch.from_numpy(catch).to(self.device),
                pages_per_block=ppb)
        self.dcache = rollback(self.dcache, new_len)
        return n_emitted
