"""Continuous batching: a slot scheduler over the paged serving path.

The port of tpukern/models/batcher.py's ContinuousBatcher with greedy
decoding: B_max slots share one paged KV pool; requests are admitted into
free slots mid-stream (a single-slot prefill writes the new sequence's
pages while the other slots keep their state), every step decodes all
slots in one batched paged-decode call, and finished sequences (EOS or
token budget) free their slot at once. Prompts are padded to a bucket
length, as in the JAX batcher.

The batcher runs on the device of its params, and its cache follows
them.

Not ported: chunked prefill, the prefix cache, ring pools, int8 pools,
sampled decoding (kernels #26/#27), and the speculative and tensor-
parallel batchers (ROADMAP.md queue 1 item 10).
"""

import dataclasses

import numpy as np
import torch

from tpukern_torch.models.serving import decode_step, init_cache, prefill

_TODO = "ROADMAP.md queue 1 item 10 (serving chain)"


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


class ContinuousBatcher:
    """Admit / step / collect loop over a fixed slot pool.

    >>> cb = ContinuousBatcher(params, cfg, n_slots=4, pages_per_seq=8)
    >>> cb.add_request("a", prompt_ids)       # any time a slot is free
    >>> cb.step()                             # one token for every slot
    >>> cb.finished                           # {request_id: [token, ...]}
    """

    def __init__(self, params, cfg, n_slots, pages_per_seq, page_size=128,
                 eos_id=None, max_new_tokens=64, prompt_buckets=(64, 128),
                 greedy=True, cache_dtype=torch.bfloat16,
                 chunked_prefill=None, ring=False, prefix_cache=False):
        for name, on in dict(greedy=not greedy,
                             chunked_prefill=chunked_prefill is not None,
                             ring=ring, prefix_cache=prefix_cache).items():
            if on:
                raise NotImplementedError(f"ContinuousBatcher({name}=...): "
                                          f"{_TODO}")
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.max_new = max_new_tokens
        self.buckets = tuple(sorted(prompt_buckets))
        self.device = params["embed"].device
        self.cache = init_cache(cfg, n_slots, pages_per_seq, page_size,
                                dtype=cache_dtype, device=self.device)
        self.max_len = pages_per_seq * page_size
        self.active = np.zeros(n_slots, bool)
        self.last_tok = np.zeros(n_slots, np.int32)
        self.n_generated = np.zeros(n_slots, np.int32)
        self.slot_request = [None] * n_slots
        self.outputs = {}      # request_id -> [tokens so far]
        self.finished = {}     # request_id -> [tokens]

    def free_slots(self):
        return [i for i in range(self.n_slots) if not self.active[i]]

    def _prefill_slot(self, tokens, true_len, slot):
        """Prefill one slot on a single-sequence view of the shared cache
        (its page-table row and a zero start); returns (vocab,) logits."""
        view = dataclasses.replace(
            self.cache, page_table=self.cache.page_table[slot:slot + 1],
            lengths=torch.zeros(1, dtype=torch.int32, device=self.device))
        last = torch.tensor([true_len - 1], device=self.device)
        logits, _ = prefill(self.params, self.cfg, tokens, view,
                            last_index=last)
        self.cache.lengths[slot] = true_len
        return logits[0]

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
        bucket = _bucket(true_len, self.buckets, cap=self.max_len)
        padded = np.zeros(bucket, np.int32)
        padded[:true_len] = prompt_ids
        logits = self._prefill_slot(
            torch.from_numpy(padded[None]).to(self.device), true_len, slot)
        self.active[slot] = True
        self.n_generated[slot] = 0
        self.slot_request[slot] = request_id
        self.outputs[request_id] = []
        self.last_tok[slot] = int(self._sample(logits[None])[0])
        return slot

    def _sample(self, logits):
        return torch.argmax(logits, -1).to(torch.int32).cpu().numpy()

    def step(self):
        """One decode step across all slots; collects tokens for active
        slots and frees slots that hit EOS or the token budget."""
        if not self.active.any():
            return 0
        logits, self.cache = decode_step(
            self.params, self.cfg,
            torch.from_numpy(self.last_tok).to(self.device), self.cache,
            active=torch.from_numpy(self.active).to(self.device))
        next_tok = self._sample(logits)
        n_emitted = 0
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            tok = int(self.last_tok[slot])
            rid = self.slot_request[slot]
            self.outputs[rid].append(tok)
            self.n_generated[slot] += 1
            n_emitted += 1
            done = ((self.eos_id is not None and tok == self.eos_id)
                    or self.n_generated[slot] >= self.max_new)
            if done:
                self.active[slot] = False
                self.finished[rid] = self.outputs.pop(rid)
                self.slot_request[slot] = None
            else:
                self.last_tok[slot] = int(next_tok[slot])
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
