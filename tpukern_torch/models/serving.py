"""Serving path: prefill + continuous decode over a paged KV cache.

The port of tpukern/models/serving.py for float pools: a paged KV pool per
layer, a prefill that runs the causal flash-attention kernel over the
prompt and writes K/V into pages, a decode step that runs the paged
decode kernel per layer, and a verify step that scores T new tokens per
sequence against the pages with the paged prefix-prefill kernel (chunked
prefill, prefix-cache admission, speculative verification). The
sliding window, attention sinks and logit softcap of Config reach all
three kernels. share_prefix aliases a prompt prefix's pages from one
slot into others, prefill_prefix prefills one slot, and rollback rewinds
the lengths. Norms and RoPE go through their kernels too; the
projections, the embedding lookup, the tanh-GELU MLP, the page writes
and the argmax are plain PyTorch, as the JAX path leaves them to XLA.

Unlike the JAX functions, which return new arrays, prefill, decode_step,
verify_step, share_prefix and prefill_prefix write the cache's pools
(and share_prefix its page table) in place and return the cache with
new lengths: a copy of the pools per step would cost more than the step.

init_cache builds its pools on the card unless the caller passes
device="cpu"; the other functions run on the device of their inputs (a
CPU tensor takes every kernel's plain version).

Not ported: the quantized (int8/fp8) pools, ring pools, MoE,
Config.pv_int8, make_tp_serving and quantize_model_weights (ROADMAP.md
queue 1 item 10).
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpukern_torch.models.transformer import Config
from tpukern_torch.ops.attention import flash_attention
from tpukern_torch.ops.paged_attention import (paged_attention,
                                               paged_prefill_attention)
from tpukern_torch.ops.rmsnorm import rms_norm
from tpukern_torch.ops.rope import make_cos_sin, rope_cached
from tpukern_torch.ops.sampling import sample

_TODO = "ROADMAP.md queue 1 item 10 (serving chain)"


@dataclasses.dataclass
class KVCache:
    k_pages: torch.Tensor     # (L, Hkv, P, page, D)
    v_pages: torch.Tensor     # (L, Hkv, P, page, D)
    page_table: torch.Tensor  # (B, pages_per_seq) int32 physical page ids
    lengths: torch.Tensor     # (B,) int32 live tokens per sequence
    # f32 (max_seq, D/2) RoPE tables, built once with the cache
    cos: torch.Tensor
    sin: torch.Tensor


def _check_cfg(cfg: Config):
    if cfg.n_experts or cfg.pv_int8:
        raise NotImplementedError(f"MoE or int8 serving: {_TODO}")


def init_cache(cfg: Config, batch, pages_per_seq, page_size=128,
               dtype=torch.bfloat16, device="cuda", ring=False):
    """Fixed page pool on `device` (the card unless the caller asks for
    "cpu"); sequence b owns physical pages
    [b*pages_per_seq, (b+1)*pages_per_seq) — the identity mapping a real
    allocator would replace (the kernel only sees the table)."""
    _check_cfg(cfg)
    if ring:
        raise NotImplementedError(f"ring pools: {_TODO}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{dtype} pools (quantized tier): {_TODO}")
    P = batch * pages_per_seq
    shape = (cfg.n_layers, cfg.n_kv_heads, P, page_size, cfg.head_dim)
    cos, sin = make_cos_sin(cfg.max_seq, cfg.head_dim, device=device)
    return KVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.arange(P, dtype=torch.int32, device=device
                                ).reshape(batch, pages_per_seq),
        lengths=torch.zeros(batch, dtype=torch.int32, device=device),
        cos=cos, sin=sin)


def _write_tokens(pages, layer, new, table, start):
    """Write new (B, Hkv, T, D) tokens into pages[layer] in place, at
    positions start[b] .. start[b]+T-1 of each sequence.

    Positions clamp at the pool's last slot, so a full sequence cannot
    write past its pages. The JAX version writes token by token and the
    last clamped token wins; here every clamped token writes that last
    token's value, so duplicate indices agree. An inactive slot's decode
    writes at its frozen length: a dead write, overwritten before the
    slot's length ever covers it."""
    B, Hkv, T, D = new.shape
    page_size = pages.shape[3]
    max_pos = table.shape[1] * page_size - 1
    t = torch.arange(T, device=new.device)
    want = start.long()[:, None] + t[None, :]                  # (B, T)
    pos = want.clamp(max=max_pos)
    if T > 1:
        src = torch.where(want >= max_pos, T - 1, t[None, :])
        new = new.gather(2, src[:, None, :, None].expand(B, Hkv, T, D))
    phys = table.long().gather(1, pos // page_size)
    pages[layer][:, phys, pos % page_size] = (
        new.permute(1, 0, 2, 3).to(pages.dtype))


def _rope_tables(cache: KVCache, positions, n_heads):
    """cos/sin rows for (B, n_heads, T) rows at positions (B, T): the
    layout of _layer_qkv's flattened heads. Positions past the tables
    clamp, as the JAX gather does."""
    B, T = positions.shape
    rows = positions.long().clamp(0, cache.cos.shape[0] - 1)
    rows = rows[:, None, :].expand(B, n_heads, T).reshape(-1)
    return cache.cos[rows], cache.sin[rows]


def _layer_qkv(h, lp, cfg: Config, rope_q, rope_k):
    """Project + rope one batch of hidden states h (B, T, d); rope_q and
    rope_k are the _rope_tables rows for the q and kv heads."""
    B, T, d = h.shape
    Dh, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h2 = h.reshape(B * T, d)
    q = (h2 @ lp["wq"]).reshape(B, T, Hq, Dh).transpose(1, 2)
    k = (h2 @ lp["wk"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    v = (h2 @ lp["wv"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    q = rope_cached(q.reshape(B * Hq * T, Dh), *rope_q).reshape(B, Hq, T, Dh)
    k = rope_cached(k.reshape(B * Hkv * T, Dh), *rope_k
                    ).reshape(B, Hkv, T, Dh)
    return q, k, v


def _mlp(h, lp):
    # jax.nn.gelu defaults to the tanh form; torch's default is erf
    return F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]


def prefill(params, cfg: Config, tokens, cache: KVCache, last_index=None):
    """Process a full prompt (B, T): causal flash attention over the
    prompt, K/V written into the cache pages, next-token logits (B, vocab)
    in f32. Returns (logits, cache with lengths advanced).

    last_index (B,) selects which position's hidden state feeds the
    logits (default T-1): continuous batching pads prompts to a bucket
    length and reads the logits at the true last token."""
    _check_cfg(cfg)
    B, T = tokens.shape
    h = F.embedding(tokens.long(), params["embed"])
    start = cache.lengths
    positions = start[:, None] + torch.arange(T, device=tokens.device)
    rope_q = _rope_tables(cache, positions, cfg.n_heads)
    rope_k = _rope_tables(cache, positions, cfg.n_kv_heads)
    for li, lp in enumerate(params["layers"]):
        hn = rms_norm(h.reshape(B * T, -1), lp["ln1"]).reshape(h.shape)
        q, k, v = _layer_qkv(hn, lp, cfg, rope_q, rope_k)
        o = flash_attention(q, k, v, causal=True, window=cfg.window,
                            sinks=cfg.sinks, softcap=cfg.softcap)
        o = o.transpose(1, 2).reshape(B * T, -1) @ lp["wo"]
        h = h + o.reshape(B, T, -1)
        hn = rms_norm(h.reshape(B * T, -1), lp["ln2"])
        h = h + _mlp(hn, lp).reshape(h.shape)
        _write_tokens(cache.k_pages, li, k, cache.page_table, start)
        _write_tokens(cache.v_pages, li, v, cache.page_table, start)
    if last_index is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(B, device=h.device), last_index.long()]
    hn = rms_norm(h_last, params["lnf"])
    logits = (hn @ params["head"]).float()
    n_new = T if last_index is None else last_index + 1
    lengths = (cache.lengths + n_new).to(torch.int32)
    return logits, dataclasses.replace(cache, lengths=lengths)


def decode_step(params, cfg: Config, last_tokens, cache: KVCache,
                active=None):
    """One continuous-batching decode step: last_tokens (B,) -> logits
    (B, vocab) in f32, through the paged decode kernel per layer. active
    (B,) bool masks which slots advance (inactive slots' lengths don't
    move; their page writes land at the frozen length, which stays dead)."""
    _check_cfg(cfg)
    B = last_tokens.shape[0]
    h = F.embedding(last_tokens.long(), params["embed"])[:, None, :]
    positions = cache.lengths[:, None]
    rope_q = _rope_tables(cache, positions, cfg.n_heads)
    rope_k = _rope_tables(cache, positions, cfg.n_kv_heads)
    # attention sees each slot's history + the token written this step
    attn_len = cache.lengths + 1
    for li, lp in enumerate(params["layers"]):
        hn = rms_norm(h.reshape(B, -1), lp["ln1"]).reshape(h.shape)
        q, k, v = _layer_qkv(hn, lp, cfg, rope_q, rope_k)
        _write_tokens(cache.k_pages, li, k, cache.page_table, cache.lengths)
        _write_tokens(cache.v_pages, li, v, cache.page_table, cache.lengths)
        o = paged_attention(q[:, :, 0], cache.k_pages[li], cache.v_pages[li],
                            attn_len, cache.page_table, window=cfg.window,
                            sinks=cfg.sinks, softcap=cfg.softcap)
        h = h + (o.reshape(B, -1) @ lp["wo"]).reshape(h.shape)
        hn = rms_norm(h.reshape(B, -1), lp["ln2"])
        h = h + _mlp(hn, lp).reshape(h.shape)
    hn = rms_norm(h[:, 0], params["lnf"])
    logits = (hn @ params["head"]).float()
    adv = 1 if active is None else active.to(torch.int32)
    lengths = (cache.lengths + adv).to(torch.int32)
    return logits, dataclasses.replace(cache, lengths=lengths)


def verify_step(params, cfg: Config, tokens, cache: KVCache,
                pages_per_block=None):
    """Score T tokens (B, T) in one pass against the paged cache: each
    layer writes their K/V into the pages at lengths[b] .. lengths[b]+T-1,
    then runs the paged prefix-prefill kernel (token t sees the cached
    prefix and the new tokens up to t). Returns f32 logits at every
    position (B, T, vocab) and the cache with lengths + T: the
    speculative verification step and the chunked-prefill continuation.
    pages_per_block is accepted and ignored, as in paged_attention."""
    _check_cfg(cfg)
    B, T = tokens.shape
    h = F.embedding(tokens.long(), params["embed"])
    start = cache.lengths
    positions = start[:, None] + torch.arange(T, device=tokens.device)
    rope_q = _rope_tables(cache, positions, cfg.n_heads)
    rope_k = _rope_tables(cache, positions, cfg.n_kv_heads)
    attn_len = start + T
    for li, lp in enumerate(params["layers"]):
        hn = rms_norm(h.reshape(B * T, -1), lp["ln1"]).reshape(h.shape)
        q, k, v = _layer_qkv(hn, lp, cfg, rope_q, rope_k)
        _write_tokens(cache.k_pages, li, k, cache.page_table, start)
        _write_tokens(cache.v_pages, li, v, cache.page_table, start)
        o = paged_prefill_attention(q, cache.k_pages[li], cache.v_pages[li],
                                    attn_len, cache.page_table,
                                    pages_per_block=pages_per_block,
                                    window=cfg.window, sinks=cfg.sinks,
                                    softcap=cfg.softcap)
        o = o.transpose(1, 2).reshape(B * T, -1) @ lp["wo"]
        h = h + o.reshape(B, T, -1)
        hn = rms_norm(h.reshape(B * T, -1), lp["ln2"])
        h = h + _mlp(hn, lp).reshape(h.shape)
    hn = rms_norm(h.reshape(B * T, -1), params["lnf"])
    logits = (hn @ params["head"]).float().reshape(B, T, -1)
    lengths = attn_len.to(torch.int32)
    return logits, dataclasses.replace(cache, lengths=lengths)


def share_prefix(cache: KVCache, src_slot, dst_slots, prefix_len):
    """Prefix caching: alias src_slot's first prefix_len positions into
    each dst slot. Each dst row of the page table is first reset to the
    slot's own (identity) pages, a recycled slot may still hold aliases;
    then its first prefix_len // page entries point at src's pages, which
    dst only reads (serving writes at positions >= length), and the
    partial page's prefix_len % page rows are copied into dst's own page
    in every layer. Writes the table and pools in place; returns the
    cache with dst lengths set to prefix_len. Host ints throughout."""
    if src_slot in dst_slots:
        raise ValueError(f"src slot {src_slot} is among dst {dst_slots}")
    page = cache.k_pages.shape[3]
    pps = cache.page_table.shape[1]
    full, rem = divmod(int(prefix_len), page)
    table = cache.page_table
    lengths = cache.lengths.clone()
    for d in dst_slots:
        table[d] = torch.arange(d * pps, (d + 1) * pps, dtype=table.dtype,
                                device=table.device)
        table[d, :full] = table[src_slot, :full]
        if rem:
            sp, dp = int(table[src_slot, full]), d * pps + full
            for pages in (cache.k_pages, cache.v_pages):
                pages[:, :, dp, :rem] = pages[:, :, sp, :rem]
        lengths[d] = prefix_len
    return dataclasses.replace(cache, lengths=lengths)


def prefill_prefix(params, cfg: Config, prompt, cache: KVCache, slot=0):
    """Prefill one slot's prompt (T,) on a single-slot view of the shared
    cache (its page-table row and a zero start), the producer half of
    share_prefix. Returns ((vocab,) logits, cache with lengths[slot] =
    T)."""
    view = dataclasses.replace(
        cache, page_table=cache.page_table[slot:slot + 1],
        lengths=torch.zeros(1, dtype=torch.int32, device=prompt.device))
    logits, _ = prefill(params, cfg, prompt[None], view)
    lengths = cache.lengths.clone()
    lengths[slot] = prompt.shape[0]
    return logits[0], dataclasses.replace(cache, lengths=lengths)


def rollback(cache: KVCache, new_lengths):
    """Rewind the cache to new_lengths (B,): positions past them are dead
    (the kernels mask them, and later writes overwrite them)."""
    lengths = torch.as_tensor(new_lengths, dtype=torch.int32)
    return dataclasses.replace(cache, lengths=lengths.to(cache.lengths.device))


def generate(params, cfg: Config, prompt, n_steps, pages_per_seq=8,
             page_size=128, greedy=True, seed=0, temperature=1.0, top_k=0,
             top_p=1.0, min_p=0.0, cache_dtype=torch.bfloat16):
    """Prefill the prompt (B, T), then decode n_steps tokens, greedily or
    sampled. Returns (B, n_steps) int32 token ids; the first is the
    prefill's argmax, as in JAX.

    Sampled (greedy=False): with top_k, top_p or min_p set, or a
    temperature other than 1, each step runs ops/sampling.py's sample
    (#27's thresholds, then #26) with a seed drawn on the host from
    np.random.default_rng(seed), so no step waits on the device;
    otherwise torch.multinomial draws from softmax(logits) with a
    torch.Generator on the prompt's device seeded with `seed`."""
    B = prompt.shape[0]
    cache = init_cache(cfg, B, pages_per_seq, page_size, dtype=cache_dtype,
                       device=prompt.device)
    logits, cache = prefill(params, cfg, prompt, cache)
    restricted = top_k or top_p < 1.0 or min_p > 0.0 or temperature != 1.0
    seeds = np.random.default_rng(seed)
    generator = torch.Generator(prompt.device).manual_seed(seed)

    def pick(logits):
        if greedy:
            return torch.argmax(logits, -1).to(torch.int32)
        if restricted:
            return sample(logits, int(seeds.integers(0, 2**31 - 1)),
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          min_p=min_p)
        return torch.multinomial(torch.softmax(logits, -1), 1,
                                 generator=generator)[:, 0].to(torch.int32)

    tok = torch.argmax(logits, -1).to(torch.int32)
    outs = []
    for _ in range(n_steps):
        outs.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = pick(logits)
    return torch.stack(outs, dim=1)
