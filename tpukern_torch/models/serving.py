"""Serving path: prefill + continuous decode over a paged KV cache.

The port of tpukern/models/serving.py: a paged KV pool per layer, a
prefill that runs the causal flash-attention kernel over the prompt and
writes K/V into pages, a decode step that runs the paged
decode kernel per layer, and a verify step that scores T new tokens per
sequence against the pages with the paged prefix-prefill kernel (chunked
prefill, prefix-cache admission, speculative verification). The
sliding window, attention sinks and logit softcap of Config reach all
three kernels. share_prefix aliases a prompt prefix's pages from one
slot into others, prefill_prefix prefills one slot, and rollback rewinds
the lengths. Norms and RoPE go through their kernels too; the
projections of float weights, the embedding lookup, the tanh-GELU MLP,
the page scatter and the argmax are plain PyTorch, as the JAX path leaves
them to XLA.

The quantized tier: init_cache(dtype=torch.int8 or torch.float8_e4m3fn)
builds 1-byte pools with per-token f32 scale pools; every new K/V token
is row-quantized as it is written (ops/quant.py write_kv_quantized: #20
/ #22 on the card, one launch a layer for K and V: JAX's quantize_ref /
quantize_fp8_ref and scatter), and decode_step
and verify_step attend with the quantized paged kernels: on int8 pools
always with the int8 score dot (q_int8), and with Config.pv_int8 also
the int8 P V dot. Prefill attends over the unquantized K/V, so the first
token equals the float tiers'.

Ring pools: init_cache(ring=True) (Config.window required) makes each
sequence's pages a rolling buffer, as JAX's: a token at position p lives
in slot p for p < sinks, else in slot sinks + (p - sinks) mod (ring_tokens
- sinks), so a sequence can run past its pages with memory bounded by the
window; the paged kernels recover each slot's position from the length.

The w8a16 tier: quantize_model_weights turns every projection and the LM
head into an int8 {"q", "s"} pair, and _wmm sends each such product
through ops/matmul_w8a16.py (#25 on the card at M <= 128 rows, JAX's
dequant-then-dot above).

Unlike the JAX functions, which return new arrays, prefill, decode_step,
verify_step, share_prefix and prefill_prefix write the cache's pools
(and share_prefix its page table) in place and return the cache with
new lengths: a copy of the pools per step would cost more than the step.

init_cache builds its pools on the card unless the caller passes
device="cpu"; the other functions run on the device of their inputs (a
CPU tensor takes every kernel's plain version).

Not ported: make_tp_serving (ROADMAP.md queue 1 item 13). MoE serving
raises NotImplementedError: the JAX package's serving has no MoE path
(its layers read w1/w2 only); MoE runs in training (models/moe.py).
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpukern_torch.models.transformer import Config
from tpukern_torch.ops.attention import flash_attention
from tpukern_torch.ops.matmul_w8a16 import matmul_w8a16, quantize_weights
from tpukern_torch.ops.paged_attention import (
    QUANT_DTYPES, paged_attention, paged_attention_quantized,
    paged_prefill_attention, paged_prefill_attention_quantized)
from tpukern_torch.ops.quant import scatter_slots as _scatter
from tpukern_torch.ops.quant import write_kv_quantized
# the plain quantized write under the name of JAX's function
from tpukern_torch.ops.quant import (  # noqa: F401
    write_tokens_quantized_ref as _write_tokens_quantized)
from tpukern_torch.ops.rmsnorm import rms_norm
from tpukern_torch.ops.rope import make_cos_sin, rope_cached
from tpukern_torch.ops.sampling import sample

_TODO = ("the JAX package's serving has no MoE path (ROADMAP.md queue 1 "
         "item 11: MoE is a training slice)")
# the layer weights quantize_model_weights turns into w8a16 pairs (and
# the head)
W8A16_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")


@dataclasses.dataclass
class KVCache:
    k_pages: torch.Tensor     # (L, Hkv, P, page, D)
    v_pages: torch.Tensor     # (L, Hkv, P, page, D)
    page_table: torch.Tensor  # (B, pages_per_seq) int32 physical page ids
    lengths: torch.Tensor     # (B,) int32 live tokens per sequence
    # f32 (max_seq, D/2) RoPE tables, built once with the cache
    cos: torch.Tensor
    sin: torch.Tensor
    # the quantized tier (int8 or float8_e4m3fn pools): per-token scales
    # (L, Hkv, P, page) f32; None for float pools
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None
    # a rolling buffer (init_cache(ring=True)): writes wrap at ring_tokens
    ring: bool = False

    @property
    def quantized(self):
        return self.k_scales is not None

    @property
    def ring_tokens(self):
        return self.page_table.shape[1] * self.k_pages.shape[3]


def _check_cfg(cfg: Config):
    if cfg.n_experts:
        raise NotImplementedError(f"MoE serving: {_TODO}")


def init_cache(cfg: Config, batch, pages_per_seq, page_size=128,
               dtype=torch.bfloat16, device="cuda", ring=False):
    """Fixed page pool on `device` (the card unless the caller asks for
    "cpu"); sequence b owns physical pages
    [b*pages_per_seq, (b+1)*pages_per_seq) — the identity mapping a real
    allocator would replace (the kernel only sees the table).

    dtype bf16 or f32 gives float pools; torch.int8 or
    torch.float8_e4m3fn the quantized tier: 1-byte pools and f32 scale
    pools, half the bytes of bf16 pools a token. Config.pv_int8 needs
    int8 pools (ValueError otherwise, as in JAX).

    ring=True makes each sequence's pages a rolling buffer of
    pages_per_seq * page_size tokens (the module docstring): it needs
    Config.window and a capacity of at least window + sinks (ValueError
    otherwise, where JAX asserts); size it at window + the longest verify
    or chunk T."""
    _check_cfg(cfg)
    if ring:
        if cfg.window is None:
            raise ValueError("a ring cache requires Config.window")
        need = cfg.window + int(cfg.sinks or 0)
        if need > pages_per_seq * page_size:
            raise ValueError(f"ring capacity {pages_per_seq * page_size} < "
                             f"window + sinks {need}")
    if dtype not in (torch.bfloat16, torch.float32, *QUANT_DTYPES):
        raise TypeError(f"pools are bf16, f32, int8 or float8_e4m3fn, got "
                        f"{dtype}")
    if cfg.pv_int8 and dtype != torch.int8:
        raise ValueError(f"Config.pv_int8=True requires an int8 KV cache, "
                         f"got dtype={dtype}")
    P = batch * pages_per_seq
    shape = (cfg.n_layers, cfg.n_kv_heads, P, page_size, cfg.head_dim)
    cos, sin = make_cos_sin(cfg.max_seq, cfg.head_dim, device=device)
    quant = dtype in QUANT_DTYPES
    return KVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.arange(P, dtype=torch.int32, device=device
                                ).reshape(batch, pages_per_seq),
        lengths=torch.zeros(batch, dtype=torch.int32, device=device),
        cos=cos, sin=sin,
        k_scales=(torch.zeros(shape[:4], dtype=torch.float32, device=device)
                  if quant else None),
        v_scales=(torch.zeros(shape[:4], dtype=torch.float32, device=device)
                  if quant else None),
        ring=ring)


def _pages_per_block(pages_per_seq, max_live_pages=None):
    """JAX's page-block pick (tpukern/models/serving.py:123-138): the
    largest of 8, 4, 2, 1 pages that divides pages_per_seq and, with a
    max_live_pages hint, fits the live range. The CUDA kernels need no
    page DMA batch; the pick matters for pv_int8, whose p is quantized
    per block of page * pages_per_block tokens."""
    cands = [d for d in (8, 4, 2, 1) if pages_per_seq % d == 0]
    if max_live_pages is not None:
        fit = [d for d in cands if d <= max(int(max_live_pages), 1)]
        if fit:
            return fit[0]
    return cands[0]


def _slots(table, start, T, page_size, ring=False, sinks=0):
    """Where T new tokens a sequence go: (physical page, row) (B, T) for
    positions start[b] .. start[b]+T-1, and the source token of each
    (None where every token has a slot of its own). One step computes
    them once for all its layers.

    Flat pools clamp positions at the pool's last slot, so a full
    sequence cannot write past its pages; the JAX version writes token by
    token and the last clamped token wins, so here every clamped token
    writes that last token's value (its source token is T - 1). Ring
    pools wrap: position p goes to slot p below `sinks`, else to sinks +
    (p - sinks) mod R with R = ring_tokens - sinks; a write of more than R
    tokens gives a slot several, and it takes the newest, as JAX's token
    by token writes leave it. Either way duplicate indices write equal
    values (PyTorch's scatter has no defined order for them). An inactive
    slot's decode writes at its frozen length: a dead write, overwritten
    before the slot's length ever covers it (on a ring it lands on the
    slot of position length - R, outside the window)."""
    cap = table.shape[1] * page_size
    t = torch.arange(T, device=table.device)
    want = start.long()[:, None] + t[None, :]                  # (B, T)
    if ring:
        R = cap - sinks
        wraps = want >= sinks
        pos = torch.where(wraps, sinks + (want - sinks) % R, want)
        src = (torch.where(wraps, t + R * ((T - 1 - t) // R), t)
               if T > R else None)
    else:
        pos = want.clamp(max=cap - 1)
        src = torch.where(want >= cap - 1, T - 1, t) if T > 1 else None
    phys = table.long().gather(1, pos // page_size)
    return phys, pos % page_size, src


def _write_tokens(pages, layer, new, table, start, ring=False, sinks=0):
    """Write new (B, Hkv, T, D) tokens into pages[layer] in place, at
    positions start[b] .. start[b]+T-1 of each sequence (_slots)."""
    _scatter(pages, layer, new, _slots(table, start, new.shape[2],
                                       pages.shape[3], ring, sinks))


def _write_kv(cache: KVCache, layer, k, v, slots):
    """Write one layer's new K/V tokens through the cache's tier, at the
    step's _slots: on the quantized tier one write_kv_quantized for both."""
    if cache.quantized:
        write_kv_quantized(k, v, cache.k_pages, cache.k_scales,
                           cache.v_pages, cache.v_scales, layer, slots)
    else:
        _scatter(cache.k_pages, layer, k, slots)
        _scatter(cache.v_pages, layer, v, slots)


def _quant_flags(cfg: Config, cache: KVCache):
    """JAX's flags of the quantized kernels: the int8 score dot on int8 K,
    the int8 P V dot with Config.pv_int8 on int8 V."""
    return dict(q_int8=cache.k_pages.dtype == torch.int8,
                pv_int8=bool(cfg.pv_int8)
                and cache.v_pages.dtype == torch.int8)


def _step_slots(cfg: Config, cache: KVCache, start, T):
    """_slots of a step of T tokens from start, in the cache's layout."""
    return _slots(cache.page_table, start, T, cache.k_pages.shape[3],
                  cache.ring, int(cfg.sinks or 0))


def _attn_features(cfg: Config, cache: KVCache):
    """The paged kernels' mask options of cfg on this cache."""
    return dict(window=cfg.window, sinks=cfg.sinks, softcap=cfg.softcap,
                ring=cache.ring)


def quantize_model_weights(params):
    """The weight-only int8 (w8a16) serving tier, as JAX's: wq, wk, wv,
    wo, w1, w2 of every layer and the LM head become {"q": int8, "s": f32
    per column} (quantize_weights), which every serving step sends through
    matmul_w8a16: half the weight bytes of bf16 per decode step. The
    embedding and the norm gains stay as they are. Runs on the params'
    device. Serving-only: forward and the train step refuse such params."""
    def q(w):
        qq, s = quantize_weights(w)
        return {"q": qq, "s": s}

    out = dict(params)
    out["head"] = q(params["head"])
    out["layers"] = [
        {k: (q(v) if k in W8A16_WEIGHTS else v) for k, v in lp.items()}
        for lp in params["layers"]]
    return out


def _wmm(h2, w):
    """h2 @ w for a float weight, or matmul_w8a16 for a w8a16 pair."""
    if isinstance(w, dict):
        return matmul_w8a16(h2, w["q"], w["s"])
    return h2 @ w


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
    q = _wmm(h2, lp["wq"]).reshape(B, T, Hq, Dh).transpose(1, 2)
    k = _wmm(h2, lp["wk"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    v = _wmm(h2, lp["wv"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    q = rope_cached(q.reshape(B * Hq * T, Dh), *rope_q).reshape(B, Hq, T, Dh)
    k = rope_cached(k.reshape(B * Hkv * T, Dh), *rope_k
                    ).reshape(B, Hkv, T, Dh)
    return q, k, v


def _mlp(h, lp):
    # jax.nn.gelu defaults to the tanh form; torch's default is erf
    return _wmm(F.gelu(_wmm(h, lp["w1"]), approximate="tanh"), lp["w2"])


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
    slots = _step_slots(cfg, cache, start, T)
    for li, lp in enumerate(params["layers"]):
        hn = rms_norm(h.reshape(B * T, -1), lp["ln1"]).reshape(h.shape)
        q, k, v = _layer_qkv(hn, lp, cfg, rope_q, rope_k)
        o = flash_attention(q, k, v, causal=True, window=cfg.window,
                            sinks=cfg.sinks, softcap=cfg.softcap)
        o = _wmm(o.transpose(1, 2).reshape(B * T, -1), lp["wo"])
        h = h + o.reshape(B, T, -1)
        hn = rms_norm(h.reshape(B * T, -1), lp["ln2"])
        h = h + _mlp(hn, lp).reshape(h.shape)
        _write_kv(cache, li, k, v, slots)
    if last_index is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(B, device=h.device), last_index.long()]
    hn = rms_norm(h_last, params["lnf"])
    logits = _wmm(hn, params["head"]).float()
    n_new = T if last_index is None else last_index + 1
    lengths = (cache.lengths + n_new).to(torch.int32)
    return logits, dataclasses.replace(cache, lengths=lengths)


def decode_step(params, cfg: Config, last_tokens, cache: KVCache,
                active=None, pages_per_block=None):
    """One continuous-batching decode step: last_tokens (B,) -> logits
    (B, vocab) in f32, through the paged decode kernel per layer. active
    (B,) bool masks which slots advance (inactive slots' lengths don't
    move; their page writes land at the frozen length, which stays dead).
    pages_per_block overrides _pages_per_block(pages_per_seq), as the
    batchers' length-aware pick does; only pv_int8 depends on it."""
    _check_cfg(cfg)
    ppb = pages_per_block or _pages_per_block(cache.page_table.shape[1])
    B = last_tokens.shape[0]
    h = F.embedding(last_tokens.long(), params["embed"])[:, None, :]
    positions = cache.lengths[:, None]
    rope_q = _rope_tables(cache, positions, cfg.n_heads)
    rope_k = _rope_tables(cache, positions, cfg.n_kv_heads)
    slots = _step_slots(cfg, cache, cache.lengths, 1)
    # attention sees each slot's history + the token written this step
    attn_len = cache.lengths + 1
    for li, lp in enumerate(params["layers"]):
        hn = rms_norm(h.reshape(B, -1), lp["ln1"]).reshape(h.shape)
        q, k, v = _layer_qkv(hn, lp, cfg, rope_q, rope_k)
        _write_kv(cache, li, k, v, slots)
        feat = _attn_features(cfg, cache)
        if cache.quantized:
            o = paged_attention_quantized(
                q[:, :, 0], cache.k_pages[li], cache.k_scales[li],
                cache.v_pages[li], cache.v_scales[li], attn_len,
                cache.page_table, pages_per_block=ppb,
                **_quant_flags(cfg, cache), **feat)
        else:
            o = paged_attention(q[:, :, 0], cache.k_pages[li],
                                cache.v_pages[li], attn_len,
                                cache.page_table, **feat)
        h = h + _wmm(o.reshape(B, -1), lp["wo"]).reshape(h.shape)
        hn = rms_norm(h.reshape(B, -1), lp["ln2"])
        h = h + _mlp(hn, lp).reshape(h.shape)
    hn = rms_norm(h[:, 0], params["lnf"])
    logits = _wmm(hn, params["head"]).float()
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
    pages_per_block as in decode_step."""
    _check_cfg(cfg)
    ppb = pages_per_block or _pages_per_block(cache.page_table.shape[1])
    B, T = tokens.shape
    h = F.embedding(tokens.long(), params["embed"])
    start = cache.lengths
    positions = start[:, None] + torch.arange(T, device=tokens.device)
    rope_q = _rope_tables(cache, positions, cfg.n_heads)
    rope_k = _rope_tables(cache, positions, cfg.n_kv_heads)
    slots = _step_slots(cfg, cache, start, T)
    attn_len = start + T
    for li, lp in enumerate(params["layers"]):
        hn = rms_norm(h.reshape(B * T, -1), lp["ln1"]).reshape(h.shape)
        q, k, v = _layer_qkv(hn, lp, cfg, rope_q, rope_k)
        _write_kv(cache, li, k, v, slots)
        feat = _attn_features(cfg, cache)
        if cache.quantized:
            o = paged_prefill_attention_quantized(
                q, cache.k_pages[li], cache.k_scales[li], cache.v_pages[li],
                cache.v_scales[li], attn_len, cache.page_table,
                pages_per_block=ppb, **_quant_flags(cfg, cache), **feat)
        else:
            o = paged_prefill_attention(q, cache.k_pages[li],
                                        cache.v_pages[li], attn_len,
                                        cache.page_table, **feat)
        o = _wmm(o.transpose(1, 2).reshape(B * T, -1), lp["wo"])
        h = h + o.reshape(B, T, -1)
        hn = rms_norm(h.reshape(B * T, -1), lp["ln2"])
        h = h + _mlp(hn, lp).reshape(h.shape)
    hn = rms_norm(h.reshape(B * T, -1), params["lnf"])
    logits = _wmm(hn, params["head"]).float().reshape(B, T, -1)
    lengths = attn_len.to(torch.int32)
    return logits, dataclasses.replace(cache, lengths=lengths)


def share_prefix(cache: KVCache, src_slot, dst_slots, prefix_len):
    """Prefix caching: alias src_slot's first prefix_len positions into
    each dst slot. Each dst row of the page table is first reset to the
    slot's own (identity) pages, a recycled slot may still hold aliases;
    then its first prefix_len // page entries point at src's pages, which
    dst only reads (serving writes at positions >= length), and the
    partial page's prefix_len % page rows are copied into dst's own page
    in every layer (with its scales on the quantized tier). Writes the
    table and pools in place; returns the cache with dst lengths set to
    prefix_len. Host ints throughout. Ring pools raise ValueError (a wrap
    would overwrite shared pages), as JAX asserts."""
    if cache.ring:
        raise ValueError("prefix sharing needs a non-ring pool")
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
            for pool in (cache.k_pages, cache.v_pages, cache.k_scales,
                         cache.v_scales):
                if pool is not None:
                    pool[:, :, dp, :rem] = pool[:, :, sp, :rem]
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
             top_p=1.0, min_p=0.0, cache_dtype=torch.bfloat16, ring=False):
    """Prefill the prompt (B, T), then decode n_steps tokens, greedily or
    sampled. Returns (B, n_steps) int32 token ids; the first is the
    prefill's argmax, as in JAX.

    Sampled (greedy=False): with top_k, top_p or min_p set, or a
    temperature other than 1, each step runs ops/sampling.py's sample
    (#27's thresholds, then #26) with a seed drawn on the host from
    np.random.default_rng(seed), so no step waits on the device;
    otherwise torch.multinomial draws from softmax(logits) with a
    torch.Generator on the prompt's device seeded with `seed`.
    cache_dtype=torch.int8 or torch.float8_e4m3fn serves from the
    quantized tier; ring=True from ring pools (init_cache)."""
    B = prompt.shape[0]
    cache = init_cache(cfg, B, pages_per_seq, page_size, dtype=cache_dtype,
                       device=prompt.device, ring=ring)
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
