"""Speculative decoding: a draft model proposes, the target verifies all
proposals in one paged prefix-prefill pass.

The port of tpukern/models/speculative.py: a round drafts gamma tokens
with the small model, scores [last, d_1 .. d_gamma] with one verify_step
of the target (csrc/paged_prefill.cu on the card), and keeps a prefix of
the drafts.

- speculative_generate (greedy): the drafts are kept while they equal the
  target's greedy choice, so the emitted stream is the one target-only
  greedy decoding gives.
- speculative_sample_generate (sampled): rejection sampling (Leviathan
  et al. 2022): accept d_i with probability min(1, p_i(d_i) / q_i(d_i)),
  on a rejection draw from norm(max(p_i - q_i, 0)), on full acceptance
  draw the bonus token from p_{gamma+1}; every emitted token is then
  distributed as target-only sampling at the temperature. As in JAX, the
  draws and the acceptance run on the host in numpy (_temp_probs,
  rejection_accept, copied from the JAX module, bit-equal with it on the
  same np.random.Generator), so they need no kernel.

Cache discipline: both caches hold the n emitted tokens, and one pending
token `last` is in neither. The draft grows to n + gamma, the target to
n + gamma + 1; after accepting j drafts both roll back to n + j + 1 (on
full acceptance the draft first catches up on d_gamma). cache_dtype may
be the quantized tier's torch.int8 or torch.float8_e4m3fn: rollback
moves only the lengths, so every kept token keeps its scales.
"""

import dataclasses

import numpy as np
import torch

from tpukern_torch.models.serving import (decode_step, init_cache, prefill,
                                          rollback, verify_step)


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self):
        return self.accepted / max(1, self.drafted)


def speculative_generate(target_params, target_cfg, draft_params,
                         draft_cfg, prompt, n_steps, *, gamma=4,
                         pages_per_seq=8, page_size=128, return_stats=False,
                         cache_dtype=torch.bfloat16):
    """Greedy speculative decoding of n_steps tokens for prompt (1, T),
    on the prompt's device. Emits exactly the tokens target-only greedy
    decoding (serving.generate) would. gamma = draft tokens proposed per
    round; cache_dtype is both caches' pool dtype. Returns (1, n_steps)
    int32 ids (and a SpecStats with the acceptance rate)."""
    if prompt.shape[0] != 1:
        raise ValueError("speculative_generate decodes one sequence")
    # every round writes up to gamma + 1 tokens past the emitted length
    # before it rolls back; past the pool the writes would clamp
    max_len = pages_per_seq * page_size
    if prompt.shape[1] + n_steps + gamma + 1 > max_len:
        raise ValueError(f"prompt ({prompt.shape[1]}) + n_steps ({n_steps}) "
                         f"+ gamma+1 ({gamma + 1}) must fit the page pool "
                         f"({max_len})")
    dev = prompt.device
    tc, dc = (init_cache(c, 1, pages_per_seq, page_size, dtype=cache_dtype,
                         device=dev) for c in (target_cfg, draft_cfg))
    t_logits, tc = prefill(target_params, target_cfg, prompt, tc)
    _, dc = prefill(draft_params, draft_cfg, prompt, dc)
    last = int(t_logits[0].argmax())

    out, stats = [], SpecStats()
    while len(out) < n_steps:
        n = int(tc.lengths[0])
        g = min(gamma, n_steps - len(out))  # don't overdraft the budget
        drafts, cur = [], last
        for _ in range(g):
            dl, dc = decode_step(draft_params, draft_cfg,
                                 torch.tensor([cur], dtype=torch.int32,
                                              device=dev), dc)
            cur = int(dl[0].argmax())
            drafts.append(cur)
        # the candidates are padded to gamma + 1, as JAX pads them;
        # positions past g are rolled back and never read
        cand = torch.zeros(1, gamma + 1, dtype=torch.int32)
        cand[0, :g + 1] = torch.tensor([last] + drafts)
        vl, tc = verify_step(target_params, target_cfg, cand.to(dev), tc)
        greedy = vl[0].argmax(-1).tolist()                # (gamma + 1,)
        j = 0
        while j < g and drafts[j] == greedy[j]:
            j += 1
        out += [last] + drafts[:j]
        stats.rounds += 1
        stats.drafted += g
        stats.accepted += j
        tc = rollback(tc, [n + j + 1])
        if j == g and g > 0:
            # full acceptance: the draft never saw d_g
            _, dc = decode_step(draft_params, draft_cfg,
                                torch.tensor([drafts[-1]], dtype=torch.int32,
                                             device=dev), dc)
        dc = rollback(dc, [n + j + 1])
        last = greedy[j]

    result = torch.tensor([out[:n_steps]], dtype=torch.int32, device=dev)
    return (result, stats) if return_stats else result


def rejection_accept(drafts, q_probs, p_probs, rng):
    """Rejection-sampling acceptance over one speculative round.

    drafts: (g,) proposed ids, d_i drawn from q_probs[i]; q_probs (g, V)
    the draft's distributions, p_probs (g + 1, V) the target's at the same
    positions (p_probs[g] after all g drafts); rng an
    np.random.Generator. Returns (j, next_token): j accepted drafts, and
    the residual draw at the first rejection or a p_probs[g] draw on full
    acceptance."""
    g = len(drafts)
    for i in range(g):
        d = int(drafts[i])
        q = max(float(q_probs[i, d]), 1e-20)
        if rng.random() < min(1.0, float(p_probs[i, d]) / q):
            continue
        resid = np.maximum(p_probs[i] - q_probs[i], 0.0)
        z = resid.sum()
        # z == 0 only by rounding (p <= q everywhere yet the draw lost):
        # p itself is still the target's distribution
        resid = resid / z if z > 0 else p_probs[i] / p_probs[i].sum()
        return i, int(rng.choice(len(resid), p=resid))
    p = p_probs[g] / p_probs[g].sum()
    return g, int(rng.choice(len(p), p=p))


def _temp_probs(logits, temperature):
    """softmax(logits / T) as float64 numpy, renormalized exactly."""
    x = np.asarray(logits, np.float64) / temperature
    x -= x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def _host_probs(logits, temperature):
    """_temp_probs of device logits."""
    return _temp_probs(logits.float().cpu().numpy(), temperature)


def speculative_sample_generate(target_params, target_cfg, draft_params,
                                draft_cfg, prompt, n_steps, *, gamma=4,
                                temperature=1.0, seed=0, pages_per_seq=8,
                                page_size=128, return_stats=False,
                                cache_dtype=torch.bfloat16):
    """Sampled speculative decoding of n_steps tokens for prompt (1, T),
    distributed exactly as target-only sampling at `temperature` (> 0;
    speculative_generate is the greedy one). The draws come from
    np.random.default_rng(seed), as in JAX. Returns (1, n_steps) int32
    ids (and a SpecStats)."""
    if temperature <= 0:
        raise ValueError("temperature must be > 0: speculative_generate is "
                         "the greedy path")
    if prompt.shape[0] != 1:
        raise ValueError("speculative_sample_generate decodes one sequence")
    max_len = pages_per_seq * page_size
    if prompt.shape[1] + n_steps + gamma + 1 > max_len:
        raise ValueError(f"prompt ({prompt.shape[1]}) + n_steps ({n_steps}) "
                         f"+ gamma+1 ({gamma + 1}) must fit the page pool "
                         f"({max_len})")
    rng = np.random.default_rng(seed)
    dev = prompt.device
    tc, dc = (init_cache(c, 1, pages_per_seq, page_size, dtype=cache_dtype,
                         device=dev) for c in (target_cfg, draft_cfg))
    t_logits, tc = prefill(target_params, target_cfg, prompt, tc)
    _, dc = prefill(draft_params, draft_cfg, prompt, dc)
    p0 = _host_probs(t_logits[0], temperature)
    last = int(rng.choice(len(p0), p=p0))

    out, stats = [], SpecStats()
    while len(out) < n_steps:
        n = int(tc.lengths[0])
        g = min(gamma, n_steps - len(out))
        drafts, q_rows, cur = [], [], last
        for _ in range(g):
            dl, dc = decode_step(draft_params, draft_cfg,
                                 torch.tensor([cur], dtype=torch.int32,
                                              device=dev), dc)
            q = _host_probs(dl[0], temperature)
            cur = int(rng.choice(len(q), p=q))
            drafts.append(cur)
            q_rows.append(q)
        cand = torch.zeros(1, gamma + 1, dtype=torch.int32)
        cand[0, :g + 1] = torch.tensor([last] + drafts)
        vl, tc = verify_step(target_params, target_cfg, cand.to(dev), tc)
        p_rows = _host_probs(vl[0, :g + 1], temperature)
        j, new_last = rejection_accept(
            np.asarray(drafts, np.int64),
            np.asarray(q_rows) if g else np.zeros((0, p_rows.shape[-1])),
            p_rows, rng)
        out += [last] + drafts[:j]
        stats.rounds += 1
        stats.drafted += g
        stats.accepted += j
        tc = rollback(tc, [n + j + 1])
        if j == g and g > 0:
            _, dc = decode_step(draft_params, draft_cfg,
                                torch.tensor([drafts[-1]], dtype=torch.int32,
                                             device=dev), dc)
        dc = rollback(dc, [n + j + 1])
        last = new_last

    result = torch.tensor([out[:n_steps]], dtype=torch.int32, device=dev)
    return (result, stats) if return_stats else result
