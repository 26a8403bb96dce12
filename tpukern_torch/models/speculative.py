"""Greedy speculative decoding: a draft model proposes, the target
verifies all proposals in one paged prefix-prefill pass.

The port of tpukern/models/speculative.py's greedy path: a round drafts
gamma tokens with the small model, scores [last, d_1 .. d_gamma] with one
verify_step of the target (csrc/paged_prefill.cu on the card), and keeps
the drafts while they equal the target's greedy choice, so the emitted
stream is the one target-only greedy decoding gives.

Cache discipline: both caches hold the n emitted tokens, and one pending
token `last` is in neither. The draft grows to n + gamma, the target to
n + gamma + 1; after accepting j drafts both roll back to n + j + 1 (on
full acceptance the draft first catches up on d_gamma).

Not ported: rejection_accept, _temp_probs and speculative_sample_generate
(sampled acceptance), which wait for the sampling kernels #26/#27
(ROADMAP.md queue 1 item 10).
"""

import dataclasses

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
