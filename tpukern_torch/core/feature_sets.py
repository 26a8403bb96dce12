"""The feature sets the featured attention kernels are checked with: one
definition for the GPU tests (tests/test_torch_kernels.py) and
chip_smoke.py. A causal sliding window (with sinks), a logit softcap, and
segment ids whose last id only queries carry, so those rows see no key.
"""

import torch

FEATURE_SETS = {"window": dict(window=37),
                "window+sinks": dict(window=37, sinks=5),
                "softcap": dict(softcap=3.0),
                "segments": dict(segments=True),
                "window+softcap+segments": dict(window=37, softcap=3.0,
                                                segments=True)}


def feature_kwargs(name, B, S, device):
    """The flash_attention kwargs of FEATURE_SETS[name] for batch B and
    length S on `device`, and the bool (S,) rows that see a key. Segments
    are three packed sequences with ids 0, 1 and 2; the keys of the last
    carry id 3, so its queries see no key."""
    kw = dict(FEATURE_SETS[name])
    seen = torch.ones(S, dtype=torch.bool, device=device)
    if kw.pop("segments", False):
        q_seg = torch.arange(S, device=device) * 3 // S
        kv_seg = torch.where(q_seg == 2, 3, q_seg)
        kw["segment_ids"] = (q_seg.expand(B, S), kv_seg.expand(B, S))
        seen = q_seg != 2
    return kw, seen
