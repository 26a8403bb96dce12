"""The hand-written CUDA kernels of tpukern_torch against their plain
PyTorch versions. Every test needs an NVIDIA GPU (marker `cuda`) and
skips without one. This file imports no JAX, so it also runs on a GPU
host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py imports jax). Tolerances: the _TOLS
bf16 row for bf16; 1e-4 for f32, since CUDA's exp/rsqrt and the
summation order differ from PyTorch's in the last bits.
"""

import numpy as np
import pytest
import torch

from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import (Config, ContinuousBatcher, init_params,
                                  params_to)
from tpukern_torch.ops import attention, paged_attention, rmsnorm, rope

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
F32 = dict(rtol=1e-4, atol=1e-4)
WRAPPERS = {"rms_norm": rmsnorm.rms_norm, "rope_cached": rope.rope_cached,
            "flash_attention": attention.flash_attention,
            "paged_attention": paged_attention.paged_attention}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _cases(dev, dt):
    """op -> (kernel call, plain call, args) at small, ragged shapes."""
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    cos, sin = rope.make_cos_sin(256, 64, device=dev)
    pos = torch.randint(0, 256, (48,), generator=g, device=dev)
    table = torch.randperm(12, generator=g, device=dev).reshape(3, 4)
    lengths = torch.tensor([0, 17, 64], dtype=torch.int32, device=dev)
    return {
        "rms_norm": (rmsnorm.rms_norm, rmsnorm.rms_norm_ref,
                     (r(33, 200), 1 + r(200))),
        "rope_cached": (rope.rope_cached, rope.rope_cached_ref,
                        (r(48, 64), cos[pos], sin[pos])),
        "flash_attention": (
            lambda *a: attention.flash_attention(*a, causal=True),
            lambda *a: attention.attention_ref(*a, causal=True),
            (r(2, 4, 100, 64), r(2, 2, 100, 64), r(2, 2, 100, 64))),
        "paged_attention": (
            paged_attention.paged_attention,
            paged_attention.paged_attention_ref,
            (r(3, 4, 64), r(2, 12, 16, 64), r(2, 12, 16, 64), lengths,
             table.to(torch.int32))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("op", sorted(WRAPPERS))
def test_kernel_matches_plain(cuda, op, dt):
    kernel, plain, args = _cases(cuda, DTYPES[dt])[op]
    before = WRAPPERS[op].launches
    out = kernel(*args)
    torch.cuda.synchronize()
    assert WRAPPERS[op].launches == before + 1
    check_all_close(out.float(), plain(*args).float(), dtype=DTYPES[dt],
                    name=op, **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 300])
def test_flash_attention_tails(cuda, S, D):
    """Lengths around the 64-row tile, every supported head dim, GQA 2."""
    g = torch.Generator(device=cuda).manual_seed(S * D)
    q, k, v = (torch.randn((1, h, S, D), generator=g, device=cuda)
               .to(torch.bfloat16) for h in (4, 2, 2))
    for causal in (True, False):
        check_all_close(attention.flash_attention(q, k, v, causal=causal),
                        attention.attention_ref(q, k, v, causal=causal),
                        name=f"S{S} D{D} causal={causal}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D,group", [(32, 8), (64, 1), (128, 2)])
def test_paged_attention_head_dims(cuda, D, group, dt):
    """Every head dim and dtype the kernel is built for, groups 1 to 8, a
    shuffled table and lengths around the 64-token tile."""
    g = torch.Generator(device=cuda).manual_seed(D + group)
    kp, vp = (torch.randn((2, 12, 32, D), generator=g, device=cuda)
              .to(DTYPES[dt]) for _ in range(2))
    q = torch.randn((4, 2 * group, D), generator=g, device=cuda).to(DTYPES[dt])
    table = torch.randperm(12, generator=g, device=cuda).reshape(4, 3)
    lengths = torch.tensor([63, 64, 65, 96], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, lengths, table.to(torch.int32))
    check_all_close(paged_attention.paged_attention(*args).float(),
                    paged_attention.paged_attention_ref(*args).float(),
                    dtype=DTYPES[dt], **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
def test_paged_attention_length_past_the_pool(cuda):
    """An inactive slot at the pool's end decodes with length pool + 1:
    the kernel attends the whole pool, as the masked plain version does."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kp, vp = (torch.randn((2, 8, 16, 64), generator=g, device=cuda)
              for _ in range(2))
    q = torch.randn((2, 4, 64), generator=g, device=cuda)
    table = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    lengths = torch.tensor([65, 5], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, lengths, table)
    check_all_close(paged_attention.paged_attention(*args),
                    paged_attention.paged_attention_ref(*args), **F32)


@pytest.mark.cuda
def test_misaligned_input(cuda):
    """A contiguous view that starts off a 16-byte boundary is copied
    before the kernel's 16-byte loads."""
    flat = torch.randn(33 * 200 + 1, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(33, 200)
    g = torch.ones(200, device=cuda, dtype=torch.bfloat16)
    check_all_close(rmsnorm.rms_norm(x, g), rmsnorm.rms_norm_ref(x, g))


@pytest.mark.cuda
def test_unsupported_shapes_raise(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q, causal=True)
    kp = torch.zeros(2, 4, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention.paged_attention(
            q[:, :, 0], kp, kp, torch.ones(1, dtype=torch.int32, device=cuda),
            torch.zeros(1, 4, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        rmsnorm.rms_norm(torch.zeros(2, 8, device=cuda, dtype=torch.float16),
                         torch.ones(8, device=cuda, dtype=torch.float16))


@pytest.mark.cuda
def test_batcher_on_kernels_equals_plain(cuda):
    """The serving path through the kernels (f32 weights and pools) gives
    the same greedy streams as the plain path on the CPU."""
    cfg = Config(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, max_seq=512)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (17, 40, 9)]
    kw = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=6,
              prompt_buckets=(64,), cache_dtype=torch.float32)
    ref = ContinuousBatcher(params, cfg, **kw).run(list(enumerate(prompts)))
    counts = {n: w.launches for n, w in WRAPPERS.items()}
    out = ContinuousBatcher(params_to(params, cuda), cfg, **kw).run(
        list(enumerate(prompts)))
    assert out == ref
    assert all(w.launches > counts[n] for n, w in WRAPPERS.items())
