"""The embedding family of the port (ops/embedding.py, kernels #38-#40)
against the JAX package's (tpukern/ops/embedding.py).

Every registry variant gathers the same numpy table and indices through
the JAX variant (its Pallas kernel in interpret mode) and the port's (its
plain version on the CPU), bit for bit, at (V, D, S) = (64, 48, 40) and
(37, 130, 24). Indices outside [0, V) give what each JAX variant gives in
interpret mode, and embedding_ref what jnp.take gives. embedding_dma
refuses a token count that is no multiple of block_tokens, as JAX's
assert does; ops_bench.work counts a gather's bytes, not its table's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
import tpukern_torch.ops  # noqa: F401
from torch_parity import to_numpy
from tpukern.core import registry as jax_registry
from tpukern.ops import embedding as jax_emb
from tpukern_torch.core import registry
from tpukern_torch.harness import ops_bench
from tpukern_torch.ops import embedding

CASES = [(64, 48, 40), (37, 130, 24)]
NAMES = sorted(registry.variants("embedding"))
KINDS = {"prefetch": (jax_emb.embedding_prefetch,
                      embedding.embedding_prefetch),
         "dma": (jax_emb.embedding_dma, embedding.embedding_dma),
         "onehot": (jax_emb.embedding_onehot, embedding.embedding_onehot)}
# V = 8: in range, past the end, -1, -V, below -V, int32's ends
OUT_OF_RANGE = np.array([0, 7, 8, -1, 3, 9, -8, -9, -100, 100, 2 ** 31 - 1,
                         -2 ** 31, 2, 1, 5, 6], np.int32)


def _case(V, D, S, seed=0):
    rng = np.random.default_rng(seed + V)
    return (rng.integers(0, V, size=S).astype(np.int32),
            rng.standard_normal((V, D)).astype(np.float32))


def _equal(jax_out, torch_out):
    np.testing.assert_array_equal(to_numpy(torch_out), to_numpy(jax_out))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_jax_bit_for_bit(name, case):
    idx, w = _case(*case)
    out = registry.get("embedding", name).fn(torch.from_numpy(idx),
                                             torch.from_numpy(w))
    dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
    assert out.dtype == dt and out.shape == (case[2], case[1])
    _equal(jax_registry.get("embedding", name).fn(jnp.asarray(idx),
                                                  jnp.asarray(w)), out)
    # every row is the table's own row, rounded to the variant's dtype
    assert torch.equal(out, torch.from_numpy(w).to(dt)[idx])


def test_every_jax_variant_has_a_case():
    assert set(jax_registry.variants("embedding")) == set(NAMES)
    assert len(NAMES) == 6
    assert not [k for k in registry.PENDING if k[0] == "embedding"]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_out_of_range_indices_match_jax(kind):
    """prefetch and dma: a negative index counts from the end, then it is
    clamped to [0, V - 1]; onehot: a zero row. int64 indices give the
    same."""
    _, w = _case(8, 4, 1)
    jax_fn, fn = KINDS[kind]
    want = jax_fn(jnp.asarray(OUT_OF_RANGE), jnp.asarray(w))
    _equal(want, fn(torch.from_numpy(OUT_OF_RANGE), torch.from_numpy(w)))
    _equal(want, fn(torch.from_numpy(OUT_OF_RANGE.astype(np.int64)),
                    torch.from_numpy(w)))
    rows = to_numpy(fn(torch.from_numpy(OUT_OF_RANGE), torch.from_numpy(w)))
    if kind == "onehot":
        assert not rows[2].any() and not rows[3].any()
    else:  # 8 -> 7, -1 -> 7, -9 -> 0
        np.testing.assert_array_equal(rows[[2, 3, 7]], w[[7, 7, 0]])


def test_embedding_ref_is_jnp_take():
    """[-V, 0) wraps, rows past that are NaN."""
    _, w = _case(8, 4, 1)
    want = np.asarray(jax_emb.embedding_ref(jnp.asarray(OUT_OF_RANGE),
                                            jnp.asarray(w)))
    got = embedding.embedding_ref(torch.from_numpy(OUT_OF_RANGE),
                                  torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]).all() and not np.isnan(got[3]).any()


def test_dma_refuses_a_token_count_off_the_block():
    idx, w = _case(64, 48, 36)
    with pytest.raises(AssertionError):
        jax_emb.embedding_dma(jnp.asarray(idx), jnp.asarray(w))
    with pytest.raises(ValueError, match="block size"):
        embedding.embedding_dma(torch.from_numpy(idx), torch.from_numpy(w))
    with pytest.raises(ValueError, match="block size"):
        embedding.embedding_dma_plain(torch.from_numpy(idx),
                                      torch.from_numpy(w))
    # a block of 4 divides 36
    _equal(jax_emb.embedding_dma(jnp.asarray(idx), jnp.asarray(w), 4),
           embedding.embedding_dma(torch.from_numpy(idx),
                                   torch.from_numpy(w), 4))


@pytest.mark.parametrize("name", ["embedding_prefetch_f32",
                                  "embedding_onehot_bf16"])
def test_ops_bench_work_counts_the_gather(name):
    """The bound's bytes are the variant's bytes_moved: S rows read, S
    rows written and the indices, never the whole table."""
    v = registry.get("embedding", name)
    size = ops_bench.Size(embedding=(4096, 64, 32), onehot_vocab=4096)
    args = ops_bench.inputs("embedding", name, size,
                            torch.Generator().manual_seed(0))
    flops, _, nbytes = ops_bench.work(v, args, v.fn(*args))
    item = 2 if name.endswith("bf16") else 4
    assert flops == 0
    assert nbytes == v.bytes_moved(*args) == 2 * 32 * 64 * item + 32 * 4
    assert nbytes < args[1].numel() * args[1].element_size()
