"""The embedding family of the port (ops/embedding.py, kernels #38-#40)
against the JAX package's (tpukern/ops/embedding.py).

Every registry variant gathers the same numpy table and indices through
the JAX variant (its Pallas kernel in interpret mode) and the port's (its
plain version on the CPU), bit for bit, at (V, D, S) = (64, 48, 40) and
(37, 130, 24). Indices outside [0, V) give what each JAX variant gives in
interpret mode, and embedding_ref what jnp.take gives. embedding_dma
refuses a token count that is no multiple of block_tokens, as JAX's
assert does; ops_bench.work counts the distinct rows a gather reads, not
its table.
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


# (V, D) and indices with repeats and indices outside [0, V): #38/#39
# read rows {0, 3, 5, 15} (-1, 16 and 2^31 - 1 clamp to 15), #40 rows
# {0, 3, 5} (it reads nothing for an index outside [0, V))
WORK_IDX = [0, 3, 3, -1, 16, 5, 0, 2 ** 31 - 1]


@pytest.mark.parametrize("name", ["embedding_prefetch_f32",
                                  "embedding_onehot_bf16"])
def test_ops_bench_work_counts_the_gather(name):
    """The bound's bytes are the variant's bytes_moved: each distinct row
    the indices read, S rows written and the indices, never the whole
    table."""
    v = registry.get("embedding", name)
    V, D = 16, 64
    args = (torch.tensor(WORK_IDX, dtype=torch.int32),
            torch.ones(V, D, dtype=torch.float32))
    flops, _, nbytes = ops_bench.work(v, args, v.fn(*args))
    item = 2 if name.endswith("bf16") else 4
    read = 3 if "_onehot_" in name else 4
    S = len(WORK_IDX)
    assert flops == 0
    assert nbytes == v.bytes_moved(*args) == (read + S) * D * item + S * 4
    assert nbytes < args[1].numel() * args[1].element_size()


@pytest.mark.parametrize("inf", [np.inf, -np.inf], ids=str)
def test_jax_onehot_spreads_an_inf_as_nan(inf):
    """JAX's one-hot product multiplies every table row: an inf at (3, 2)
    makes column 2 NaN (0 x inf) for every token that does not select
    row 3, outside [0, V) too, and the inf for those that do. The port's
    plain version (and kernel #40) selects the row: column 2 is the
    token's own value, or 0 outside [0, V). The other columns agree bit
    for bit (ROADMAP.md §3, "not a bit-exact oracle")."""
    _, w = _case(8, 6, 16)
    idx = OUT_OF_RANGE
    w[3, 2] = inf
    jout = np.asarray(jax_emb.embedding_onehot(jnp.asarray(idx),
                                               jnp.asarray(w), 8))
    out = to_numpy(embedding.embedding_onehot(torch.from_numpy(idx),
                                              torch.from_numpy(w), 8))
    hit, inside = idx == 3, (idx >= 0) & (idx < 8)
    assert hit.any() and (~inside).any()
    np.testing.assert_array_equal(jout[hit, 2], inf)
    assert np.isnan(jout[~hit, 2]).all()
    np.testing.assert_array_equal(out[:, 2], np.where(
        inside, w[np.where(inside, idx, 0), 2], 0))
    keep = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(out[:, keep], jout[:, keep])
