"""tpukern_torch/ops/sampling.py (#26, #27 and the thresholds) and the
sampled acceptance of models/speculative.py against the JAX package on
the CPU. The port's wrappers take their plain twins here; JAX runs its
Pallas kernels in interpret mode, as tests/test_sampling.py does, where
`sample` adds jax.random.gumbel noise of its padded (Bp, Vp) shape: the
port gets the same noise, sliced to (B, V), through `noise=`, so the
indices must be equal bit for bit. Top-k thresholds are exact on both
sides; top-p thresholds sum masses in another order, so they are held
to JAX's own rule (tests/test_sampling.py:136-153): the kept sets differ
by at most the boundary token, of mass < 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.core import round_up
from tpukern.models import speculative as jax_spec
from tpukern.ops import sampling as jsp
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import speculative as spec
from tpukern_torch.ops import sampling as sp


def _logits(rng, B, V, scale=1.0):
    x = (rng.standard_normal((B, V)) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _jax_noise(seed, B, V):
    """The noise JAX's interpret-mode _stream_sample adds (sampling.py:
    102-103, 129), sliced to (B, V)."""
    bb, bv = min(round_up(B, 8), 64), min(round_up(V, 128), 8192)
    g = jax.random.gumbel(jax.random.key(seed),
                          (round_up(B, bb), round_up(V, bv)), jnp.float32)
    return torch.from_numpy(np.array(g)[:B, :V])


@pytest.mark.parametrize("B,V", [(8, 1024), (5, 1000), (64, 4096)])
def test_greedy_sample_equals_jax(B, V, rng):
    jx, tx = _logits(rng, B, V)
    out = sp.greedy_sample(tx)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jsp.greedy_sample(jx)))


def test_greedy_tie_break_equals_jax():
    """Ties within one 128-column block and across blocks: the first
    index, as JAX's streamed argmax gives."""
    x = np.zeros((4, 512), np.float32)
    x[0, [7, 300]] = 3.0
    x[1, [129, 130]] = 5.0
    x[2, 0] = 1.0
    ref = jsp.greedy_sample(jnp.asarray(x), block_v=128)
    np.testing.assert_array_equal(sp.greedy_sample(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(ref), [7, 129, 0, 0])


SAMPLE_CASES = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(temperature=0.9, top_k=8),
    "top_p": dict(top_p=0.9),
    "min_p": dict(temperature=1.3, min_p=0.05),
    "all": dict(temperature=0.8, top_k=50, top_p=0.8, min_p=0.02),
}


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_with_noise_equals_jax(case, seed, rng):
    """The same noise, the same support: bit-equal indices."""
    B, V = 12, 1000
    jx, tx = _logits(rng, B, V, scale=3.0)
    kw = SAMPLE_CASES[case]
    ref = np.asarray(jsp.sample(jx, seed, **kw))
    out = sp.sample(tx, seed, noise=_jax_noise(seed, B, V), **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("k", [1, 8, 64, 1000])
def test_topk_threshold_equals_jax(k, rng):
    jx, tx = _logits(rng, 16, 1000, scale=3.0)
    ref = np.asarray(jsp.topk_threshold(jx, k, use_kernel=True))
    np.testing.assert_array_equal(sp.topk_threshold(tx, k).numpy(), ref)
    np.testing.assert_array_equal(
        sp.topk_threshold(tx, k, use_kernel=False).numpy(), ref)


@pytest.mark.parametrize("k", [1, 5, 10, 11])
def test_topk_threshold_ties_equal_jax(k):
    x = np.zeros((4, 256), np.float32)
    x[:, :10] = 5.0
    ref = np.asarray(jsp.topk_threshold(jnp.asarray(x), k, use_kernel=True))
    np.testing.assert_array_equal(
        sp.topk_threshold(torch.from_numpy(x), k).numpy(), ref)


def _kept_sets_agree(logits, a, b, probs):
    """JAX's top-p rule: the kept sets differ by at most one token, of
    mass < 1e-4."""
    for r in range(logits.shape[0]):
        extra = (set(np.flatnonzero(logits[r] >= a[r]))
                 ^ set(np.flatnonzero(logits[r] >= b[r])))
        assert len(extra) <= 1, (r, a[r], b[r])
        assert sum(probs[r][i] for i in extra) < 1e-4, (r, extra)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.999])
def test_topp_threshold_meets_jax_rule(p, temperature, rng):
    """Against JAX's kernel and its sort path, and the port's sort path."""
    jx, tx = _logits(rng, 16, 512, scale=3.0)
    x = tx.numpy()
    probs = np.asarray(jax.nn.softmax(jx / temperature, -1), np.float64)
    out = sp.topp_threshold(tx, p, temperature).numpy()
    assert np.isin(out, x).all()  # data values
    for ref in (jsp.topp_threshold(jx, p, temperature, use_kernel=True),
                jsp.topp_threshold(jx, p, temperature, use_kernel=False),
                sp.topp_threshold(tx, p, temperature, use_kernel=False)):
        _kept_sets_agree(x, out, np.asarray(ref), probs)


def test_minp_threshold_equals_jax(rng):
    jx, tx = _logits(rng, 8, 700, scale=2.0)
    for mp, t in ((0.05, 1.0), (0.2, 0.6)):
        check_all_close(sp.minp_threshold(tx, mp, t),
                        np.asarray(jsp.minp_threshold(jx, mp, t)),
                        dtype=torch.float32)


def test_temperature_zero_is_greedy(rng):
    _, tx = _logits(rng, 8, 512)
    np.testing.assert_array_equal(
        sp.sample(tx, 0, temperature=0.0, top_k=5).numpy(),
        torch.argmax(tx, -1).numpy())


def test_philox_noise_deterministic_per_seed(rng):
    """The plain twin's own noise: the same seed gives the same draw, a
    different seed another; a draw depends on (row, column) only."""
    _, tx = _logits(rng, 8, 512)
    a, b = sp.sample(tx, 123), sp.sample(tx, 123)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (a.numpy() != sp.sample(tx, 124).numpy()).any()
    g = sp._gumbel(5, 8, 512, "cpu")
    np.testing.assert_array_equal(sp._gumbel(5, 3, 100, "cpu").numpy(),
                                  g[:3, :100].numpy())


def test_philox_noise_frequencies(rng):
    """8192 rows of one 16-wide row: each token's frequency within a
    3-sigma band of softmax(x / T) (tests/test_sampling.py:88-100)."""
    V, N, T = 16, 8192, 0.8
    base = (rng.standard_normal(V) * 1.5).astype(np.float32)
    x = torch.from_numpy(np.tile(base, (N, 1)))
    got = sp.sample(x, 7, temperature=T).numpy()
    freq = np.bincount(got, minlength=V) / N
    probs = torch.softmax(torch.from_numpy(base).double() / T, -1).numpy()
    tol = 3 * np.sqrt(probs * (1 - probs) / N) + 2e-3
    np.testing.assert_array_less(np.abs(freq - probs), tol)


def test_topk_draws_stay_in_support(rng):
    _, tx = _logits(rng, 32, 2048, scale=3.0)
    topk = torch.topk(tx, 8, dim=-1).indices.numpy()
    for seed in range(4):
        got = sp.sample(tx, seed, top_k=8).numpy()
        assert all(got[r] in topk[r] for r in range(32))
    g = torch.Generator().manual_seed(0)
    got = sp.sample_ref(tx, g, top_k=8).numpy()
    assert all(got[r] in topk[r] for r in range(32))


def test_size_dispatch_above_the_kernel():
    """Past _BISECT_MAX_V columns the thresholds take torch.topk / sort,
    as JAX's take lax.top_k / sort; no #27 launch either way on the CPU."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, sp._BISECT_MAX_V + 8)).astype(np.float32))
    before = sp._bisect_threshold.launches
    assert sp.topk_threshold(x, 3).item() == torch.topk(x, 3).values[0, -1]
    thr = sp.topp_threshold(x, 0.5)
    assert thr.item() in x
    assert sp._bisect_threshold.launches == before
    with pytest.raises(ValueError):
        sp._bisect_threshold(x, mode="count", kk=3)


def test_temp_probs_and_rejection_accept_bit_equal_jax(rng):
    """Pure numpy, copied: bit-equal to JAX's on the same inputs and the
    same np.random.Generator."""
    g, V = 4, 64
    logits = rng.standard_normal((g + 1, V)) * 2
    for T in (1.0, 0.6):
        np.testing.assert_array_equal(spec._temp_probs(logits, T),
                                      jax_spec._temp_probs(logits, T))
    q = spec._temp_probs(rng.standard_normal((g, V)), 0.9)
    p = spec._temp_probs(logits, 0.9)
    for seed in range(20):
        r1, r2 = (np.random.default_rng(seed) for _ in range(2))
        drafts = r1.choice(V, size=g, p=q[0])
        r2.choice(V, size=g, p=q[0])
        assert (spec.rejection_accept(drafts, q, p, r1)
                == jax_spec.rejection_accept(drafts, q, p, r2))
        assert r1.random() == r2.random()
