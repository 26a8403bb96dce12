"""The histogram (#41), transpose (#42) and nms (#43) families of the port
against the JAX package's (tests/test_memory_ops.py's counterpart).

The same numpy inputs go through each JAX variant (its Pallas kernel in
interpret mode) and the port's (its plain version on the CPU), compared
exactly: counts, transposed values and kept indices are integers or bit
patterns. Three places where JAX's own functions part:

- histogram_ref (jnp.bincount) counts negatives in bin 0, the kernel and
  histogram_sorted never count them; the port's histogram_ref follows
  the first, its variants the second.
- nms_ref sorts with numpy's unstable quicksort, nms with a stable
  argsort: on tied scores the two return other index lists, so the
  port's nms is held to JAX's nms, and nms_ref only on distinct scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
import tpukern_torch.ops  # noqa: F401
from torch_parity import to_numpy
from tpukern.core import registry as jax_registry
from tpukern.ops import histogram as jax_hist
from tpukern.ops import nms as jax_nms
from tpukern_torch.core import registry
from tpukern_torch.harness import ops_bench
from tpukern_torch.ops import histogram, nms, transpose

HIST_NAMES = sorted(registry.variants("histogram"))
TRANSPOSE_NAMES = sorted(registry.variants("transpose"))
# values outside [0, 8): negatives, past the end, int32's largest
OUT_OF_RANGE = np.array([-3, -1, 0, 1, 1, 5, 7, 300, 2 ** 31 - 1], np.int32)


def _equal(jax_out, torch_out):
    np.testing.assert_array_equal(to_numpy(torch_out), to_numpy(jax_out))


def _hist(name, x, bins):
    """(JAX variant, port variant) on the numpy values x."""
    return (jax_registry.get("histogram", name).fn(jnp.asarray(x), bins),
            registry.get("histogram", name).fn(torch.from_numpy(x), bins))


def test_every_jax_variant_has_a_case():
    for fam, n in (("histogram", 3), ("transpose", 8), ("nms", 1)):
        assert set(jax_registry.variants(fam)) == set(registry.variants(fam))
        assert len(registry.variants(fam)) == n
        assert not [k for k in registry.PENDING if k[0] == fam]
    assert registry.get("histogram", "histogram_i32_sorted").tags == (
        "baseline",)


# ------------------------------------------------------------- histogram

@pytest.mark.parametrize("bins", [100, 256, 1000])
@pytest.mark.parametrize("name", HIST_NAMES)
def test_histogram_variant_matches_jax(name, bins):
    x = np.random.default_rng(bins).integers(0, bins, 10000).astype(np.int32)
    want, got = _hist(name, x, bins)
    _equal(want, got)
    assert got.dtype == torch.int32 and got.sum().item() == x.size


@pytest.mark.parametrize("name", HIST_NAMES)
def test_histogram_out_of_range_values_are_never_counted(name):
    want, got = _hist(name, OUT_OF_RANGE, 8)
    _equal(want, got)
    np.testing.assert_array_equal(to_numpy(got), [1, 2, 0, 0, 0, 1, 0, 1])


@pytest.mark.parametrize("bins", [8, 256])
def test_histogram_ref_clips_negatives_as_bincount(bins):
    rng = np.random.default_rng(1)
    for x in (OUT_OF_RANGE, rng.integers(-20, bins + 20, 5000).astype(
            np.int32)):
        _equal(jax_hist.histogram_ref(jnp.asarray(x), bins),
               histogram.histogram_ref(torch.from_numpy(x), bins))
    ref = histogram.histogram_ref(torch.from_numpy(OUT_OF_RANGE), 8)
    np.testing.assert_array_equal(to_numpy(ref)[:1], [3])


def test_histogram_sorted_matches_jax_beyond_the_bins():
    x = np.random.default_rng(2).integers(-50, 1100, 7000).astype(np.int32)
    _equal(jax_hist.histogram_sorted(jnp.asarray(x), 1000),
           histogram.histogram_sorted(torch.from_numpy(x), 1000))


@pytest.mark.parametrize("name", HIST_NAMES)
def test_histogram_takes_int64_values_narrowed_to_int32(name):
    x64 = np.random.default_rng(3).integers(-5, 260, 3000)
    x64[::100] += 2 ** 32  # narrowed to int32: the same value
    x32 = x64.astype(np.int32)
    want, got32 = _hist(name, x32, 256)
    got64 = registry.get("histogram", name).fn(torch.from_numpy(x64), 256)
    _equal(want, got32)
    assert torch.equal(got64, got32)


def test_histogram_checks_its_arguments():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        histogram.histogram(x.float(), 4)
    with pytest.raises(ValueError):
        histogram.histogram(x, 0)
    with pytest.raises(ValueError):
        histogram.histogram(x, 4, block_rows=24)


# ------------------------------------------------------------- transpose

@pytest.mark.parametrize("shape", [(384, 256), (300, 200)], ids=str)
@pytest.mark.parametrize("name", TRANSPOSE_NAMES)
def test_transpose_variant_matches_jax_bit_for_bit(name, shape):
    x = np.random.default_rng(shape[0]).standard_normal(shape).astype(
        np.float32)
    got = registry.get("transpose", name).fn(torch.from_numpy(x))
    _equal(jax_registry.get("transpose", name).fn(jnp.asarray(x)), got)
    dt = torch.bfloat16 if "_bf16_" in name else torch.float32
    assert got.dtype == dt
    assert torch.equal(got, torch.from_numpy(x).to(dt).T)


def test_transpose_checks_its_arguments():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        transpose.transpose(x, order="spiral")
    with pytest.raises(ValueError):
        transpose.transpose(x, block=(128, 96))
    with pytest.raises(ValueError):
        transpose.transpose(x[0])


# ------------------------------------------------------------------- nms

def _test_boxes(n, seed=0):
    """tests/test_memory_ops.py:70-74's draw."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 100, (n, 2))
    sizes = rng.uniform(5, 30, (n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=1)
    return boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def _nms_both(boxes, scores, thr=0.5):
    return (jax_nms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr),
            nms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr))


def test_nms_matches_jax_on_the_tests_boxes():
    boxes, scores = _test_boxes(64)
    want, got = _nms_both(boxes, scores)
    _equal(want, got)
    out = to_numpy(got)
    assert got.dtype == torch.int32 and (out >= 0).any() and (out == -1).any()
    # distinct scores: nms_ref gives the same list, as JAX's does
    _equal(jax_nms.nms_ref(boxes, scores, 0.5),
           nms.nms_ref(torch.from_numpy(boxes), torch.from_numpy(scores)))
    _equal(want, nms.nms_ref(torch.from_numpy(boxes),
                             torch.from_numpy(scores)))


def test_nms_orders_tied_scores_as_jax_stable_sort():
    boxes, _ = _test_boxes(300, seed=1)
    scores = np.random.default_rng(2).integers(0, 4, 300).astype(np.float32)
    want, got = _nms_both(boxes, scores)
    _equal(want, got)
    kept = to_numpy(got)[to_numpy(got) >= 0]
    # ties keep index order inside a score
    s = scores[kept]
    assert all(s[i] > s[i + 1] or (s[i] == s[i + 1] and kept[i] < kept[i + 1])
               for i in range(len(kept) - 1))


def test_nms_keeps_a_box_at_an_iou_of_exactly_the_threshold():
    boxes = np.array([[0, 0, 2, 1], [0, 0, 1, 1], [0, 0, 0.9, 1]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    want, got = _nms_both(boxes, scores)
    _equal(want, got)
    # IoU 1 / 2 = 0.5 is not > 0.5; 0.9 / 2 < 0.5; but [0, 0, 1, 1]
    # against [0, 0, 0.9, 1] is 0.9 > 0.5
    np.testing.assert_array_equal(to_numpy(got), [0, 1, -1])


def test_nms_zero_area_boxes_match_jax():
    boxes = np.array([[1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 4, 0], [0, 0, 4, 4],
                      [2, 2, 1, 1], [0, 0, 4, 4]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6, 0.5, 0.4], np.float32)
    want, got = _nms_both(boxes, scores)
    _equal(want, got)
    # zero areas: a union of 0 is floored at 1e-12, an IoU of 0: kept
    np.testing.assert_array_equal(to_numpy(got), [0, 1, 2, 3, 4, -1])


def test_nms_matches_jax_at_1000_boxes():
    boxes, scores = ops_bench.nms_boxes(
        1000, torch.Generator().manual_seed(0), exact_pairs=100)
    want, got = _nms_both(boxes.numpy(), scores.numpy())
    _equal(want, got)
    out = to_numpy(got)
    # every exact pair's second box is kept: 100 threshold-exact IoUs
    assert set(range(900, 1000)) <= set(out.tolist())
    _equal(jax_nms.nms_ref(boxes.numpy(), scores.numpy(), 0.5),
           nms.nms_ref(boxes, scores))


# --------------------------------------------------- ops_bench at TINY

@pytest.mark.parametrize("family", ["histogram", "transpose", "nms"])
def test_ops_bench_inputs_and_check_at_tiny(family):
    gen = torch.Generator().manual_seed(0)
    for name, v in sorted(registry.variants(family).items()):
        args = ops_bench.inputs(family, name, ops_bench.TINY, gen)
        ok, err, rule = ops_bench.check(v, args)
        assert ok and err == 0, (name, rule, err)
        flops, _, nbytes = ops_bench.work(v, args, v.fn(*args))
        if family == "histogram":
            n, bins = ops_bench.TINY.hist
            assert args[1] == bins and args[0].shape == (n,)
            assert (flops, nbytes) == (0, 4 * (n + bins))
        elif family == "transpose":
            assert rule == "bit-equal"
            assert nbytes == 2 * args[0].numel() * args[0].element_size()
        else:
            assert args[0].shape == (ops_bench.TINY.nms, 4)
            assert flops == 14 * ops_bench.TINY.nms ** 2
