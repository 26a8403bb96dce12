"""NMS: greedy IoU non-max suppression (tpukern/ops/nms.py).

Kernel: csrc/nms.cu (#43, replaces nms.py:24 `_nms_keep_kernel`), two
launches for the one TPU kernel: the IoU > threshold bitmask of the upper
triangle as 64-bit words over 64-column tiles, in parallel, then one
block that walks the sorted boxes in order, 64 rows a step, and ORs the
kept rows' later words into a removed bitmap in shared memory, all of a
step's in parallel. The walk is sequential, so the kernel's time is set
by latency, not by its N^2 IoUs.
The IoU is nms.py:26-38's in f32, in its order, with IEEE operations
that nvcc never contracts into an FMA, and a strict `>`.

What JAX leaves to XLA stays torch: the sort before the kernel is
torch.argsort(-scores, stable=True), as JAX's jnp.argsort is stable, and
the compaction after it a stable argsort of ~keep. `nms` returns the
kept indices in descending score order, padded with -1 to N, int32.

`nms_ref` is the counterpart of JAX's numpy reference: f64 IoUs, the
union tested > 0, and an unstable sort, so it orders tied scores as it
pleases (numpy's quicksort in JAX, PyTorch's here): it equals `nms` on
distinct scores only. The plain version of the kernel path
(`nms_plain`, the registry's `ref`) is `nms` with `nms_keep_plain`.

On a CPU tensor `nms_keep` returns its plain version.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register


def _check_boxes(boxes):
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"nms: boxes (N, 4), got {tuple(boxes.shape)}")
    if boxes.shape[0] >= 2 ** 31:
        raise ValueError(f"nms: N = {boxes.shape[0]} past int32")


def _check(boxes, scores):
    _check_boxes(boxes)
    if scores.shape != (boxes.shape[0],):
        raise ValueError(f"nms: scores (N,), got {tuple(scores.shape)} for "
                         f"{boxes.shape[0]} boxes")


def nms_keep(boxes, iou_threshold=0.5):
    """(N,) bool keep flags of greedy suppression over boxes (N, 4)
    sorted by descending score (#43). CPU: nms_keep_plain."""
    _check_boxes(boxes)
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, iou_threshold)
    _build.check_cuda(boxes)
    b = _build.aligned(boxes.to(torch.float32))
    n = b.shape[0]
    mask = torch.empty((n, -(-n // 64)), dtype=torch.int64, device=b.device)
    keep = torch.empty(n, dtype=torch.int32, device=b.device)
    _build.launch("tk_nms_keep", b.data_ptr(), n, float(iou_threshold),
                  mask.data_ptr(), keep.data_ptr(), _build.stream(b))
    nms_keep.launches += 1
    return keep.bool()


nms_keep.launches = 0


def _inter_union(b):
    """The (N, N) intersections and unions of boxes b in b's dtype, in
    nms.py:26-38's order: union = (area_i + area_j) - inter."""
    x1, y1, x2, y2 = b.unbind(1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    inter = ((torch.minimum(x2[:, None], x2) - torch.maximum(x1[:, None], x1))
             .clamp_min(0)
             * (torch.minimum(y2[:, None], y2)
                - torch.maximum(y1[:, None], y1)).clamp_min(0))
    return inter, area[:, None] + area - inter


def _greedy(suppress):
    """The keep flags of the greedy walk over the (N, N) bool matrix
    `suppress` (row i: the later boxes box i suppresses), on the host."""
    suppress = suppress.triu(1).cpu()
    keep = torch.ones(suppress.shape[0], dtype=torch.bool)
    for i in range(suppress.shape[0]):
        if keep[i]:
            keep &= ~suppress[i]
    return keep


def nms_keep_plain(boxes, iou_threshold=0.5):
    """The IoU matrix in f32, then the greedy walk over it on the host."""
    _check_boxes(boxes)
    inter, union = _inter_union(boxes.to(torch.float32))
    iou = inter / union.clamp_min(1e-12)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=iou.device)
    return _greedy(iou > thr).to(boxes.device)


def _compact(order, keep):
    """The kept indices of `order` first, in order, then -1 (int32)."""
    pos = torch.argsort((~keep).to(torch.uint8), stable=True)
    return torch.where(keep[pos], order[pos], -1).to(torch.int32)


def nms(boxes, scores, iou_threshold=0.5):
    """Greedy NMS of boxes (N, 4) [x1, y1, x2, y2] by scores (N,): the
    kept indices in descending score order, padded with -1 to N, int32."""
    _check(boxes, scores)
    order = torch.argsort(-scores, stable=True)
    return _compact(order, nms_keep(boxes[order], iou_threshold))


def nms_plain(boxes, scores, iou_threshold=0.5):
    _check(boxes, scores)
    order = torch.argsort(-scores, stable=True)
    return _compact(order, nms_keep_plain(boxes[order], iou_threshold))


def nms_ref(boxes, scores, iou_threshold=0.5):
    """JAX's nms_ref: f64, a pair suppressed where its union is > 0 and
    inter / union > threshold, an unstable sort."""
    _check(boxes, scores)
    order = torch.argsort(-scores.double().cpu())
    inter, union = _inter_union(boxes.double().cpu()[order])
    keep = _greedy((union > 0) & (inter / union > iou_threshold))
    return _compact(order, keep).to(boxes.device)


def _flops(boxes, scores, **_):
    # nms.py:26-38 on each of the N^2 pairs: 4 max/min, 2 subtractions, 2
    # clamps and a product (inter), an add and a subtraction (union), a
    # clamp, a division, a comparison
    return 14 * boxes.shape[0] ** 2


register("nms", "nms_f32", ref=nms_plain, flops=_flops)(nms)
