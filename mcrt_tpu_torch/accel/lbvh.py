"""Device-side LBVH construction: Morton codes and a Karras radix tree
(counterpart of ``mcrt_tpu/accel/lbvh.py``).

The build runs on the scene's device as a handful of dense tensor ops:

1. triangle AABBs and centroids;
2. 30-bit Morton codes of the normalized centroids;
3. a stable sort of the codes (padding faces get ``0xFFFFFFFF`` and sort
   last; equal codes keep their face order, as ``jnp.argsort`` keeps it);
4. the binary radix tree (Karras 2012): every internal node's range and
   split found independently with three 32-step bit searches;
5. the bottom-up box fit as a fixpoint of parent = union(children).

uint32 arithmetic (codes, ``_clz32``, the index keys ``32 + clz(i ^ j)``)
runs in int64 with explicit 32-bit masks.  Every field equals the JAX
build's.  The traversal tables are stored row-major, one row per node or
leaf (``packed`` (L-1, 12), ``leaf_rows`` (L, 9K), ``unified`` (2L-1, 24)),
where the JAX package stores them component-major for the TPU's lanes;
the JAX layouts stay readable as ``packed_t``, ``children``, ``leaf_t``,
``unified_t`` and ``unified_ci``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import BVHConfig
from ..core.types import F32_MAX, TensorRecord
from ..scene.scene import Geometry, take_clip

U32 = 0xFFFFFFFF
# The fixpoint fit tests for convergence on the host once every this many
# steps: a step after convergence changes nothing, so the extra steps are
# harmless, and each test is one host sync
SYNC_EVERY = 8


@dataclass
class LBVH(TensorRecord):
    """Linear BVH over L leaves of ``leaf_size`` Morton-consecutive
    triangles.  2L-1 nodes: [0, L-1) internal, [L-1, 2L-1) leaves; leaf k
    (node L-1+k) holds the sorted triangles ``prim[k*leaf_size :
    (k+1)*leaf_size]``.

    - ``packed`` (L-1, 12): both children's boxes per internal node
      [lmin(3), lmax(3), rmin(3), rmax(3)]; ``child`` (L-1, 2) their ids;
    - ``leaf_rows`` (L, 9*leaf_size): each leaf's triangles as Moller-
      Trumbore (p0, e1, e2), padding slots with zero edges;
    - ``unified`` (2L-1, 24) and ``unified_child`` (2L-1, 2), leaf size 2
      only: internal rows (12 box floats, then zeros) and leaf rows (18
      triangle floats, then zeros) in one table, children -1 on leaves.
    ``fit_iterations``: the fixpoint steps until the first that changed
    no box (the JAX build's loop count); ``fit_syncs``: the build's host
    syncs."""

    node_min: torch.Tensor  # (2L-1, 3)
    node_max: torch.Tensor  # (2L-1, 3)
    left: torch.Tensor  # (L-1,) i32
    right: torch.Tensor  # (L-1,) i32
    prim: torch.Tensor  # (L*leaf_size,) i32 sorted triangle ids
    prim_valid: torch.Tensor  # (L*leaf_size,) bool
    packed: torch.Tensor
    child: torch.Tensor
    leaf_rows: torch.Tensor
    unified: torch.Tensor | None
    unified_child: torch.Tensor | None
    leaf_size: int = 2
    fit_iterations: int = 0
    fit_syncs: int = 0

    @property
    def num_leaves(self) -> int:
        return self.leaf_rows.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    # the JAX package's component-major layouts
    @property
    def packed_t(self) -> torch.Tensor:
        return self.packed.T

    @property
    def children(self) -> torch.Tensor:
        return self.child.T

    @property
    def leaf_t(self) -> torch.Tensor:
        return self.leaf_rows.T

    @property
    def unified_t(self) -> torch.Tensor | None:
        return None if self.unified is None else self.unified.T

    @property
    def unified_ci(self) -> torch.Tensor | None:
        return None if self.unified_child is None else self.unified_child.T


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the uint32 values in int64 ``x`` (5-step
    reduction, as the JAX package's)."""
    x = x.to(torch.int64) & U32
    n = torch.full(x.shape, 32, dtype=torch.int64, device=x.device)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = torch.where(big, n - shift, n)
        x = torch.where(big, x >> shift, x)
    return n - x  # x is now 0 or 1


def _expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` to every third bit: the JAX
    package's uint32 multiply-and-mask, each product masked to 32 bits."""
    v = v.to(torch.int64) & U32
    for mul, mask in ((0x00010001, 0xFF0000FF), (0x00000101, 0x0F00F00F),
                      (0x00000011, 0xC30C30C3), (0x00000005, 0x49249249)):
        v = ((v * mul) & U32) & mask
    return v


def morton3d(p01: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of points normalized to [0, 1]^3."""
    q = torch.clamp(p01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits10(q[..., 0]) << 2) | (_expand_bits10(q[..., 1]) << 1)
            | _expand_bits10(q[..., 2]))


def triangle_bounds(geom: Geometry):
    """(F, 3) min, max and centroid of each triangle; padding faces get the
    empty box (F32_MAX, -F32_MAX) and the centroid 0."""
    idx = geom.indices
    pos = geom.positions.detach()
    p0, p1, p2 = (take_clip(pos, idx[:, k]) for k in range(3))
    bmin = torch.minimum(torch.minimum(p0, p1), p2)
    bmax = torch.maximum(torch.maximum(p0, p1), p2)
    valid = geom.face_valid[:, None]
    bmin = torch.where(valid, bmin, F32_MAX)
    bmax = torch.where(valid, bmax, -F32_MAX)
    centroid = torch.where(valid, 0.5 * (bmin + bmax), 0.0)
    return bmin, bmax, centroid


def _delta_fn(codes: torch.Tensor, n: int):
    """delta(i, j): common-prefix length of the (code, index) keys, the
    index bits breaking Morton ties (Karras section 4); -1 for j out of
    range."""

    def delta(i, j):
        in_range = (j >= 0) & (j <= n - 1)
        jc = j.clamp(0, n - 1)
        ci = codes[i.clamp(0, n - 1)]
        cj = codes[jc]
        d_code = _clz32(ci ^ cj)
        d_idx = 32 + _clz32((i & U32) ^ jc)
        return torch.where(in_range, torch.where(ci == cj, d_idx, d_code), -1)

    return delta


def _radix_tree(codes: torch.Tensor):
    """Karras 2012 radix-tree topology over the n-1 internal nodes: (left,
    right) child ids in the LBVH numbering (internal i -> i, leaf k ->
    n-1+k), int32."""
    n = codes.shape[0]
    i = torch.arange(n - 1, dtype=torch.int64, device=codes.device)
    delta = _delta_fn(codes, n)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # upper bound on the range length: a doubling search of 32 steps
    lmax = torch.full_like(i, 2)
    for _ in range(32):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax << 1, lmax)
    # binary search for the exact length
    length = torch.zeros_like(i)
    t = lmax >> 1
    for _ in range(32):
        cond = (t >= 1) & (delta(i, i + (length + t) * d) > delta_min)
        length = torch.where(cond, length + t, length)
        t = t >> 1
    j = i + length * d

    # split: the largest s with delta(i, i + s*d) > delta(i, j), over the
    # ceil-halving series of the length
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = length
    for _ in range(32):
        t = (t + 1) >> 1
        cond = delta(i, i + (s + t) * d) > delta_node
        s = torch.where(cond & (t >= 1), s + t, s)
        t = torch.where(t == 1, 0, t)
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    leaf_base = n - 1
    left = torch.where(lo == gamma, leaf_base + gamma, gamma)
    right = torch.where(hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    return left.to(torch.int32), right.to(torch.int32)


def _fit(node_min, node_max, left, right, num_leaves: int):
    """Bottom-up fit: steps of parent = union(children) until a step
    changes no box (at most ``num_nodes`` steps, as the JAX loop's cap).
    Returns (node_min, node_max, steps until the first that changed
    nothing, host syncs: one a ``SYNC_EVERY`` steps and the count's copy)."""
    n_int = num_leaves - 1
    num_nodes = node_min.shape[0]
    li, ri = left.long(), right.long()
    steps = torch.zeros((), dtype=torch.int64, device=node_min.device)
    running = torch.ones((), dtype=torch.bool, device=node_min.device)
    done, syncs = 0, 0
    while done < num_nodes:
        for _ in range(min(SYNC_EVERY, num_nodes - done)):
            new_min = torch.minimum(node_min[li], node_min[ri])
            new_max = torch.maximum(node_max[li], node_max[ri])
            changed = ((new_min != node_min[:n_int]) | (new_max != node_max[:n_int])).any()
            node_min = torch.cat([new_min, node_min[n_int:]])
            node_max = torch.cat([new_max, node_max[n_int:]])
            steps = steps + running.long()
            running = running & changed
            done += 1
        syncs += 1
        if not bool(running):
            break
    return node_min, node_max, int(steps), syncs + 1  # the step count's copy


def build_lbvh(geom: Geometry, cfg: BVHConfig | None = None, leaf_size: int = 2) -> LBVH:
    """The full build on the geometry's device.  Triangles are Morton-
    sorted and grouped into leaves of ``leaf_size`` consecutive triangles
    (``cfg.max_leaf_size`` where a config is given); the radix tree is
    built over the leaves' first codes."""
    if cfg is not None:
        leaf_size = cfg.max_leaf_size
    bmin, bmax, centroid = triangle_bounds(geom)
    n = bmin.shape[0]
    if n % leaf_size:
        raise ValueError(f"{n} faces do not fill leaves of {leaf_size}")
    num_leaves = n // leaf_size
    dev = bmin.device

    scene_min = bmin.amin(dim=0)
    scene_max = bmax.amax(dim=0)
    extent = torch.clamp_min(scene_max - scene_min, 1e-12)
    codes = morton3d((centroid - scene_min) / extent)
    codes = torch.where(geom.face_valid, codes, U32)  # padding sorts last

    order = torch.sort(codes, stable=True).indices
    codes_s = codes[order]
    bmin_s, bmax_s = bmin[order], bmax[order]
    valid_s = geom.face_valid[order]

    leaf_min = bmin_s.reshape(num_leaves, leaf_size, 3).amin(dim=1)
    leaf_max = bmax_s.reshape(num_leaves, leaf_size, 3).amax(dim=1)
    left, right = _radix_tree(codes_s[::leaf_size].contiguous())

    node_min = torch.cat([torch.full((num_leaves - 1, 3), F32_MAX, device=dev), leaf_min])
    node_max = torch.cat([torch.full((num_leaves - 1, 3), -F32_MAX, device=dev), leaf_max])
    node_min, node_max, iters, syncs = _fit(node_min, node_max, left, right, num_leaves)

    li, ri = left.long(), right.long()
    packed = torch.cat([node_min[li], node_max[li], node_min[ri], node_max[ri]], dim=1)
    child = torch.stack([left, right], dim=1)

    tri = geom.indices[order]
    pos = geom.positions.detach()
    p0, p1, p2 = (take_clip(pos, tri[:, k]) for k in range(3))
    e1 = torch.where(valid_s[:, None], p1 - p0, 0.0)
    e2 = torch.where(valid_s[:, None], p2 - p0, 0.0)
    leaf_rows = torch.cat([p0, e1, e2], dim=1).reshape(num_leaves, leaf_size * 9)

    unified = unified_child = None
    if leaf_size == 2:
        zeros = torch.zeros((num_leaves - 1, 12), device=dev)
        unified = torch.cat([torch.cat([packed, zeros], dim=1),
                             torch.cat([leaf_rows, torch.zeros((num_leaves, 6), device=dev)],
                                       dim=1)])
        unified_child = torch.cat([child, torch.full((num_leaves, 2), -1, dtype=torch.int32,
                                                     device=dev)])
    return LBVH(node_min=node_min, node_max=node_max, left=left, right=right,
                prim=order.to(torch.int32), prim_valid=valid_s, packed=packed, child=child,
                leaf_rows=leaf_rows, unified=unified, unified_child=unified_child,
                leaf_size=leaf_size, fit_iterations=iters, fit_syncs=syncs)
