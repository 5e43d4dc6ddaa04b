"""LBVH stack traversal vectorized over rays (counterpart of
``mcrt_tpu/accel/traverse.py``).

Closest-hit and any-hit queries against ``lbvh.LBVH`` as a lockstep
masked loop: each iteration every live ray processes one node.  An
internal node slab-tests both children; the near child is taken and the
far one pushed when both are entered.  A leaf runs one Moller-Trumbore
test per slot.  A ray whose node gives no next node pops its stack, and
is done (``DONE``) when the stack is empty.  A push is dropped when the
stack is full (``sp == stack_depth``), as in the JAX package.  The JAX
arithmetic is kept as written: ``sd`` replaces |d| <= 1e-12 by +1e-12
(sign dropped), the best t starts at ``min(tmax, F32_MAX)``, the
determinant guard is 1e-9.

Where the JAX package keeps an (S, N) stack updated with one-hot selects
(a TPU lane layout), the port keeps an (N, S) stack and reads and writes
each ray's top with one ``gather`` and one ``scatter``: the same values.

The loop ends when no ray is live.  Testing that is a host sync, so the
loop tests it once every ``SYNC_EVERY`` iterations: once every ray is
``DONE`` an iteration changes nothing (no lane is on, so no hit, push or
pop).  ``STATS`` counts each query's executed iterations and syncs.

No gradient flows through the walk: it runs on detached rays, and the
winner's barycentrics take their gradient in the rays from
``brute.attach_uv`` where a graph is needed.
"""
from __future__ import annotations

import torch

from ..config import BVHConfig
from ..core.types import F32_MAX, Hit, Rays
from ..scene.scene import Geometry, take_clip
from .brute import attach_uv, mt_edges, needs_uv_grad
from .lbvh import LBVH, morton3d

DONE = -1
SYNC_EVERY = 8  # iterations between two tests of the loop's end (host syncs)
STATS = {"queries": 0, "iterations": 0, "syncs": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _detached(rays: Rays) -> Rays:
    return Rays(o=rays.o.detach(), d=rays.d.detach(), tmin=rays.tmin.detach(),
                tmax=rays.tmax.detach(), active=rays.active)


def _ray_terms(rays: Rays):
    """(o, d, inverse d) components; ``sd`` as the JAX package writes it."""
    o, d = rays.o.unbind(1), rays.d.unbind(1)

    def sd(c):
        return torch.where(torch.abs(c) > 1e-12, c, 1e-12)

    return o, d, tuple(1.0 / sd(c) for c in d)


def _slab(o, inv, lo, hi, tmin, tmax):
    """(entered, t_near) of the boxes ``lo``..``hi`` (component triples)."""
    t0 = [(lo[k] - o[k]) * inv[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * inv[k] for k in range(3)]
    t_near = torch.maximum(
        torch.maximum(torch.minimum(t0[0], t1[0]), torch.minimum(t0[1], t1[1])),
        torch.maximum(torch.minimum(t0[2], t1[2]), tmin))
    t_far = torch.minimum(
        torch.minimum(torch.maximum(t0[0], t1[0]), torch.maximum(t0[1], t1[1])),
        torch.minimum(torch.maximum(t0[2], t1[2]), tmax))
    return t_near <= t_far, t_near


def _push(stack, sp, value, can_push):
    """Write ``value`` at each ray's ``sp`` where ``can_push`` (in place)."""
    pos = sp.clamp_max(stack.shape[1] - 1)[:, None]
    old = stack.gather(1, pos)[:, 0]
    stack.scatter_(1, pos, torch.where(can_push, value, old)[:, None])
    return stack


def _pop(stack, sp):
    """Each ray's stack entry at ``sp`` (where ``sp`` is in range)."""
    return stack.gather(1, sp.clamp(0, stack.shape[1] - 1)[:, None])[:, 0]


def _next_node(lane_on, is_leaf, hit_l, tn_l, hit_r, tn_r, lc, rc, stack, sp, blocked):
    """The stack step of one iteration: (cur, stack, sp).  ``blocked`` is
    None for closest-hit walks (any-hit walks pop and end on it)."""
    proc_int = lane_on & ~is_leaf
    both = proc_int & hit_l & hit_r
    near_is_l = tn_l <= tn_r
    near = torch.where(near_is_l, lc, rc)
    far = torch.where(near_is_l, rc, lc)
    only_l = proc_int & hit_l & ~hit_r
    only_r = proc_int & hit_r & ~hit_l

    can_push = both & (sp < stack.shape[1])
    stack = _push(stack, sp, far, can_push)
    sp = sp + can_push.to(sp.dtype)

    goto = torch.where(both, near, torch.where(only_l, lc, torch.where(only_r, rc, DONE)))
    need_pop = lane_on & (goto == DONE)
    if blocked is not None:
        need_pop = need_pop | (lane_on & blocked)
    can_pop = need_pop & (sp > 0)
    sp = sp - can_pop.to(sp.dtype)
    popped = _pop(stack, sp)
    cur = torch.where(lane_on, torch.where(need_pop, torch.where(can_pop, popped, DONE), goto),
                      DONE)
    if blocked is not None:
        cur = torch.where(blocked, DONE, cur)
    return cur, stack, sp


def _lockstep(fetch, leaf_size: int, internal_count: int, rays: Rays, stack_depth: int,
              any_hit: bool, fixed_iters: int | None = None):
    """The loop of ``_traverse`` and ``_traverse_unified``; ``fetch(cur)``
    gives (the box columns (at least 12 (N,) tensors), left ids, right ids,
    the triangle columns (at least 9*leaf_size), leaf ids) of each ray's
    node.  Returns (best_t, best_slot, best_u, best_v, blocked)."""
    if stack_depth < 1:
        raise ValueError("stack_depth must be at least 1")
    n, dev = rays.n, rays.o.device
    o, d, inv = _ray_terms(rays)
    tmin = rays.tmin
    cur = torch.where(rays.active, 0, DONE).to(torch.int32)
    stack = torch.zeros((n, stack_depth), dtype=torch.int32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_t = torch.clamp_max(rays.tmax, F32_MAX)
    best_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)

    def body():
        nonlocal cur, stack, sp, best_t, best_slot, best_u, best_v, blocked
        lane_on = cur >= 0
        is_leaf = cur >= internal_count
        box, lc, rc, tri, leaf_idx = fetch(cur)
        hit_l, tn_l = _slab(o, inv, box[0:3], box[3:6], tmin, best_t)
        hit_r, tn_r = _slab(o, inv, box[6:9], box[9:12], tmin, best_t)
        leaf_on = lane_on & is_leaf
        for slot in range(leaf_size):
            c = tri[slot * 9:slot * 9 + 9]
            t, u, v, hit = mt_edges(*o, *d, c[0:3], c[3:6], c[6:9])
            hit = leaf_on & hit & (t > tmin) & (t < best_t)
            best_slot = torch.where(hit, leaf_idx * leaf_size + slot, best_slot)
            best_u = torch.where(hit, u, best_u)
            best_v = torch.where(hit, v, best_v)
            best_t = torch.where(hit, t, best_t)
            if any_hit:
                blocked = blocked | hit
        cur, stack, sp = _next_node(lane_on, is_leaf, hit_l, tn_l, hit_r, tn_r, lc, rc, stack,
                                    sp, blocked if any_hit else None)

    STATS["queries"] += 1
    if fixed_iters is not None:  # instrumentation: exactly this many steps
        for _ in range(fixed_iters):
            body()
        STATS["iterations"] += fixed_iters
    else:
        while True:
            STATS["syncs"] += 1
            if not bool((cur >= 0).any()):
                break
            for _ in range(SYNC_EVERY):
                body()
            STATS["iterations"] += SYNC_EVERY
    return best_t, best_slot, best_u, best_v, blocked


def _internal(bvh: LBVH, cur):
    """(box columns, left ids, right ids) of each ray's internal node, the
    index clamped into range.  A tree of one leaf has no internal node: its
    root is the leaf, and lanes on a leaf never read these."""
    n_int = bvh.num_leaves - 1
    if n_int == 0:
        return ((torch.zeros(cur.shape, device=cur.device),) * 12, torch.full_like(cur, DONE),
                torch.full_like(cur, DONE))
    inode = cur.clamp(0, n_int - 1).long()
    ch = bvh.child.index_select(0, inode)
    return bvh.packed.index_select(0, inode).unbind(1), ch[:, 0], ch[:, 1]


def _traverse(bvh: LBVH, rays: Rays, stack_depth: int, any_hit: bool,
              fixed_iters: int | None = None):
    """The lockstep loop over the split tables (``packed``/``child`` for
    internal nodes, ``leaf_rows`` for leaves; any leaf size).  Returns
    (best_t, best_slot, best_u, best_v, blocked); best_slot indexes
    ``bvh.prim`` (leaf * leaf_size + slot), -1 on a miss."""
    n_leaves = bvh.num_leaves
    internal_count = n_leaves - 1

    def fetch(cur):
        leaf_idx = (cur - internal_count).clamp(0, n_leaves - 1)
        tri = bvh.leaf_rows.index_select(0, leaf_idx.long())
        return (*_internal(bvh, cur), tri.unbind(1), leaf_idx)

    return _lockstep(fetch, bvh.leaf_size, internal_count, rays, stack_depth, any_hit,
                     fixed_iters)


def _traverse_unified(bvh: LBVH, rays: Rays, stack_depth: int, any_hit: bool):
    """The lockstep loop over the unified table (leaf size 2): one row
    gather and one child gather per iteration; internal lanes read the box
    columns of their row, leaf lanes the triangle columns."""
    n_leaves = bvh.num_leaves
    internal_count = n_leaves - 1
    num_nodes = 2 * n_leaves - 1

    def fetch(cur):
        node = cur.clamp(0, num_nodes - 1).long()
        cols = bvh.unified.index_select(0, node).unbind(1)
        ch = bvh.unified_child.index_select(0, node)
        return cols, ch[:, 0], ch[:, 1], cols, (cur - internal_count).clamp(0, n_leaves - 1)

    return _lockstep(fetch, 2, internal_count, rays, stack_depth, any_hit)


def traversal_iterations(bvh: LBVH, rays: Rays, stack_depth: int = 64):
    """Diagnostic: (lockstep iterations, per-ray node visits) of a walk
    that only follows node pointers (a leaf enters no child, so it pops;
    boxes are tested against the rays' tmax).  The JAX loop runs until the last ray is
    done, so its count is the most visits of any ray."""
    rays = _detached(rays)
    n, dev = rays.n, rays.o.device
    internal_count = bvh.num_leaves - 1
    o, _, inv = _ray_terms(rays)
    cur = torch.where(rays.active, 0, DONE).to(torch.int32)
    stack = torch.zeros((n, stack_depth), dtype=torch.int32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int32, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    while bool((cur >= 0).any()):
        for _ in range(SYNC_EVERY):
            lane_on = cur >= 0
            is_leaf = cur >= internal_count
            box, lc, rc = _internal(bvh, cur)
            hit_l, tn_l = _slab(o, inv, box[0:3], box[3:6], rays.tmin, rays.tmax)
            hit_r, tn_r = _slab(o, inv, box[6:9], box[9:12], rays.tmin, rays.tmax)
            cur, stack, sp = _next_node(lane_on, is_leaf, hit_l, tn_l, hit_r, tn_r, lc, rc,
                                        stack, sp, None)
            visits = visits + lane_on.to(torch.int32)
    return int(visits.max()) if n else 0, visits


def _coherence_order(rays: Rays) -> torch.Tensor:
    """Ray permutation grouping rays by direction: a stable sort of 24
    bits of the direction's Morton code."""
    code = morton3d(rays.d * 0.5 + 0.5) >> 6
    return torch.sort(code, stable=True).indices


def _run_chunked(bvh: LBVH, rays: Rays, stack_depth: int, any_hit: bool, chunk: int):
    """The walk over all rays at once (``chunk <= 0``), or over
    coherence-sorted chunks of ``chunk`` rays, each ending at its own
    slowest ray; results in the rays' order."""
    def core(r):
        if bvh.unified is not None:
            return _traverse_unified(bvh, r, stack_depth, any_hit)
        return _traverse(bvh, r, stack_depth, any_hit)

    n = rays.n
    if chunk <= 0 or n <= chunk:
        return core(rays)
    pad = (-n) % chunk
    order = _coherence_order(rays)

    def take_ray(a):
        a = a[order]
        if pad:
            a = torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype, device=a.device)])
        return a

    r = Rays(o=take_ray(rays.o), d=take_ray(rays.d), tmin=take_ray(rays.tmin),
             tmax=take_ray(rays.tmax), active=take_ray(rays.active))
    outs = [core(Rays(o=r.o[s:s + chunk], d=r.d[s:s + chunk], tmin=r.tmin[s:s + chunk],
                      tmax=r.tmax[s:s + chunk], active=r.active[s:s + chunk]))
            for s in range(0, n + pad, chunk)]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=order.device)
    return tuple(torch.cat(parts)[pos] for parts in zip(*outs))


def intersect_bvh(geom: Geometry, bvh: LBVH, rays: Rays, cfg: BVHConfig | None = None,
                  chunk: int = 0) -> Hit:
    """Closest-hit query."""
    cfg = cfg or BVHConfig()
    best_t, best_slot, best_u, best_v, _ = _run_chunked(bvh, _detached(rays), cfg.stack_depth,
                                                        False, chunk)
    found = best_slot >= 0
    slot = best_slot.clamp_min(0)
    prim = torch.where(found, take_clip(bvh.prim, slot), -1)
    valid = found & rays.active
    if needs_uv_grad(rays):
        row = take_clip(bvh.leaf_rows.reshape(-1, 9), slot)
        best_u, best_v = attach_uv(best_u, best_v, found, rays, row[:, 0:3], row[:, 3:6],
                                   row[:, 6:9])
    shape = torch.where(valid, take_clip(geom.face_shape, prim.clamp_min(0)), -1)
    return Hit(t=torch.where(valid, best_t, F32_MAX), prim=prim.to(torch.int32),
               shape=shape.to(torch.int32), u=best_u, v=best_v, valid=valid)


def occluded_bvh(geom: Geometry, bvh: LBVH, rays: Rays, cfg: BVHConfig | None = None,
                 chunk: int = 0) -> torch.Tensor:
    """Any-hit query with an early end per ray: (N,) bool."""
    cfg = cfg or BVHConfig()
    *_, blocked = _run_chunked(bvh, _detached(rays), cfg.stack_depth, True, chunk)
    return blocked & rays.active
