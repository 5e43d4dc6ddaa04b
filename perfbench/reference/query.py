"""The reference's ray queries: every triangle tested by Moller-Trumbore,
culled only by boxes of 64 faces.

It shares no code and no layout with the program's accels.  Faces are put
in Morton order of their centroids over the scene's bounds and cut into
clusters of ``CLUSTER`` faces, each with its bounding box (widened by a
relative 1e-5).  A query tests each live ray against every box, then
against every face of each box it meets, in chunks of (ray, box) pairs.
The closest hit is the least t, and on equal t the face of the lowest id,
whatever the chunking; the triangle test is the port's brute-force oracle's
arithmetic (``moller_trumbore``, frozen below), so an exact answer has
the oracle's t, u and v.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import F32_MAX, Hit, Rays

CLUSTER = 64
_DET_EPS = 1e-9
# rays a box test holds ((RAY_CHUNK, clusters) temporaries) and (ray, box)
# pairs a face test holds ((PAIR_CHUNK, CLUSTER) temporaries), by device type
RAY_CHUNK = {"cuda": 16384, "cpu": 1024}
PAIR_CHUNK = {"cuda": 1 << 17, "cpu": 1 << 12}


def mt_edges(ox, oy, oz, dx, dy, dz, p0, e1, e2, eps: float = _DET_EPS):
    """Moller-Trumbore on precomputed edges ``e1 = p1 - p0``, ``e2 = p2 -
    p0``, each of ``p0``, ``e1``, ``e2`` a triple of components: the port's
    oracle's arithmetic (cross and dot products summed x + y + z, a 1e-9
    determinant guard).  Returns (t, u, v, hit)."""
    pvx = dy * e2[2] - dz * e2[1]
    pvy = dz * e2[0] - dx * e2[2]
    pvz = dx * e2[1] - dy * e2[0]
    det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
    ok = torch.abs(det) > eps
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - p0[0], oy - p0[1], oz - p0[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1[2] - tvz * e1[1]
    qvy = tvz * e1[0] - tvx * e1[2]
    qvz = tvx * e1[1] - tvy * e1[0]
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def _morton3(q: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of (n, 3) integer cells in [0, 1024)."""
    def spread(x):
        x = x.astype(np.uint64) & np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x
    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


class ClusterQuery:
    """Closest-hit and any-hit queries over host arrays ``positions`` (V, 3)
    and ``indices`` (F, 3), with ``face_shape`` (F,) for the hit's shape."""

    def __init__(self, positions, indices, face_shape, device):
        pos = np.asarray(positions, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        f = idx.shape[0]
        tri = pos[idx]  # (F, 3 vertices, 3)
        cen = tri.mean(axis=1)
        lo, hi = cen.min(0), cen.max(0)
        q = ((cen - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.int64)
        order = np.argsort(_morton3(np.clip(q, 0, 1023)), kind="stable")
        n_cl = -(-f // CLUSTER)
        ids = np.full((n_cl * CLUSTER,), -1, np.int64)
        ids[:f] = order
        valid = ids >= 0
        t_sorted = tri[np.where(valid, ids, 0)]  # (C*K, 3, 3)
        t_sorted[~valid] = 0.0  # a degenerate face: its determinant is 0, never a hit
        box = t_sorted.reshape(n_cl, CLUSTER * 3, 3)
        vmask = np.repeat(valid.reshape(n_cl, CLUSTER), 3, axis=1)[..., None]
        blo = np.where(vmask, box, np.inf).min(1)
        bhi = np.where(vmask, box, -np.inf).max(1)
        pad = 1e-5 * np.maximum(np.abs(blo), np.abs(bhi)) + 1e-6
        f32 = torch.float32
        self.device = torch.device(device)
        self.box_lo = torch.as_tensor(blo - pad, dtype=f32, device=device)
        self.box_hi = torch.as_tensor(bhi + pad, dtype=f32, device=device)
        self.face_id = torch.as_tensor(ids, device=device)  # (C*K,) -1 padding
        p0 = t_sorted[:, 0]
        self.p0 = torch.as_tensor(p0, dtype=f32, device=device)
        self.e1 = torch.as_tensor(t_sorted[:, 1] - p0, dtype=f32, device=device)
        self.e2 = torch.as_tensor(t_sorted[:, 2] - p0, dtype=f32, device=device)
        self.face_shape = torch.as_tensor(np.asarray(face_shape, np.int64), device=device)
        self.num_faces = f

    def _pairs(self, o, d, tmin, tmax):
        """(ray, cluster) pairs whose box the ray's segment meets."""
        inv = 1.0 / torch.where(torch.abs(d) < 1e-30, torch.full_like(d, 1e-30), d)
        rows, cols = [], []
        step = RAY_CHUNK[self.device.type]
        for s in range(0, o.shape[0], step):
            oo, ii = o[s:s + step, None, :], inv[s:s + step, None, :]
            t1 = (self.box_lo[None] - oo) * ii
            t2 = (self.box_hi[None] - oo) * ii
            near = torch.maximum(torch.minimum(t1, t2).amax(-1), tmin[s:s + step, None])
            far = torch.minimum(torch.maximum(t1, t2).amin(-1), tmax[s:s + step, None])
            r, c = torch.nonzero(near <= far, as_tuple=True)
            rows.append(r + s)
            cols.append(c)
        return torch.cat(rows), torch.cat(cols)

    def _test(self, o, d, tmin, tmax, rows, cols):
        """Per chunk of pairs: (rows, t, face ids, hit), the last three
        (pairs, CLUSTER)."""
        k = torch.arange(CLUSTER, device=self.device)
        step = PAIR_CHUNK[self.device.type]
        for s in range(0, rows.shape[0], step):
            r, c = rows[s:s + step], cols[s:s + step]
            slot = c[:, None] * CLUSTER + k[None, :]
            p0, e1, e2 = (x[slot].unbind(-1) for x in (self.p0, self.e1, self.e2))
            ro, rd = o[r][:, None, :].unbind(-1), d[r][:, None, :].unbind(-1)
            t, _, _, hit = mt_edges(*ro, *rd, p0, e1, e2)
            hit = hit & (t > tmin[r, None]) & (t < tmax[r, None])
            yield r, t, self.face_id[slot], hit

    def intersect(self, scene, rays: Rays) -> Hit:
        n, dev = rays.n, rays.o.device
        live = torch.nonzero(rays.active, as_tuple=True)[0]
        o, d = rays.o.detach()[live], rays.d.detach()[live]
        tmin, tmax = rays.tmin.detach()[live], rays.tmax.detach()[live]
        m = live.shape[0]
        best_t = torch.full((m,), F32_MAX, dtype=torch.float32, device=dev)
        if m:
            rows, cols = self._pairs(o, d, tmin, tmax)
            for r, t, _, hit in self._test(o, d, tmin, tmax, rows, cols):
                tt = torch.where(hit, t, F32_MAX).amin(-1)
                best_t = best_t.scatter_reduce(0, r, tt, reduce="amin")
            big = torch.iinfo(torch.int64).max
            best_f = torch.full((m,), big, dtype=torch.int64, device=dev)
            for r, t, fid, hit in self._test(o, d, tmin, tmax, rows, cols):
                win = hit & (t == best_t[r, None]) & (best_t[r, None] < F32_MAX)
                ff = torch.where(win, fid, big).amin(-1)
                best_f = best_f.scatter_reduce(0, r, ff, reduce="amin")
        else:
            best_f = torch.zeros((0,), dtype=torch.int64, device=dev)
        found = best_f < self.num_faces
        face = torch.where(found, best_f, 0)
        pos = scene.geometry.positions.detach()
        tri = scene.geometry.indices.long()[face]
        p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        t, u, v, _ = mt_edges(*o.unbind(-1), *d.unbind(-1), p0.unbind(-1),
                              (p1 - p0).unbind(-1), (p2 - p0).unbind(-1))
        hit = Hit.none(n, dev)
        put = live[found]
        return Hit(t=hit.t.index_put((put,), t[found]),
                   prim=hit.prim.index_put((put,), face[found].to(torch.int32)),
                   shape=hit.shape.index_put((put,), self.face_shape[face[found]].to(torch.int32)),
                   u=hit.u.index_put((put,), u[found]), v=hit.v.index_put((put,), v[found]),
                   valid=hit.valid.index_put((put,), torch.ones_like(put, dtype=torch.bool)))

    def occluded(self, scene, rays: Rays) -> torch.Tensor:
        n, dev = rays.n, rays.o.device
        live = torch.nonzero(rays.active, as_tuple=True)[0]
        blocked = torch.zeros((live.shape[0],), dtype=torch.int64, device=dev)
        if live.shape[0]:
            o, d = rays.o.detach()[live], rays.d.detach()[live]
            tmin, tmax = rays.tmin.detach()[live], rays.tmax.detach()[live]
            rows, cols = self._pairs(o, d, tmin, tmax)
            for r, _, _, hit in self._test(o, d, tmin, tmax, rows, cols):
                blocked = blocked.scatter_reduce(0, r, hit.any(-1).long(), reduce="amax")
        out = torch.zeros((n,), dtype=torch.bool, device=dev)
        return out.index_put((live,), blocked.bool())
