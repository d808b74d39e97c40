"""Semantic Bayesian-Kernel-Inference occupancy mapping — the L7 module.

Reference: src/mapping/{bkioctomap,bkiblock,bkioctree}.cpp (SemanticBKIOctoMap,
insert_pointcloud_csm, bkioctomap.h:31-140): per-voxel Dirichlet
concentration vectors alpha over semantic classes (class 0 = free) updated
by sparse-kernel-weighted evidence from measured points, plus ray-cast
free-space samples.

Redesign (static shapes): the block/octree/RTree machinery exists to bound CPU
neighbor search; here every insert is one device program — all (point,
candidate-voxel) contributions are generated with static shapes, kernel
weights evaluated on the device, duplicates reduced by a multi-operand
`lax.sort` over the voxel coordinates followed by a sorted `segment_sum`
(the same sort-carrying-payload pattern `ops/neighbors.py` profiles as the
fastest K-reduction on this chip). The host keeps the persistent map as a
sorted int64-key array + dense alpha matrix; merging a scan is vectorized
(sort + add.reduceat + in-place add), and queries are `searchsorted` — no
per-point Python anywhere. Free-space evidence is ray-cast as a padded
[N, S] sample lattice instead of a per-ray loop.

The sparse BKI kernel (Melkumyan & Ramos; used by S-BKI):
  k(d) = sigma0 * [ (2 + cos(2 pi d/l)) (1 - d/l) / 3 + sin(2 pi d/l)/(2 pi) ]
for d < l, else 0.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

# key packing: 21 bits per signed voxel coordinate (host-side int64)
_KEY_BIAS = 1 << 20
_KEY_BITS = 21
# device sentinel pushing dead slots to the end of the sort
_DEAD = np.int32(1 << 30)

# points per device dispatch; every blocking transfer stalls the device
# queue, so chunks are sized to make dispatches rare, bounded by the
# [N*M(, C+1)] intermediates
_CHUNK_WIDE = 8192     # general evidence: [N*M, C+1] gather + segment sum
_CHUNK_SCALAR = 32768  # rank-1 evidence: scalar segment sum only


def sparse_kernel(d: np.ndarray, ell: float, sigma0: float) -> np.ndarray:
    """NumPy twin of the device kernel (kept for tests / host callers)."""
    r = np.clip(d / ell, 0.0, 1.0)
    k = sigma0 * ((2.0 + np.cos(2 * np.pi * r)) * (1.0 - r) / 3.0
                  + np.sin(2 * np.pi * r) / (2 * np.pi))
    return np.where(d < ell, np.maximum(k, 0.0), 0.0)


def _pack_keys(vox: np.ndarray) -> np.ndarray:
    """[V, 3] int voxel coords -> sorted-comparable int64 keys."""
    v = vox.astype(np.int64) + _KEY_BIAS
    return (v[:, 0] << (2 * _KEY_BITS)) | (v[:, 1] << _KEY_BITS) | v[:, 2]


def _spread21(x: np.ndarray) -> np.ndarray:
    """Interleave 21 bits with two zero bits each (host Morton helper)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _morton_keys(vox: np.ndarray) -> np.ndarray:
    """[V, 3] int voxel coords -> Morton codes, so sorted runs are spatially
    compact cubes (bounds both the chunk-local key span and cross-chunk
    duplicate voxels)."""
    v = vox.astype(np.int64) + _KEY_BIAS
    return (_spread21(v[:, 0]) | (_spread21(v[:, 1]) << np.uint64(1))
            | (_spread21(v[:, 2]) << np.uint64(2))).astype(np.uint64)


@functools.lru_cache(maxsize=None)
def _kernel_offsets(reach: int, res_q: float, ell_q: float) -> np.ndarray:
    """Static candidate-voxel offsets: the cube [-reach, reach]^3 pruned to
    offsets whose *minimum possible* point-to-center distance is < ell
    (per-axis min |delta| = max(|off| - 0.5, 0) * res for a point anywhere
    inside its own voxel). Exact: every pruned offset has kernel weight 0."""
    offs = np.arange(-reach, reach + 1)
    grid = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"), -1).reshape(-1, 3)
    dmin = np.linalg.norm(np.maximum(np.abs(grid) - 0.5, 0.0) * res_q, axis=1)
    return np.ascontiguousarray(grid[dmin < ell_q].astype(np.int32))


def _chunk_weights(pts, valid, offsets, origin_vox, res, ell, sigma0, n, m):
    """Shared front half: candidate voxels (chunk-local coords), kernel
    weights, flattened single-int32 keys (lx<<20 | ly<<10 | lz — callers
    guarantee local spans < 1024 via the Morton-chunk guard)."""
    base = jnp.floor(pts / res).astype(jnp.int32)                # [n, 3]
    vox = base[:, None, :] + offsets[None, :, :]                 # [n, m, 3]
    centers = (vox.astype(jnp.float32) + 0.5) * res
    d = jnp.linalg.norm(centers - pts[:, None, :], axis=-1)      # [n, m]
    r = jnp.clip(d / ell, 0.0, 1.0)
    k = sigma0 * ((2.0 + jnp.cos(2 * jnp.pi * r)) * (1.0 - r) / 3.0
                  + jnp.sin(2 * jnp.pi * r) / (2 * jnp.pi))
    w = jnp.where((d < ell) & valid[:, None], jnp.maximum(k, 0.0), 0.0)
    loc = vox - origin_vox[None, None, :]                        # [n, m, 3]
    # defensive: a local coord outside [0, 1023] would corrupt the OR-packed
    # key (negative int32 sets all high bits); kill such candidates
    in_key = jnp.all((loc >= 0) & (loc < 1024), axis=-1)         # [n, m]
    key = ((loc[..., 0] << 20) | (loc[..., 1] << 10)
           | loc[..., 2]).reshape(-1)                            # [n*m]
    wf = jnp.where(in_key, w, 0.0).reshape(-1)
    key = jnp.where(wf > 0, key, _DEAD)
    return key, wf


def _pack_hilo_device(vox_biased):
    """[R, 3] int32 biased 21-bit voxel coords -> (hi, lo) uint32 pair whose
    lexicographic order equals the host int64 key order (_pack_keys):
    hi = x(21) | y_top(11), lo = y_low(10) | z(21)."""
    x = vox_biased[:, 0].astype(jnp.uint32)
    y = vox_biased[:, 1].astype(jnp.uint32)
    z = vox_biased[:, 2].astype(jnp.uint32)
    hi = (x << 11) | (y >> 10)
    lo = ((y & jnp.uint32(0x3FF)) << 21) | z
    return hi, lo


_SENT = np.uint32(0xFFFFFFFF)   # dead-row sentinel: sorts last in uint32


def _unpack_hilo_host(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 -> int64 packed keys (same value as _pack_keys)."""
    hi = hi.astype(np.int64)
    lo = lo.astype(np.int64)
    x = hi >> 11
    y = ((hi & 0x7FF) << 10) | (lo >> 21)
    z = lo & 0x1FFFFF
    return (x << (2 * _KEY_BITS)) | (y << _KEY_BITS) | z


@functools.lru_cache(maxsize=None)
def _chunk_globalize_fn(cap: int, c1: int):
    """Jitted: chunk-local compacted output -> global (hi, lo) keys +
    alpha rows, dead rows sentineled. No host transfer anywhere."""

    def run(keys_loc, alpha, nseg, bmin):
        lx = keys_loc >> 20
        ly = (keys_loc >> 10) & 0x3FF
        lz = keys_loc & 0x3FF
        vox = (jnp.stack([lx, ly, lz], axis=1)
               + bmin[None, :] + jnp.int32(_KEY_BIAS))
        hi, lo = _pack_hilo_device(vox)
        ok = jnp.arange(cap, dtype=jnp.int32) < nseg
        hi = jnp.where(ok, hi, _SENT)
        lo = jnp.where(ok, lo, _SENT)
        alpha = jnp.where(ok[:, None], alpha, 0.0)
        return hi, lo, alpha

    return jax.jit(run)


def _segment_rows_sum(contrib, segid, nm, c1):
    """Per-segment sums of [nm, c1] rows with SORTED segment ids, without a
    wide segment_sum: `jax.ops.segment_sum` on a minor-dim-c1 operand
    lowers to a per-index scatter-add; the cumsum-diff formulation is
    pure streaming.

    alpha[s] = cum[end(s)] - cum[end(s-1)] where cum is the running prefix
    over rows and end(s) is each segment's last row. Precision: f32 prefix
    totals reach ~sigma0 * nm, so per-class absolute error is bounded by
    ~eps * sigma0 * nm (~0.01 for a 2M-row chunk at sigma0=0.1) — far
    below sensor noise on any alpha this map accumulates."""
    cum = jnp.cumsum(contrib, axis=0)
    pos = jax.ops.segment_min(jnp.arange(nm, dtype=jnp.int32), segid,
                              num_segments=nm, indices_are_sorted=True)
    nxt = jnp.concatenate([pos[1:], jnp.full((1,), nm, jnp.int32)])
    end = jnp.clip(nxt - 1, 0, nm - 1)
    cum_end = cum[end]                                       # [nm, c1]
    return cum_end - jnp.concatenate(
        [jnp.zeros((1, c1), cum.dtype), cum_end[:-1]])


@functools.lru_cache(maxsize=None)
def _merge_fn(rows: int, c1: int, prior: float, n_src: int = 0):
    """Jitted device merge: (batch ++ map) -> sorted unique voxels.

    Sorts the (hi, lo) key pairs carrying a row index (2-key lex sort ==
    int64 key order), gathers alpha rows once, segment-reduces duplicates,
    and adds the Dirichlet prior to voxels that carry no map row. Valid
    unique voxels land in a prefix (sentinels sort last); only the new
    size crosses to the host.

    n_src > 0 asserts that every concatenated source (each chunk, the
    map) holds a voxel AT MOST ONCE, so segments have <= n_src rows and
    the alpha reduction is n_src-1 EXACT shifted adds gathered at the
    segment heads — a wide sorted segment_sum lowers to a per-index
    scatter-add."""

    def run(hi, lo, alpha, from_map):
        idx = jnp.arange(rows, dtype=jnp.int32)
        hi_s, lo_s, idx_s = lax.sort((hi, lo, idx), num_keys=2)
        al_s = alpha[idx_s]
        fm_s = from_map[idx_s]
        newseg = jnp.concatenate(
            [jnp.ones((1,), bool),
             (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])])
        segid = jnp.cumsum(newseg.astype(jnp.int32)) - 1
        valid_row = hi_s != _SENT
        nseg = jnp.sum((newseg & valid_row).astype(jnp.int32))
        if n_src > 0:
            total = al_s
            for k in range(1, n_src):
                same = segid[k:] == segid[:-k]
                shifted = jnp.concatenate(
                    [al_s[k:], jnp.zeros((k, c1), al_s.dtype)])
                total = total + jnp.where(
                    jnp.concatenate([same, jnp.zeros((k,), bool)])[:, None],
                    shifted, 0.0)
            head = jax.ops.segment_min(idx, segid, num_segments=rows,
                                       indices_are_sorted=True)
            al_out = total[jnp.clip(head, 0, rows - 1)]
        else:
            al_out = _segment_rows_sum(al_s, segid, rows, c1)
        fm_out = jax.ops.segment_max(fm_s, segid, num_segments=rows,
                                     indices_are_sorted=True)
        hi_out = jax.ops.segment_min(hi_s, segid, num_segments=rows,
                                     indices_are_sorted=True)
        lo_out = jax.ops.segment_min(lo_s, segid, num_segments=rows,
                                     indices_are_sorted=True)
        row_ok = jnp.arange(rows, dtype=jnp.int32) < nseg
        al_out = al_out + jnp.where(
            row_ok & (fm_out == 0), jnp.float32(prior), 0.0)[:, None]
        al_out = jnp.where(row_ok[:, None], al_out, 0.0)
        hi_out = jnp.where(row_ok, hi_out, _SENT)
        lo_out = jnp.where(row_ok, lo_out, _SENT)
        return hi_out, lo_out, al_out, nseg

    return jax.jit(run)


def _segment_starts(keys):
    newseg = jnp.concatenate(
        [jnp.ones((1,), bool), keys[1:] != keys[:-1]])
    segid = jnp.cumsum(newseg.astype(jnp.int32)) - 1
    return newseg & (keys < _DEAD), segid


def _compact(ks, segid, nm, start, alpha):
    """Per-segment key prefix + valid-segment count, so the host transfers
    exactly the meaningful rows (dead rows all share _DEAD and form the
    final segment, hence valid segments are a prefix)."""
    out_keys = jax.ops.segment_min(ks, segid, num_segments=nm,
                                   indices_are_sorted=True)
    nseg = jnp.sum(start.astype(jnp.int32))
    return out_keys, nseg, alpha


@functools.lru_cache(maxsize=None)
def _scatter_fn(n: int, m: int, c1: int):
    """Jitted (point-chunk -> unique-voxel [*, c1] contributions) for
    general per-point evidence rows."""

    def run(pts, ev, valid, offsets, origin_vox, res, ell, sigma0):
        key, wf = _chunk_weights(pts, valid, offsets, origin_vox,
                                 res, ell, sigma0, n, m)
        nidx = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32)[:, None], (n, m)).reshape(-1)
        # one single-key sort carrying (weight, point-index) payloads; dead
        # slots sort last so valid segments are a prefix
        ks, ws, ns = lax.sort((key, wf, nidx), num_keys=1)
        start, segid = _segment_starts(ks)
        contrib = ws[:, None] * ev[ns]                           # [n*m, c1]
        alpha = _segment_rows_sum(contrib, segid, n * m, c1)
        return _compact(ks, segid, n * m, start, alpha)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _scatter_fn_scalar(n: int, m: int):
    """Jitted scalar-evidence variant: every point's evidence is
    scale[p] * (one shared direction) — free-space rays and unlabeled
    occupied inserts — so the reduction is a scalar segment sum, no
    [n*m, c1] gather/scatter."""

    def run(pts, scale, valid, offsets, origin_vox, res, ell, sigma0):
        key, wf = _chunk_weights(pts, valid, offsets, origin_vox,
                                 res, ell, sigma0, n, m)
        ws = jnp.broadcast_to(scale[:, None], (n, m)).reshape(-1) * wf
        ks, ws = lax.sort((key, ws), num_keys=1)
        start, segid = _segment_starts(ks)
        alpha = jax.ops.segment_sum(ws, segid, num_segments=n * m,
                                    indices_are_sorted=True)
        return _compact(ks, segid, n * m, start, alpha)

    return jax.jit(run)


@dataclasses.dataclass
class SemanticBKIMap:
    """Flat-voxel semantic BKI map. Class 0 is free space; classes 1..C are
    semantic categories (reference convention, bkioctree_node semantics).

    Persistent state is two host arrays — `_keys` (sorted int64 packed voxel
    coords, [V]) and `_alpha` ([V, C+1] float32 Dirichlet concentrations) —
    so queries and merges are O(V log V) vectorized ops."""

    resolution: float = 0.1
    num_classes: int = 19          # semantic classes (excluding free)
    ell: float = 0.3               # BKI kernel support
    sigma0: float = 1.0
    prior: float = 0.001           # Dirichlet prior per class
    free_resolution: float = 0.5   # spacing of free-space ray samples

    def __post_init__(self):
        self._keys = np.zeros((0,), np.int64)
        self._alpha = np.zeros((0, self.num_classes + 1), np.float32)
        # device-resident map (uint32 key pair + alpha, power-of-two
        # capacity); the host mirror above is refreshed lazily on query
        self._dev = None          # dict(hi, lo, alpha) device arrays
        self._dev_size = 0
        self._host_clean = True

    def __len__(self):
        return self._dev_size if self._dev is not None else len(self._keys)

    # ---------------------------------------------------------------- insert

    def _chunk_walk(self, positions: np.ndarray, rows: np.ndarray,
                    chunk: int, dispatch, expand):
        """Morton-sort `positions`, walk them in spatially-compact chunks
        whose local voxel span fits the 10-bit packed key, call
        `dispatch(pts, rows, valid, origin_vox)` per chunk, and merge the
        per-chunk unique-voxel contributions into the map. `expand` turns a
        chunk's device alpha output into [U, C+1] host rows.

        Per chunk the host blocks exactly twice (the valid-segment count,
        then the compacted prefix)."""
        res = self.resolution
        reach = int(np.ceil(self.ell / res))
        # base voxel coords from the SAME float32 values and division the
        # device floor sees (_chunk_weights line ~102) — float64 here can
        # disagree by one voxel at ~1e-5 boundaries, and a chunk-extremal
        # disagreement would corrupt the 10-bit packed local key
        base_all = np.floor(np.asarray(positions, np.float32)
                            / np.float32(res)).astype(np.int64)
        order = np.argsort(_morton_keys(base_all), kind="stable")
        pos32 = np.asarray(positions, np.float32)[order]
        rows = rows[order]
        base_all = base_all[order]
        span_cap = (1 << 10) - 1

        pend = []

        def emit(lo, hi):
            bmin = base_all[lo:hi].min(0) - reach
            span = base_all[lo:hi].max(0) + reach - bmin
            if span.max() >= span_cap:
                if hi - lo == 1:  # cannot happen for reach < 511, kept safe
                    raise ValueError("BKI kernel reach exceeds key span")
                mid = (lo + hi) // 2
                emit(lo, mid)
                emit(mid, hi)
                return
            pad = chunk - (hi - lo)
            pts = np.pad(pos32[lo:hi], ((0, pad), (0, 0)))
            rws = np.pad(rows[lo:hi],
                         ((0, pad),) + ((0, 0),) * (rows.ndim - 1))
            valid = np.zeros(chunk, bool)
            valid[: hi - lo] = True
            pend.append((bmin, *dispatch(pts, rws, valid, bmin)))

        for lo in range(0, len(pos32), chunk):
            emit(lo, min(lo + chunk, len(pos32)))
        if not pend:
            return
        # ONE host sync for all chunk segment counts instead of two per
        # chunk
        nsegs = np.asarray(jnp.stack([p[2] for p in pend]))
        c1 = self.num_classes + 1
        parts = []
        for (bmin, keys_d, _, alpha_d), nseg in zip(pend, nsegs):
            if nseg == 0:
                continue
            # power-of-two cap bounds compile variety to ~log2(n*m)
            cap = min(keys_d.shape[0],
                      1 << max(14, (int(nseg) - 1).bit_length()))
            gl = _chunk_globalize_fn(cap, c1)
            parts.append(gl(keys_d[:cap], expand(alpha_d[:cap]),
                            jnp.int32(nseg), jnp.asarray(bmin, jnp.int32)))
        if parts:
            self._merge_device(parts)

    def _merge_device(self, parts):
        """Fold per-chunk (hi, lo, alpha) device arrays into the
        device-resident map: one 2-key sort + segment reduce, one scalar
        host sync (the new size) to pick the next capacity bucket."""
        c1 = self.num_classes + 1
        his = [p[0] for p in parts]
        los = [p[1] for p in parts]
        als = [p[2] for p in parts]
        fms = [jnp.zeros(p[0].shape, jnp.float32) for p in parts]
        if self._dev is not None:
            his.append(self._dev["hi"])
            los.append(self._dev["lo"])
            als.append(self._dev["alpha"])
            fms.append(jnp.ones(self._dev["hi"].shape, jnp.float32))
        hi = jnp.concatenate(his)
        lo = jnp.concatenate(los)
        al = jnp.concatenate(als)
        fm = jnp.concatenate(fms)
        # pad the batch to a power of two so the merge program's shape
        # variety stays logarithmic
        rows = hi.shape[0]
        rows_p = 1 << (rows - 1).bit_length()
        if rows_p != rows:
            padn = rows_p - rows
            hi = jnp.concatenate([hi, jnp.full((padn,), _SENT)])
            lo = jnp.concatenate([lo, jnp.full((padn,), _SENT)])
            al = jnp.concatenate([al, jnp.zeros((padn, c1), jnp.float32)])
            fm = jnp.concatenate([fm, jnp.zeros((padn,), jnp.float32)])
        # cap the exact shifted-add unroll: each extra source is a full
        # [rows, c1] pass AND a fresh compiled program per source count.
        # Inserts beyond the cap (>12
        # chunks ~ >98k occupied points at once) take the streaming
        # cumsum-diff reduction (n_src=0) — its f32 prefix error scales
        # with the total alpha mass in the merge, so the exact path is
        # preferred whenever the unroll stays cheap.
        n_src = len(his) if len(his) <= 12 else 0
        hi_o, lo_o, al_o, nseg_d = _merge_fn(
            rows_p, c1, float(self.prior), n_src=n_src)(hi, lo, al, fm)
        size = int(nseg_d)                       # the ONE merge host sync
        cap = 1 << max(14, (size - 1).bit_length()) if size else 1 << 14
        cap = min(cap, rows_p)
        self._dev = {"hi": hi_o[:cap], "lo": lo_o[:cap],
                     "alpha": al_o[:cap]}
        self._dev_size = size
        self._host_clean = False

    def _sync_host(self):
        """Refresh the host mirror (_keys/_alpha) from the device map —
        lazily, only when a query/export needs it."""
        if self._dev is None or self._host_clean:
            return
        size = self._dev_size
        hi, lo, al = jax.device_get(
            (self._dev["hi"], self._dev["lo"], self._dev["alpha"]))
        self._keys = _unpack_hilo_host(hi[:size], lo[:size])
        self._alpha = np.asarray(al[:size], np.float32)
        self._host_clean = True

    def _accumulate(self, positions: np.ndarray, evidence: np.ndarray):
        """Scatter kernel-weighted evidence [N, C+1] from points onto all
        voxels within the kernel support (device program + host merge)."""
        if len(positions) == 0:
            return
        res, c1 = self.resolution, self.num_classes + 1
        reach = int(np.ceil(self.ell / res))
        offsets = jnp.asarray(
            _kernel_offsets(reach, float(res), float(self.ell)))
        fn = _scatter_fn(_CHUNK_WIDE, offsets.shape[0], c1)

        def dispatch(pts, ev, valid, origin_vox):
            return fn(jnp.asarray(pts), jnp.asarray(ev), jnp.asarray(valid),
                      offsets, jnp.asarray(origin_vox, jnp.int32),
                      jnp.float32(res), jnp.float32(self.ell),
                      jnp.float32(self.sigma0))

        self._chunk_walk(positions, np.asarray(evidence, np.float32),
                         _CHUNK_WIDE, dispatch, lambda a: a)

    def _accumulate_scalar(self, positions: np.ndarray, scale: np.ndarray,
                           evec: np.ndarray):
        """Rank-1 evidence fast path: every point contributes
        scale[p] * evec. The device reduces a scalar per voxel; the [U, C+1]
        rows are expanded on the host at unique-voxel count."""
        if len(positions) == 0:
            return
        res = self.resolution
        reach = int(np.ceil(self.ell / res))
        offsets = jnp.asarray(
            _kernel_offsets(reach, float(res), float(self.ell)))
        fn = _scatter_fn_scalar(_CHUNK_SCALAR, offsets.shape[0])
        evec = np.asarray(evec, np.float32)

        def dispatch(pts, sc, valid, origin_vox):
            return fn(jnp.asarray(pts), jnp.asarray(sc), jnp.asarray(valid),
                      offsets, jnp.asarray(origin_vox, jnp.int32),
                      jnp.float32(res), jnp.float32(self.ell),
                      jnp.float32(self.sigma0))

        evec_d = jnp.asarray(evec)
        self._chunk_walk(positions, np.asarray(scale, np.float32),
                         _CHUNK_SCALAR, dispatch,
                         lambda a: a[:, None] * evec_d[None, :])

    def insert_pointcloud(
        self,
        xyz: np.ndarray,
        labels: Optional[np.ndarray] = None,
        origin: Optional[np.ndarray] = None,
        max_range: float = -1.0,
    ):
        """The insert_pointcloud_csm equivalent (bkioctomap.h:89): occupied
        evidence from the measured points (their label distribution over
        classes 1..C) and free evidence sampled along the sensor rays."""
        xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        if max_range > 0 and origin is not None:
            keep = np.linalg.norm(xyz - origin, axis=1) < max_range
            xyz = xyz[keep]
            labels = None if labels is None else labels[keep]
        n = len(xyz)
        c1 = self.num_classes + 1
        if labels is None:
            # occupied, unknown class -> class 1 (rank-1 fast path)
            e1 = np.zeros(c1)
            e1[1] = 1.0
            self._accumulate_scalar(xyz, np.ones(n), e1)
        else:
            labels = np.asarray(labels, np.float64).reshape(n, -1)
            ev = np.zeros((n, c1))
            ev[:, 1 : 1 + labels.shape[1]] = labels
            self._accumulate(xyz, ev)

        if origin is not None and n:
            origin = np.asarray(origin, np.float64).reshape(3)
            rays = xyz - origin
            dist = np.linalg.norm(rays, axis=1)                    # [n]
            smax = int(np.floor((dist.max() - 1e-9) / self.free_resolution))
            if smax >= 1:
                t = np.arange(1, smax + 1) * self.free_resolution  # [S]
                ok = t[None, :] <= dist[:, None] - 1e-9            # [n, S]
                frac = t[None, :] / np.maximum(dist[:, None], 1e-12)
                fpos = (origin[None, None, :]
                        + rays[:, None, :] * frac[..., None])[ok]
                # converging rays duplicate samples near the sensor; fold
                # samples sharing a voxel into one count-weighted sample at
                # their mean (the reference's ds_resolution downsampling of
                # free training points, bkioctomap.cpp get_training_data)
                q = np.floor(fpos / self.resolution).astype(np.int64)
                order = np.argsort(_pack_keys(q), kind="stable")
                ks = _pack_keys(q)[order]
                seg = np.flatnonzero(
                    np.concatenate([[True], ks[1:] != ks[:-1]]))
                counts = np.diff(np.append(seg, len(ks)))
                mean_pos = (np.add.reduceat(fpos[order], seg, axis=0)
                            / counts[:, None])
                e0 = np.zeros(self.num_classes + 1)
                e0[0] = 1.0
                self._accumulate_scalar(mean_pos, counts, e0)

    # ----------------------------------------------------------------- query

    def _lookup(self, vox: np.ndarray):
        """[Q, 3] voxel coords -> (row index into _alpha or -1, found mask)."""
        self._sync_host()
        q = _pack_keys(vox)
        if len(self._keys) == 0:
            return np.zeros(len(q), np.int64), np.zeros(len(q), bool)
        idx = np.searchsorted(self._keys, q)
        idx_c = np.minimum(idx, len(self._keys) - 1)
        found = self._keys[idx_c] == q
        return idx_c, found

    def query(self, xyz: np.ndarray):
        """Per-query-point (state, semantics): state 1 occupied / -1 free /
        0 unknown; semantics = argmax class (0 if free/unknown)."""
        xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        vox = np.floor(xyz / self.resolution).astype(np.int64)
        states = np.zeros(len(xyz), np.int8)
        sems = np.zeros(len(xyz), np.int32)
        idx, found = self._lookup(vox)
        if not found.any():
            return states, sems
        a = self._alpha[idx]
        known = found & (a.sum(1) >= self.num_classes * self.prior * 2)
        cls = np.argmax(a, axis=1)
        occ = known & (cls != 0)
        states[known & (cls == 0)] = -1
        states[occ] = 1
        sems[occ] = cls[occ]
        return states, sems

    def export_occupied(self):
        """(xyz [V,3] voxel centers, semantics [V], alpha [V, C+1]) of
        occupied voxels — Frame::export_points_from_map's source."""
        C = self.num_classes
        self._sync_host()
        if len(self._keys) == 0:
            return (np.zeros((0, 3)), np.zeros((0,), np.int32),
                    np.zeros((0, C + 1)))
        cls = np.argmax(self._alpha, axis=1)
        occ = cls != 0
        keys = self._keys[occ]
        vox = np.stack([
            (keys >> (2 * _KEY_BITS)) - _KEY_BIAS,
            ((keys >> _KEY_BITS) & ((1 << _KEY_BITS) - 1)) - _KEY_BIAS,
            (keys & ((1 << _KEY_BITS) - 1)) - _KEY_BIAS,
        ], 1).astype(np.float64)
        centers = (vox + 0.5) * self.resolution
        return centers, cls[occ].astype(np.int32), self._alpha[occ]
