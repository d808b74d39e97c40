"""Keyframe pose-graph SLAM back-end — the PoseGraph/GTSAM layer, on device.

Reference (src/graph_optimizer/PoseGraph.cpp, legacy L6): track each new
frame against the last frame with pairwise CVO, gauge tracking quality by
the RKHS inner product, promote to keyframe when the function-angle drops
below threshold (decide_new_keyframe, PoseGraph.cpp:90-104), add a relative
-pose factor, and optimize with GTSAM iSAM2 / fixed-lag smoothing.

Redesign: factors are SE(3) between-measurements; the graph is
optimized by Gauss-Newton in the tangent space with the residual
  r_e = log( Z_e^{-1} T_i^{-1} T_j )
linearized by forward-mode autodiff through the Lie exp/log (no GTSAM, no
hand-written jacobians), solved as a dense 6F x 6F system on device — pose
graphs here are tens of keyframes, far too small for a sparse solver to
pay off, so clarity wins.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from unified_cvo_tpu.ops import lie


class RelativePose(NamedTuple):
    """(curr_id, ref_id, ref_T_curr, cvo inner product) — reference
    RelativePose.hpp:7-61."""

    curr_id: int
    ref_id: int
    transform: np.ndarray  # [4,4] ref_T_curr
    inner_product: float


def _factor_residuals(poses_rt, delta, fi, fj, Z_rt):
    """Stacked residuals [E,6] as a function of tangent updates delta [F,6]."""
    R0, t0 = poses_rt
    dR, dt = lie.se3_exp(delta, 1.0)
    R = dR @ R0
    t = jnp.einsum("fij,fj->fi", dR, t0) + dt

    Ri, ti = R[fi], t[fi]
    Rj, tj = R[fj], t[fj]
    # T_i^{-1} T_j
    Rij = jnp.einsum("eki,ekj->eij", Ri, Rj)
    tij = jnp.einsum("eki,ek->ei", Ri, tj - ti)
    # Z^{-1} (T_i^{-1} T_j) with Z = (Rz, tz) the raw measurement
    Rz, tz = Z_rt
    Re = jnp.einsum("eki,ekj->eij", Rz, Rij)
    te = jnp.einsum("eki,ek->ei", Rz, tij - tz)
    return lie.se3_log(Re, te)


def _edge_residual_d(Ri, ti, Rj, tj, Rz, tz, d):
    """One edge's residual r(d) with d = [delta_i | delta_j] in R^12 and the
    same left-multiplicative update convention as _factor_residuals."""
    dRi, dti = lie.se3_exp(d[:6], 1.0)
    dRj, dtj = lie.se3_exp(d[6:], 1.0)
    Ri2 = dRi @ Ri
    ti2 = dRi @ ti + dti
    Rj2 = dRj @ Rj
    tj2 = dRj @ tj + dtj
    Rij = Ri2.T @ Rj2
    tij = Ri2.T @ (tj2 - ti2)
    Re = Rz.T @ Rij
    te = Rz.T @ (tij - tz)
    return lie.se3_log(Re, te)


def _edge_blocks_pg(R, t, fi, fj, Rz, tz, weights):
    """Per-edge residuals + 6x6 GN blocks, O(E) memory (replaces the
    whole-graph jacfwd's [E,6,F,6] dense jacobian).
    Returns (res [E,6], H_aa, H_bb, H_ab [E,6,6], b_a, b_b [E,6])."""
    zero12 = jnp.zeros((12,), jnp.float32)

    def one(Ri, ti, Rj, tj, Rze, tze):
        r = _edge_residual_d(Ri, ti, Rj, tj, Rze, tze, zero12)
        J = jax.jacfwd(
            lambda d: _edge_residual_d(Ri, ti, Rj, tj, Rze, tze, d))(zero12)
        return r, J[:, :6], J[:, 6:]

    res, Ji, Jj = jax.vmap(one)(R[fi], t[fi], R[fj], t[fj], Rz, tz)
    w = weights[:, None, None]
    H_aa = w * jnp.einsum("eri,erj->eij", Ji, Ji)
    H_bb = w * jnp.einsum("eri,erj->eij", Jj, Jj)
    H_ab = w * jnp.einsum("eri,erj->eij", Ji, Jj)
    b_a = weights[:, None] * jnp.einsum("eri,er->ei", Ji, res)
    b_b = weights[:, None] * jnp.einsum("eri,er->ei", Jj, res)
    return res, H_aa, H_bb, H_ab, b_a, b_b


@functools.partial(jax.jit, static_argnames=("iters", "solver", "cg_iters",
                                              "robust_delta"))
def optimize_pose_graph(
    poses: jax.Array,          # [F,4,4]
    fi: jax.Array,             # [E] i32
    fj: jax.Array,             # [E]
    Z: jax.Array,              # [E,4,4] measured i_T_j
    weights: jax.Array,        # [E]
    fixed_mask: jax.Array,     # [F] 1.0 = held constant
    iters: int = 10,
    damping: float = 1e-6,
    prior: Optional[dict] = None,
    solver: str = "dense",
    cg_iters: int = 150,
    robust_delta: Optional[float] = None,
):
    """Weighted GN over the pose graph. Returns optimized poses [F,4,4].

    The system is assembled from per-edge 6x6 blocks (O(E) memory; the
    round-3 whole-graph jacfwd materialized [E,6,F,6]).

    solver: 'dense' scatters the blocks into the 6F x 6F matrix and
    Cholesky-solves (exact; right up to a few hundred keyframes); 'cg'
    runs the same matrix-free block-sparse PCG as the distributed BA
    (irls._solve_cg_blocks) — O(E) memory for long trajectories.
    'cg' does not support `prior` (fixed-lag windows are bounded, so the
    dense path always covers them).

    prior: optional Gaussian marginal from sliding-window marginalization
    (the BatchFixedLagSmoother analogue, reference PoseGraph.cpp:421-551):
    {idx [K] i32 local keyframe rows, H [6K,6K], b [6K], lin_R [K,3,3],
    lin_t [K,3]}. Energy 0.5 (xi+delta)^T H (xi+delta) + b^T (xi+delta)
    with xi_k = log(T_k T_lin,k^{-1}) the left-tangent deviation from the
    linearization point — contributes H to the system and (H xi + b) to
    the gradient each GN iteration."""
    if solver == "cg" and prior is not None:
        raise ValueError("solver='cg' does not support a marginal prior; "
                         "fixed-lag windows use the dense path")
    F = poses.shape[0]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    Rz = Z[:, :3, :3]
    tz = Z[:, :3, 3]
    free = (1.0 - fixed_mask)[:, None]

    def _blocks(R, t):
        """Per-edge blocks, optionally Huber-reweighted (the GTSAM robust
        noise-model analogue): edges whose residual norm exceeds
        robust_delta are downweighted by delta/||r||, so a few bad
        odometry edges absorb a loop-closure discrepancy instead of
        bending the whole trajectory. IRLS: weights recompute from the
        CURRENT residuals at every GN iteration."""
        if robust_delta is None:
            return _edge_blocks_pg(R, t, fi, fj, Rz, tz, weights)
        zero = jnp.zeros((poses.shape[0], 6), jnp.float32)
        res0 = _factor_residuals((R, t), zero, fi, fj, (Rz, tz))
        rn = jnp.linalg.norm(res0, axis=1)
        w_r = jnp.where(rn > robust_delta, robust_delta / jnp.maximum(rn, 1e-12), 1.0)
        return _edge_blocks_pg(R, t, fi, fj, Rz, tz, weights * w_r)

    def body_cg(carry, _):
        from unified_cvo_tpu.models.irls import _solve_cg_blocks

        R, t = carry
        res, H_aa, H_bb, H_ab, b_a, b_b = _blocks(R, t)
        b = (jnp.zeros((F, 6), jnp.float32)
             .at[fi].add(b_a).at[fj].add(b_b))
        free6f = jnp.tile(jnp.ones((6,), jnp.float32), (F, 1)) * free
        delta = _solve_cg_blocks(F, fi, fj, H_aa, H_bb, H_ab, b, free6f,
                                 damping, cg_iters)
        dR, dt = lie.se3_exp(delta, 1.0)
        t = jnp.einsum("fij,fj->fi", dR, t) + dt
        R = dR @ R
        return (R, t), jnp.linalg.norm(delta)

    def body(carry, _):
        R, t = carry
        res, H_aa, H_bb, H_ab, b_a, b_b = _blocks(R, t)
        # scatter the 6x6 blocks into the dense [F,F,6,6] -> [6F,6F] system
        Hb = (jnp.zeros((F, F, 6, 6), jnp.float32)
              .at[fi, fi].add(H_aa)
              .at[fj, fj].add(H_bb)
              .at[fi, fj].add(H_ab)
              .at[fj, fi].add(jnp.swapaxes(H_ab, 1, 2)))
        H = Hb.transpose(0, 2, 1, 3).reshape(6 * F, 6 * F)
        b = (jnp.zeros((F, 6), jnp.float32)
             .at[fi].add(b_a).at[fj].add(b_b)).reshape(6 * F)
        if prior is not None:
            pR = R[prior["idx"]]
            pt = t[prior["idx"]]
            Rd = jnp.einsum("kil,kjl->kij", pR, prior["lin_R"])  # R lin_R^T
            td = pt - jnp.einsum("kij,kj->ki", Rd, prior["lin_t"])
            xi = lie.se3_log(Rd, td).reshape(-1)                 # [6K]
            rows = (prior["idx"][:, None] * 6
                    + jnp.arange(6, dtype=jnp.int32)[None, :]).reshape(-1)
            H = H.at[rows[:, None], rows[None, :]].add(prior["H"])
            b = b.at[rows].add(prior["H"] @ xi + prior["b"])
        free6 = jnp.repeat(free[:, 0], 6)
        H = H * free6[:, None] * free6[None, :]
        H = H + jnp.diag(jnp.where(free6 > 0, damping, 1.0))
        b = b * free6
        delta = jnp.linalg.solve(H, -b).reshape(F, 6) * free
        dR, dt = lie.se3_exp(delta, 1.0)
        t = jnp.einsum("fij,fj->fi", dR, t) + dt
        R = dR @ R
        return (R, t), jnp.linalg.norm(delta)

    (R, t), dn = jax.lax.scan(body_cg if solver == "cg" else body,
                              (R, t), None, length=iters)
    out = jnp.tile(jnp.eye(4, dtype=poses.dtype), (F, 1, 1))
    out = out.at[:, :3, :3].set(R).at[:, :3, 3].set(t)
    return out, dn[-1]


@dataclasses.dataclass
class PoseGraphConfig:
    keyframe_function_angle_threshold: float = 0.6   # is_tracking_bad analogue
    odometry_weight: float = 1.0
    window_size: int = 0                             # 0 = full batch
    optimize_iters: int = 10
    solver: str = "auto"       # 'auto' = dense up to 64 in-window keyframes,
    #   matrix-free block-PCG beyond (full-batch long trajectories);
    #   windows with a marginal prior always solve dense (bounded size)
    robust_delta: Optional[float] = None   # Huber threshold [tangent norm]
    #   for robust edge reweighting (None = pure least squares)
    incremental: bool = False  # iSAM2-analogue active-subgraph updates
    #   (PoseGraph.cpp:421 uses gtsam::ISAM2, whose per-keyframe cost is
    #   bounded by the affected sub-tree, not the trajectory length).
    #   When on (and window_size == 0), optimize() solves only the frames
    #   touched since the last call, expanded inc_hops over the factor
    #   graph, with the subgraph boundary held fixed as anchors; frames
    #   whose pose moves more than inc_update_threshold re-activate their
    #   neighbourhood next round (the fluid-relinearization analogue), so
    #   a loop closure cascades as far as it actually reaches while pure
    #   odometry updates stay O(window) regardless of trajectory length.
    inc_hops: int = 2
    inc_update_threshold: float = 1e-3
    inc_max_rounds: int = 4


class PoseGraph:
    """Online keyframe SLAM driver (PoseGraph::add_new_frame semantics,
    PoseGraph.cpp:272-320): caller supplies each frame's tracking result
    (relative transform + function angle vs the last keyframe); this class
    maintains keyframes, factors, and runs GN after each new keyframe."""

    def __init__(self, config: PoseGraphConfig = PoseGraphConfig()):
        self.config = config
        self.keyframe_poses: List[np.ndarray] = []   # world_T_kf
        self.keyframe_ids: List[int] = []
        self.factors: List[RelativePose] = []
        self.trajectory: List[np.ndarray] = []       # every frame, world_T_f
        self.window_lo = 0                           # first in-window keyframe
        # Gaussian marginal over the window-boundary keyframes:
        # {"ids": global kf indices [K], "H": [6K,6K], "b": [6K],
        #  "lin": [K,4,4] linearization poses} — None until the window
        # first slides
        self.prior: Optional[dict] = None
        self._touched: set = set()      # keyframes affected since last solve
        self._adj: dict = {}            # frame -> [factor index] (lazily
        #   extended in _optimize_incremental; O(new factors) per call)
        self._adj_n = 0

    @property
    def num_keyframes(self):
        return len(self.keyframe_poses)

    def add_first_frame(self, frame_id: int):
        self.keyframe_poses.append(np.eye(4))
        self.keyframe_ids.append(frame_id)
        self.trajectory.append(np.eye(4))

    def add_frame(
        self,
        frame_id: int,
        kf_T_frame: np.ndarray,
        function_angle: float,
        extra_factors: Optional[List[RelativePose]] = None,
    ) -> bool:
        """Returns True if the frame became a keyframe. kf_T_frame maps
        frame points into the last keyframe's frame."""
        world_T_kf = self.keyframe_poses[-1]
        world_T_frame = world_T_kf @ kf_T_frame
        self.trajectory.append(world_T_frame)
        is_keyframe = function_angle < self.config.keyframe_function_angle_threshold
        if not is_keyframe:
            return False
        self.factors.append(
            RelativePose(
                curr_id=len(self.keyframe_poses),
                ref_id=len(self.keyframe_poses) - 1,
                transform=np.asarray(kf_T_frame, np.float64),
                inner_product=float(function_angle),
            )
        )
        self.keyframe_poses.append(world_T_frame)
        self.keyframe_ids.append(frame_id)
        self._touched.add(len(self.keyframe_poses) - 1)
        if extra_factors:
            self.factors.extend(extra_factors)
            for f in extra_factors:
                self._touched.update((f.ref_id, f.curr_id))
        self.optimize()
        return True

    def _linearized_system(self, factors, S, loc):
        """(H, b) of `factors` linearized at the current keyframe estimates
        over the variable set S (local index map loc), reference-weighted
        exactly as optimize_pose_graph builds its system."""
        K = len(S)
        poses = jnp.asarray(
            np.stack([self.keyframe_poses[s] for s in S]), jnp.float32)
        R, t = poses[:, :3, :3], poses[:, :3, 3]
        fi = jnp.asarray([loc[f.ref_id] for f in factors], jnp.int32)
        fj = jnp.asarray([loc[f.curr_id] for f in factors], jnp.int32)
        Z = jnp.asarray(np.stack([f.transform for f in factors]), jnp.float32)
        Rz, tz = Z[:, :3, :3], Z[:, :3, 3]
        zero = jnp.zeros((K, 6), jnp.float32)
        res = _factor_residuals((R, t), zero, fi, fj, (Rz, tz))
        J = jax.jacfwd(
            lambda d: _factor_residuals((R, t), d, fi, fj, (Rz, tz)))(zero)
        E = res.shape[0]
        w = self.config.odometry_weight
        Jf = np.asarray(J, np.float64).reshape(E * 6, K * 6) * w
        rf = np.asarray(res, np.float64).reshape(E * 6)
        return Jf.T @ (Jf / w), Jf.T @ rf

    def _marginalize(self, new_lo: int):
        """Schur-complement the keyframes [window_lo, new_lo) out of the
        factors (and existing prior) that touch them, leaving a Gaussian
        marginal on the boundary keyframes — real fixed-lag smoothing
        (GTSAM BatchFixedLagSmoother, reference PoseGraph.cpp:421-551)
        instead of factor truncation, which silently re-anchors the window
        and drops all cross-boundary information."""
        marg = [f for f in self.factors
                if f.ref_id < new_lo or f.curr_id < new_lo]
        keep = [f for f in self.factors
                if f.ref_id >= new_lo and f.curr_id >= new_lo]
        ids = set(range(self.window_lo, new_lo))
        for f in marg:
            ids.update((f.ref_id, f.curr_id))
        if self.prior is not None:
            ids.update(self.prior["ids"])
        S = sorted(ids)
        loc = {s: k for k, s in enumerate(S)}
        K = len(S)
        if marg:
            H, b = self._linearized_system(marg, S, loc)
        else:
            H, b = np.zeros((6 * K, 6 * K)), np.zeros(6 * K)

        if self.prior is not None:
            # transport the old prior to the current linearization point:
            # xi = log(T_cur T_lin^{-1}) folds into the gradient
            p_rows = np.concatenate(
                [6 * loc[s] + np.arange(6) for s in self.prior["ids"]])
            xi = []
            for k, s in enumerate(self.prior["ids"]):
                T_cur = self.keyframe_poses[s]
                T_lin = self.prior["lin"][k]
                D = T_cur @ np.linalg.inv(T_lin)
                xi.append(np.asarray(lie.se3_log(
                    jnp.asarray(D[:3, :3], jnp.float32),
                    jnp.asarray(D[:3, 3], jnp.float32)), np.float64))
            xi = np.concatenate(xi)
            H[np.ix_(p_rows, p_rows)] += self.prior["H"]
            b[p_rows] += self.prior["H"] @ xi + self.prior["b"]

        # keyframe 0 is globally gauge-fixed (delta_0 = 0): conditioning on
        # it = simply excluding its rows/cols from both partitions
        def rows_of(ids):
            return (np.concatenate([6 * loc[s] + np.arange(6) for s in ids])
                    if ids else np.zeros(0, np.int64))

        m_rows = rows_of([s for s in S if s < new_lo and s != 0])
        b_ids = [s for s in S if s >= new_lo]
        b_rows = rows_of(b_ids)

        if len(b_rows) and len(m_rows):
            H_mm = H[np.ix_(m_rows, m_rows)] + 1e-9 * np.eye(len(m_rows))
            H_bm = H[np.ix_(b_rows, m_rows)]
            sol_H = np.linalg.solve(H_mm, H[np.ix_(m_rows, b_rows)])
            sol_b = np.linalg.solve(H_mm, b[m_rows])
            H_new = H[np.ix_(b_rows, b_rows)] - H_bm @ sol_H
            b_new = b[b_rows] - H_bm @ sol_b
            self.prior = {
                "ids": b_ids,
                "H": H_new,
                "b": b_new,
                "lin": np.stack([self.keyframe_poses[s] for s in b_ids]),
            }
        elif len(b_rows):
            self.prior = {
                "ids": b_ids,
                "H": H[np.ix_(b_rows, b_rows)],
                "b": b[b_rows],
                "lin": np.stack([self.keyframe_poses[s] for s in b_ids]),
            }
        else:
            self.prior = None
        self.factors = keep
        self.window_lo = new_lo

    def _solve_subgraph(self, S, sub, fixed_mask):
        """Bucketed GN over variable set S (global kf indices, sorted) with
        factors `sub`; fixed_mask marks anchor frames. Updates
        self.keyframe_poses in place; returns per-frame tangent-ish update
        magnitudes (dict id -> float)."""
        loc = {s: k for k, s in enumerate(S)}
        Fw, E = len(S), len(sub)
        Fp = max(8, 1 << (Fw - 1).bit_length())
        Ep = max(8, 1 << (E - 1).bit_length())
        poses_np = np.tile(np.eye(4, dtype=np.float32), (Fp, 1, 1))
        poses_np[:Fw] = np.stack([self.keyframe_poses[s] for s in S])
        fi = jnp.asarray([loc[f.ref_id] for f in sub] + [0] * (Ep - E),
                         jnp.int32)
        fj = jnp.asarray([loc[f.curr_id] for f in sub] + [0] * (Ep - E),
                         jnp.int32)
        Z_np = np.tile(np.eye(4, dtype=np.float32), (Ep, 1, 1))
        Z_np[:E] = np.stack([f.transform for f in sub])
        w = jnp.asarray(
            [self.config.odometry_weight] * E + [0.0] * (Ep - E), jnp.float32)
        fixed = np.ones(Fp, np.float32)
        fixed[:Fw] = fixed_mask
        solver = self.config.solver
        if solver == "auto":
            # same policy as the batch path: dense Cholesky for small
            # active sets, matrix-free block-PCG when a loop-closure
            # cascade activates a large subgraph
            solver = "cg" if Fw > 64 else "dense"
        out, _ = optimize_pose_graph(
            jnp.asarray(poses_np), fi, fj, jnp.asarray(Z_np), w,
            jnp.asarray(fixed), iters=self.config.optimize_iters,
            solver=solver, robust_delta=self.config.robust_delta,
        )
        out = np.asarray(out, np.float64)
        moved = {}
        for k, s in enumerate(S):
            if fixed_mask[k]:
                continue
            d = float(np.abs(out[k][:3, :4]
                             - self.keyframe_poses[s][:3, :4]).max())
            self.keyframe_poses[s] = out[k]
            moved[s] = d
        return moved

    def _optimize_incremental(self):
        """Active-subgraph update (config.incremental docstring). Per-call
        cost is bounded by the affected neighbourhood, not the trajectory
        length — measured flat over a 1000-keyframe odometry run
        (tests/test_posegraph_bki.py::test_incremental_flat_cost)."""
        F = len(self.keyframe_poses)
        touched = self._touched or {F - 1}
        self._touched = set()
        # extend the cached adjacency with factors added since last call
        # (append-only in incremental mode; windowed marginalization,
        # which rewrites self.factors, never routes here)
        for fidx in range(self._adj_n, len(self.factors)):
            f = self.factors[fidx]
            self._adj.setdefault(f.ref_id, []).append(fidx)
            self._adj.setdefault(f.curr_id, []).append(fidx)
        self._adj_n = len(self.factors)
        adj = self._adj
        cfg = self.config
        for _ in range(cfg.inc_max_rounds):
            active = set(touched)
            for _ in range(cfg.inc_hops):
                front = set()
                for s in active:
                    for fidx in adj.get(s, ()):  # noqa: B909
                        f = self.factors[fidx]
                        front.add(f.ref_id)
                        front.add(f.curr_id)
                active |= front
            # factors touching the active set, via the adjacency lists
            # (O(active neighbourhood), not O(all factors))
            sub_idx = sorted({fidx for s in active
                              for fidx in adj.get(s, ())})
            sub, boundary = [], set()
            for fidx in sub_idx:
                f = self.factors[fidx]
                sub.append(f)
                if f.ref_id not in active:
                    boundary.add(f.ref_id)
                if f.curr_id not in active:
                    boundary.add(f.curr_id)
            if not sub:
                return
            S = sorted(active | boundary)
            fixed_mask = np.asarray(
                [1.0 if s in boundary else 0.0 for s in S], np.float32)
            if not boundary:
                fixed_mask[S.index(0) if 0 in active else 0] = 1.0  # gauge
            moved = self._solve_subgraph(S, sub, fixed_mask)
            # only significant movement at the ACTIVE RIM (frames sharing a
            # factor with the fixed boundary) can justify pulling more of
            # the graph in; interior frames were already solved consistently
            rim = {s for s in moved
                   if any(self.factors[fidx].ref_id in boundary
                          or self.factors[fidx].curr_id in boundary
                          for fidx in adj.get(s, ()))}
            touched = {s for s, d in moved.items()
                       if d > cfg.inc_update_threshold} & rim
            if not touched:
                return

    def optimize(self):
        F = len(self.keyframe_poses)
        if F < 2 or not self.factors:
            return
        if self.config.incremental and not self.config.window_size:
            self._optimize_incremental()
            return
        lo = self.window_lo
        if self.config.window_size and F - lo > self.config.window_size:
            lo = F - self.config.window_size
            self._marginalize(lo)
        sub = [f for f in self.factors if f.ref_id >= lo and f.curr_id >= lo]
        if not sub:
            return
        # pad keyframes and edges to power-of-two buckets: the online driver
        # re-optimizes after EVERY keyframe, and an unpadded call would
        # compile a fresh program per (F, E) shape (seconds each). Pad
        # poses are identity + held fixed; pad
        # edges are weight-0 self-loops on frame 0 — both contribute
        # exactly nothing to the system.
        Fw = len(self.keyframe_poses) - lo
        E = len(sub)
        Fp = max(8, 1 << (Fw - 1).bit_length())
        Ep = max(8, 1 << (E - 1).bit_length())
        poses_np = np.tile(np.eye(4, dtype=np.float32), (Fp, 1, 1))
        poses_np[:Fw] = np.stack(self.keyframe_poses[lo:])
        poses = jnp.asarray(poses_np)
        fi = jnp.asarray([f.ref_id - lo for f in sub] + [0] * (Ep - E),
                         jnp.int32)
        fj = jnp.asarray([f.curr_id - lo for f in sub] + [0] * (Ep - E),
                         jnp.int32)
        Z_np = np.tile(np.eye(4, dtype=np.float32), (Ep, 1, 1))
        Z_np[:E] = np.stack([f.transform for f in sub])
        Z = jnp.asarray(Z_np)
        w = jnp.asarray(
            [self.config.odometry_weight] * E + [0.0] * (Ep - E), jnp.float32)
        fixed = np.ones(Fp, np.float32)
        fixed[:Fw] = 0.0
        if lo == 0:
            fixed[0] = 1.0   # gauge: the global origin while in window;
            # afterwards the marginal prior anchors the window
        prior_local = None
        if self.prior is not None:
            prior_local = {
                "idx": jnp.asarray(
                    [s - lo for s in self.prior["ids"]], jnp.int32),
                "H": jnp.asarray(self.prior["H"], jnp.float32),
                "b": jnp.asarray(self.prior["b"], jnp.float32),
                "lin_R": jnp.asarray(self.prior["lin"][:, :3, :3], jnp.float32),
                "lin_t": jnp.asarray(self.prior["lin"][:, :3, 3], jnp.float32),
            }
        solver = self.config.solver
        if solver == "auto":
            solver = ("cg" if prior_local is None and Fw > 64
                      else "dense")
        out, _ = optimize_pose_graph(
            poses, fi, fj, Z, w, jnp.asarray(fixed),
            iters=self.config.optimize_iters, prior=prior_local,
            solver=solver, robust_delta=self.config.robust_delta,
        )
        out = np.asarray(out, np.float64)
        for k in range(Fw):                    # skip the identity padding
            self.keyframe_poses[lo + k] = out[k]

    def write_trajectory(self, path: str):
        """KITTI-format rows of every frame pose (PoseGraph::write_trajectory)."""
        with open(path, "w") as f:
            for T in self.trajectory:
                f.write(" ".join(f"{v:.9g}" for v in T[:3, :4].reshape(-1)) + "\n")
