"""Embedded deformation graph (Sumner-style) for loop closure — PyTorch
counterpart of cofusion_tpu/ops/deformation.py (Core/Utils/DeformationGraph,
Core/Model/Deformation, CholeskyDecomp).

Nodes are sampled time-sequentially from the surfel map
(Deformation.cpp:207-276) with k = 4 sequential neighbours
(connectGraphSeq :218-245); the energy is wRot E_rot (6 rows a node) +
wReg E_reg (3 rows an edge) + wCon E_con (3 rows a constraint), weights
1/10/100 (DeformationGraph.cpp:25-27), minimised by <= 3 Gauss-Newton steps
on the dense normal equations (optimiseGraphSparse :384-457, CHOLMOD in the
reference).  Surfels and poses are warped by their k nearest-in-time nodes
with weights (1 - d/dmax)^2 (weightVerticesSeq :247-343, applyGraphToPoses
:89-116).

Where the port differs from the JAX version, and why:
  * the Jacobian of the residual stack is `torch.func.jacfwd` of a function
    of (R, t), the same matrix as JAX's `jax.jacrev`: reverse mode would
    differentiate the node gathers into float scatter-adds, which run as
    atomics on CUDA and sum the duplicate nodes of clipped windows in no
    fixed order; forward mode gathers the tangents, so reruns stay
    bit-identical (and 12 G columns are fewer than the rows);
  * the linear solve is `solve_ex(check_errors=False)`: `solve` checks its
    result on the host;
  * the k + 1 nearest of the 2k candidates come from a stable sort, so
    equal distances (the clipped windows' duplicate candidates) keep index
    order, as `lax.top_k` keeps it;
  * the rotation of a warped pose is made orthonormal by a fixed number of
    Newton steps of the polar factor, R <- (R + R^-T) / 2 with R^-T from
    the cofactors, where JAX takes U V^T of an SVD: both are the orthogonal
    polar factor of a non-singular matrix, and the CUDA SVD synchronises
    with the host (ROADMAP C10);
  * the small fixed-size sums (3 coordinates, k weights) are written out
    in one order, so the CPU and the card round them alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.models.surfel_model import SurfelStore
from cofusion_tpu_torch.ops import rasterize as rz
from cofusion_tpu_torch.ops.lie import invert_rt

K_NEIGHBOURS = 4
POLAR_STEPS = 8


class DeformationGraph(NamedTuple):
    positions: torch.Tensor  # (G, 3) node positions (sampled surfels)
    times: torch.Tensor      # (G,) node init times, nondecreasing
    R: torch.Tensor          # (G, 3, 3) node rotations
    t: torch.Tensor          # (G, 3) node translations
    valid: torch.Tensor      # (G,) bool
    count: torch.Tensor      # () int32


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] along dim 0 for an index tensor of any shape."""
    return arr.index_select(0, idx.reshape(-1)).reshape(idx.shape + arr.shape[1:])


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3 in one fixed order."""
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def _node_rows(count: torch.Tensor, num_nodes: int, n: int) -> torch.Tensor:
    """The rows every count/G-th of a valid prefix of `count` rows (of
    `n`); row 0 where the prefix is empty."""
    g = torch.arange(num_nodes, device=count.device)
    cnt = torch.clamp(count, min=1).to(torch.int64)
    return torch.clamp(torch.div(g * cnt, num_nodes, rounding_mode="floor"), 0, n - 1)


def _graph(px, py, pz, init_time, count, num_nodes: int) -> DeformationGraph:
    """The graph of the sampled nodes' positions and init times; a running
    max keeps the times monotone, as the reference asserts
    (Deformation.cpp:193-195)."""
    dev = px.device
    count = torch.clamp(count, max=num_nodes)
    return DeformationGraph(
        positions=torch.stack([px, py, pz], dim=-1),
        times=torch.cummax(init_time, dim=0).values,
        R=torch.eye(3, device=dev).expand(num_nodes, 3, 3).clone(),
        t=torch.zeros((num_nodes, 3), device=dev),
        valid=torch.arange(num_nodes, device=dev) < count,
        count=count.to(torch.int32),
    )


def sample_graph(store: SurfelStore, num_nodes: int) -> DeformationGraph:
    """Time-sequential node sampling (Deformation::sampleGraphModel): every
    count/G-th surfel of the valid prefix."""
    idx = _node_rows(store.count, num_nodes, store.capacity)
    cols = (store.px, store.py, store.pz, store.init_time)
    return _graph(*(c.index_select(0, idx) for c in cols), store.count, num_nodes)


def sample_graph_tiers(stable, active, num_nodes: int) -> DeformationGraph:
    """`sample_graph` of the whole two-tier map, the stable tier first (old
    times), then the active tier: of `concat_stores(stable, active)`.
    Sharded tiers give the same graph bit for bit without that (S + A)-row
    store on one device: the G sampled rows are the valid rows of global
    rank count/G-th over [stable shards, active shards], each gathered
    from the shard that holds it (`sm.rows_of_rank`)."""
    if not isinstance(active, sm.ShardedStore):
        return sample_graph(sm.concat_stores(stable, active), num_nodes)
    shards, ranks, total = sm.concat_ranks(stable, active)
    count = total.to(torch.int32)
    idx = _node_rows(count, num_nodes, stable.capacity + active.capacity)
    cols = sm.rows_of_rank(shards, ranks, idx, ("px", "py", "pz", "init_time"))
    return _graph(*cols, count, num_nodes)


def _neighbors(G: int, device, k: int = K_NEIGHBOURS) -> torch.Tensor:
    """Sequential connectivity (connectGraphSeq): the k temporally adjacent
    nodes, clipped into range.  (G, k)."""
    offs = [o for o in range(-(k // 2), k // 2 + 2) if o != 0][:k]
    i = torch.arange(G, device=device)
    return torch.stack([torch.clamp(i + o, 0, G - 1) for o in offs], dim=1)


def _knn_time_weights(graph: DeformationGraph, points: torch.Tensor, ptimes: torch.Tensor,
                      k: int = K_NEIGHBOURS):
    """The k nearest nodes by init-time locality then distance
    (weightVerticesSeq): binary-search the node times for each point's
    time, take a 2k window, keep the k nearest in space with weights
    (1 - d/dmax)^2 normalised, dmax the (k+1)-th distance.
    Returns (node index (P, k) int64, weight (P, k))."""
    G = graph.times.shape[0]
    dev = points.device
    base = torch.searchsorted(graph.times, ptimes.contiguous())
    cand = torch.clamp(base[:, None] + torch.arange(-k, k, device=dev)[None, :], 0, G - 1)
    diff = _take(graph.positions, cand) - points[:, None, :]
    d2 = _sum3(diff * diff)
    d2 = torch.where(_take(graph.valid, cand), d2, float("inf"))
    d2s, order = torch.sort(d2, dim=1, stable=True)
    dists = torch.sqrt(torch.clamp(d2s[:, : k + 1], min=0.0))
    nidx = torch.gather(cand, 1, order[:, :k])
    dmax = torch.clamp(dists[:, k], min=1e-6)
    w = (1.0 - dists[:, :k] / dmax[:, None]) ** 2
    w = torch.where(torch.isfinite(w), w, 0.0)
    wsum = w[:, 0]
    for j in range(1, k):
        wsum = wsum + w[:, j]
    wsum = wsum[:, None]
    # a degenerate window (all candidates identical) weighs its nodes alike
    w = torch.where(wsum > 1e-9, w / torch.clamp(wsum, min=1e-9), 1.0 / k)
    return nidx, w


def _rotate_k(Rj: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as explicit multiply-adds."""
    return torch.stack([_sum3(Rj[..., i, :] * v) for i in range(3)], dim=-1)


def _blend(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_j w[:, j] x[:, j] over the k nodes, in node order."""
    w = w.reshape(w.shape + (1,) * (x.dim() - 2))
    out = w[:, 0] * x[:, 0]
    for j in range(1, w.shape[1]):
        out = out + w[:, j] * x[:, j]
    return out


def _warp(R, t, positions, points, nidx, w) -> torch.Tensor:
    """phi(p) = sum_j w_j [R_j (p - g_j) + g_j + t_j] with fixed node
    weights (copy_unstable.vert:155-335)."""
    gj = _take(positions, nidx)
    moved = _rotate_k(_take(R, nidx), points[:, None, :] - gj) + gj + _take(t, nidx)
    return _blend(w, moved)


def warp_points(graph: DeformationGraph, points: torch.Tensor, ptimes: torch.Tensor,
                k: int = K_NEIGHBOURS) -> torch.Tensor:
    nidx, w = _knn_time_weights(graph, points, ptimes, k)
    return _warp(graph.R, graph.t, graph.positions, points, nidx, w)


def _warp_normals(R, normals, nidx, w) -> torch.Tensor:
    out = _blend(w, _rotate_k(_take(R, nidx), normals[:, None, :]))
    norm = torch.sqrt(_sum3(out * out))[:, None]
    return torch.where(norm > 1e-9, out / torch.clamp(norm, min=1e-9), normals)


def warp_normals(graph: DeformationGraph, normals: torch.Tensor, ptimes: torch.Tensor,
                 points: torch.Tensor, k: int = K_NEIGHBOURS) -> torch.Tensor:
    nidx, w = _knn_time_weights(graph, points, ptimes, k)
    return _warp_normals(graph.R, normals, nidx, w)


def _residuals(R, t, graph: DeformationGraph, nbr, src, tgt, cons_valid, nidx, w,
               w_rot=1.0, w_reg=10.0, w_con=100.0) -> torch.Tensor:
    """The stacked energy rows (DeformationGraph.h:105-108) as a function
    of (R, t); the neighbours `nbr` and the constraints' node weights
    (`nidx`, `w`) do not depend on them and come precomputed."""
    nv = graph.valid.to(torch.float32)
    c0, c1, c2 = R[:, :, 0], R[:, :, 1], R[:, :, 2]
    # E_rot: orthonormality of each R (6 rows a node)
    rot = torch.stack(
        [_sum3(c0 * c1), _sum3(c0 * c2), _sum3(c1 * c2),
         _sum3(c0 * c0) - 1.0, _sum3(c1 * c1) - 1.0, _sum3(c2 * c2) - 1.0],
        dim=1,
    ) * nv[:, None]
    # E_reg: R_j (g_k - g_j) + g_j + t_j - (g_k + t_k) over sequential edges
    gj = graph.positions[:, None, :]
    gk = _take(graph.positions, nbr)
    reg = (
        _rotate_k(R[:, None], gk - gj) + gj + t[:, None, :] - (gk + _take(t, nbr))
    ) * nv[:, None, None]
    # E_con: phi(src) - tgt
    con = (_warp(R, t, graph.positions, src, nidx, w) - tgt) * cons_valid[:, None].to(torch.float32)
    return torch.cat([
        math.sqrt(w_rot) * rot.reshape(-1),
        math.sqrt(w_reg) * reg.reshape(-1),
        math.sqrt(w_con) * con.reshape(-1),
    ])


def optimize(
    graph: DeformationGraph,
    src: torch.Tensor,         # (C, 3) constraint sources (world, current)
    src_times: torch.Tensor,   # (C,)
    tgt: torch.Tensor,         # (C, 3) constraint targets
    cons_valid: torch.Tensor,  # (C,)
    iters: int = 3,
    k: int = K_NEIGHBOURS,
) -> tuple[DeformationGraph, torch.Tensor]:
    """Gauss-Newton on the stacked energy with the dense normal equations
    (optimiseGraphSparse); a step that raises the error is rolled back
    (DeformationGraph.cpp:438-441).  Returns (graph, final error)."""
    G = graph.positions.shape[0]
    dev = src.device
    nidx, w = _knn_time_weights(graph, src, src_times, k)
    nbr = _neighbors(G, dev, k)

    def resid(R, t):
        return _residuals(R, t, graph, nbr, src, tgt, cons_valid, nidx, w)

    def resid2(R, t):
        r = resid(R, t)
        return r, r

    jac = torch.func.jacfwd(resid2, argnums=(0, 1), has_aux=True)
    eye = torch.eye(12 * G, device=dev)
    R, t = graph.R, graph.t
    for _ in range(iters):
        (J_R, J_t), r = jac(R, t)
        J = torch.cat([J_R.reshape(r.shape[0], -1), J_t.reshape(r.shape[0], -1)], dim=1)
        A = J.T @ J + 1e-6 * eye
        b = J.T @ r
        sol, info = torch.linalg.solve_ex(A, b[:, None], check_errors=False)
        delta = sol[:, 0]
        delta = torch.where(torch.isfinite(delta).all() & (info == 0), delta, 0.0)
        R_new = R - delta[: 9 * G].reshape(G, 3, 3)
        t_new = t - delta[9 * G:].reshape(G, 3)
        r_new = resid(R_new, t_new)
        better = (r_new * r_new).sum() < (r * r).sum()
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
    r = resid(R, t)
    return graph._replace(R=R, t=t), (r * r).sum()


def mean_constraint_error(graph: DeformationGraph, src, src_times, tgt, cons_valid,
                          k: int = K_NEIGHBOURS) -> torch.Tensor:
    """Mean distance of the warped constraint sources to their targets: the
    reference's meanConsError gate for fern-match deformations
    (Deformation.cpp:134)."""
    d = warp_points(graph, src, src_times, k) - tgt
    d = torch.sqrt(_sum3(d * d))
    wv = cons_valid.to(torch.float32)
    return (d * wv).sum() / torch.clamp(wv.sum(), min=1.0)


def _graph_to(graph: DeformationGraph, dev: torch.device) -> DeformationGraph:
    return DeformationGraph(*(sm.to_device(x, dev) for x in graph))


def apply_to_surfels(graph: DeformationGraph, store):
    """Warp every valid surfel's position and normal through the graph
    (copy_unstable.vert:155-335); the node weights are found once for
    both.  A sharded store warps shard by shard, the graph copied to each
    shard's device (every sum is per surfel)."""
    if isinstance(store, sm.ShardedStore):
        return sm.ShardedStore(
            tuple(apply_to_surfels(_graph_to(graph, s.px.device), s) for s in store.shards),
            store.count)
    pos = store.pos
    nidx, w = _knn_time_weights(graph, pos, store.init_time)
    new_pos = _warp(graph.R, graph.t, graph.positions, pos, nidx, w)
    new_norm = _warp_normals(graph.R, store.normal, nidx, w)
    keep = store.valid[:, None]
    out = sm.with_pos(store, torch.where(keep, new_pos, pos))
    return sm.with_normal(out, torch.where(keep, new_norm, store.normal))


def refresh_timestamps(store, pose: torch.Tensor, cam, time: int, depth_cutoff, conf_threshold):
    """Post-deformation timestamps (the reference's synthesizeDepth +
    copy_unstable.vert:316-333): confident surfels that project onto the
    deformed model's synthesized depth at the corrected pose get
    last_time = time, so they stay in the active window.  The synthesized
    depth has no time window (timeDelta = USHRT_MAX in the reference):
    2^30, exact in float32.  Of a sharded store, the depth is rendered by
    the shard-aware z-buffer, copied to each shard's device once, and each
    shard re-stamps its own surfels."""
    imap = rz.predict_indices(store, pose, cam, time, 1 << 30, depth_cutoff,
                              conf_threshold=conf_threshold)
    synth = torch.where(imap.valid, imap.vert_conf[..., 2], 0.0).reshape(-1)
    t_inv = invert_rt(pose)
    if isinstance(store, sm.ShardedStore):
        return sm.ShardedStore(tuple(
            _bump(s, *(sm.to_device(x, s.px.device) for x in (synth, t_inv, conf_threshold)),
                  cam, time, depth_cutoff)
            for s in store.shards), store.count)
    return _bump(store, synth, t_inv, conf_threshold, cam, time, depth_cutoff)


def _bump(store: SurfelStore, synth, t_inv, conf_threshold, cam, time: int,
          depth_cutoff) -> SurfelStore:
    """`refresh_timestamps`' per-surfel part: last_time = time where the
    surfel projects in front of the synthesized depth `synth` (H·W)."""
    H, W = cam.height, cam.width
    lx, ly, z = rz.rotate_planar(t_inv[:3, :3], store.px, store.py, store.pz, t_inv[:3, 3])
    zs = torch.where(z == 0, 1.0, z)
    x = lx * cam.fx / zs + cam.cx
    y = ly * cam.fy / zs + cam.cy
    xi = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 1)
    inb = (x > 0) & (y > 0) & (x < W) & (y < H) & (z > 0) & (z < depth_cutoff)
    d = synth.index_select(0, yi * W + xi)
    bump = store.valid & (store.conf > conf_threshold) & inb & (d > 0) & (z < d + 0.1)
    return store._replace(last_time=torch.where(bump, float(time), store.last_time))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _polar(M: torch.Tensor, steps: int = POLAR_STEPS) -> torch.Tensor:
    """The orthogonal polar factor U V^T of each non-singular (..., 3, 3)
    matrix by Newton's iteration M <- (M + M^-T) / 2, M^-T the cofactor
    matrix over the determinant (elementwise: no solver, no host read)."""
    for _ in range(steps):
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cof = torch.stack([_cross(r1, r2), _cross(r2, r0), _cross(r0, r1)], dim=-2)
        det = _sum3(r0 * cof[..., 0, :])
        M = 0.5 * (M + cof / det[..., None, None])
    return M


def apply_to_poses(graph: DeformationGraph, poses: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Warp a pose log through the graph (applyGraphToPoses,
    DeformationGraph.cpp:89-116): each translation as a point at its own
    time, each rotation blended from the k nearest-in-time nodes and made
    orthonormal again.  `poses` (P, 4, 4), `times` (P,)."""
    p = poses[:, :3, 3]
    nidx, w = _knn_time_weights(graph, p, times)
    new_p = _warp(graph.R, graph.t, graph.positions, p, nidx, w)
    Rmix = _blend(w, _take(graph.R, nidx))
    R = torch.stack([_rotate_k(Rmix, poses[:, :3, j]) for j in range(3)], dim=-1)
    out = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(poses.shape[0], 4, 4).clone()
    out[:, :3, :3] = _polar(R)
    out[:, :3, 3] = new_p
    return out


def apply_to_pose(graph: DeformationGraph, pose: torch.Tensor, pose_time) -> torch.Tensor:
    """One camera pose warped as `apply_to_poses` warps a log."""
    if isinstance(pose_time, torch.Tensor):
        t = pose_time.to(torch.float32).reshape(1)
    else:
        t = torch.full((1,), float(pose_time), device=pose.device)
    return apply_to_poses(graph, pose[None], t)[0]
