"""Multi-device execution: data-parallel video batches + tensor-parallel
matching, via ``jax.sharding`` + ``shard_map`` over a device Mesh.

The reference has no parallelism of any kind (SURVEY.md §2.5: single-process
NumPy, no threads/MPI/NCCL). The JAX equivalents, per §5.7/§5.8:

  * **DP** (BASELINE config 5): a batch of videos sharded over the ``data``
    mesh axis — preprocessing, detection, matching and *per-core independent
    BA solves* all run without any cross-device communication.
  * **TP**: the Hamming-distance matmul sharded over the ``model`` axis —
    train descriptors split column-wise, each core computes a distance-matrix
    slab and its local top-2, then an ``all_gather`` of the (tiny) per-core
    candidates reduces to the global top-2. The collective rides ICI and
    moves O(Q) scalars, not the O(Q x T) matrix.
  * **SP** (the long-video analog of sequence parallelism): frame chunks of
    one video sharded over ``data`` for the embarrassingly-parallel
    preprocessing (CLAHE + grey), gathered only for the sequential KLT scan.

All functions accept an explicit ``Mesh`` so tests run on the 8-device
virtual CPU backend (conftest) and the same code drives a real slice.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from meatmodeler_tpu.solvers import bundle_adjust

__all__ = [
    "make_mesh",
    "preprocess_sharded",
    "solve_ba_batch",
    "solve_ba_point_sharded",
    "match_descriptors_tp",
]


def make_mesh(
    data: Optional[int] = None, model: int = 1, devices=None
) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None:
        data = n // model
    assert data * model <= n, (data, model, n)
    arr = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def preprocess_sharded(mesh: Mesh, frames: jax.Array) -> jax.Array:
    """CLAHE + grey over a frame batch sharded on the ``data`` axis.

    frames: (B, H, W, 3) uint8 — B is the video batch or a single video's
    frame axis (the SP case); must divide the data axis size.
    """
    from meatmodeler_tpu.ops import clahe

    spec = P("data", None, None, None)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=P("data", None, None),
    )
    def run(chunk):
        return clahe.enhanced_grey(chunk)

    return run(frames)


def solve_ba_batch(
    mesh: Mesh,
    problems: bundle_adjust.BAProblem,
    config=None,
) -> bundle_adjust.BAResult:
    """Independent per-video BA solves, sharded over ``data`` (config 5).

    ``problems`` holds a leading batch axis on every field (stack the
    per-video problems with equal static capacities). No communication:
    each core runs its videos' Schur solves locally.
    """
    from meatmodeler_tpu.config import SolverConfig

    config = config or SolverConfig()

    spec = bundle_adjust.BAProblem(
        cam_params=P("data"),
        points=P("data"),
        intrinsics=P("data"),
        obs=P("data"),
        frame_idx=P("data"),
        point_idx=P("data"),
        mask=P("data"),
        weight=None if problems.weight is None else P("data"),
    )
    out_spec = bundle_adjust.BAResult(
        cam_params=P("data"),
        points=P("data"),
        cost=P("data"),
        rmse=P("data"),
        iterations=P("data"),
        final_lambda=P("data"),
    )

    # check_vma off: solve_ba's while_loop seeds scalar carries (lambda, cost)
    # from unvarying constants, which the manual-axes checker rejects even
    # though each core's solve is fully independent.
    @partial(
        jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=out_spec, check_vma=False
    )
    def run(local):
        return jax.vmap(lambda p: bundle_adjust.solve_ba(p, config=config))(local)

    return run(problems)


def solve_ba_point_sharded(
    mesh: Mesh,
    problem: bundle_adjust.BAProblem,
    config=None,
    init_lambda=None,
) -> bundle_adjust.BAResult:
    """ONE bundle-adjustment problem with its points sharded over ``data``.

    The SURVEY §5.7/§5.8 strategy for problems larger than a core: point
    blocks (V, b_p, back-substitution) and their observations stay local;
    camera-sized quantities (U, b_c, the Schur cross term S, the reduced RHS,
    the scalar cost) are ``psum``-reduced across the axis, so every core
    walks the identical LM trajectory and solves the identical (6F x 6F)
    reduced camera system. Cross-device traffic per iteration is O(F^2)
    camera floats — never anything point-sized. This also shards the
    (P_local, F, 6, 3) Schur strip, the solver's peak-memory term
    (reference analog: the whole of ``bundleAdjuster.py:160-194`` at
    100-camera/10k-point scale and beyond).

    Host-side prep: points are partitioned into ``data`` contiguous shards
    and each observation is routed to its point's shard (re-indexed to local
    point ids). Returns a BAResult matching ``solve_ba`` on the unsharded
    problem: points gathered back to the original order/length.
    """
    from meatmodeler_tpu.config import SolverConfig

    config = config or SolverConfig()
    d = mesh.shape["data"]

    pidx = np.asarray(problem.point_idx)
    fidx = np.asarray(problem.frame_idx)
    obs = np.asarray(problem.obs)
    valid = np.asarray(problem.mask).astype(bool)
    weight = np.ones(len(obs), np.float32) if problem.weight is None else np.asarray(
        problem.weight, np.float32
    )
    pts = np.asarray(problem.points)
    p_total = pts.shape[0]
    pl = -(-p_total // d)  # points per shard, padded

    pts_pad = np.zeros((d * pl, 3), pts.dtype)
    pts_pad[:p_total] = pts
    shard_of_obs = np.minimum(pidx // pl, d - 1)
    local_pidx = pidx - shard_of_obs * pl

    counts = np.bincount(shard_of_obs[valid], minlength=d)
    nl = max(int(counts.max()), 1)
    obs_l = np.zeros((d, nl, 2), obs.dtype)
    fidx_l = np.zeros((d, nl), np.int32)
    pidx_l = np.zeros((d, nl), np.int32)
    mask_l = np.zeros((d, nl), bool)
    w_l = np.ones((d, nl), np.float32)
    for s in range(d):
        sel = valid & (shard_of_obs == s)
        n = int(counts[s])
        obs_l[s, :n] = obs[sel]
        fidx_l[s, :n] = fidx[sel]
        pidx_l[s, :n] = local_pidx[sel]
        mask_l[s, :n] = True
        w_l[s, :n] = weight[sel]

    pts_sharded = pts_pad.reshape(d, pl, 3)

    out_spec = bundle_adjust.BAResult(
        cam_params=P(), points=P("data"), cost=P(), rmse=P(), iterations=P(),
        final_lambda=P(),
    )

    # check_vma off for the same reason as solve_ba_batch; additionally the
    # replicated outputs (cam/cost/rmse) are identical across cores because
    # every camera-sized reduction inside solve_ba is psum'd.
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P("data"), P("data"), P("data"), P("data"), P("data"),
            P("data"), P(), P(),
        ),
        out_specs=out_spec,
        check_vma=False,
    )
    def run(cam, pts_s, obs_s, fidx_s, pidx_s, mask_s, w_s, k, lam0):
        local = bundle_adjust.BAProblem(
            cam_params=cam,
            points=pts_s[0],
            intrinsics=k,
            obs=obs_s[0],
            frame_idx=fidx_s[0],
            point_idx=pidx_s[0],
            mask=mask_s[0],
            weight=w_s[0],
        )
        res = bundle_adjust.solve_ba(
            local, config=config, axis_name="data", init_lambda=lam0
        )
        return res._replace(points=res.points[None])

    # Host copies: arrays the caller committed to one device would clash
    # with the mesh's placement.
    res = run(
        np.asarray(problem.cam_params),
        jnp.asarray(pts_sharded),
        jnp.asarray(obs_l),
        jnp.asarray(fidx_l),
        jnp.asarray(pidx_l),
        jnp.asarray(mask_l),
        jnp.asarray(w_l),
        np.asarray(problem.intrinsics),
        jnp.asarray(
            config.init_lambda if init_lambda is None else init_lambda,
            jnp.float32,
        ),
    )
    return res._replace(points=res.points.reshape(d * pl, 3)[:p_total])


def match_descriptors_tp(
    mesh: Mesh,
    query: jax.Array,
    train: jax.Array,
    query_mask: jax.Array,
    train_mask: jax.Array,
    ratio: float = 0.75,
    max_distance: float = 256.0,
):
    """Tensor-parallel knn(2) Hamming matching over the ``model`` axis.

    The (Q, T) distance matrix never materializes globally: each core holds a
    (Q, T/m) slab, reduces it to per-row local top-2 candidates, and a single
    ``all_gather`` of those (Q, 2) candidates produces the exact global
    top-2. Returns (best_train_idx, best_dist, good_mask) per query row.
    """
    m = mesh.shape["model"]
    t = train.shape[0]
    assert t % m == 0, (t, m)

    from meatmodeler_tpu.ops.matching import hamming_matrix

    # check_vma off: after the all_gather every core computes the identical
    # reduction, so the outputs are replicated — a fact the static checker
    # cannot infer.
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("model"), P(), P("model")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def run(q, t_shard, qm, tm_shard):
        shard_idx = jax.lax.axis_index("model")
        big = jnp.float32(1e9)
        d = hamming_matrix(q, t_shard)
        d = jnp.where(tm_shard[None, :], d, big)
        d = jnp.where(qm[:, None], d, big)

        local_best = jnp.argmin(d, axis=1)
        local_best_d = jnp.take_along_axis(d, local_best[:, None], axis=1)[:, 0]
        d2 = d.at[jnp.arange(d.shape[0]), local_best].set(big)
        local_second_d = jnp.min(d2, axis=1)
        local_best_global = local_best + shard_idx * t_shard.shape[0]

        # Gather each core's two candidates; reduce to global top-2.
        cand_d = jax.lax.all_gather(
            jnp.stack([local_best_d, local_second_d], axis=1), "model"
        )  # (m, Q, 2)
        cand_i = jax.lax.all_gather(local_best_global, "model")  # (m, Q)

        q_n = q.shape[0]
        flat_d = jnp.moveaxis(cand_d, 0, 1).reshape(q_n, -1)  # (Q, 2m)
        best_slot = jnp.argmin(flat_d, axis=1)
        best_d = jnp.take_along_axis(flat_d, best_slot[:, None], axis=1)[:, 0]
        flat_d2 = flat_d.at[jnp.arange(q_n), best_slot].set(big)
        second_d = jnp.min(flat_d2, axis=1)
        # The global best always comes from some core's *local best* slot.
        best_core = best_slot // 2
        best_idx = jnp.take_along_axis(
            jnp.moveaxis(cand_i, 0, 1), best_core[:, None], axis=1
        )[:, 0]

        good = (best_d < ratio * second_d) & (best_d <= max_distance) & qm
        return best_idx.astype(jnp.int32), best_d, good

    return run(query, train, query_mask, train_mask)
