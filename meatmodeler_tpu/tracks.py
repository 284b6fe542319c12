"""SoA track store: fixed-capacity device arrays replacing dict-of-``Track``.

The reference stores correspondences as a Python list of ``Track`` objects
keyed by float coordinates, associated by *exact float-tuple equality* in an
O(matches x tracks) nested loop (``pointTracking``, ``processor.py:190-243``;
``track.py``) — SURVEY.md §3.4 calls this the single biggest impedance
mismatch with XLA. Here:

  * structure-of-arrays with static capacities: ``coords[T, F, 2]``,
    ``obs_mask[T, F]``, ``alive[T]``, plus ``last_feature_idx[T]`` — the
    index of each live track's keypoint in the previous keyframe's feature
    set. Association is by descriptor *index* (robust; the reference's
    float-equality trick works only by accident of float reuse, SURVEY.md
    §7.1).
  * ``update_tracks`` is a pure jittable function: one scatter builds a
    feature->match lookup, live tracks extend/pop in parallel, and unmatched
    matches claim free slots via a prefix-sum allocator. O(T + M), no loops.

A thin ``Track`` view class mirrors the reference's ``track.py`` API for
compatibility.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "TrackStore",
    "make_store",
    "update_tracks",
    "update_tracks_scan",
    "finalize_tracks",
    "Track",
]


class TrackStore(NamedTuple):
    coords: jax.Array  # (T, F, 2) float32 pixel coords per keyframe
    obs_mask: jax.Array  # (T, F) bool
    alive: jax.Array  # (T,) bool — still being extended
    used: jax.Array  # (T,) bool — slot allocated at some point
    last_feature_idx: jax.Array  # (T,) int32 — keypoint index in the latest keyframe
    points: jax.Array  # (T, 3) float32 triangulated points (filled later)
    # Pyramid octave of each observation (meaningful where obs_mask is set):
    # positional uncertainty ~ scale_factor**octave px (drives scale-aware
    # outlier gates and per-observation inverse-variance BA weights).
    octaves: jax.Array  # (T, F) int32

    @property
    def capacity(self):
        return self.coords.shape[0]

    @property
    def max_keyframes(self):
        return self.coords.shape[1]


def make_store(max_tracks: int, max_keyframes: int) -> TrackStore:
    return TrackStore(
        coords=jnp.zeros((max_tracks, max_keyframes, 2), jnp.float32),
        obs_mask=jnp.zeros((max_tracks, max_keyframes), bool),
        alive=jnp.zeros(max_tracks, bool),
        used=jnp.zeros(max_tracks, bool),
        last_feature_idx=jnp.full(max_tracks, -1, jnp.int32),
        points=jnp.zeros((max_tracks, 3), jnp.float32),
        octaves=jnp.zeros((max_tracks, max_keyframes), jnp.int32),
    )


@jax.jit
def update_tracks(
    store: TrackStore,
    prev_kf_id: jax.Array,
    kf_id: jax.Array,
    match_query: jax.Array,  # (M,) feature idx in previous keyframe
    match_train: jax.Array,  # (M,) feature idx in current keyframe
    match_mask: jax.Array,  # (M,) bool
    prev_xy: jax.Array,  # (K, 2) previous keyframe keypoint positions
    curr_xy: jax.Array,  # (K, 2) current keyframe keypoint positions
    prev_octave: Optional[jax.Array] = None,  # (K,) int32 pyramid octave
    curr_octave: Optional[jax.Array] = None,  # (K,) int32
) -> TrackStore:
    """One keyframe step of ``pointTracking`` (``processor.py:190-243``).

    Live tracks whose last feature matched are extended; unmatched live
    tracks are popped (finalized, ``processor.py:233-238``); leftover matches
    spawn new 2-observation tracks (``processor.py:226-231``).
    """
    t_cap = store.capacity
    n_feats = prev_xy.shape[0]
    m_cap = match_query.shape[0]
    if prev_octave is None:
        prev_octave = jnp.zeros(n_feats, jnp.int32)
    if curr_octave is None:
        curr_octave = jnp.zeros(curr_xy.shape[0], jnp.int32)

    # feature index in prev keyframe -> match row (or -1). Masked rows
    # scatter to an out-of-bounds index, which drop-mode discards.
    rows = jnp.arange(m_cap, dtype=jnp.int32)
    match_of_feat = jnp.full(n_feats, -1, jnp.int32).at[
        jnp.where(match_mask, match_query, n_feats)
    ].set(rows, mode="drop")

    # --- extend / pop live tracks ---
    live_feat = jnp.where(store.alive, store.last_feature_idx, n_feats)  # OOB for dead
    m_row = jnp.where(
        store.alive, jnp.take(match_of_feat, jnp.clip(live_feat, 0, n_feats - 1)), -1
    )
    extended = store.alive & (m_row >= 0)
    new_train = jnp.take(match_train, jnp.clip(m_row, 0, m_cap - 1))
    new_xy = jnp.take(curr_xy, jnp.clip(new_train, 0, curr_xy.shape[0] - 1), axis=0)

    coords = store.coords.at[:, kf_id].set(
        jnp.where(extended[:, None], new_xy, store.coords[:, kf_id])
    )
    obs_mask = store.obs_mask.at[:, kf_id].set(
        jnp.where(extended, True, store.obs_mask[:, kf_id])
    )
    alive = extended  # non-extended live tracks are popped
    last_feature_idx = jnp.where(extended, new_train, store.last_feature_idx)
    new_oct = jnp.take(curr_octave, jnp.clip(new_train, 0, curr_octave.shape[0] - 1))
    octaves = store.octaves.at[:, kf_id].set(
        jnp.where(extended, new_oct, store.octaves[:, kf_id])
    )

    # --- which matches were consumed by an extension? ---
    consumed = jnp.zeros(m_cap, bool).at[jnp.where(extended, m_row, m_cap)].set(
        True, mode="drop"
    )
    is_new = match_mask & ~consumed

    # --- allocate free slots for new tracks (prefix-sum allocator) ---
    free = ~store.used
    # free slot ids in order: sort puts free slots (keyed by index) first.
    slot_key = jnp.where(free, jnp.arange(t_cap), t_cap + jnp.arange(t_cap))
    free_slots = jnp.argsort(slot_key)  # first num_free entries are free slot ids
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # rank among new matches
    num_free = jnp.sum(free.astype(jnp.int32))
    can_alloc = is_new & (new_rank < num_free)
    slot_of_match = jnp.take(free_slots, jnp.clip(new_rank, 0, t_cap - 1))

    tgt = jnp.where(can_alloc, slot_of_match, t_cap)  # OOB -> dropped
    q_xy = jnp.take(prev_xy, jnp.clip(match_query, 0, n_feats - 1), axis=0)
    t_xy = jnp.take(curr_xy, jnp.clip(match_train, 0, curr_xy.shape[0] - 1), axis=0)

    coords = coords.at[tgt, prev_kf_id].set(q_xy, mode="drop")
    coords = coords.at[tgt, kf_id].set(t_xy, mode="drop")
    obs_mask = obs_mask.at[tgt, prev_kf_id].set(True, mode="drop")
    obs_mask = obs_mask.at[tgt, kf_id].set(True, mode="drop")
    alive = alive.at[tgt].set(True, mode="drop")
    used = store.used.at[tgt].set(True, mode="drop")
    last_feature_idx = last_feature_idx.at[tgt].set(match_train, mode="drop")
    q_oct = jnp.take(prev_octave, jnp.clip(match_query, 0, n_feats - 1))
    t_oct = jnp.take(curr_octave, jnp.clip(match_train, 0, curr_octave.shape[0] - 1))
    octaves = octaves.at[tgt, prev_kf_id].set(q_oct, mode="drop")
    octaves = octaves.at[tgt, kf_id].set(t_oct, mode="drop")

    return TrackStore(coords, obs_mask, alive, used, last_feature_idx, store.points, octaves)


@jax.jit
def update_tracks_scan(
    store: TrackStore,
    query_idx: jax.Array,  # (F-1, M) per-pair query feature indices
    train_idx: jax.Array,  # (F-1, M)
    match_mask: jax.Array,  # (F-1, M)
    xy: jax.Array,  # (F, K, 2) per-keyframe keypoint positions
    octave: Optional[jax.Array] = None,  # (F, K) per-keypoint pyramid octave
) -> TrackStore:
    """All consecutive-pair track updates in ONE compiled ``lax.scan``.

    Identical state evolution to calling :func:`update_tracks` per pair (the
    scan body IS that function); one dispatch instead of F-1 — the per-call
    dispatch latency dominates the update's actual compute.
    """
    if octave is None:
        octave = jnp.zeros(xy.shape[:2], jnp.int32)

    def step(s, inp):
        k, q, t, m = inp
        return update_tracks(
            s, k, k + 1, q, t, m, xy[k], xy[k + 1], octave[k], octave[k + 1]
        ), None

    ks = jnp.arange(query_idx.shape[0], dtype=jnp.int32)
    s, _ = jax.lax.scan(step, store, (ks, query_idx, train_idx, match_mask))
    return s


def finalize_tracks(store: TrackStore) -> TrackStore:
    """End of video: all remaining live tracks are implicitly popped
    (``processor.py:418``)."""
    return store._replace(alive=jnp.zeros_like(store.alive))


def triangulation_endpoints(store: TrackStore):
    """Per-track (first, last) observation — the reference's widest-baseline
    pair (``track.py:30-32``). Returns (first_kf, last_kf, first_xy, last_xy,
    valid) with valid = has >= 2 observations.
    """
    f_max = store.max_keyframes
    kf_ids = jnp.arange(f_max)
    first_kf = jnp.argmax(store.obs_mask, axis=1)
    last_kf = f_max - 1 - jnp.argmax(store.obs_mask[:, ::-1], axis=1)
    n_obs = jnp.sum(store.obs_mask, axis=1)
    valid = store.used & (n_obs >= 2)
    first_xy = jnp.take_along_axis(store.coords, first_kf[:, None, None].repeat(2, -1), axis=1)[:, 0]
    last_xy = jnp.take_along_axis(store.coords, last_kf[:, None, None].repeat(2, -1), axis=1)[:, 0]
    return first_kf, last_kf, first_xy, last_xy, valid


def to_ba_arrays(store: TrackStore):
    """Flatten the store into the BA observation lists (host-side, NumPy) —
    the role of ``managePoints`` (``processor.py:264-291``).

    Returns (points (P,3), obs (N,2), frame_idx (N,), point_idx (N,),
    track_ids (P,), obs_octave (N,)) over tracks with >= 2 observations, in
    track-major order like the reference.
    """
    # One batched fetch: device_get issues async copies for every leaf
    # before blocking, so the five arrays cost one round trip, not five.
    coords, obs_mask, used, pts, octaves = jax.device_get(
        (store.coords, store.obs_mask, store.used, store.points, store.octaves)
    )

    n_obs = obs_mask.sum(1)
    keep = used & (n_obs >= 2)
    track_ids = np.nonzero(keep)[0]

    points = pts[track_ids]
    t_idx, f_idx = np.nonzero(obs_mask[track_ids])
    obs = coords[track_ids][t_idx, f_idx]
    obs_octave = octaves[track_ids][t_idx, f_idx]
    return (
        points,
        obs,
        f_idx.astype(np.int32),
        t_idx.astype(np.int32),
        track_ids,
        obs_octave.astype(np.int32),
    )


class Track:
    """Compatibility view mirroring the reference's ``track.py`` API."""

    def __init__(self, prev_frame_id, feature, frame_id, correspondent):
        self.coordinates = {prev_frame_id: feature, frame_id: correspondent}
        self.point = None
        self.updated = False

    def update(self, frame_id, correspondent):
        self.coordinates[frame_id] = correspondent
        self.updated = True

    def reset(self):
        self.updated = False

    def wasUpdated(self):
        return self.updated

    def getCoordinate(self, frame_id):
        return self.coordinates.get(frame_id)

    def getTriangulationData(self):
        frames = list(self.coordinates.keys())
        return frames[0], frames[-1], self.coordinates.get(frames[0]), self.coordinates.get(frames[-1])

    def getCoordinates(self):
        return self.coordinates

    def setPoint(self, point):
        self.point = point

    def getPoint(self):
        return self.point


def views_from_store(store: TrackStore):
    """Materialize reference-style ``Track`` objects from the SoA store."""
    coords = np.asarray(store.coords)
    obs_mask = np.asarray(store.obs_mask)
    used = np.asarray(store.used)
    pts = np.asarray(store.points)
    out = []
    for t in np.nonzero(used)[0]:
        kf_ids = np.nonzero(obs_mask[t])[0]
        if len(kf_ids) < 2:
            continue
        tr = Track(int(kf_ids[0]), tuple(coords[t, kf_ids[0]]), int(kf_ids[1]), tuple(coords[t, kf_ids[1]]))
        for k in kf_ids[2:]:
            tr.update(int(k), tuple(coords[t, k]))
            tr.reset()
        tr.setPoint(pts[t : t + 1])
        out.append(tr)
    return out
