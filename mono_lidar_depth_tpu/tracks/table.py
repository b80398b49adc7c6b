"""Fixed-capacity tracklet table.

Batched replacement for the reference's tracklet cache — a GC'd
`std::map<id, feature_tracking::Tracklet>` with per-frame push_front
(`tracklet_depth_module.cpp:119-207`).  Here the table is a ring of
`max_tracks` slots over dense `[T, L]` arrays:

  * slot column 0 is the NEWEST frame (matching the reference's
    "feature_points newest first" message convention,
    matches_msg_depth_ros/msg/Tracklet.msg);
  * pushing a frame is a roll along L + write at column 0;
  * the reference's TidyUpTracklets GC (drop tracks that got no update
    this frame, tracklet_depth_module.cpp:171-193) becomes freeing the
    un-matched slots before allocation;
  * id→slot matching is one [M, T] equality matmul-style reduction —
    no hash map, fully parallel.

All functions are pure and jit/scan-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

FREE = jnp.int32(-1)


class TrackTable(NamedTuple):
    """[T]-slot track store; L = per-track frame window (newest first)."""

    track_id: jnp.ndarray  # [T] int32 external track id, -1 = free slot
    age: jnp.ndarray  # [T] int32 number of pushes - 1 (reference `age_`)
    length: jnp.ndarray  # [T] int32 valid frames in the window (<= L)
    uv: jnp.ndarray  # [T, L, 2] f32 feature track, col 0 newest
    depth: jnp.ndarray  # [T, L] f32 depth per frame entry (-1 = none)
    stamps: jnp.ndarray  # [L] f64/f32 frame timestamps, col 0 newest

    @classmethod
    def create(cls, max_tracks: int, max_length: int,
               stamp_dtype=jnp.float32) -> "TrackTable":
        T, L = max_tracks, max_length
        return cls(
            track_id=jnp.full((T,), FREE, jnp.int32),
            age=jnp.zeros((T,), jnp.int32),
            length=jnp.zeros((T,), jnp.int32),
            uv=jnp.zeros((T, L, 2), jnp.float32),
            depth=jnp.full((T, L), -1.0, jnp.float32),
            stamps=jnp.zeros((L,), stamp_dtype),
        )

    @property
    def capacity(self) -> int:
        return self.track_id.shape[0]

    @property
    def window(self) -> int:
        return self.depth.shape[1]

    def active(self) -> jnp.ndarray:
        return self.track_id != FREE


def match_tracks(table: TrackTable, ids: jnp.ndarray, ids_valid: jnp.ndarray
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Match incoming track ids to table slots.

    Returns (slot [M] int32 — existing slot index or -1, is_new [M]).
    Replaces `_trackletMap.count(id)` (tracklet_depth_module.cpp:32).
    """
    eq = (ids[:, None] == table.track_id[None, :]) & table.active()[None, :]
    found = jnp.any(eq, axis=1)
    slot = jnp.where(found, jnp.argmax(eq, axis=1).astype(jnp.int32), FREE)
    is_new = ids_valid & ~found
    return slot, is_new


def update_tracks(
    table: TrackTable,
    ids: jnp.ndarray,
    ids_valid: jnp.ndarray,
    uv_new: jnp.ndarray,
    uv_prev: jnp.ndarray,
    depths_new: jnp.ndarray,
    depths_prev: jnp.ndarray,
    stamp: jnp.ndarray,
    match: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> tuple[TrackTable, jnp.ndarray]:
    """One frame of tracklet bookkeeping.

    Semantics mirror `SaveFeatureDepths` + `TidyUpTracklets` +
    `TidyUpTimeStamps` (tracklet_depth_module.cpp:119-207):
      * tracks absent from `ids` are dropped (GC);
      * brand-new tracks are seeded with TWO frames — the previous
        frame's feature (uv_prev / depths_prev) then the newest
        (ExractNewTrackletFrames two-feature rule, :36-46);
      * existing tracks push one new frame;
      * timestamps shift with the newest stamp at column 0.

    Args:
      ids/ids_valid: [M] incoming track ids + padding mask.
      uv_new: [M, 2] newest feature per track.
      uv_prev: [M, 2] previous-frame feature (used for new tracks only).
      depths_new: [M] depth of newest feature (current frame cloud).
      depths_prev: [M] depth of previous feature (last frame cloud).
      stamp: scalar timestamp of this frame.
      match: optional precomputed match_tracks(table, ids, ids_valid)
        result, so callers that already matched don't pay the [M, T]
        reduction twice.

    Returns (table, slot [M] — the slot each incoming track landed in).
    """
    T, L = table.capacity, table.window

    slot_exist, is_new = (match if match is not None
                          else match_tracks(table, ids, ids_valid))

    # --- GC: free every slot that is not matched this frame.
    hit = (slot_exist >= 0) & ids_valid
    matched = jnp.zeros((T,), bool).at[
        jnp.where(hit, slot_exist, T)].max(hit, mode="drop")
    keep = table.active() & matched

    # --- allocate free slots (in slot order) to new tracks (in input
    # order): new track with rank r takes the r-th free slot.
    free = ~keep  # [T]
    # free_list[r] = index of r-th free slot
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1  # rank per slot
    free_list = jnp.full((T,), FREE, jnp.int32).at[
        jnp.where(free, free_rank, T)].set(
        jnp.arange(T, dtype=jnp.int32), mode="drop")
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    num_free = jnp.sum(free.astype(jnp.int32))
    overflow = new_rank >= num_free  # table full: drop the track
    slot_new = jnp.where(
        is_new & ~overflow,
        free_list[jnp.clip(new_rank, 0, T - 1)], FREE)
    slot = jnp.where(is_new, slot_new, slot_exist)
    landing = (slot >= 0) & ids_valid

    # --- reset freed / newly-allocated slots.
    reset = free
    track_id = jnp.where(reset, FREE, table.track_id)
    age = jnp.where(reset, 0, table.age)
    length = jnp.where(reset, 0, table.length)
    uv = jnp.where(reset[:, None, None], 0.0, table.uv)
    depth = jnp.where(reset[:, None], -1.0, table.depth)

    # Scatter index for each incoming lane; non-landing lanes target the
    # (dropped) out-of-bounds index T so duplicate-index writes cannot
    # clobber a real slot.
    tgt = jnp.where(landing, slot, T)

    # --- seed new tracks with the PREVIOUS frame entry first.
    seed = landing & is_new
    seed_tgt = jnp.where(seed, slot, T)
    track_id = track_id.at[seed_tgt].set(ids, mode="drop")
    uv = uv.at[seed_tgt, 0].set(uv_prev, mode="drop")
    depth = depth.at[seed_tgt, 0].set(depths_prev, mode="drop")
    length = length.at[seed_tgt].set(1, mode="drop")

    # --- push the newest frame for ALL landing tracks: shift right.
    push = jnp.zeros((T,), bool).at[tgt].max(landing, mode="drop")
    seeded = jnp.zeros((T,), bool).at[seed_tgt].max(seed, mode="drop")
    uv_shifted = jnp.concatenate([uv[:, :1], uv[:, :-1]], axis=1)
    depth_shifted = jnp.concatenate([depth[:, :1], depth[:, :-1]], axis=1)
    uv = jnp.where(push[:, None, None], uv_shifted, uv)
    depth = jnp.where(push[:, None], depth_shifted, depth)
    uv = uv.at[tgt, 0].set(uv_new, mode="drop")
    depth = depth.at[tgt, 0].set(depths_new, mode="drop")
    length = jnp.where(push, jnp.minimum(length + 1, L), length)
    # Age: entries seen - 1.  (The reference sets age_ = 0 at creation
    # and never increments it for existing tracks,
    # tracklet_depth_module.cpp:139-141 — the published age is stuck at
    # 0; we keep a meaningful per-track age instead.  Documented
    # deviation.)
    age = jnp.where(push, jnp.where(seeded, 1, age + 1), age)
    age = jnp.where(reset & ~push, 0, age)

    stamps = jnp.concatenate([stamp[None].astype(table.stamps.dtype),
                              table.stamps[:-1]])

    out = TrackTable(track_id=track_id, age=age, length=length,
                     uv=uv, depth=depth, stamps=stamps)
    return out, slot
