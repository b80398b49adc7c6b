"""Vectorized first-local-max depth-blob segmentation.

Batched replacement for `PointHistogram::FilterPointsMinDistBlob`
(HistogramPointDepth.cpp:15-123) + `Histogram` (Histogram.cpp).  The
reference's sequential bin scan becomes a cummax/argmax program over a
static [N, B] count tensor; all N features segment simultaneously.

Reference scan semantics, replicated exactly (see
HistogramPointDepth.cpp:70-85):

  for b in bins ascending:
    if count[b] > running_max and count[b] >= min_count: update max (bin b)
    elif count[b] < running_max: BREAK          (first local max found)
    if count[b-1] > 0 and count[b] == 0: FAIL   (gap before any max)

  selected bin = the bin where running_max was last updated; FAIL if
  none qualified.  Output = points with depth in [bin*w, bin*w + w).

Vectorized formulation (proved equivalent in tests):
  M[b]     = cummax over b' <= b of (count[b'] if count[b'] >= min_count else -1)
  break_b  = count[b] < M[b-1]          (first such b ends the scan; a
                                         break implies M[b-1] >= min_count)
  abort_b  = count[b-1] > 0 and count[b] == 0 and not break_b
             (a gap with running max set always triggers break_b first,
              so abort_b only fires while no max was found)
  success  = first break before first abort, or clean scan with a max.

Deviation from the reference (documented in config.histogram_max_depth):
the reference sizes the histogram per feature to ceil(max depth) and
clamps huge values into its last bin (Histogram.cpp:29-31); here the bin
range is static [0, histogram_max_depth] with the same last-bin clamp.
Outcomes differ only for points beyond histogram_max_depth (default
150 m), which the global depth gate (100 m) disposes of regardless.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class HistogramSegmentation(NamedTuple):
    seg_mask: jnp.ndarray  # [N, K] points inside the selected bin
    found: jnp.ndarray  # [N] bool: local max found
    lower: jnp.ndarray  # [N] selected bin lower border
    upper: jnp.ndarray  # [N] selected bin upper border
    bin_id: jnp.ndarray  # [N] selected bin index (-1 if not found)


def filter_points_min_dist_blob(
    depths: jnp.ndarray,
    mask: jnp.ndarray,
    bin_width: float,
    min_pointcount: int,
    num_bins: int,
) -> HistogramSegmentation:
    """Segment neighbor depths by the first local-max histogram bin.

    Sort-based formulation (the default): instead of scattering counts
    into a [N, B] bin tensor and scanning B bins, sort the K bin ids per
    feature and run the break/abort scan over the <= K occupied-bin
    GROUPS — empty bins between groups are handled by the gap rules.
    Equivalent outcomes (fuzz-verified against the literal-semantics
    oracle in tests), with no scatter (K << B lanes).

    Args:
      depths: [N, K] neighbor camera-z values (only masked entries used).
      mask: [N, K] neighbor validity.
      bin_width: histogram_segmentation_bin_witdh.
      min_pointcount: histogram_segmentation_min_pointcount (>= 1).
      num_bins: static bin count B (config.histogram_bins).
    """
    N, K = depths.shape
    B = num_bins

    # DepthEstimator.cpp:743 clamp + static-range bin clamp.
    d = jnp.minimum(depths, 999.0)
    bins = jnp.clip((jnp.abs(d) / bin_width).astype(jnp.int32), 0, B - 1)
    bins_m = jnp.where(mask, bins, B)  # invalid → sentinel bin B, sorts last
    sb = jnp.sort(bins_m, axis=1)
    karr = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[None, :], (N, K))
    valid = sb < B
    prev_sb = jnp.concatenate(
        [jnp.full((N, 1), -1, sb.dtype), sb[:, :-1]], axis=1)
    is_start = valid & (sb != prev_sb)

    # Group run lengths: next group-start position minus own position.
    startpos = jnp.where(is_start, karr, K)
    suffmin = jnp.flip(jax.lax.cummin(jnp.flip(startpos, 1), axis=1), 1)
    next_start = jnp.concatenate(
        [suffmin[:, 1:], jnp.full((N, 1), K, jnp.int32)], axis=1)
    n_valid = jnp.sum(valid, axis=1)
    gcount = jnp.where(
        is_start, jnp.minimum(next_start, n_valid[:, None]) - karr, 0)

    # Scan over groups (reference loop semantics, see module docstring):
    #   gap before a group with no max yet        → abort
    #   gap before a group with a max             → break (at the gap)
    #   group count below the running max         → break
    gap_before = is_start & (prev_sb >= 0) & (sb > prev_sb + 1)
    qual = jnp.where(is_start & (gcount >= min_pointcount), gcount, -1)
    M = jax.lax.cummax(qual, axis=1)
    Mprev = jnp.concatenate(
        [jnp.full((N, 1), -1, M.dtype), M[:, :-1]], axis=1)
    abort_b = gap_before & (Mprev == -1)
    break_b = (gap_before & (Mprev >= 0)) | (
        is_start & (gcount < Mprev) & ~gap_before)

    fb = _first_true(break_b, K)
    fa = _first_true(abort_b, K)
    Mprev_at_fb = jnp.take_along_axis(
        Mprev, jnp.minimum(fb, K - 1)[:, None], axis=1)[:, 0]
    M_last = M[:, -1]
    clean = (fb == K) & (fa == K)
    # Clean scan: trailing empty bins after the last group break (max
    # set) or abort (no max) — net: found iff a qualifying max exists.
    found = jnp.where(fb < fa, True,
                      jnp.where(fa < fb, False, clean & (M_last >= 0)))
    target = jnp.where(fb < K, Mprev_at_fb, M_last)
    cand = (is_start & (qual == target[:, None]) & (target[:, None] >= 0)
            & (karr < jnp.minimum(fb, fa)[:, None]))
    sel = _first_true(cand, K)
    bin_id = jnp.take_along_axis(
        sb, jnp.minimum(sel, K - 1)[:, None], axis=1)[:, 0]
    found = found & jnp.any(valid, axis=1) & (sel < K)
    bin_id = jnp.where(found, bin_id, -1)

    lower = bin_id.astype(d.dtype) * bin_width
    upper = lower + bin_width  # HistogramPointDepth.cpp:99-101
    seg_mask = (mask & (d >= lower[:, None]) & (d < upper[:, None])
                & found[:, None])
    return HistogramSegmentation(
        seg_mask=seg_mask,
        found=found,
        lower=jnp.where(found, lower, -1.0),
        upper=jnp.where(found, upper, -1.0),
        bin_id=bin_id,
    )


def filter_points_min_dist_blob_scatter(
    depths: jnp.ndarray,
    mask: jnp.ndarray,
    bin_width: float,
    min_pointcount: int,
    num_bins: int,
) -> HistogramSegmentation:
    """Scatter-based variant (counts in a dense [N, B] tensor + bin
    scan) — kept as the cross-check implementation for tests."""
    N, K = depths.shape
    B = num_bins

    # DepthEstimator.cpp:743 clamps depths at 999 before histogramming;
    # the static bin range then clamps into the last bin.
    d = jnp.minimum(depths, 999.0)
    bins = jnp.clip((jnp.abs(d) / bin_width).astype(jnp.int32), 0, B - 1)
    bins = jnp.where(mask, bins, B)  # trash bin for invalid entries

    row = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, K))
    counts = jnp.zeros((N, B + 1), dtype=jnp.int32)
    counts = counts.at[row, bins].add(1)
    counts = counts[:, :B]

    qual = jnp.where(counts >= min_pointcount, counts, -1)
    M = jax.lax.cummax(qual, axis=1)
    Mprev = jnp.concatenate(
        [jnp.full((N, 1), -1, dtype=M.dtype), M[:, :-1]], axis=1)
    prev_counts = jnp.concatenate(
        [jnp.zeros((N, 1), dtype=counts.dtype), counts[:, :-1]], axis=1)

    break_b = counts < Mprev
    abort_b = (prev_counts > 0) & (counts == 0) & ~break_b

    first_break = _first_true(break_b, B)
    first_abort = _first_true(abort_b, B)

    clean = (first_break == B) & (first_abort == B)
    target = jnp.where(first_break < B,
                       jnp.take_along_axis(Mprev, jnp.minimum(first_break, B - 1)[:, None],
                                           axis=1)[:, 0],
                       M[:, -1])
    found = (first_break < first_abort) | (clean & (M[:, -1] >= 0))
    # The reference additionally fails when binCount <= 1, i.e. when the
    # masked set is empty (max depth 0); empty mask → all counts 0 → no
    # qualifying bin → found is already False.

    # Selected bin: FIRST bin b with count[b] == target and count[b] >=
    # min_count (strict-> update rule keeps the earliest maximizer).
    cand = (counts == target[:, None]) & (counts >= min_pointcount)
    bin_id = _first_true(cand, B)
    bin_id = jnp.where(found, bin_id, -1)

    lower = bin_id.astype(d.dtype) * bin_width
    upper = lower + bin_width  # HistogramPointDepth.cpp:99-101
    seg_mask = mask & (d >= lower[:, None]) & (d < upper[:, None])
    seg_mask = seg_mask & found[:, None]

    return HistogramSegmentation(
        seg_mask=seg_mask,
        found=found,
        lower=jnp.where(found, lower, -1.0),
        upper=jnp.where(found, upper, -1.0),
        bin_id=bin_id,
    )


def nearest_point(depths: jnp.ndarray, mask: jnp.ndarray
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Index of the minimum-depth masked entry per row, and whether the
    row has any entry (PointHistogram::GetNearestPoint semantics —
    implemented index-correct; the reference has a latent neighbor-index
    bug at HistogramPointDepth.cpp:146)."""
    d = jnp.where(mask, depths, jnp.inf)
    idx = jnp.argmin(d, axis=-1)
    return idx.astype(jnp.int32), jnp.any(mask, axis=-1)


def _first_true(flags: jnp.ndarray, fill: int) -> jnp.ndarray:
    """Index of first True along the last axis; `fill` if none."""
    any_ = jnp.any(flags, axis=-1)
    idx = jnp.argmax(flags, axis=-1)
    return jnp.where(any_, idx, fill).astype(jnp.int32)
