"""KITTI odometry evaluation (BASELINE.json configs 2-4).

  config 2: per-sequence depth association — success-rate statistics
            against the reference's published numbers
            (22.5% of all features / 82.7% of lidar-covered,
            monolidar_fusion/Logs/log_depth_calc_stats.txt).
  config 3: full VO with lidar depth priors + sliding-window BA —
            ATE RMSE / RPE against ground-truth poses.
  config 4: pose-graph backend over the VO trajectory with
            proximity-proposed, feature-verified loop closures.

All functions accept a KittiSequence; scripts/run_kitti.py is the CLI.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DepthEstimatorConfig
from ..core.geometry import SE3, PinholeCamera
from ..io.kitti import KittiSequence, pad_cloud
from ..obs.stats import DepthCalcStats, format_stats_report, success_rates
from ..precision import f32_matmuls
from ..tracker.frontend import init_tracker, track_frame
from ..tracks.pipeline import (FrameInput, TrackletDepthState, prime_state,
                               process_frame)
from ..vo.metrics import ate_rmse, rpe_stats
from ..vo.pipeline import OdometryConfig, OdometryState, odometry_step
from ..vo.pose import estimate_pose_gn
from ..vo.pose_graph import PoseGraph, optimize_pose_graph


# Frames per stacked device program in the scanned eval drivers.
# Bounds host RAM + HBM to O(chunk) frames — a full 4541-frame KITTI
# sequence host-stacked at once would be ~19 GB of clouds + images.
# Sequences up to one chunk (incl. the committed 220-frame record)
# still compile exactly one program; longer ones compile at most three
# shapes (first chunk, full chunk, tail) and dispatch once per chunk.
_CHUNK_FRAMES = 256


def _load_payload(seq: KittiSequence, cfg: DepthEstimatorConfig,
                  f: int, xyzi, count, use_semantics: bool):
    """The ONE per-frame payload protocol (padded cloud, UINT8
    grayscale image, int32 semantic labels) shared by the streaming
    generator and the chunked/scanned eval drivers — keeping it single
    guarantees their bit-parity.

    Images ship as uint8 and are normalized to [0, 1] f32 ON DEVICE
    (`_dev_img`) — uint8 is 4x fewer host->device bytes than
    pre-normalized f32 for a bit-identical result (u8.astype(f32)/255
    is the same IEEE op sequence either side)."""
    cloud, cvalid = pad_cloud(xyzi, count, cfg.max_points)
    img = seq.image(f)
    if img is None:
        raise FileNotFoundError(
            f"sequence {seq.sequence} has no image_0 data")
    img = np.ascontiguousarray(img)  # uint8 [H, W]
    sem = None
    if use_semantics:
        sem = seq.semantic(f)
        if sem is None:
            raise FileNotFoundError(
                f"sequence {seq.sequence} has no semantic_0 data "
                f"(frame {f}) — semantic plane mode needs it")
        sem = sem.astype(np.int32)
    return cloud, cvalid, img, sem


def _dev_img(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 [H, W] -> [0, 1] f32, on device (see _load_payload)."""
    return img.astype(jnp.float32) / 255.0


def _prefetch_iter(gen, depth: int = 1):
    """Run a generator in a background thread with a bounded queue —
    host-side chunk prep (PNG decode + scan reads + stacking) overlaps
    device compute of the previous chunk.

    If the consumer abandons the iterator (an exception inside the
    eval loop, or an explicit .close()), the worker must not stay
    parked on a full queue holding hundreds of MB of staged chunks: a
    cancellation flag is checked around every blocking put, and the
    consumer's finally-block sets it, drains the queue, and closes the
    source generator."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    cancelled = threading.Event()

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # propagate into the consumer
            put(e)
        finally:
            gen.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancelled.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:  # pragma: no cover
                break
        t.join(timeout=5.0)


def _key_chain(n: int) -> np.ndarray:
    """[n-1, 2] PRNG keys, one split per PROCESSED frame (frames
    1..n-1) — the exact prev_key evolution of _frame_inputs."""
    key = jax.random.PRNGKey(0)
    keys = []
    for _ in range(n - 1):
        key, sub = jax.random.split(key)
        keys.append(np.asarray(sub))
    return (np.stack(keys) if keys
            else np.zeros((0, 2), np.uint32))


def _frame_inputs(seq: KittiSequence, cfg: DepthEstimatorConfig,
                  max_frames: Optional[int] = None,
                  prime: Optional[list] = None,
                  pyramid_levels: int = 4,
                  use_semantics: bool = False):
    """Generator of (FrameInput, frame index) over a sequence, driving
    the internal tracker on the grayscale images.  Frame 0 initializes
    the tracker; if `prime` is a list, its padded cloud is appended to
    it so the caller can prime the tracklet state (see
    tracks.pipeline.prime_state).  With `use_semantics` the sequence's
    semantic label images ride along (the reference's 4-way sync path);
    missing semantics raise."""
    tracker_state = None
    prev_key = jax.random.PRNGKey(0)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    scans = seq.scans(cfg.max_points)
    for f, (xyzi, count) in enumerate(scans):
        if f >= n:
            break
        cloud, cvalid, img, sem = _load_payload(
            seq, cfg, f, xyzi, count, use_semantics)
        if sem is not None:
            sem = jnp.asarray(sem)
        jimg = _dev_img(jnp.asarray(img))
        if tracker_state is None:
            tracker_state = init_tracker(jimg, cfg.max_features,
                                         levels=pyramid_levels)
            if prime is not None:
                prime.append((jnp.asarray(cloud), jnp.asarray(cvalid), sem))
            continue
        tracker_state, out = track_frame(tracker_state, jimg)
        prev_key, sub = jax.random.split(prev_key)
        stamp = float(seq.times[f]) if seq.times is not None else float(f)
        yield FrameInput(
            cloud=jnp.asarray(cloud), cloud_valid=jnp.asarray(cvalid),
            ids=out.ids, ids_valid=out.valid,
            uv_new=out.uv_new, uv_prev=out.uv_prev,
            stamp=jnp.asarray(stamp), rng=sub, semantic=sem), f


def _stack_chunks(seq: KittiSequence, cfg: DepthEstimatorConfig,
                  max_frames: Optional[int], use_semantics: bool,
                  chunk: Optional[int] = None,
                  start_frame: int = 0):
    """Yield a sequence as dense per-frame chunks for the scanned eval
    drivers: dicts of host arrays covering frames [start, start+C).
    Frame 0 (tracker-init / state-prime) rides in the first chunk.
    Per-frame payloads come from `_load_payload` (the same protocol as
    `_frame_inputs`, incl. the PRNG split chain); each chunk is ONE
    host→device transfer and ONE device program instead of per-frame
    dispatch, so per-dispatch latency is paid once per chunk.  keys[k]
    belongs to frame start+k (frame 0's slot is a dummy — frame 0 is
    never a scan step).

    `start_frame` starts chunking mid-sequence for checkpoint/resume:
    stamps and PRNG keys stay indexed by ABSOLUTE frame number (the
    key chain is deterministic in the frame index), so a resumed run
    sees byte-identical per-frame inputs to the straight-through run."""
    if chunk is None:
        chunk = _CHUNK_FRAMES  # resolved at call time (tests override)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    stamps_all = (np.asarray(seq.times[:n], np.float32)
                  if seq.times is not None
                  else np.arange(n, dtype=np.float32))
    keys_all = np.concatenate(
        [np.zeros((1, 2), np.uint32), _key_chain(n).astype(np.uint32)])
    imgs, clouds, cvalids, sems = [], [], [], []
    start = start_frame

    def flush(stop):
        out = {
            "images": np.stack(imgs),
            "clouds": np.stack(clouds),
            "cvalids": np.stack(cvalids),
            "sems": np.stack(sems) if use_semantics else None,
            "stamps": stamps_all[start:stop],
            "keys": keys_all[start:stop],
        }
        imgs.clear(), clouds.clear(), cvalids.clear(), sems.clear()
        return out

    for f, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        if f >= n:
            break
        if f < start_frame:
            continue
        cloud, cvalid, img, sem = _load_payload(
            seq, cfg, f, xyzi, count, use_semantics)
        imgs.append(img)
        clouds.append(cloud)
        cvalids.append(cvalid)
        if use_semantics:
            sems.append(sem)
        if len(imgs) == chunk:
            yield flush(f + 1), start
            start = f + 1
    if imgs:
        yield flush(start + len(imgs)), start


def _chunk_xs(arrs, skip_first: bool, with_sem: bool):
    """Scan-step inputs for one chunk (device arrays); skip_first drops
    the tracker-init/prime frame of the first chunk."""
    s = 1 if skip_first else 0
    xs = {"img": jnp.asarray(arrs["images"][s:]),
          "cloud": jnp.asarray(arrs["clouds"][s:]),
          "cvalid": jnp.asarray(arrs["cvalids"][s:]),
          "stamp": jnp.asarray(arrs["stamps"][s:]),
          "key": jnp.asarray(arrs["keys"][s:])}
    if with_sem:
        xs["sem"] = jnp.asarray(arrs["sems"][s:])
    return xs


@partial(jax.jit, static_argnames=("cfg", "camera", "with_sem"))
def _scan_depth_chunk(cfg, camera, lidar_to_cam, carry, xs,
                      with_sem: bool = False):
    """One chunk of frames of depth association as one device program."""
    def step(carry, x):
        tstate, dstate = carry
        tstate, out = track_frame(tstate, _dev_img(x["img"]))
        frame = FrameInput(
            cloud=x["cloud"], cloud_valid=x["cvalid"],
            ids=out.ids, ids_valid=out.valid,
            uv_new=out.uv_new, uv_prev=out.uv_prev,
            stamp=x["stamp"], rng=x["key"],
            semantic=x["sem"] if with_sem else None)
        dstate, _, _ = process_frame(cfg, camera, lidar_to_cam, dstate,
                                     frame)
        return (tstate, dstate), None

    carry, _ = jax.lax.scan(step, carry, xs)
    return carry


def eval_depth_sequence(seq: KittiSequence, cfg: DepthEstimatorConfig,
                        max_frames: Optional[int] = None,
                        max_tracks: int = 4096, max_length: int = 12,
                        verbose: bool = True,
                        plane_mode: str = "ransac") -> dict:
    """Config 2: depth-augmented tracklets over a sequence; returns the
    outcome statistics dict (success rates + counters).

    plane_mode: "ransac" (3-way-sync path) or "semantic" (4-way path —
    the ground plane comes from the sequence's semantic label images)."""
    if plane_mode not in ("ransac", "semantic"):
        raise ValueError(f"unknown plane_mode {plane_mode!r}")
    with_sem = plane_mode == "semantic"
    cam, l2c = seq.calib.camera, seq.calib.lidar_to_cam
    carry = None
    n = 0
    for arrs, start in _prefetch_iter(
            _stack_chunks(seq, cfg, max_frames, with_sem)):
        n = start + len(arrs["images"])
        if carry is None:
            sem0 = jnp.asarray(arrs["sems"][0]) if with_sem else None
            state = TrackletDepthState.create(cfg, max_tracks, max_length)
            state = prime_state(cfg, cam, l2c, state,
                                jnp.asarray(arrs["clouds"][0]),
                                jnp.asarray(arrs["cvalids"][0]),
                                jax.random.PRNGKey(1234), semantic=sem0)
            tracker = init_tracker(
                _dev_img(jnp.asarray(arrs["images"][0])),
                cfg.max_features, levels=4)
            carry = (tracker, state)
        carry = _scan_depth_chunk(cfg, cam, l2c, carry,
                                  _chunk_xs(arrs, start == 0, with_sem),
                                  with_sem=with_sem)
    counters = carry[1].counters
    frames = n - 1
    stats = DepthCalcStats.zeros()
    stats = stats._replace(accumulated=counters, frames=jnp.int32(frames))
    out = success_rates(np.asarray(counters))
    out["frames"] = frames
    out["counters"] = np.asarray(counters).tolist()
    if verbose:
        print(format_stats_report(stats))
    return out


@partial(jax.jit, static_argnames=("cfg", "ocfg", "camera"))
def _scan_vo_chunk(cfg, ocfg, camera, lidar_to_cam, carry, xs):
    """One chunk of frames of VO + window BA as one device program;
    returns per-frame (R_cw [C,3,3], t_cw [C,3], diag [C,3])."""
    def step(carry, x):
        tstate, ostate = carry
        tstate, out = track_frame(tstate, _dev_img(x["img"]))
        frame = FrameInput(
            cloud=x["cloud"], cloud_valid=x["cvalid"],
            ids=out.ids, ids_valid=out.valid,
            uv_new=out.uv_new, uv_prev=out.uv_prev,
            stamp=x["stamp"], rng=x["key"])
        ostate, R_cw, t_cw, diag = odometry_step(
            cfg, ocfg, camera, lidar_to_cam, ostate, frame)
        return (tstate, ostate), (R_cw, t_cw, diag)

    return jax.lax.scan(step, carry, xs)


def measure_depth_device_time(seq: KittiSequence,
                              cfg: DepthEstimatorConfig,
                              max_frames: Optional[int] = None,
                              max_tracks: int = 4096,
                              max_length: int = 12) -> dict:
    """Device-only time for the config-2 pipeline: stage every chunk on
    the device FIRST, then time only the scan dispatches (warm) — the
    denominator for the eval wall-clock figures.  The gap between this
    and the steady wall is host-side loading and host->device transfer;
    the record prints both so neither is mistaken for the other."""
    import time

    cam, l2c = seq.calib.camera, seq.calib.lidar_to_cam
    staged = []
    for arrs, start in _stack_chunks(seq, cfg, max_frames, False):
        staged.append((_chunk_xs(arrs, start == 0, False), arrs, start))
    arrs0 = staged[0][1]
    state = TrackletDepthState.create(cfg, max_tracks, max_length)
    state = prime_state(cfg, cam, l2c, state,
                        jnp.asarray(arrs0["clouds"][0]),
                        jnp.asarray(arrs0["cvalids"][0]),
                        jax.random.PRNGKey(1234))
    tracker = init_tracker(_dev_img(jnp.asarray(arrs0["images"][0])),
                           cfg.max_features, levels=4)

    def run():
        carry = (tracker, state)
        for xs, _, _ in staged:
            carry = _scan_depth_chunk(cfg, cam, l2c, carry, xs,
                                      with_sem=False)
        return float(jnp.sum(carry[1].counters).block_until_ready())

    run()  # compile + warm
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    n = sum(len(a["images"]) for _, a, _ in staged) - 1
    return {"device_s": dt, "frames": n,
            "device_ms_per_frame": 1e3 * dt / n}


def eval_vo_sequence(seq: KittiSequence, cfg: DepthEstimatorConfig,
                     ocfg: OdometryConfig = OdometryConfig(),
                     max_frames: Optional[int] = None,
                     max_tracks: int = 2048, max_length: int = 12,
                     verbose: bool = True,
                     start_frame: int = 0,
                     init_carry=None,
                     return_carry: bool = False) -> dict:
    """Config 3: full VO + sliding-window BA; ATE/RPE vs ground truth.

    Checkpoint/resume: pass `return_carry=True` to get the final
    (tracker, odometry) carry pytree in `out["carry"]` (snapshot it
    with io.checkpoint.save_checkpoint), and resume with
    `start_frame=<next frame>` + `init_carry=<restored carry>`.  The
    PRNG chain and stamps are indexed by absolute frame number, so a
    resumed run is numerically identical to the straight-through run
    (asserted in tests/test_eval_chunking.py)."""
    if (start_frame > 0) != (init_carry is not None):
        raise ValueError("start_frame and init_carry go together")
    cam, l2c = seq.calib.camera, seq.calib.lidar_to_cam
    carry = init_carry
    n = 0
    Rs, ts, diags = [], [], []
    for arrs, start in _prefetch_iter(
            _stack_chunks(seq, cfg, max_frames, use_semantics=False,
                          start_frame=start_frame)):
        n = start + len(arrs["images"])
        if carry is None:
            state = OdometryState.create(cfg, ocfg, max_tracks, max_length)
            state = state._replace(tracklets=prime_state(
                cfg, cam, l2c, state.tracklets,
                jnp.asarray(arrs["clouds"][0]),
                jnp.asarray(arrs["cvalids"][0]), jax.random.PRNGKey(1234)))
            tracker = init_tracker(
                _dev_img(jnp.asarray(arrs["images"][0])),
                cfg.max_features, levels=4)
            carry = (tracker, state)
        carry, (Rc, tc, dc) = _scan_vo_chunk(
            cfg, ocfg, cam, l2c, carry,
            _chunk_xs(arrs, start == 0, with_sem=False))
        Rs.append(np.asarray(Rc))
        ts.append(np.asarray(tc))
        diags.append(np.asarray(dc))
    R = np.concatenate(Rs)
    t = np.concatenate(ts)
    diag = np.concatenate(diags)
    F = R.shape[0]
    poses = np.tile(np.eye(4), (F, 1, 1))
    poses[:, :3, :3] = R.transpose(0, 2, 1)
    poses[:, :3, 3] = -np.einsum("fij,fj->fi", R.transpose(0, 2, 1), t)
    frame_ids = list(range(max(1, start_frame), n))
    out = {"frames": F, "poses": poses, "frame_ids": frame_ids,
           "diag": np.asarray(diag)}
    if return_carry:
        out["carry"] = carry
    if seq.gt_poses is not None:
        gt = seq.gt_poses[frame_ids]
        out["ate_rmse"] = ate_rmse(poses[:, :3, 3], gt[:, :3, 3])
        out["ate_rmse_scaled"] = ate_rmse(poses[:, :3, 3], gt[:, :3, 3],
                                          with_scale=True)
        out.update({f"rpe_{k}": v
                    for k, v in rpe_stats(poses, gt).items()})
        if verbose:
            print(f"ATE RMSE: {out['ate_rmse']:.3f} m "
                  f"(scale-aligned {out['ate_rmse_scaled']:.3f} m); "
                  f"RPE trans {out['rpe_trans_rmse']:.3f} m "
                  f"rot {out['rpe_rot_rmse_deg']:.3f} deg")
    return out


def propose_loop_closures(poses: np.ndarray, min_gap: int = 100,
                          radius: float = 10.0, stride: int = 5,
                          max_heading_deg: float = 45.0,
                          max_candidates: int = 50,
                          drift_frac: float = 0.03,
                          min_candidates: int = 1) -> list[tuple[int, int]]:
    """Loop-closure candidates over a trajectory.

    Accepts [F, 4, 4] poses (or [F, 3] positions — then no heading
    filter): pairs (i, j) with j - i >= min_gap, |p_i - p_j| below a
    DRIFT-AWARE radius, and relative heading below `max_heading_deg`
    (KLT verification can only match similar viewpoints;
    opposite-direction passes are skipped rather than wasted on doomed
    verification).

    The match radius for a pair grows with the path length driven
    between them: radius_ij = max(radius, drift_frac · pathlen(i→j)) —
    positions are ESTIMATED, and VO error grows with distance traveled
    (typically 1-3%), so a fixed radius proposes nothing exactly when
    closures matter most (high drift).  If a pass proposes fewer than
    `min_candidates`, drift_frac escalates ×2 and the heading
    tolerance widens with it (rotational drift corrupts the estimated
    relative heading just like positional drift corrupts distances) —
    but escalation is CAPPED at 20% of path length / 90° heading:
    beyond ~20% drift a "nearby" estimate carries no revisit
    information, and an uncapped escalation would manufacture
    candidates on any curved loop-FREE trajectory (a circular arc's
    chord is always shorter than its path), burning a verification
    round trip per spurious pair and raising the odds one falsely
    verifies.  `min_candidates` > 1 matters under HEAVY drift: the
    first non-empty pass often finds only the least-drifted revisit,
    and a backend fed one closure can at best anchor one point — the
    escalation keeps widening until the proposal covers the loop or
    the physical caps land (measured on the 0.5°/frame-yaw + 8%-scale
    leg: 3 proposed/1 verified/0 used at min_candidates=1 vs a
    recovering set at 6).

    Over-budget sets are thinned UNIFORMLY OVER j, not truncated at
    ascending j: a truncating cap clusters closures in the earliest
    revisits and leaves the drifted tail unconstrained (measured on
    the 9-lap endurance circuit: 4 early closures moved 2047-frame
    ATE 20.9 → 21.4 m while full-span coverage recovers it).  Each
    accepted j emits up to its 3 closest partners — under drift the
    single closest estimated i is often the WRONG revisit."""
    poses = np.asarray(poses)
    if poses.ndim == 3:
        positions = poses[:, :3, 3]
        rots = poses[:, :3, :3]
    else:
        positions = poses
        rots = None
    # cumulative path length (on the estimated trajectory)
    seg = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])

    def scan(frac: float, heading_tol: float) -> list[tuple[int, int]]:
        groups = []  # one group of <=3 (i, j) pairs per accepted j
        last_j = -10 * stride
        for j in range(0, len(positions), stride):
            near = []
            for i in range(0, j - min_gap, stride):
                d = np.linalg.norm(positions[i] - positions[j])
                r_ij = max(radius, frac * (s[j] - s[i]))
                if d >= r_ij:
                    continue
                if rots is not None:
                    rel = rots[i].T @ rots[j]
                    ang = np.degrees(np.arccos(
                        np.clip((np.trace(rel) - 1) / 2, -1, 1)))
                    if ang > heading_tol:
                        continue
                near.append((d, i))
            if near and j - last_j >= 4 * stride:
                near.sort()
                groups.append([(i, j) for _, i in near[:3]])
                last_j = j
        if sum(len(g) for g in groups) <= max_candidates:
            return [p for g in groups for p in g]
        # Thin to budget uniformly across the accepted-j groups, then
        # within groups (closest partners first) — coverage of the
        # whole drive beats density at any one revisit.
        n_groups = len(groups)
        per = max(1, max_candidates // n_groups)
        keep = [g[:per] for g in groups]
        out = [p for g in keep for p in g]
        if len(out) > max_candidates:
            sel = np.linspace(0, len(out) - 1, max_candidates)
            out = [out[int(k)] for k in sel]
        elif len(out) < max_candidates:
            # round-robin the leftover slots over groups' next-closest
            extras = [p for g in groups for p in g[per:]]
            out.extend(extras[:max_candidates - len(out)])
            out.sort(key=lambda p: p[1])
        return out

    max_frac, max_heading = 0.20, 90.0
    frac = drift_frac
    heading_tol = max_heading_deg
    while True:
        cands = scan(frac, heading_tol)
        if len(cands) >= min_candidates or frac >= max_frac:
            return cands
        frac = min(2.0 * frac, max_frac)
        heading_tol = min(2.0 * heading_tol, max_heading)


def _appearance_descriptor(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Zero-mean, unit-norm average-pooled thumbnail of a grayscale
    image — a th×tw global appearance descriptor (pooling = built-in
    low-pass, so small viewpoint shifts move the descriptor smoothly;
    the normalization removes global gain/offset)."""
    H, W = img.shape
    hh, ww = H - H % th, W - W % tw
    t = img[:hh, :ww].astype(np.float32)
    t = t.reshape(th, hh // th, tw, ww // tw).mean(axis=(1, 3))
    t -= t.mean()
    n = float(np.linalg.norm(t))
    return (t / n).ravel() if n > 0 else t.ravel()


def propose_loop_closures_appearance(
        seq: KittiSequence, frame_ids, min_gap: int = 100,
        stride: int = 2, max_candidates: int = 24,
        min_similarity: float = 0.5,
        thumb: tuple[int, int] = (10, 32)) -> list[tuple[int, int]]:
    """Pose-estimate-FREE loop-closure proposal by global image
    appearance.

    The metric proposer above ranks pairs by distance on the ESTIMATED
    trajectory, which is exactly the quantity that heavy drift
    corrupts: under a dominant yaw/scale bias the drifted path curls
    near itself at places that are NOT revisits, those junk pairs fill
    the candidate budget (they have the smallest estimated distances),
    and every verification correctly fails — 12 proposed / 0 verified
    on the committed 220-frame 0.5°/frame-yaw + 8%-scale leg.  The
    drift-aware radius escalation cannot fix ranking: it widens the
    net but junk still sorts first.

    Appearance ranking needs no pose estimate at all (the FAB-MAP /
    NetVLAD insight, reduced to its minimal form): per-frame
    descriptor = zero-mean unit-norm average-pooled thumbnail, revisit
    candidates = high-cosine-similarity pairs.  All-pairs similarity
    is one [F, D]·[D, F] matmul (F ≈ hundreds, D ≈ 320 — microseconds
    on host; the same formulation sharded over a device mesh covers
    million-frame maps).  Greedy selection by descending similarity
    with (i, j)-neighborhood suppression spreads candidates over
    distinct revisit events instead of stacking them on the single
    best-matching pair.

    False positives (perceptual aliasing — distinct places that look
    alike) are expected and safe: every candidate still passes the
    KLT + depth + GN verification gauntlet, which measures actual
    relative geometry and rejects non-overlapping views.  Use the
    UNION of this and `propose_loop_closures` — metric proposal wins
    at low drift (appearance can miss revisits under strong viewpoint
    change), appearance wins when drift dominates.
    """
    frame_ids = list(frame_ids)
    ks = list(range(0, len(frame_ids), stride))
    descs = []
    kept = []
    for k in ks:
        img = seq.image(frame_ids[k])
        if img is None:
            continue
        descs.append(_appearance_descriptor(img, *thumb))
        kept.append(k)
    if len(kept) < 2:
        return []
    D = np.stack(descs)  # [Fs, d]
    S = D @ D.T  # cosine similarities (descriptors are unit-norm)
    pairs = []
    for b in range(len(kept)):
        for a in range(b):
            i, j = kept[a], kept[b]
            if j - i < min_gap:
                continue
            if S[a, b] >= min_similarity:
                pairs.append((float(S[a, b]), i, j))
    pairs.sort(reverse=True)
    out: list[tuple[int, int]] = []
    sup = max(2 * stride, 4)
    for sim, i, j in pairs:
        if any(abs(i - pi) < sup and abs(j - pj) < sup for pi, pj in out):
            continue
        out.append((i, j))
        if len(out) >= max_candidates:
            break
    out.sort(key=lambda p: p[1])
    return out


def union_closure_candidates(*cand_lists: list[tuple[int, int]],
                             sup: int = 0) -> list[tuple[int, int]]:
    """Union of candidate lists with optional (i, j)-neighborhood
    dedup (sup=0 keeps exact-duplicate removal only).  Order: sorted
    by j then i, so verification walks the trajectory forward."""
    seen: list[tuple[int, int]] = []
    for cands in cand_lists:
        for (i, j) in cands:
            if any(abs(i - pi) <= sup and abs(j - pj) <= sup
                   for pi, pj in seen):
                continue
            seen.append((i, j))
    seen.sort(key=lambda p: (p[1], p[0]))
    return seen


def filter_consistent_closures(poses: np.ndarray,
                               closures: list[tuple],
                               rot_tol_deg: float = 3.0,
                               trans_tol_m: float = 0.5,
                               drift_frac: float = 0.02,
                               remeasure=None,
                               max_cycle_path_m: float = 150.0
                               ) -> list[tuple]:
    """Pairwise-consistency filtering of loop-closure measurements
    (PCM-lite): keep closures corroborated by their COMPARABLE peers.

    A closure that verified geometrically can still be CONFIDENTLY
    wrong — KLT latching onto repeating structure gives a tight GN
    convergence on a mis-registration (measured on the synthetic loop:
    one closure 7.8 m / 30° off among seven sub-0.2 m ones, and no
    per-measurement statistic flags it).  What does flag it is mutual
    consistency: for closures a = (i, j, Za) and b = (k, l, Zb), the
    cycle i→k→l→j→i composed from Zb and the VO odometry segments
    O(i→k), O(l→j) predicts Za; drift cancels over the SHORT segments
    between nearby closure endpoints, so true closures agree with each
    other even under heavy global drift, while a mis-registration
    agrees with nothing.  Tolerances grow with the cycle's odometry
    path length (drift_frac).

    The evidence is ASYMMETRIC in the cycle's odometry path length:

    * CONSISTENCY is positive evidence at any comparable path (capped
      at `max_cycle_path_m`) — agreement through a long odometry chain
      in all 6 DoF is vanishingly unlikely for independent
      mis-registrations;
    * INCONSISTENCY is negative evidence only over SHORT paths
      (~40 m): beyond that, real VO drift — concentrated in turns, so
      NOT bounded by any per-meter tolerance — routinely breaks cycles
      between two TRUE closures (measured on the 3-lap circuit:
      good-good cycle residuals of 4 m over 69 m paths crossing a
      U-turn, vs 0.1-0.4 m for all sub-40 m good-good pairs).

    A closure survives if it has at least one supporter and at least
    as many supporters as short-path opponents.  The r4 form — one
    greedy global max-clique over path-scaled tolerances — assumed a
    single mutually-consistent set; on a multi-lap circuit the
    consistency graph splits into per-region camps separated by
    genuine drift, and the clique kept ONE camp, discarding
    two-thirds of the true closures and leaving whole laps
    unconstrained (measured, 3-lap/660-frame circuit, 22 verified of
    which 7 are >0.5 m wrong: clique kept 8 — all in one early-lap
    region — for ATE 9.28 → 7.45 m; the support/oppose vote keeps 15
    spanning the full lap, matching the oracle >0.5 m-error split up
    to two borderline closures, for ~2.3 m — the single-lap drift
    floor).

    A LONE closure has no peer to agree with, and it previously went
    to the backend unchecked — exactly the class this filter exists
    for (one confidently-wrong KLT mis-registration corrupted a 0.45 m
    trajectory to 2.5 m when it happened to be the only closure).  Two
    nets, in preference order:

    * With `remeasure` (a callable (a, b) -> (Z_R, Z_t[, w6]) or None
      returning the measured relative pose T_a⁻¹T_b, e.g.
      closure_constraint_from_frames bound to the sequence): MAKE a
      peer — measure the short hop Z_{i,i±Δ} (a near-trivial
      small-baseline registration) and a support closure Z_{i±Δ,j},
      and demand cycle consistency Z_ij ≈ Z_{i,i±Δ}·Z_{i±Δ,j}.  The
      cycle is built ENTIRELY from measurements — odometry (and
      therefore drift, however large) never enters — so the tolerance
      stays measurement-tight in every regime, and a mis-registration
      onto repeating structure has to reproduce coherently at a
      multi-meter-shifted baseline to slip through.  If the lone
      closure fails its cycle but two INDEPENDENT chains (different
      shifted endpoints, no shared measurement) agree with each other,
      the bad closure is replaced by one chain's edges — measured on
      the synthetic loop: a lone verified closure 3.5 m off ground
      truth (overconfident GN covariance, w6 all 1.0) was rejected
      while the replacement chain was 0.39 m / 0.9° from truth.
    * Without `remeasure`: check against the odometry chain between
      the endpoints under a generous drift allowance (10% of path
      translation, 0.25°/m rotation) — passes plausible real VO drift,
      rejects the measured mis-registration class (7.8 m / 30° over a
      ~40 m path).  Drift beyond the allowance also drops a lone TRUE
      closure: the fail-closed choice — config 4 reverts to plain VO
      rather than gambling the trajectory on one unverifiable
      measurement."""
    poses = np.asarray(poses, np.float64)
    if len(closures) == 0:
        return closures
    if len(closures) == 1:
        i, j = closures[0][0], closures[0][1]
        Za = np.eye(4)
        Za[:3, :3] = np.asarray(closures[0][2], np.float64)
        Za[:3, 3] = np.asarray(closures[0][3], np.float64)
        seg1 = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
        s1 = np.concatenate([[0.0], np.cumsum(seg1)])

        def rel1(a, b):
            return np.linalg.inv(poses[a]) @ poses[b]

        def angle_deg(R):
            return np.degrees(np.arccos(np.clip(
                (np.trace(R) - 1) / 2, -1, 1)))

        if remeasure is not None:
            def as_T4(z):
                T = np.eye(4)
                T[:3, :3] = np.asarray(z[0], np.float64)
                T[:3, 3] = np.asarray(z[1], np.float64)
                return T

            def agree(Ta, Tb):
                E = np.linalg.inv(Ta) @ Tb
                return (angle_deg(E[:3, :3]) <= 2.0 * rot_tol_deg
                        and np.linalg.norm(E[:3, 3]) <= 2.0 * trans_tol_m)

            chains = []  # (pred T_i⁻¹T_j, replacement edges)
            for side, delta in (("i", 4), ("i", -4), ("j", 4), ("j", -4)):
                # shifted endpoint: the cycle is i -> mid -> j
                mid = (i + delta) if side == "i" else (j + delta)
                if not (0 <= mid < len(poses)) or abs(j - mid) < 2 \
                        or abs(mid - i) < 2:
                    continue
                z1 = remeasure(i, mid)  # hop or shifted support
                z2 = remeasure(mid, j)
                if z1 is None or z2 is None:
                    continue
                pred = as_T4(z1) @ as_T4(z2)  # measurement-only cycle
                if agree(Za, pred):
                    return closures  # lone closure corroborated
                chains.append((pred, [(i, mid, *z1), (mid, j, *z2)]))
            # Lone closure corroborated by nothing — if two independent
            # chains corroborate EACH OTHER, trust them instead.
            for ca in range(len(chains)):
                for cb in range(ca + 1, len(chains)):
                    if agree(chains[ca][0], chains[cb][0]):
                        return chains[ca][1]
            return []
        E = np.linalg.inv(Za) @ rel1(i, j)
        path = float(abs(s1[j] - s1[i]))
        if (angle_deg(E[:3, :3]) <= rot_tol_deg + 0.25 * path
                and np.linalg.norm(E[:3, 3]) <= trans_tol_m + 0.10 * path):
            return closures
        return []
    seg = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])

    def rel(a: int, b: int) -> np.ndarray:
        return np.linalg.inv(poses[a]) @ poses[b]

    def as_T(zr, zt) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = np.asarray(zr, np.float64)
        T[:3, 3] = np.asarray(zt, np.float64)
        return T

    OPPOSE_PATH_M = 40.0
    n = len(closures)
    ok = np.zeros((n, n), bool)
    comparable = np.zeros((n, n), bool)
    local = np.zeros((n, n), bool)
    for a in range(n):
        ia, ja = closures[a][0], closures[a][1]
        Za = as_T(closures[a][2], closures[a][3])
        for b in range(a + 1, n):
            ib, jb = closures[b][0], closures[b][1]
            path = abs(s[ib] - s[ia]) + abs(s[ja] - s[jb])
            if path > max_cycle_path_m:
                continue  # drift over the cycle swamps the evidence
            comparable[a, b] = comparable[b, a] = True
            local[a, b] = local[b, a] = path <= OPPOSE_PATH_M
            Zb = as_T(closures[b][2], closures[b][3])
            pred = rel(ia, ib) @ Zb @ rel(jb, ja)
            E = np.linalg.inv(Za) @ pred
            ang = np.degrees(np.arccos(np.clip(
                (np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
            t_tol = trans_tol_m + drift_frac * path
            r_tol = rot_tol_deg + 0.05 * path  # ~0.05 deg/m VO rot drift
            ok[a, b] = ok[b, a] = (
                ang <= r_tol
                and np.linalg.norm(E[:3, 3]) <= t_tol)
    support = ok.sum(1)
    oppose = (local & ~ok).sum(1)
    keep = (support >= 1) & (support >= oppose)
    # Closures with NO comparable peer (an isolated revisit) get the
    # lone-closure treatment if a remeasure callback exists; without
    # one they are dropped — fail-closed, same as the lone-list case.
    kept = [c for c, k in zip(closures, keep) if k]
    if len(kept) == 1:
        # a single survivor's support came from a closure that itself
        # lost its vote — no INDEPENDENT mutual support; treat it like
        # a lone closure (remeasure-corroborated or dropped)
        kept = filter_consistent_closures(
            poses, kept, rot_tol_deg, trans_tol_m, drift_frac,
            remeasure=remeasure, max_cycle_path_m=max_cycle_path_m)
    corroborated = []
    if remeasure is not None:
        for a in range(n):
            if not comparable[a].any():
                # isolated revisit: no peer to vote with — the
                # lone-closure remeasure corroboration decides it
                corroborated.extend(filter_consistent_closures(
                    poses, [closures[a]], rot_tol_deg, trans_tol_m,
                    drift_frac, remeasure=remeasure,
                    max_cycle_path_m=max_cycle_path_m))
    return kept + corroborated


def calibrate_closure_weights(poses: np.ndarray,
                              closures: list[tuple],
                              sigma_ref_t: float = 0.1,
                              sigma_ref_r: float = 0.01,
                              max_cycle_path_m: float = 150.0
                              ) -> list[tuple]:
    """Cap each closure's per-component confidence by MEASURED
    closure-residual statistics instead of trusting the verification
    GN's covariance alone.

    The GN covariance models pixel noise only; systematic closure
    error (lidar depth bias, KLT locking onto repeating texture) is
    invisible to it, and closure errors across one revisit are
    CORRELATED (same depth source, same viewpoint pair), so a batch of
    GN-confident closures can over-pull a good trajectory.  What CAN
    be measured without ground truth is mutual cycle consistency: for
    closures a, b the cycle i_a→i_b→j_b→j_a composed through the short
    odometry segments between endpoints predicts Z_a, and the residual
    bounds the (sum of the two) closure errors plus short-segment
    drift.  The MAX cycle residual over all pairs is therefore a
    conservative per-closure error bound, and each component's weight
    is capped at (sigma_ref / that bound)² — closures measured tightly
    AND mutually consistent keep full weight; anything else fades.

    With fewer than two closures no cycle exists; the translation
    confidence is capped at (sigma_ref_t / 0.3 m)² — a lone closure's
    translation is never trusted beyond 0.3 m, while its rotation
    (the component that cancels yaw drift, and the one the GN
    covariance measures well at far-landmark geometry) keeps its
    claimed confidence."""
    poses = np.asarray(poses, np.float64)

    def as_T(zr, zt):
        T = np.eye(4)
        T[:3, :3] = np.asarray(zr, np.float64)
        T[:3, 3] = np.asarray(zt, np.float64)
        return T

    def rel(a, b):
        return np.linalg.inv(poses[a]) @ poses[b]

    seg = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])

    def angle(R):
        return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))

    n = len(closures)
    if n >= 2:
        # The cycle rides through odometry segments between closure
        # endpoints, so at high drift the residual is dominated by
        # SEGMENT drift, not closure error — deduct an estimate of it
        # (per-meter drift measured from each closure's own
        # odometry-vs-measurement gap over its long path; median over
        # closures).  Without the deduction, a heavily drifted
        # trajectory zeroes its own closure weights and the backend
        # fixes nothing — measured: 10% vs 80% ATE recovery.
        fr_t, fr_r = [], []
        for (i, j, zr, zt, *_rest) in closures:
            E = np.linalg.inv(as_T(zr, zt)) @ rel(i, j)
            path = max(float(abs(s[j] - s[i])), 1e-6)
            fr_t.append(np.linalg.norm(E[:3, 3]) / path)
            fr_r.append(angle(E[:3, :3]) / path)
        frac_t = float(np.median(fr_t))
        frac_r = float(np.median(fr_r))
        t_res, r_res = [], []
        for a in range(n):
            Za = as_T(closures[a][2], closures[a][3])
            ia, ja = closures[a][0], closures[a][1]
            for b in range(a + 1, n):
                ib, jb = closures[b][0], closures[b][1]
                seg_path = abs(s[ib] - s[ia]) + abs(s[ja] - s[jb])
                if seg_path > max_cycle_path_m:
                    # Same comparability cap as the consistency
                    # filter: beyond it the cycle residual measures
                    # accumulated drift (deduction and all), not
                    # closure error — on a multi-lap circuit the
                    # lap-spanning pairs would set sig via their
                    # drift noise and fade every true closure.
                    continue
                Zb = as_T(closures[b][2], closures[b][3])
                E = np.linalg.inv(Za) @ (rel(ia, ib) @ Zb @ rel(jb, ja))
                t_res.append(np.linalg.norm(E[:3, 3])
                             - frac_t * seg_path)
                r_res.append(angle(E[:3, :3]) - frac_r * seg_path)
        if t_res:
            sig_t = max(float(np.max(t_res)), 0.02)
            sig_r = max(float(np.max(r_res)), 1e-4)
        else:  # no comparable pair anywhere — lone-closure caps
            sig_t, sig_r = 0.3, None
    else:
        sig_t, sig_r = 0.3, None
    cap_t = min(1.0, (sigma_ref_t / sig_t) ** 2)
    cap_r = (min(1.0, (sigma_ref_r / sig_r) ** 2)
             if sig_r is not None else 1.0)
    out = []
    for c in closures:
        w6 = (np.asarray(c[4], np.float32).copy() if len(c) > 4
              else np.ones(6, np.float32))
        w6[:3] = np.minimum(w6[:3], cap_t)
        w6[3:] = np.minimum(w6[3:], cap_r)
        out.append((*c[:4], w6))
    return out


def _so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation-vector log of a single rotation matrix (numpy)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-8:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                  R[1, 0] - R[0, 1]])
    return v * (th / (2.0 * np.sin(th)))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    """Rotation matrix of a rotation vector (numpy Rodrigues)."""
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def run_pose_graph_backend(poses: np.ndarray,
                           closures: Iterable[tuple],
                           closure_weight: float = 1.0,
                           odom_sigma_t: float = 0.06,
                           odom_sigma_rot_deg: float = 1.0,
                           gn_iters: int = 20, cg_iters: int = 250,
                           consistency_filter: bool = True,
                           calibrate_weights: bool = True,
                           bias_alternations: int = 2,
                           remeasure=None) -> np.ndarray:
    """Config 4: optimize a trajectory with odometry-chain edges plus
    loop-closure edges.

    Args:
      poses: [F, 4, 4] world←cam VO poses.
      closures: iterable of (i, j, Z_R [3,3], Z_t [3][, w6 [6]])
        relative measurements T_i⁻¹ T_j; the optional w6 gives
        per-residual-component confidences in [0, 1] ([rho, phi]
        ordering) — closure_constraint_from_frames derives them from
        the verification GN's covariance, so a closure whose
        translation is weakly observed (far-landmark geometry)
        contributes its (strong) rotation without polluting positions.
      closure_weight: extra scale on closure information (1 = trust the
        covariance-derived confidences as-is).
      odom_sigma_t / odom_sigma_rot_deg: per-edge odometry noise.  All
        weights share one information scale (weight 1 ≡ σ_t = 0.1 m /
        σ_rot = 0.01 rad — the reference sigmas of the closure
        confidences), so odometry and closure edges are balanced by
        MEASURED noise rather than a hand-picked ratio.
      calibrate_weights: cap closure confidences by measured cycle
        statistics (calibrate_closure_weights) — on by default.
      remeasure: optional (i, j) -> (Z_R, Z_t[, w6]) | None callback
        used by the consistency filter to manufacture a support
        measurement when exactly one closure verified (see
        filter_consistent_closures).  The odom sigma defaults
        are this pipeline's measured per-frame RPE on the synthetic
        loop (trans RMSE 0.06 m, rot RMSE ~1-1.6°); a fixed 20x closure
        boost over-weighted closures ~50x against that and made the
        backend DEGRADE low-drift trajectories (measured 2.27 → 2.45 m
        ATE on the 220-frame loop).

    Solver: chain-preconditioned Gauss-Newton/PCG (vo/pose_graph.py) —
    convergence takes O(closure-count) CG iterations independent of
    trajectory length, and the r3 failure mode (truncated CG leaving
    the graph HALF-corrected, worse than raw VO) is structurally gone;
    cg_iters is a cap above the early-exit tolerance, not a cost.

    Returns the optimized [F, 4, 4] poses.
    """
    closures = list(closures)
    if consistency_filter:
        closures = filter_consistent_closures(poses, closures,
                                              remeasure=remeasure)
    F = len(poses)
    R = poses[:, :3, :3].astype(np.float32)
    t = poses[:, :3, 3].astype(np.float32)
    w_ot = (0.1 / max(odom_sigma_t, 1e-4)) ** 2
    w_or = (0.01 / max(np.radians(odom_sigma_rot_deg), 1e-5)) ** 2
    w_odom = np.array([w_ot] * 3 + [w_or] * 3, np.float32)
    # Shared odometry-bias state (see the alternation below): every
    # chain measurement is corrected by one rotation vector + one log
    # scale before entering the graph.
    bias_w = np.zeros(3)
    bias_s = 0.0

    def odom_rel(k):
        bR = _so3_exp(bias_w).astype(np.float32)
        return (R[k].T @ R[k + 1]) @ bR, \
            np.float32(np.exp(bias_s)) * (R[k].T @ (t[k + 1] - t[k]))

    def solve(cls):
        ei, ej, ZR, Zt, w = [], [], [], [], []
        for k in range(F - 1):
            ei.append(k)
            ej.append(k + 1)
            zr, zt = odom_rel(k)
            ZR.append(zr)
            Zt.append(zt)
            w.append(w_odom)
        for c in cls:
            i, j, zr, zt = c[:4]
            w6 = np.asarray(c[4], np.float32) if len(c) > 4 \
                else np.ones(6, np.float32)
            ei.append(i)
            ej.append(j)
            ZR.append(np.asarray(zr, np.float32))
            Zt.append(np.asarray(zt, np.float32))
            w.append(closure_weight * w6)
        g = PoseGraph(
            R=jnp.asarray(R), t=jnp.asarray(t),
            edge_i=jnp.asarray(np.array(ei, np.int32)),
            edge_j=jnp.asarray(np.array(ej, np.int32)),
            Z_R=jnp.asarray(np.stack(ZR)), Z_t=jnp.asarray(np.stack(Zt)),
            edge_weight=jnp.asarray(np.stack(w)),
            edge_valid=jnp.ones(len(ei), bool),
            fixed=jnp.asarray(np.arange(F) == 0))
        out = optimize_pose_graph(g, gn_iters=gn_iters, cg_iters=cg_iters)
        res = np.tile(np.eye(4, dtype=np.float64), (F, 1, 1))
        res[:, :3, :3] = np.asarray(out.R)
        res[:, :3, 3] = np.asarray(out.t)
        return res

    if not closures:
        return solve(closures)
    # Pre-solve calibration: cap confidences by drift-deducted cycle
    # statistics on the INPUT trajectory (calibrate_closure_weights —
    # at heavy drift the deduction keeps true closures at full weight;
    # at low drift the caps reflect honest mutual closure consistency).
    #
    # Deliberately NOT re-gated at the optimum: a post-solve
    # chi-squared rescale was tried and measured to UNDO the recovery
    # at heavy drift (11.5 -> 2.8 -> 9.8 m) — with a mis-modeled
    # (biased) odometry chain, even true closures keep residual
    # tension at the optimum, so "inconsistent with claimed sigma at
    # the solution" does not separate good closures from bad ones
    # there.  Mis-registration protection lives in the verification
    # two-tier test and the pairwise-consistency filter instead.
    cls = calibrate_closure_weights(poses, closures) \
        if calibrate_weights else closures

    # Odometry-BIAS estimation: closures fix a topology limit the
    # per-pose solve cannot.  On a single-lap loop every closure ties
    # the start region to the end region; the interior is constrained
    # only by odometry, so a SYSTEMATIC per-frame odometry error (yaw
    # bias, scale error — the classic uncalibrated-VO model) leaves
    # the interior bent no matter how the solver is tuned (measured,
    # 1.0°/frame + 10% scale, 9 true closures used: 14.6% recovery,
    # invariant to gn_iters ×5, calibration on/off, closure_weight ×4;
    # the robust loss rightly treats 180°-misclosure closures as
    # outliers, so the solve cannot even be read back for the bias).
    # But that same systematic error is a 2-parameter GLOBAL the
    # closure MEASUREMENTS observe directly through chain composition:
    # for closure (i, j), log(pred_R(i→j)ᵀ · Z_R) ≈ (j−i)·(−bias_rot)
    # (rotation composition is translation-free, so this estimate
    # needs no solve and no scale knowledge), and once rotations are
    # corrected the chain straightens, making |Z_t| / |pred_t| ≈ the
    # per-edge scale factor (end-to-end displacement is linear in a
    # uniform scale).  Median over closures for robustness, clamp each
    # step (≤2°/frame, |log s| ≤ 0.2), iterate (scale geometry feeds
    # back into prediction), then ONE solve with the corrected chain,
    # accepted only if it releases closure tension vs the uncorrected
    # solve.  Exactly neutral for unbiased VO: the median discrepancy
    # per frame is noise/(j−i) ~ 1e-4 rad, under the fold-in floor.
    # Estimation set: only closures whose gap the ±2.5°/101-step grid
    # can RESOLVE (step 0.05°/frame; bound the per-step discrepancy
    # swing to ~25° -> gap <= 500).  At multi-lap scale closures span
    # gaps in the thousands, where one grid step swings the predicted
    # rotation by >100° — the misclosure of those closures is
    # effectively random across the scan, and with enough of them a
    # spurious minimum passes the accept gate (measured, 2048-frame
    # endurance rerun: spurious bias accepted -> dead-reckoned init
    # thousands of degrees wrong -> solve diverged to 1.3e7 m ATE).
    # Long-gap closures still go to the SOLVE — they are just not used
    # to estimate the 3-parameter bias, which short gaps determine.
    max_bias_gap = 500
    est = [c for c in cls if 0 < (c[1] - c[0]) <= max_bias_gap]
    if bias_alternations > 0 and F > 2 and len(est) >= 2:

        R64 = R.astype(np.float64)
        t64 = t.astype(np.float64)
        rel_R_all = np.einsum("nji,njk->nik", R64[:-1], R64[1:])
        rel_t_all = np.einsum("nji,nj->ni", R64[:-1], t64[1:] - t64[:-1])

        def chain_pred():
            """Dead-reckon the bias-corrected odometry chain.

            Composition is associative, so the prefix products run as
            a Hillis-Steele scan: log2(F) passes of batched 4x4
            einsums instead of an F-step Python loop (the loop was the
            dominant bias-estimation cost at endurance scale — each
            grid candidate re-composes a 2047-edge chain)."""
            Tk = np.tile(np.eye(4), (F, 1, 1))
            Tk[1:, :3, :3] = rel_R_all @ _so3_exp(bias_w)
            Tk[1:, :3, 3] = np.exp(bias_s) * rel_t_all
            shift = 1
            while shift < F:
                Tk[shift:] = np.einsum("nij,njk->nik",
                                       Tk[:-shift], Tk[shift:])
                shift *= 2
            return Tk

        def misclosure(Tc):
            """Measurement-space misclosure: chain-composed odometry
            prediction vs closure measurement, mean over the
            ESTIMATION closures.  This — NOT post-solve closure
            tension — is the accept metric: the solver can zero
            closure residuals by bending the trajectory near the
            endpoints while the interior stays wrong, so at the
            optimum the tension of a bias-corrected and an
            uncorrected chain are both at the closure-noise floor and
            cannot be compared.  The measurement-space metric never
            involves a solve and is reduced exactly when the
            3-parameter bias actually explains the closures."""
            m = []
            for c in est:
                i, j, zr_c, zt_c = c[:4]
                pred = np.linalg.inv(Tc[i]) @ Tc[j]
                m.append(float(np.linalg.norm(_so3_log(
                    pred[:3, :3].T @ np.asarray(zr_c, np.float64))))
                    + 0.05 * float(np.linalg.norm(
                        pred[:3, 3] - np.asarray(zt_c))))
            return float(np.mean(m))

        m0 = misclosure(chain_pred())
        bias_w_prev, bias_s_prev = bias_w.copy(), bias_s

        # --- Stage 1: GLOBAL search over angle-per-frame. ---
        # The incremental estimate log(pred_R^T Z_R)/gap ALIASES: a
        # rotation log only represents angles <= 180°, so when
        # |bias| * gap crosses 180° the recovered axis flips and a
        # local estimator walks the wrong way (measured on the real
        # 220-frame leg: gaps ~184-218 at 1.0°/frame -> every
        # discrepancy wrapped, recovery 14.6% -> -10%).  The bias is
        # identifiable anyway because closures have DIFFERENT gaps
        # (aliases that fit one gap miss the others) — but only to a
        # GLOBAL search, so: take the rotation axis from the data
        # (sign-aligned mean of the per-closure logs — wrapping flips
        # signs but preserves the axis line for single-axis bias),
        # scan angle-per-frame over ±2.5° evaluating the true
        # measurement-space misclosure, and take the argmin.
        Tc0 = chain_pred()
        logs = []
        for c in est:
            i, j, zr_c, _ = c[:4]
            pred = np.linalg.inv(Tc0[i]) @ Tc0[j]
            logs.append(_so3_log(pred[:3, :3].T
                                 @ np.asarray(zr_c, np.float64)))
        L = np.stack(logs)
        ref = L[int(np.argmax(np.linalg.norm(L, axis=1)))]
        if float(np.linalg.norm(ref)) > 1e-9:
            sgn = np.where(L @ ref < 0, -1.0, 1.0)
            axis = (L * sgn[:, None]).mean(axis=0)
            na = float(np.linalg.norm(axis))
        else:
            na = 0.0
        # Occam prior on the bias magnitude.  On a multi-lap circuit
        # the revisit gaps are COMMENSURATE (multiples of the lap
        # length), so the misclosure profile has perfect aliases at
        # multiples of 360°/lap per frame — and the alias can even
        # score BETTER than the true bias by absorbing common-mode
        # noise (measured, 3-lap synthetic with 0.3°/frame truth:
        # alias at 2.12°/frame scored 0.135 vs truth's 0.270, and the
        # folded alias took ATE 2.0 -> 22.3 m).  No data statistic can
        # break a perfect alias; physics can: a real VO yaw bias is a
        # small fraction of a degree per frame, while the first alias
        # sits at 360°/lap ~ 1.6-1.8°.  The selection objective is
        # therefore misclosure + BIAS_PRIOR·|bias| (rad/frame), strong
        # enough to reject commensurate aliases, weak enough that a
        # genuine 1°/frame bias (penalty ~0.1) still dominates the
        # multi-radian unbiased misclosure it explains.
        BIAS_PRIOR = 6.0

        def score(m):
            return m + BIAS_PRIOR * float(np.linalg.norm(bias_w))

        if na > 1e-9:
            axis /= na
            base_w = bias_w.copy()
            best_u, best_s = 0.0, score(misclosure(Tc0))
            # Adaptive resolution: one grid step must swing the
            # longest estimation gap's predicted rotation by <= 10°,
            # or the profile is undersampled and the true minimum can
            # fall between samples.
            max_gap = max(c[1] - c[0] for c in est)
            npts = int(np.ceil(np.radians(5.0)
                               / (np.radians(10.0) / max_gap))) + 1
            npts = min(max(npts, 101), 1001) | 1
            for u in np.linspace(-np.radians(2.5), np.radians(2.5), npts):
                bias_w = np.asarray(_so3_log(
                    _so3_exp(base_w) @ _so3_exp(u * axis)))
                s = score(misclosure(chain_pred()))
                if s < best_s:
                    best_u, best_s = u, s
            bias_w = np.asarray(_so3_log(
                _so3_exp(base_w) @ _so3_exp(best_u * axis)))

        # Scale bias is deliberately NOT estimated.  It looked
        # estimable (end-to-end displacement is linear in a uniform
        # per-edge scale) but both estimators failed on measurement:
        # per-closure |Z_t|/|pred_t| ratio medians carry O(1) noise
        # (closure baselines of 0-6 m vs metres of accumulated chain
        # drift over the gap), and a grid argmin of the misclosure
        # jointly overfits with rotation — every closure spans nearly
        # the SAME chain, so the accumulated random-walk noise is
        # common-mode and a 1-parameter scale absorbs it (measured:
        # grid picked s=+0.02 where truth is -0.095, ATE 2.2 -> 9.4 m).
        # Unlike rotation bias — whose position damage grows
        # quadratically with path and which the robust solve treats as
        # outlier misclosure — a scale error's damage is linear and
        # the solver itself distributes the translation misclosure
        # along the chain, so leaving scale to the solve is both safer
        # and empirically as good.

        # --- Stage 2: monotone local refinement. ---
        # Inside the unwrapped basin the incremental estimator
        # (median per-closure log/gap) polishes rotation below the
        # grid resolution; every step is accepted only if it REDUCES
        # the measurement-space misclosure — a noisy estimate cannot
        # walk the bias away from the grid optimum.
        s_cur = score(misclosure(chain_pred()))
        for _ in range(bias_alternations):
            Tc = chain_pred()
            dws = []
            for c in est:
                i, j, zr_c, zt_c = c[:4]
                pred = np.linalg.inv(Tc[i]) @ Tc[j]
                gap = j - i
                dws.append(_so3_log(
                    pred[:3, :3].T @ np.asarray(zr_c, np.float64)) / gap)
            dw = np.median(np.stack(dws), axis=0)
            n = float(np.linalg.norm(dw))
            if n > np.radians(2.0):
                dw *= np.radians(2.0) / n
            if n < 2e-4:
                break  # unbiased odometry — nothing to fold in
            w_keep = bias_w
            bias_w = np.asarray(_so3_log(_so3_exp(bias_w) @ _so3_exp(dw)))
            s_try = score(misclosure(chain_pred()))
            if s_try < s_cur:
                s_cur = s_try
            else:
                bias_w = w_keep
                break
        # Accept only a SUBSTANTIAL reduction (x0.7): a 3-parameter
        # model fitted to >= 2 closures x 6 DoF cannot overfit noise
        # into a 30% mean improvement; anything less reverts to the
        # plain chain.
        folded = False
        R_orig, t_orig = R, t
        if misclosure(chain_pred()) >= 0.7 * m0:
            bias_w, bias_s = bias_w_prev, bias_s_prev
        elif float(np.linalg.norm(bias_w)) > 1e-6:
            # Fold the accepted bias INTO the trajectory: rebuild the
            # poses by dead-reckoning the corrected measurements and
            # zero the bias (odom_rel recomputes measurements from
            # R/t, so the corrected chain reproduces them exactly and
            # nothing double-applies).  This also re-initializes the
            # solve at the corrected chain — the original poses are
            # the WRONG linearization point once the measurements are
            # corrected: they sit up to hundreds of accumulated
            # degrees away, and 20 GN steps cannot cross that
            # nonconvexity (measured: perfect bias estimate, solve
            # from drifted init -> 11 m ATE; from the corrected chain
            # -> the expected ~1-2 m).
            Tc = chain_pred()
            P0 = np.eye(4)
            P0[:3, :3] = R[0].astype(np.float64)
            P0[:3, 3] = t[0].astype(np.float64)
            init = P0[None] @ Tc
            R = init[:, :3, :3].astype(np.float32)
            t = init[:, :3, 3].astype(np.float32)
            bias_w = np.zeros(3)
            bias_s = 0.0
            folded = True
        if folded:
            # Divergence-ONLY guard: a folded bias changes the solve's
            # initialization, and a wrong fold can put it somewhere GN
            # cannot recover from (diverged solutions reach 1e7 m).
            # Solve BOTH ways; keep the bias solve unless it is
            # non-finite or its residual closure tension is an order
            # of magnitude beyond the plain solve's.  Deliberately NOT
            # a straight <= comparison: post-solve tension cannot rank
            # two healthy solves — the plain solve zeroes closure
            # residuals by bending near the endpoints while its
            # interior stays wrong (measured: plain tension 0.0155 <
            # bias tension 0.0202 with plain ATE 10x worse) — but a
            # diverged solve has astronomic tension and never fits
            # inside the 10x + 0.1 envelope.
            out_bias = solve(cls)
            R, t = R_orig, t_orig
            out_plain = solve(cls)

            def _tension(o):
                errs = []
                for c in cls:
                    i, j, zr_c, zt_c = c[:4]
                    rel_R = o[i, :3, :3].T @ o[j, :3, :3]
                    rel_t = o[i, :3, :3].T @ (o[j, :3, 3] - o[i, :3, 3])
                    errs.append(float(np.linalg.norm(_so3_log(
                        np.asarray(zr_c, np.float64).T @ rel_R)))
                        + 0.05 * float(np.linalg.norm(
                            rel_t - np.asarray(zt_c))))
                return float(np.mean(errs))

            tb = _tension(out_bias)
            if np.isfinite(out_bias).all() \
                    and tb <= 10.0 * _tension(out_plain) + 0.1:
                return out_bias
            return out_plain
    return solve(cls)


def closure_constraint_from_frames(seq: KittiSequence,
                                   cfg: DepthEstimatorConfig,
                                   frame_i: int, frame_j: int,
                                   max_features: int = 512,
                                   min_inliers: int = 6,
                                   max_mean_err_px: float = 1.0,
                                   max_translation_m: float = 15.0,
                                   ) -> Optional[tuple[np.ndarray, np.ndarray,
                                                       np.ndarray]]:
    """Measure the relative pose T_i⁻¹ T_j for a closure candidate:
    detect features in frame i, KLT-track them directly into frame j,
    lift to 3D with frame i's lidar depths, Gauss-Newton the 3D→2D
    pose.  Returns (Z_R, Z_t, w6) — the transform mapping j-frame
    camera points from i-frame camera points plus per-component
    confidences — or None if verification fails.

    Closure pairs sit at multi-meter baselines (unlike the tracker's
    0.5 m inter-frame step), so: detection is DENSE (8 px cells — wide
    baselines kill most tracks, and only lidar-covered survivors count),
    the KLT gates are relaxed (fb 3 px, zncc 0.5), BOTH directions are
    tried (i→j, then j→i inverted — whichever frame has better lidar
    coverage of the shared view wins), and acceptance is a JOINT
    two-tier test trading inlier count against convergence quality:
    min_inliers at sub-max_mean_err convergence, or 2× the inliers at
    2× the error — a handful of coherent 3D→2D inliers at sub-pixel
    residual is physically stronger evidence than a larger count that
    barely converged.  A plausible translation magnitude is required
    either way (closures ARE spatial revisits).

    The returned w6 ([rho, phi] ordering, each in [0, 1]) encodes how
    well each block of the measurement is actually observed, from the
    verification GN's covariance Cov ≈ σ² H⁻¹ (σ = mean inlier
    reprojection error): closure views dominated by FAR landmarks
    (e.g. a wall at 60 m) constrain rotation to sub-degree but
    translation only to meters — feeding such a measurement into the
    pose graph at full translation weight actively corrupts a
    low-drift trajectory (measured: 0.45 m → 2.5 m ATE on the 84-frame
    loop), while its rotation leg is exactly what cancels yaw drift."""
    fwd = _closure_pose_one_direction(
        seq, cfg, frame_i, frame_j, max_features)
    rev = _closure_pose_one_direction(
        seq, cfg, frame_j, frame_i, max_features)

    def accept(pose):
        if pose is None:
            return False
        t_norm = float(np.linalg.norm(np.asarray(pose.translation)))
        n = int(pose.num_inliers)
        e = float(pose.mean_error)
        tight = n >= min_inliers and e <= max_mean_err_px
        loose = n >= 2 * min_inliers and e <= 2.0 * max_mean_err_px
        return (tight or loose) and t_norm <= max_translation_m

    cand = [p for p in (fwd, rev) if accept(p)]
    if not cand:
        return None
    if len(cand) == 2:
        pose = rev if int(rev.num_inliers) > int(fwd.num_inliers) else fwd
    else:
        pose = cand[0]
    use_rev = pose is rev
    # Per-component confidence from the GN covariance Cov = σ² H⁻¹
    # (left-perturbation coords [rho, phi]; conservative: worst diag
    # element per block).  Inverting the measurement (fwd case) maps
    # translation noise through the adjoint — add the |t|·σ_rot lever
    # arm.  Confidences are σ_ref²/σ² clipped to 1: a closure measured
    # to σ_t ≤ 0.1 m / σ_r ≤ 0.01 rad keeps full weight; weaker blocks
    # fade quadratically.
    H = np.asarray(pose.hessian, np.float64)
    sigma_px = max(float(pose.mean_error), 0.3)
    cov = sigma_px ** 2 * np.linalg.inv(
        H + 1e-6 * np.eye(6))
    tp_norm = float(np.linalg.norm(np.asarray(pose.translation)))
    var_r = float(np.max(np.diag(cov)[3:]))
    var_t = float(np.max(np.diag(cov)[:3])) + tp_norm ** 2 * var_r
    conf_t = min(1.0, 0.1 ** 2 / max(var_t, 1e-12))
    conf_r = min(1.0, 0.01 ** 2 / max(var_r, 1e-12))
    w6 = np.array([conf_t] * 3 + [conf_r] * 3, np.float32)
    # pose maps source-frame points to target-frame: x_t = R x_s + t ==
    # T_t←s.  The pose-graph edge wants Z = T_i⁻¹ T_j (j expressed in
    # i): forward (s=i, t=j) → invert T_j←i; reverse (s=j, t=i) → T_i←j
    # is already Z.
    Rp = np.asarray(pose.rotation)
    tp = np.asarray(pose.translation)
    if use_rev:
        return Rp, tp, w6
    return Rp.T, -Rp.T @ tp, w6


@partial(jax.jit, static_argnames=("cfg", "cam", "max_features"))
@f32_matmuls
def _closure_pose_device(cfg, cam, lidar_to_cam, img_s, img_t,
                         cloud, cvalid, max_features: int):
    """The device program of one closure-verification direction:
    detect → pyramids → KLT → ground plane → depths → pose GN, fused
    into ONE jitted call, so a verification pays one dispatch instead
    of hundreds of per-op dispatches."""
    from ..core.depth_estimator import estimate_depths
    from ..core.ransac import fit_ground_plane_ransac
    from ..tracker.harris import detect_features
    from ..tracker.klt import build_pyramid, track_features

    js = img_s.astype(jnp.float32) / 255.0
    jt = img_t.astype(jnp.float32) / 255.0
    uv_s, ok = detect_features(js, max_features, cell_size=8)
    ps = build_pyramid(js, 4)
    pt = build_pyramid(jt, 4)
    uv_t, ok_t = track_features(ps, pt, uv_s, ok, fb_threshold=3.0,
                                min_ncc=0.5)
    gp = fit_ground_plane_ransac(
        cloud, cvalid, jax.random.PRNGKey(0),
        distance_threshold=cfg.ransac_plane_distance_treshold,
        num_hypotheses=cfg.ransac_num_hypotheses,
        subsample=cfg.ransac_subsample_points)
    M = cfg.max_features
    pad = M - uv_s.shape[0]
    if pad > 0:
        uv_s = jnp.concatenate([uv_s, jnp.zeros((pad, 2))])
        ok_t = jnp.concatenate([ok_t, jnp.zeros(pad, bool)])
        uv_t = jnp.concatenate([uv_t, jnp.zeros((pad, 2))])
    est = estimate_depths(cfg, cam, lidar_to_cam, cloud, cvalid,
                          uv_s[:M], ok_t[:M], gp)
    d = est.depths
    usable = ok_t[:M] & (d > 0)
    rays = cam.viewing_rays(uv_s[:M])
    lm = rays / jnp.maximum(rays[:, 2:3], 1e-6) * d[:, None]
    return estimate_pose_gn(cam, lm, uv_t[:M], usable, iters=15)


def _closure_pose_one_direction(seq, cfg, frame_s: int, frame_t: int,
                                max_features: int):
    """3D→2D pose T_t←s for a closure pair: dense-detect in the source
    frame, KLT directly into the target, lift with the source scan's
    lidar depths, Gauss-Newton.  Returns a PoseEstimate or None."""
    from ..io.kitti import read_velodyne

    img_s = seq.image(frame_s)
    img_t = seq.image(frame_t)
    if img_s is None or img_t is None:
        return None
    if frame_s >= len(seq.scan_paths):
        return None
    xyzi, count = read_velodyne(seq.scan_paths[frame_s], cfg.max_points)
    cloud, cvalid = pad_cloud(xyzi, count, cfg.max_points)
    return _closure_pose_device(
        cfg, seq.calib.camera, seq.calib.lidar_to_cam,
        jnp.asarray(np.ascontiguousarray(img_s)),
        jnp.asarray(np.ascontiguousarray(img_t)),
        jnp.asarray(cloud), jnp.asarray(cvalid), max_features)
