"""The tracker's plain path: sequences, single frames, scale calibration.

A frozen copy of the port's ``tracker/tracker.py`` with the plain pool
sampler and no captured graphs: the entry points run their steps eagerly.
Per-frame work that does not depend on the recurrent state (crop cameras,
the fisheye -> pinhole coordinate fields, the crop warps, the image
features) runs over all frames at once; the conv-RNN cell steps through
time; the regressor head runs over all frames at once again.

Units: the tracker API is mm, the model consumes meters.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry import affine
from ..geometry.cameras import Fisheye62Camera
from ..kinematics.hand import HandModel, scaled_hand_model
from ..models.umetrack import (
    FrameInputs,
    SkeletonInputs,
    TemporalState,
    UmeTrackNet,
    memory_motion_transform,
)
from ..ops.resample import bilinear_sample_pool_plain, fisheye_to_pinhole_coords
from .crops import gather_cameras, gen_crop_set, static_crop_points_local
from .types import (
    M_TO_MM,
    MM_TO_M,
    CameraRig,
    CropSet,
    FrameObservation,
    FrameResult,
    TrackerConfig,
    TrackState,
)


def _crop_coords(
    rig: CameraRig,  # fields [..., N] (batch dims broadcast to the frames')
    T_world_from_camera: torch.Tensor,  # [..., N, 4, 4]
    crop_set: CropSet,  # leaves [..., 2, V, ...]
    crop_size: Tuple[int, int],
) -> torch.Tensor:  # [..., 2, V, h, w, 2]
    """Per-slot fisheye source-coordinate fields (the cheap per-warp math;
    the sampling goes through the pool sampler)."""
    rig_s = rig.unsqueeze_batch(1)  # add the hand dim
    src = crop_set.src_cam_idx

    def per_slot(a, n_trailing=0):
        return gather_cameras(a, src, n_trailing)

    cam = Fisheye62Camera(
        fx=per_slot(rig_s.fx), fy=per_slot(rig_s.fy),
        cx=per_slot(rig_s.cx), cy=per_slot(rig_s.cy),
        width=per_slot(rig_s.width), height=per_slot(rig_s.height),
        T_world_from_eye=per_slot(T_world_from_camera[..., None, :, :, :], 2),
        coeffs=per_slot(rig_s.coeffs, 1),
    )
    return fisheye_to_pinhole_coords(
        crop_set.intrinsics, crop_set.T_world_from_eye, cam, crop_size
    )


def _pool_inputs(
    images: torch.Tensor,  # [F, N, H, W] raw views (F = flattened frames)
    coords: torch.Tensor,  # [F, 2*V, h, w, 2]
    src_cam_idx: torch.Tensor,  # [F, 2*V] per-slot source camera
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pool sampler's operands: the pool [F*N, H, W], the per-warp
    coordinates [F*2V, h, w, 2] and the global source index [F*2V], where
    slot k of frame f samples pool image f*N + src[f, k]."""
    f, n, h, w = images.shape
    slots = coords.shape[1]
    src_global = (
        torch.arange(f, dtype=torch.int32, device=images.device)[:, None] * n
        + src_cam_idx.reshape(f, slots).to(torch.int32)
    ).reshape(-1)
    flat_coords = coords.reshape(f * slots, *coords.shape[2:]).to(torch.float32).contiguous()
    return images.reshape(f * n, h, w), flat_coords, src_global


def _pool_warp_frames(
    images: torch.Tensor,  # [F, N, H, W]
    coords: torch.Tensor,  # [F, 2*V, h, w, 2]
    src_cam_idx: torch.Tensor,  # [F, 2*V]
    view_valid: torch.Tensor,  # [F, 2, V]
    sampler: str,
) -> torch.Tensor:  # [F, 2, V, h, w] in [0, 1]
    """ONE plain pool-sampler call for every warp of every frame against
    the F*N source views."""
    pool, flat_coords, src_global = _pool_inputs(images, coords, src_cam_idx)
    out = bilinear_sample_pool_plain(pool, flat_coords, src_global)
    warped = out.reshape(images.shape[0], *view_valid.shape[1:], *out.shape[1:]) / 255.0
    return torch.where(view_valid[..., None, None], warped, torch.zeros_like(warped))


def _frame_inputs_from_crops(
    crop_set: CropSet,  # leaves [..., B, V, ...]
    crop_images: torch.Tensor,  # [..., B, V, h, w]
    hand_idx: torch.Tensor,  # [B]
    use_memory: Optional[torch.Tensor] = None,  # [..., B] bool
) -> FrameInputs:
    """Dense model inputs; invalid view slots inherit view-0 geometry so
    every lane stays finite and orthonormal.  Without ``use_memory`` the
    gate is all False: the sequence scan computes the real one from the
    validity run."""
    extr_m = affine.rigid_inverse(crop_set.T_world_from_eye)
    extr_m[..., :3, 3] *= MM_TO_M
    vv = crop_set.view_valid[..., None, None]
    extr_m = torch.where(vv, extr_m, extr_m[..., 0:1, :, :])
    intr = torch.where(vv, crop_set.intrinsics, crop_set.intrinsics[..., 0:1, :, :])
    return FrameInputs(
        images=crop_images,
        intrinsics=intr,
        extrinsics=extr_m,
        n_views=torch.clamp(crop_set.n_views, min=1),
        hand_idx=hand_idx.expand(crop_set.n_views.shape),
        use_memory=torch.zeros_like(crop_set.hand_valid) if use_memory is None else use_memory,
    )


def _model_scan(
    model: UmeTrackNet,
    config: TrackerConfig,
    crop_sets: CropSet,  # leaves [T, B, ...]
    crop_images: torch.Tensor,  # [T, B, V, h, w]
    init_state: TrackState,  # leaves [B, ...]
    skeleton: Optional[SkeletonInputs],  # [Bs, 22, 3], Bs == B or 1; None: scale head
    hand_idx: torch.Tensor,  # [B]
) -> Tuple[FrameResult, TrackState]:
    """The recurrent model over time with the backbone hoisted out of the
    loop: image features for all T*B rows in one batch, then the conv-RNN
    cell per frame, then the regressor head for all rows in one batch (the
    scale-predicting head when ``skeleton`` is None).  Rows are flattened
    B-major."""
    t, b = crop_images.shape[:2]
    frames = _frame_inputs_from_crops(crop_sets, crop_images, hand_idx)

    hand_valid = crop_sets.hand_valid  # [T, B]
    if config.enable_memory:
        prev_valid = torch.cat([init_state.valid_history[None], hand_valid[:-1]], dim=0)
        use_memory = prev_valid & hand_valid
    else:
        use_memory = torch.zeros_like(hand_valid)
    cur_e = frames.extrinsics[:, :, 0].to(torch.float32)  # [T, B, 4, 4]
    prev_e = torch.cat(
        [init_state.temporal.prev_extrinsics[None].to(torch.float32), cur_e[:-1]], dim=0
    )
    mem_xf = memory_motion_transform(cur_e, prev_e, use_memory)  # [T, B, 4, 4]

    def flat(a):  # [T, B, ...] -> [B*T, ...]
        return a.transpose(0, 1).reshape(b * t, *a.shape[2:])

    def unflat(a):  # [B*T, ...] -> [T, B, ...]
        return a.reshape(b, t, *a.shape[1:]).transpose(0, 1)

    # 1) image features for ALL frames in one backbone batch
    feats_t = unflat(model.extract_features(frames.map(flat)))

    # 2) only the conv-RNN cell steps through time
    mem = init_state.temporal.mem_features
    fused = []
    for i in range(t):
        f, mem = model.temporal_step(feats_t[i], mem_xf[i], use_memory[i], mem)
        fused.append(f)
    fused_t = torch.stack(fused)

    # 3) regressor head for ALL frames in one batch
    if skeleton is not None:
        skel = model.encode_skeleton(skeleton)
        skel = skel.expand(b, *skel.shape[1:])
        skel_flat = skel[:, None].expand(b, t, *skel.shape[1:]).reshape(b * t, *skel.shape[1:])
        out = model.regress_known(
            flat(fused_t), skel_flat, flat(frames.hand_idx), flat(frames.extrinsics[:, :, 0])
        )
    else:
        out = model.regress_scale(
            flat(fused_t), flat(frames.hand_idx), flat(frames.extrinsics[:, :, 0])
        )
    out = out.map(unflat)

    wrist_mm = out.wrist_xfs.clone()
    wrist_mm[..., :3, 3] *= M_TO_MM
    results = FrameResult(
        joint_angles=out.joint_angles,
        wrist_xfs=wrist_mm,
        valid=hand_valid,
        n_views=crop_sets.n_views,
        predicted_scales=out.skel_scales,
    )
    final_state = TrackState(
        temporal=TemporalState(mem_features=mem, prev_extrinsics=cur_e[-1]),
        valid_history=hand_valid[-1],
    )
    return results, final_state


def _skeleton_inputs(hand_model_mm: HandModel, repeat: int = 1) -> SkeletonInputs:
    """Skeleton rows in meters: one per hand model (unbatched -> 1 row),
    each repeated ``repeat`` times."""
    hand_m = scaled_hand_model(hand_model_mm, MM_TO_M)
    axes = hand_m.joint_rotation_axes.reshape(-1, *hand_m.joint_rotation_axes.shape[-2:])
    rest = hand_m.joint_rest_positions.reshape(-1, *hand_m.joint_rest_positions.shape[-2:])

    def repeat_rows(a):  # ``repeat_interleave`` as a copy: no device-side sizes
        return a[:, None].expand(a.shape[0], repeat, *a.shape[1:]).reshape(-1, *a.shape[1:])

    return SkeletonInputs(
        joint_rotation_axes=repeat_rows(axes), joint_rest_positions=repeat_rows(rest),
    )


def _frame_geometry(
    config: TrackerConfig,
    rig: CameraRig,  # fields [..., N], batch dims broadcast to the frames'
    seq: FrameObservation,  # leaves [F..., ...] (frame dims first)
    hand_model_mm: HandModel,  # batch dims broadcast to the frames'
    min_num_crops: int,
) -> Tuple[CropSet, torch.Tensor]:
    """Crop sets and per-slot source-coordinate fields [F..., 2, V, h, w, 2]
    for all frame dims at once."""
    static_pts = static_crop_points_local(hand_model_mm, config.num_crop_points)
    crop_sets = gen_crop_set(
        rig, seq.T_world_from_camera, hand_model_mm, seq.gt_joint_angles,
        seq.gt_wrist_xfs, seq.gt_confidences, config, min_num_crops, static_pts,
    )
    return crop_sets, _crop_coords(rig, seq.T_world_from_camera, crop_sets, config.crop_size)


def _flat_frames(seq: FrameObservation, crop_sets: CropSet, coords: torch.Tensor):
    """Frame dims flattened to F: images [F, N, H, W], coords [F, 2V, h, w, 2],
    src [F, 2V], view_valid [F, 2, V]."""
    n_frames = crop_sets.hand_valid.shape[:-1].numel()
    slots = crop_sets.src_cam_idx.shape[-2:].numel()
    return (
        seq.images.reshape(n_frames, *seq.images.shape[-3:]),
        coords.reshape(n_frames, slots, *coords.shape[-3:]),
        crop_sets.src_cam_idx.reshape(n_frames, slots),
        crop_sets.view_valid.reshape(n_frames, *crop_sets.view_valid.shape[-2:]),
    )


def _prepare_frames(
    config: TrackerConfig,
    rig: CameraRig,
    seq: FrameObservation,
    hand_model_mm: HandModel,
    min_num_crops: int,
    sampler: str,
) -> Tuple[CropSet, torch.Tensor]:
    """Crop sets and warped crops [F..., 2, V, h, w] for every frame: the
    geometry over all frame dims at once, then ONE sampler call."""
    crop_sets, coords = _frame_geometry(config, rig, seq, hand_model_mm, min_num_crops)
    crop_images = _pool_warp_frames(*_flat_frames(seq, crop_sets, coords), sampler)
    frame_dims = crop_sets.hand_valid.shape[:-1]
    return crop_sets, crop_images.reshape(*frame_dims, *crop_images.shape[1:])


@torch.inference_mode()
def pool_warp_operands(
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...]
    hand_models_mm: HandModel,  # [S, ...]
    min_num_crops: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (pool, coords, src_idx) that :func:`track_sequences_batched`
    hands the image-pool sampler, for checking and timing it alone."""
    crop_sets, coords = _frame_geometry(
        config, rigs.unsqueeze_batch(1), seqs, hand_models_mm.unsqueeze_batch(1), min_num_crops
    )
    images, coords, src, _ = _flat_frames(seqs, crop_sets, coords)
    return _pool_inputs(images, coords, src)


@torch.inference_mode()
def _track_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,  # fields [N]
    obs: FrameObservation,  # one frame: images [N, H, W], ...
    state: TrackState,  # leaves [2, ...]
    hand_model_mm: HandModel,
    min_num_crops: int,
    known: bool,
    sampler: str,
    skel_hand_model_mm: Optional[HandModel] = None,
) -> Tuple[FrameResult, TrackState]:
    """One tracker step: crops -> one pool warp over the frame's 2*V slots
    -> model forward with the memory gate from the carried state -> decode
    -> new state."""
    crop_set, crop_images = _prepare_frames(
        config, rig, obs, hand_model_mm, min_num_crops, sampler
    )  # leaves [2, ...], [2, V, h, w]
    if config.enable_memory:
        use_memory = state.valid_history & crop_set.hand_valid
    else:
        use_memory = torch.zeros_like(crop_set.hand_valid)
    frame = _frame_inputs_from_crops(
        crop_set, crop_images, torch.arange(2, device=crop_images.device), use_memory
    )
    if known:
        # Crops always come from ``hand_model_mm`` (the GT skeleton of the
        # eval protocol); the model's skeleton input may differ.
        skel_src = hand_model_mm if skel_hand_model_mm is None else skel_hand_model_mm
        out, new_temporal = model.known_skeleton(frame, _skeleton_inputs(skel_src), state.temporal)
    else:
        out, new_temporal = model.predict_scale(frame, state.temporal)

    wrist_mm = out.wrist_xfs.clone()
    wrist_mm[..., :3, 3] *= M_TO_MM
    result = FrameResult(
        joint_angles=out.joint_angles,
        wrist_xfs=wrist_mm,
        valid=crop_set.hand_valid,
        n_views=crop_set.n_views,
        predicted_scales=out.skel_scales,
    )
    return result, TrackState(temporal=new_temporal, valid_history=crop_set.hand_valid)


def _prepare_sequences_merged(
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...]
    hand_models_mm: HandModel,  # [S, ...]
    min_num_crops: int,
    sampler: str,
) -> Tuple[CropSet, torch.Tensor]:
    """(S, T) prep, reshaped time-major with the S sequences merged into 2S
    flat hand rows for the recurrent scan: leaves ``[T, 2S, ...]``."""
    s = rigs.fx.shape[0]
    crop_sets, crop_images = _prepare_frames(
        config, rigs.unsqueeze_batch(1), seqs, hand_models_mm.unsqueeze_batch(1),
        min_num_crops, sampler,
    )  # leaves [S, T, 2, ...]

    def to_scan(a):  # [S, T, 2, ...] -> [T, 2S, ...]
        a = a.transpose(0, 1)
        return a.reshape(a.shape[0], s * 2, *a.shape[3:])

    return crop_sets.map(to_scan), to_scan(crop_images)


def _sequences_batched_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...]
    init_state: TrackState,  # leaves [2S, ...]
    hand_models_mm: HandModel,  # [S, ...]
    min_num_crops: int,
    skel_hand_models_mm: Optional[HandModel],
    sampler: str,
) -> Tuple[FrameResult, TrackState]:
    """:func:`track_sequences_batched` on inputs already on the model's
    device."""
    s = rigs.fx.shape[0]
    crop_sets_t, crop_images_t = _prepare_sequences_merged(
        config, rigs, seqs, hand_models_mm, min_num_crops, sampler
    )
    skel_src = hand_models_mm if skel_hand_models_mm is None else skel_hand_models_mm
    hand_idx = torch.arange(2, device=crop_images_t.device).repeat(s)
    results, final_state = _model_scan(
        model, config, crop_sets_t, crop_images_t, init_state,
        _skeleton_inputs(skel_src, repeat=2), hand_idx,
    )
    results = results.map(lambda a: a.reshape(a.shape[0], s, 2, *a.shape[2:]))
    return results, final_state


def _first_n_valid_mean(
    scales: torch.Tensor,  # [..., K] in the order the samples are appended
    valid: torch.Tensor,  # [..., K] bool
    n_calibration_samples: int,
) -> torch.Tensor:  # [...]
    """Mean of the first ``n_calibration_samples`` valid scales along the
    last dim (0 = all valid ones); 0 where none is valid."""
    if n_calibration_samples:
        take = valid & (torch.cumsum(valid.to(torch.int32), dim=-1) <= n_calibration_samples)
    else:
        take = valid
    w = take.to(scales.dtype)
    return (scales * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def _calibrate_sequences_batched_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...]
    init_state: TrackState,  # leaves [2S, ...]
    hand_models_mm: HandModel,  # [S, ...]
    n_calibration_samples: int,
    min_num_crops: int,
    sampler: str,
) -> torch.Tensor:  # [S]
    """:func:`calibrate_sequences_batched` on inputs already on the model's
    device."""
    s = rigs.fx.shape[0]
    crop_sets_t, crop_images_t = _prepare_sequences_merged(
        config, rigs, seqs, hand_models_mm, min_num_crops, sampler
    )
    results, _ = _model_scan(
        model, config, crop_sets_t, crop_images_t, init_state, None,
        torch.arange(2, device=crop_images_t.device).repeat(s),
    )

    def per_sequence(a):  # [T, 2S] -> [S, T*2] frame-major, hand-minor
        return a.reshape(-1, s, 2).transpose(0, 1).reshape(s, -1)

    return _first_n_valid_mean(
        per_sequence(results.predicted_scales), per_sequence(results.valid),
        n_calibration_samples,
    )


PLAIN = "plain"


def track_frame(model: UmeTrackNet, config: TrackerConfig, rig: CameraRig, obs: FrameObservation,
                state: TrackState, hand_model_mm: HandModel, min_num_crops: int = 1,
                known: bool = True) -> Tuple[FrameResult, TrackState]:
    """One streamed frame (no leading axis), the state carried by the
    caller; results ``[2, ...]`` in mm."""
    return _track_step(model, config, rig, obs, state, hand_model_mm, min_num_crops, known, PLAIN)


@torch.inference_mode()
def track_sequences_batched(model: UmeTrackNet, config: TrackerConfig, rigs: CameraRig,
                            seqs: FrameObservation, init_state: TrackState,
                            hand_models_mm: HandModel, min_num_crops: int = 1,
                            skel_hand_models_mm: Optional[HandModel] = None,
                            ) -> Tuple[FrameResult, TrackState]:
    """S sequences in lock-step, state rows ``[2S]``; results ``[T, S, 2, ...]``."""
    return _sequences_batched_step(model, config, rigs, seqs, init_state, hand_models_mm,
                                   min_num_crops, skel_hand_models_mm, PLAIN)


@torch.inference_mode()
def calibrate_sequences_batched(model: UmeTrackNet, config: TrackerConfig, rigs: CameraRig,
                                seqs: FrameObservation, init_state: TrackState,
                                hand_models_mm: HandModel, n_calibration_samples: int = 30,
                                min_num_crops: int = 2) -> torch.Tensor:
    """Unknown-skeleton pass 1 for S sequences: each sequence's mean of its
    first ``n_calibration_samples`` valid scale predictions [S]."""
    return _calibrate_sequences_batched_step(model, config, rigs, seqs, init_state, hand_models_mm,
                                             n_calibration_samples, min_num_crops, PLAIN)
