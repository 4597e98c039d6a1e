"""The temporal hand tracker: sequences, single frames, scale calibration.

Counterpart of ``umetrack_tpu/tracker/tracker.py``.  On a sequence, the
per-frame work that does not depend on the recurrent state (crop cameras,
the fisheye -> pinhole coordinate fields, the crop warps, the image
features) runs over all frames at once; only the conv-RNN cell steps
through time, in a Python loop; the regressor head (``regressor_k`` with a
known skeleton, ``regressor_u`` predicting the skeleton scale) then runs
over all frames at once again.  :func:`track_frame` is the streaming form:
one frame, the state carried by the caller.  Every warp of every frame of a
call goes through ONE call of the image-pool sampler (``ops/warp_pool.py``).

Every entry point jitted in the JAX package (:func:`track_frame`,
:func:`track_sequence`, :func:`track_sequences_batched` and the
calibrations :func:`calibrate_sequences_batched`,
:func:`predict_scales_sequence`, :func:`calibrate_sequence`) runs on the
card as a captured CUDA graph (``compiled.py``): the first call per key
runs eagerly and captures, later calls replay.  Their eager forms are the
``_*_step`` functions.

Under a profile each entry point is the root span ``entry.<its name>``,
and the move of its inputs to the card the span ``to_device``
(``utils/profiling.py``); :data:`HOST_COPIES` counts the moves and the
host tensors they copy to the card, profile or not.

Units: the tracker API is mm, the model consumes meters.  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from .._device import resolve_device
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
from ..ops.resample import (
    bilinear_sample,
    bilinear_sample_pool_plain,
    fisheye_to_pinhole_coords,
)
from ..ops.warp_pool import warp_pool
from ..utils.profiling import entry, span
from .compiled import CompiledStep
from .crops import gather_cameras, gen_crop_set, landmarks_from_pose, static_crop_points_local
from .types import (
    IMAGE_SAMPLERS,
    M_TO_MM,
    MM_TO_M,
    CameraRig,
    CropSet,
    FrameObservation,
    FrameResult,
    TrackerConfig,
    TrackState,
)


# calls of ``_on_device`` ("calls") and the host tensors they copied to the
# card ("copies"), over the process
HOST_COPIES: "collections.Counter[str]" = collections.Counter()


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


def _warp_crops(
    pool: torch.Tensor,  # [M, H, W]
    coords: torch.Tensor,  # [Wn, h, w, 2]
    src_idx: torch.Tensor,  # [Wn]
    method: str,
) -> torch.Tensor:  # [Wn, h, w]
    """Per-slot single-image warp: every slot samples its own copy of its
    source view, all slots in one call of a single-image sampler."""
    per_slot = pool.index_select(0, src_idx.to(torch.int64))
    return bilinear_sample(per_slot, coords, method)


def _pool_warp_frames(
    images: torch.Tensor,  # [F, N, H, W]
    coords: torch.Tensor,  # [F, 2*V, h, w, 2]
    src_cam_idx: torch.Tensor,  # [F, 2*V]
    view_valid: torch.Tensor,  # [F, 2, V]
    sampler: str,
) -> torch.Tensor:  # [F, 2, V, h, w] in [0, 1]
    """ONE sampler call for every warp of every frame against the F*N
    source views."""
    pool, flat_coords, src_global = _pool_inputs(images, coords, src_cam_idx)
    if sampler in IMAGE_SAMPLERS:
        out = _warp_crops(pool, flat_coords, src_global, IMAGE_SAMPLERS[sampler])
    elif sampler == "kernel":
        out = warp_pool(pool, flat_coords, src_global)
    else:
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


def _on_device(model: UmeTrackNet, device, *trees):
    """``trees`` moved to ``device``, counted in :data:`HOST_COPIES`."""
    device = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != device.type or (device.index is not None and p.device != device):
        raise ValueError(f"model is on {p.device}, the call on {device}: move it first")
    HOST_COPIES["calls"] += 1

    def move(a: torch.Tensor) -> torch.Tensor:
        if a.device.type == "cpu" and device.type != "cpu":
            HOST_COPIES["copies"] += 1
        return a.to(device)

    with span("to_device"):
        return device, [None if tr is None else tr.map(move) for tr in trees]


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


def _sequence_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,  # fields [N]
    seq: FrameObservation,  # leaves [T, ...]
    init_state: TrackState,  # leaves [2, ...]
    hand_model_mm: HandModel,
    min_num_crops: int,
    skel_hand_model_mm: Optional[HandModel],
    sampler: str,
) -> Tuple[FrameResult, TrackState]:
    """:func:`track_sequence` on inputs already on the model's device."""
    crop_sets, crop_images = _prepare_frames(
        config, rig, seq, hand_model_mm, min_num_crops, sampler
    )
    skel_src = hand_model_mm if skel_hand_model_mm is None else skel_hand_model_mm
    return _model_scan(
        model, config, crop_sets, crop_images, init_state,
        _skeleton_inputs(skel_src), torch.arange(2, device=crop_images.device),
    )


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


_FRAME = CompiledStep(_track_step)
_SEQUENCE = CompiledStep(_sequence_step)
_SEQUENCES_BATCHED = CompiledStep(_sequences_batched_step)


def _entry(step, model: UmeTrackNet, device, trees: dict, *, name: str = "", **static):
    """``step`` (a :class:`CompiledStep` or its ``eager`` form) on ``trees``
    moved to ``device`` (outside any captured region), with the sampler the
    config resolves there; under a profile, the root span
    ``entry.<name>``, ``name`` the public entry point's (by default the
    step's)."""
    with entry(name or getattr(step, "__self__", step).name):
        device, moved = _on_device(model, device, *trees.values())
        sampler = static["config"].resolved_sampler(device)
        return step(model, device, dict(zip(trees, moved)), sampler=sampler, **static)


def track_frame(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,  # fields [N]
    obs: FrameObservation,  # one frame (no leading axis)
    state: TrackState,  # leaves [2, ...]
    hand_model_mm: HandModel,
    min_num_crops: int = 1,
    known: bool = True,
    device=None,
) -> Tuple[FrameResult, TrackState]:
    """Single-frame streaming entry point: ``known=True`` tracks with the
    skeleton of ``hand_model_mm``, ``known=False`` with the scale-predicting
    head (``predicted_scales`` is set).  Results are ``[2, ...]`` in mm."""
    return _entry(
        _FRAME, model, device, dict(rig=rig, obs=obs, state=state, hand_model_mm=hand_model_mm),
        name="track_frame", config=config, min_num_crops=min_num_crops, known=known,
    )


def track_sequence(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,  # fields [N]
    seq: FrameObservation,  # leaves [T, ...]
    init_state: TrackState,  # leaves [2, ...]
    hand_model_mm: HandModel,
    min_num_crops: int = 1,
    skel_hand_model_mm: Optional[HandModel] = None,
    device=None,
) -> Tuple[FrameResult, TrackState]:
    """Known-skeleton tracking over a whole sequence: per-frame prep
    (crops + one pool warp) for all frames, then the recurrent model.
    Results are ``[T, 2, ...]`` in mm."""
    return _entry(
        _SEQUENCE, model, device,
        dict(rig=rig, seq=seq, init_state=init_state, hand_model_mm=hand_model_mm,
             skel_hand_model_mm=skel_hand_model_mm),
        name="track_sequence", config=config, min_num_crops=min_num_crops,
    )


def track_sequences_batched(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...] (sequence-major)
    init_state: TrackState,  # leaves [2S, ...] (flat hand rows)
    hand_models_mm: HandModel,  # [S, ...]
    min_num_crops: int = 1,
    skel_hand_models_mm: Optional[HandModel] = None,
    device=None,
) -> Tuple[FrameResult, TrackState]:
    """Track S sequences in lock-step: the (S, T) prep runs at once with
    ONE pool warp over all S*T*2*V warps, and the recurrent model runs with
    the S sequences merged into 2S hand rows.  Results are ``[T, S, 2, ...]``."""
    return _entry(_SEQUENCES_BATCHED, model, device, dict(
        rigs=rigs, seqs=seqs, init_state=init_state, hand_models_mm=hand_models_mm,
        skel_hand_models_mm=skel_hand_models_mm,
    ), name="track_sequences_batched", config=config, min_num_crops=min_num_crops)


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


def _predict_scales_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,
    seq: FrameObservation,  # leaves [T, ...]
    init_state: TrackState,
    hand_model_mm: HandModel,
    min_num_crops: int,
    sampler: str,
) -> Tuple[torch.Tensor, torch.Tensor, TrackState]:
    """:func:`predict_scales_sequence` on inputs already on the model's
    device."""
    crop_sets, crop_images = _prepare_frames(config, rig, seq, hand_model_mm, min_num_crops, sampler)
    results, state = _model_scan(
        model, config, crop_sets, crop_images, init_state, None,
        torch.arange(2, device=crop_images.device),
    )
    return results.predicted_scales, results.valid, state


def _calibrate_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,
    seq: FrameObservation,  # leaves [T, ...]
    init_state: TrackState,
    hand_model_mm: HandModel,
    n_calibration_samples: int,
    sampler: str,
) -> torch.Tensor:  # scalar
    """:func:`calibrate_sequence` on inputs already on the model's device."""
    scales, valid, _ = _predict_scales_step(model, config, rig, seq, init_state, hand_model_mm, 2, sampler)
    return _first_n_valid_mean(scales.reshape(-1), valid.reshape(-1), n_calibration_samples)


_CALIBRATE_BATCHED = CompiledStep(_calibrate_sequences_batched_step)
_PREDICT_SCALES = CompiledStep(_predict_scales_step)
_CALIBRATE = CompiledStep(_calibrate_step)


def calibrate_sequences_batched(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...]
    init_state: TrackState,  # leaves [2S, ...]
    hand_models_mm: HandModel,  # [S, ...]
    n_calibration_samples: int = 30,
    min_num_crops: int = 2,
    device=None,
) -> torch.Tensor:  # [S]
    """Unknown-skeleton pass 1 for S sequences in lock-step: the scale head
    runs on 2S merged hand rows, and each sequence averages its first
    ``n_calibration_samples`` valid predictions (frame-major, hand 0 before
    hand 1: the order in which the original evaluation appends them)."""
    return _entry(_CALIBRATE_BATCHED, model, device, dict(
        rigs=rigs, seqs=seqs, init_state=init_state, hand_models_mm=hand_models_mm,
    ), name="calibrate_sequences_batched", config=config,
        n_calibration_samples=n_calibration_samples, min_num_crops=min_num_crops)


def predict_scales_sequence(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,
    seq: FrameObservation,  # leaves [T, ...]
    init_state: TrackState,
    hand_model_mm: HandModel,
    min_num_crops: int = 2,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, TrackState]:
    """Per-frame skeleton-scale predictions over a sequence (or a chunk of
    one): (scales [T, 2], valid [T, 2], final state).  The building block of
    the chunked calibration pass, whose callers aggregate across chunks on
    the host."""
    return _entry(_PREDICT_SCALES, model, device, dict(
        rig=rig, seq=seq, init_state=init_state, hand_model_mm=hand_model_mm,
    ), name="predict_scales_sequence", config=config, min_num_crops=min_num_crops)


def calibrate_sequence(
    model: UmeTrackNet,
    config: TrackerConfig,
    rig: CameraRig,
    seq: FrameObservation,  # leaves [T, ...]
    init_state: TrackState,
    hand_model_mm: HandModel,
    n_calibration_samples: int = 30,
    device=None,
) -> torch.Tensor:  # scalar
    """Unknown-skeleton pass 1: predict per-frame skeleton scales on 2-view
    frames and average the first ``n_calibration_samples`` valid ones
    (0 = all), frame-major, hand 0 before hand 1."""
    return _entry(_CALIBRATE, model, device, dict(
        rig=rig, seq=seq, init_state=init_state, hand_model_mm=hand_model_mm,
    ), name="calibrate_sequence", config=config, n_calibration_samples=n_calibration_samples)


@torch.inference_mode()
def sequence_landmarks(
    hand_model_mm: HandModel,
    joint_angles: torch.Tensor,  # [T, 2, 22]
    wrist_xfs: torch.Tensor,  # [T, 2, 4, 4] mm
) -> torch.Tensor:  # [T, 2, 21, 3]
    """World landmarks for a whole tracked sequence (both hands)."""
    hand_idx = torch.arange(2, device=joint_angles.device)
    return landmarks_from_pose(hand_model_mm.to(joint_angles.device), joint_angles, wrist_xfs, hand_idx)


class HandTracker:
    """Model + config bundle with the JAX package's ``HandTracker`` surface.
    The model moves to ``device`` (CUDA unless ``"cpu"`` is passed)."""

    def __init__(self, model: UmeTrackNet, config: Optional[TrackerConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config or TrackerConfig()

    def init_state(self, batch: int = 2) -> TrackState:
        return TrackState.init(self.model.config, batch, device=self.device)

    def track_frame(self, rig, obs, state, hand_model_mm, min_num_crops: int = 1):
        return track_frame(
            self.model, self.config, rig, obs, state, hand_model_mm, min_num_crops,
            known=True, device=self.device,
        )

    def track_frame_and_calibrate_scale(self, rig, obs, state, hand_model_mm,
                                        min_num_crops: int = 2):
        return track_frame(
            self.model, self.config, rig, obs, state, hand_model_mm, min_num_crops,
            known=False, device=self.device,
        )

    def calibrate_sequence(self, rig, seq, hand_model_mm, n_calibration_samples: int = 30,
                           init_state: Optional[TrackState] = None):
        return calibrate_sequence(
            self.model, self.config, rig, seq, init_state or self.init_state(),
            hand_model_mm, n_calibration_samples, device=self.device,
        )

    def predict_scales(self, rig, seq, hand_model_mm, min_num_crops: int = 2,
                       init_state: Optional[TrackState] = None):
        return predict_scales_sequence(
            self.model, self.config, rig, seq, init_state or self.init_state(),
            hand_model_mm, min_num_crops, device=self.device,
        )

    def track_sequence(self, rig, seq, hand_model_mm, min_num_crops: int = 1,
                       init_state: Optional[TrackState] = None,
                       skel_hand_model_mm=None):
        return track_sequence(
            self.model, self.config, rig, seq, init_state or self.init_state(),
            hand_model_mm, min_num_crops, skel_hand_model_mm, device=self.device,
        )

    def track_sequences_batched(self, rigs, seqs, hand_models_mm,
                                min_num_crops: int = 1,
                                init_state: Optional[TrackState] = None,
                                skel_hand_models_mm=None):
        s = rigs.fx.shape[0]
        return track_sequences_batched(
            self.model, self.config, rigs, seqs,
            init_state or self.init_state(2 * s), hand_models_mm,
            min_num_crops, skel_hand_models_mm, device=self.device,
        )
