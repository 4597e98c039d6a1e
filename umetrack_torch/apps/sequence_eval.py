"""Shared raw_data sequence-eval machinery for the eval apps.

Counterpart of ``umetrack_tpu/apps/sequence_eval.py``: host -> device
staging, sequence padding to length buckets, the known and unknown
protocols (whole-sequence and chunked with the state carried across
chunks), and the per-sequence result artifact (the original project's
pickle schema plus joint angles for MPJPA).
"""
from __future__ import annotations

import fnmatch
import logging
import os
import pickle
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..data import fs
from ..data.dataset import prefetch_map
from ..kinematics.hand import HandModel, scaled_hand_model
from ..tracker import HandTracker, sequence_landmarks
from ..tracker.types import FrameObservation
from ..tracker.video import SequenceData, SequenceStream
from ..utils.profiling import PhaseTimers

logger = logging.getLogger(__name__)

# Sequences are padded to a multiple of this many frames.  The JAX package
# pads so that one compiled program serves a bucket of lengths; the port
# keeps the bucket because it fixes what is computed on the padded frames.
PAD_BUCKET = 64


def find_input_output_files(
    input_dir: str, output_dir: str, test_only: bool = True
) -> Tuple[list, list]:
    """mp4/json pairs under input_dir -> (input_paths, output .npy paths)."""
    inputs, outputs = [], []
    for cur_dir, _, filenames in fs.walk(input_dir):
        if test_only and "testing" not in cur_dir:
            continue
        for fname in sorted(fnmatch.filter(filenames, "*.mp4")):
            full = fs.join(cur_dir, fname)
            rel = full[len(input_dir):].lstrip("/")
            inputs.append(full)
            outputs.append(fs.join(output_dir, rel[:-4] + ".npy"))
    logger.info("Found %d sequences under %s", len(inputs), input_dir)
    return inputs, outputs


def _chunk_observation(
    seq: Union[SequenceData, SequenceStream],
    t0: int,
    images: np.ndarray,  # frames [t0, t0 + len(images))
    length: int,
    device="cpu",
) -> FrameObservation:
    """Frames ``[t0, t0 + len(images))`` of ``seq`` on ``device``, padded to
    ``length`` with copies of the last frame (images, poses, GT) at zero
    confidence, so the padded frames track as invalid.  A sequence's tail
    and a chunk's are padded alike, so chunked tracking equals
    whole-sequence tracking."""
    c = len(images)
    sl = slice(t0, t0 + c)

    def pad(a):
        if c != length:
            a = np.pad(a, [(0, length - c)] + [(0, 0)] * (a.ndim - 1), mode="edge")
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    conf = np.pad(seq.gt_confidences[sl], [(0, length - c), (0, 0)], constant_values=0.0)
    return FrameObservation(
        images=pad(images),
        T_world_from_camera=pad(seq.T_world_from_camera[sl]),
        gt_joint_angles=pad(seq.gt_joint_angles[sl]),
        gt_wrist_xfs=pad(seq.gt_wrist_xfs[sl]),
        gt_confidences=torch.from_numpy(conf).to(device),
    )


def to_observation(
    seq: SequenceData, pad_bucket: int = PAD_BUCKET, device="cpu"
) -> FrameObservation:
    """The sequence as a FrameObservation on ``device``, padded to a length
    bucket; padded frames carry zero confidence so they track as invalid."""
    t = seq.n_frames
    return _chunk_observation(seq, 0, seq.images, -(-t // pad_bucket) * pad_bucket, device)


def _np(a: torch.Tensor) -> np.ndarray:
    return a.cpu().numpy()


def _gt_landmarks(seq: Union[SequenceData, SequenceStream], device) -> np.ndarray:
    """GT world landmarks [T, 2, 21, 3] of the unpadded sequence."""
    return _np(sequence_landmarks(
        seq.hand_model_mm,
        torch.from_numpy(seq.gt_joint_angles).to(device),
        torch.from_numpy(seq.gt_wrist_xfs).to(device),
    ))


def _artifact(
    seq: Union[SequenceData, SequenceStream],
    tracked_lm: np.ndarray,  # [T, 2, 21, 3]
    gt_lm: np.ndarray,  # [T, 2, 21, 3]
    joint_angles: np.ndarray,  # [T, 2, 22]
    valid: np.ndarray,  # [T, 2]
) -> Dict[str, np.ndarray]:
    """The eval artifact, hand-major as the original project writes it;
    keypoints of untracked frames are zeroed on both sides."""
    zero_if_invalid = np.where(valid[..., None, None], 1.0, 0.0)
    return {
        "tracked_keypoints": np.moveaxis(tracked_lm * zero_if_invalid, 0, 1),  # [2, T, 21, 3] mm
        "gt_keypoints": np.moveaxis(gt_lm * zero_if_invalid, 0, 1),
        "valid_tracking": np.moveaxis(valid, 0, 1),
        "tracked_joint_angles": np.moveaxis(joint_angles, 0, 1),
        "gt_joint_angles": np.moveaxis(np.asarray(seq.gt_joint_angles), 0, 1),
    }


def eval_sequence_known(
    tracker: HandTracker,
    seq: SequenceData,
    skel_hand_model_mm: Optional[HandModel] = None,
    lm_hand_model_mm: Optional[HandModel] = None,
    min_num_crops: int = 1,
) -> Dict[str, np.ndarray]:
    """Track one sequence and produce the eval artifact.

    ``skel_hand_model_mm`` overrides the model's skeleton input (calibrated
    skeleton in the unknown protocol); ``lm_hand_model_mm`` the model used to
    skin tracked landmarks.  Both default to the sequence's GT hand model.
    """
    obs = to_observation(seq, device=tracker.device)
    t = seq.n_frames
    results, _ = tracker.track_sequence(
        seq.rig, obs, seq.hand_model_mm, min_num_crops=min_num_crops,
        skel_hand_model_mm=skel_hand_model_mm,
    )
    lm_model = lm_hand_model_mm if lm_hand_model_mm is not None else seq.hand_model_mm
    tracked_lm = sequence_landmarks(lm_model, results.joint_angles, results.wrist_xfs)
    return _artifact(
        seq, _np(tracked_lm)[:t], _gt_landmarks(seq, tracker.device),
        _np(results.joint_angles)[:t], _np(results.valid)[:t],
    )


def eval_sequence_known_streaming(
    tracker: HandTracker,
    stream: SequenceStream,
    skel_hand_model_mm: Optional[HandModel] = None,
    lm_hand_model_mm: Optional[HandModel] = None,
    min_num_crops: int = 1,
    chunk: int = PAD_BUCKET,
    timers: Optional[PhaseTimers] = None,
) -> Dict[str, np.ndarray]:
    """Bounded-memory version of :func:`eval_sequence_known`: video decoded
    ``chunk`` frames at a time, with the ``TrackState`` carried across chunks
    so results equal whole-sequence tracking.  Peak host and device image
    memory is O(chunk), independent of sequence length."""
    lm_model = lm_hand_model_mm if lm_hand_model_mm is not None else stream.hand_model_mm
    timers = timers if timers is not None else PhaseTimers()

    # Decode the next chunk on a host thread while the device tracks the
    # current one.
    chunks = prefetch_map(lambda x: x, stream.chunks(chunk), num_threads=1, max_prefetch=1)

    state = tracker.init_state()
    angles_parts, valid_parts, tracked_lm_parts = [], [], []
    for t0, images in chunks:
        c = len(images)
        with timers.phase("stage", items=c):
            obs = _chunk_observation(stream, t0, images, chunk, tracker.device)
        with timers.phase("track", items=c, barrier=tracker.device):
            results, state = tracker.track_sequence(
                stream.rig, obs, stream.hand_model_mm,
                min_num_crops=min_num_crops, init_state=state,
                skel_hand_model_mm=skel_hand_model_mm,
            )
            tracked_lm = sequence_landmarks(lm_model, results.joint_angles, results.wrist_xfs)
        with timers.phase("fetch", items=c):
            angles_parts.append(_np(results.joint_angles)[:c])
            valid_parts.append(_np(results.valid)[:c])
            tracked_lm_parts.append(_np(tracked_lm)[:c])

    return _artifact(
        stream, np.concatenate(tracked_lm_parts), _gt_landmarks(stream, tracker.device),
        np.concatenate(angles_parts), np.concatenate(valid_parts),
    )


def calibrate_streaming(
    tracker: HandTracker,
    stream: SequenceStream,
    n_calibration_samples: int = 30,
    chunk: int = PAD_BUCKET,
) -> float:
    """Unknown-skeleton pass 1 with bounded memory: accumulate per-frame
    scale predictions chunk by chunk, stopping at ``n_calibration_samples``
    valid ones (frame-major, hand 0 before hand 1)."""
    state = tracker.init_state()
    scales_all, valid_all = [], []
    n_valid = 0
    for t0, images in stream.chunks(chunk):
        c = len(images)
        obs = _chunk_observation(stream, t0, images, chunk, tracker.device)
        scales, valid, state = tracker.predict_scales(
            stream.rig, obs, stream.hand_model_mm, init_state=state,
        )
        scales_all.append(_np(scales)[:c].reshape(-1))
        valid_all.append(_np(valid)[:c].reshape(-1))
        n_valid += int(valid_all[-1].sum())
        if n_calibration_samples and n_valid >= n_calibration_samples:
            break
    scales = np.concatenate(scales_all)
    valid = np.concatenate(valid_all)
    if n_calibration_samples:
        take = valid & (np.cumsum(valid.astype(np.int64)) <= n_calibration_samples)
    else:
        take = valid
    return float((scales * take).sum() / max(int(take.sum()), 1))


def _retrack_calibrated(evaluate, tracker, seq, generic_hand_model_mm, scale, **kwargs):
    """Unknown-skeleton pass 2: retrack with the generic skeleton at the
    calibrated scale (crops still come from the GT skeleton)."""
    calibrated = scaled_hand_model(generic_hand_model_mm, scale)
    logger.info("calibrated scale: %.4f", float(scale))
    out = evaluate(
        tracker, seq, skel_hand_model_mm=calibrated, lm_hand_model_mm=calibrated,
        min_num_crops=1, **kwargs,
    )
    out["calibrated_scale"] = np.asarray(scale)
    return out


def eval_sequence_unknown_streaming(
    tracker: HandTracker,
    stream: SequenceStream,
    generic_hand_model_mm: HandModel,
    n_calibration_samples: int = 30,
    chunk: int = PAD_BUCKET,
) -> Dict[str, np.ndarray]:
    """Two-pass unknown-skeleton protocol, bounded memory: the video is
    decoded once per pass."""
    scale = calibrate_streaming(
        tracker, stream, n_calibration_samples=n_calibration_samples, chunk=chunk
    )
    return _retrack_calibrated(
        eval_sequence_known_streaming, tracker, stream, generic_hand_model_mm, scale, chunk=chunk
    )


def eval_sequence_unknown(
    tracker: HandTracker,
    seq: SequenceData,
    generic_hand_model_mm: HandModel,
    n_calibration_samples: int = 30,
) -> Dict[str, np.ndarray]:
    """Two-pass unknown-skeleton protocol: calibrate the generic skeleton's
    scale on 2-view frames, then retrack with the calibrated skeleton."""
    scale = tracker.calibrate_sequence(
        seq.rig, to_observation(seq, device=tracker.device), seq.hand_model_mm,
        n_calibration_samples=n_calibration_samples,
    )
    return _retrack_calibrated(
        eval_sequence_known, tracker, seq, generic_hand_model_mm, _np(scale)
    )


def save_artifact(output_path: str, artifact: Dict[str, np.ndarray]) -> None:
    os.makedirs(fs.dirname(output_path), exist_ok=True)
    with open(output_path, "wb") as fp:
        pickle.dump(artifact, fp)


def sequence_mean_error(artifact: Dict[str, np.ndarray]) -> float:
    v = artifact["valid_tracking"].astype(bool)
    diff = (artifact["gt_keypoints"] - artifact["tracked_keypoints"])[v]
    if diff.size == 0:
        return float("nan")
    return float(np.linalg.norm(diff, axis=-1).mean())
