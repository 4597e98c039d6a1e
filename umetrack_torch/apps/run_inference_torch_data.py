"""Batched torch_data inference (the throughput eval path).

Counterpart of ``umetrack_tpu/apps/run_inference_torch_data.py``: iterate
the TEST split of torch_data folders (fields ``mono`` + ``labels``),
preprocess each sequence into 96x96 left-hand crops, step the model over
the sequence with temporal memory (``use_memory=False`` only at t=0), skin
GT and predicted landmarks with the per-sample (mirrored) hand model, and
report mean keypoint error in mm.

Prefetch threads read and parse to numpy; a batch is collated on the host,
uploaded once (frames stay uint8), preprocessed on the device with ONE warp
kernel launch, and run through the model.  Runs on the GPU unless
``device="cpu"`` / ``--device cpu`` is given.

    python -m umetrack_torch.apps.run_inference_torch_data --data <root> [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..data import Sampler, Split, bundles, find_dataset, iterate_dataset
from ..data.transform import ModelInput, RawSequence, parse_raw_buffers, preprocess_sequence
from ..kinematics.hand import mirrored_hand_model
from ..kinematics.skinning import skin_landmarks
from ..models.umetrack import (
    FrameInputs,
    SkeletonInputs,
    TemporalState,
    UmeTrackNet,
    memory_motion_transform,
)

logger = logging.getLogger(__name__)


@torch.inference_mode()
def eval_batch(
    model: UmeTrackNet,
    model_input: ModelInput,  # leaves batched [B, T, ...]
    gt_joint_angles: torch.Tensor,  # [B, T, 22]
    gt_wrist_xfs: torch.Tensor,  # [B, T, 4, 4] meters
    n_views: int = 2,
    step_valid: Optional[torch.Tensor] = None,  # [B, T] bool
) -> torch.Tensor:  # [B]
    """Per-sample mean keypoint error (mm) for a batch of sequences.

    The model steps through time with its memory (off only at t=0).  What
    does not depend on the recurrent state is taken out of the time loop,
    as the tracker does: the image features of all ``B*T`` rows in one
    backbone batch, the conv-RNN cell per step, then the known-skeleton
    head over all rows.  ``n_views=1`` is the "singlev" mode: only view 0
    of each sample feeds the model.  ``step_valid`` masks padded timesteps
    out of the per-sample mean (ragged batches are edge-padded)."""
    b, t = model_input.left_images.shape[:2]
    device = model_input.left_images.device
    left_hand = model_input.orig_pose_data.left_hand_model
    hand_idx = model_input.hand_idx[:, 0].to(torch.int64)

    images, extr = model_input.left_images, model_input.extrinsics_xf
    if n_views == 1:
        # zero the unused view; geometry copies view 0 (finite masks)
        images = images.clone()
        images[:, :, 1:] = 0.0
        extr = extr[:, :, :1].expand_as(extr)

    def flat(a):  # [B, T, ...] -> [B*T, ...]
        return a.reshape(b * t, *a.shape[2:])

    def per_step(a):  # [B, ...] -> [B*T, ...]
        return a[:, None].expand(b, t, *a.shape[1:]).reshape(b * t, *a.shape[1:])

    frames = FrameInputs(
        images=flat(images),
        intrinsics=flat(model_input.intrinsics),
        extrinsics=flat(extr),
        n_views=torch.full((b * t,), n_views, dtype=torch.int32, device=device),
        hand_idx=per_step(hand_idx),
        use_memory=torch.zeros((b * t,), dtype=torch.bool, device=device),
    )
    feats = model.extract_features(frames)
    feats = feats.reshape(b, t, *feats.shape[1:])

    state = TemporalState.zeros(b, model.config, device=device)
    mem, prev_e = state.mem_features, state.prev_extrinsics
    fused = []
    for i in range(t):
        use_memory = torch.full((b,), i > 0, dtype=torch.bool, device=device)
        cur_e = extr[:, i, 0].to(torch.float32)
        xf = memory_motion_transform(cur_e, prev_e, use_memory)
        f, mem = model.temporal_step(feats[:, i], xf, use_memory, mem)
        fused.append(f)
        prev_e = cur_e
    fused_bt = torch.stack(fused, dim=1)  # [B, T, C, h, w]

    skel = model.encode_skeleton(SkeletonInputs(
        joint_rotation_axes=left_hand.joint_rotation_axes,
        joint_rest_positions=left_hand.joint_rest_positions,
    ))
    out = model.regress_known(flat(fused_bt), per_step(skel), frames.hand_idx, flat(extr[:, :, 0]))
    pred_angles = out.joint_angles.reshape(b, t, -1)
    pred_wrists = out.wrist_xfs.reshape(b, t, 4, 4)

    # Mirror the left model back to the true side for landmark skinning,
    # one hand model per sample, broadcast over time.
    hand_bt = mirrored_hand_model(left_hand, hand_idx == 1).unsqueeze_batch(1)
    gt_lm = skin_landmarks(hand_bt, gt_joint_angles, gt_wrist_xfs)
    pred_lm = skin_landmarks(hand_bt, pred_angles, pred_wrists)
    step_err = torch.linalg.norm(gt_lm - pred_lm, dim=-1).mean(dim=2)  # [B, T]
    if step_valid is None:
        err = step_err.mean(dim=1)
    else:
        w = step_valid.to(step_err.dtype)
        err = (step_err * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    return err * 1000.0


# Ragged sequence lengths are edge-padded to the next multiple of this.
# Eager PyTorch compiles nothing per shape, so the batch's longest sequence
# is enough (the JAX package pads to 16 to bound its XLA compiles).
PAD_T_BUCKET = 1


def _pad_raw_np(raw: RawSequence, t_pad: int) -> RawSequence:
    """Edge-pad every time-major leaf of a host RawSequence to ``t_pad``."""
    t = raw.images.shape[0]
    if t == t_pad:
        return raw

    def pad(a):
        widths = [(0, t_pad - t)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(np.asarray(a), widths, mode="edge")

    return dataclasses.replace(
        raw,
        images=pad(raw.images),
        extrinsics=pad(raw.extrinsics),
        intrinsics=pad(raw.intrinsics),
        enclosing_points=pad(raw.enclosing_points),
        hand=pad(raw.hand),
        wrist=pad(raw.wrist),
        joint_angles=pad(raw.joint_angles),
        solved_wrist_xfs=pad(raw.solved_wrist_xfs),
        solved_joint_angles=pad(raw.solved_joint_angles),
        pinch=pad(raw.pinch),
    )


def _run_batch(
    model: UmeTrackNet, raws, crop_size=(96, 96), n_views: int = 2,
    sampler: Optional[str] = None,
) -> np.ndarray:  # [B] mm
    """Collate already-parsed numpy RawSequences (from the prefetch workers),
    upload them to the model's device, preprocess and evaluate.  Raw dict
    items are accepted too (parsed here)."""
    raws = [
        parse_raw_buffers(r["mono"], r["labels"]) if isinstance(r, dict) else r
        for r in raws
    ]
    device = next(model.parameters()).device
    lens = [int(r.images.shape[0]) for r in raws]
    t_pad = -(-max(lens) // PAD_T_BUCKET) * PAD_T_BUCKET
    raw_batch = bundles.to_device(
        bundles.collate([_pad_raw_np(r, t_pad) for r in raws]), device
    )
    step_valid = torch.as_tensor(
        np.arange(t_pad)[None, :] < np.asarray(lens)[:, None], device=device
    )
    model_input, target = preprocess_sequence(raw_batch, tuple(crop_size), sampler=sampler)
    err = eval_batch(
        model, model_input, target.gt_joint_angles, target.gt_wrist_xfs, n_views, step_valid
    )
    return err.cpu().numpy()


def run(
    data_roots,
    model: UmeTrackNet,
    batch_size: int = 16,
    crop_size=(96, 96),
    distrib_info=(0, 1),
    num_threads: int = 6,
    max_prefetch: int = 16,
    splits=(Split.TEST,),
    limit_batches: Optional[int] = None,
    n_views: int = 2,
    device=None,
    sampler: Optional[str] = None,
):
    """Returns {split: mean keypoint error mm}.  The model moves to
    ``device`` (CUDA unless ``"cpu"`` is passed; no GPU raises)."""
    model = model.to(resolve_device(device)).eval()
    datasets = find_dataset(data_roots, ["mono", "labels"])
    results = {}
    for split, dataset in datasets.items():
        if split not in splits:
            continue
        logger.info("split %s: %d sequences", split.value, len(dataset))
        sampler_idx = Sampler(len(dataset), shuffle=False, distrib_info=distrib_info)

        def load(item):
            # Runs in the prefetch worker threads: read + msgpack-parse to
            # numpy leaves only; the device work happens per batch.
            return parse_raw_buffers(item["mono"], item["labels"])

        errors = []
        batch = []
        t0 = time.time()
        for item in iterate_dataset(
            dataset, sampler_idx, transform=load, num_threads=num_threads,
            max_prefetch=max_prefetch,
        ):
            batch.append(item)
            if len(batch) < batch_size:
                continue
            errors.append(_run_batch(model, batch, crop_size, n_views, sampler))
            batch = []
            if limit_batches and len(errors) >= limit_batches:
                break
        if batch and not (limit_batches and len(errors) >= limit_batches):
            errors.append(_run_batch(model, batch, crop_size, n_views, sampler))
        if errors:
            all_err = np.concatenate(errors)
            results[split] = float(all_err.mean())
            logger.info(
                "split %s: %.3f mm over %d sequences (%.1f s)",
                split.value, results[split], len(all_err), time.time() - t0,
            )
    return results


def main(argv=None):
    from .common import add_runtime_flags, load_model_cli, setup_runtime

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", nargs="+", required=True,
                        help="torch_data roots (e.g. .../torch_data/real)")
    parser.add_argument("--checkpoint", default=None,
                        help="orbax checkpoint dir, .msgpack or .torch file "
                             "(seeded random weights without it)")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--limit-batches", type=int, default=None)
    parser.add_argument("--mode", choices=["multiv", "singlev"], default="multiv")
    parser.add_argument("--json", action="store_true", help="print JSON result")
    add_runtime_flags(parser)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    rank, world_size = setup_runtime(args)
    model = load_model_cli(args.checkpoint, args.dtype, args.device)
    results = run(
        args.data, model,
        batch_size=args.batch_size,
        distrib_info=(rank, world_size),
        limit_batches=args.limit_batches,
        n_views=1 if args.mode == "singlev" else 2,
        device=args.device,
        sampler=args.sampler,
    )
    out = {s.value: v for s, v in results.items()}
    if args.json:
        print(json.dumps(out))
    else:
        for split, err in out.items():
            print(f"Keypoint errors ({split}): {err:.4f} mm")


if __name__ == "__main__":
    main()
