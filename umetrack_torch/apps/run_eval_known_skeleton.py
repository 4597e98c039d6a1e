"""Known-skeleton raw_data evaluation (the primary benchmark protocol).

Counterpart of ``umetrack_tpu/apps/run_eval_known_skeleton.py``: for every
testing ``*.mp4`` + ``*.json`` sequence, generate crop cameras from the GT
pose (min 1 crop), track with the temporal model using the per-user
calibrated skeleton, and pickle per-sequence artifacts for ``load_eval``
aggregation.  One process drives the GPU; a host thread decodes the next
chunk of video while the device tracks the current one.  ``--synthetic N``
runs on generated sequences when UmeTrack_data is unavailable.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional

import numpy as np

from ..data import fs
from ..tracker import HandTracker
from ..tracker.types import SAMPLERS
from ..tracker.video import SequenceData
from .common import add_runtime_flags, load_model_cli, setup_runtime, tracker_config_from_args
from .sequence_eval import (
    eval_sequence_known,
    eval_sequence_known_streaming,
    find_input_output_files,
    save_artifact,
    sequence_mean_error,
)

logger = logging.getLogger(__name__)


def load_model(checkpoint: Optional[str], dtype: str = "auto", device=None):
    """The eval model: ``common.load_model_cli`` (the checkpoint's weights,
    or seeded ones without a checkpoint, on ``device``: CUDA unless
    "cpu")."""
    return load_model_cli(checkpoint, dtype, device)


def sequences_to_process(args):
    """This rank's (input, output) pairs that still need an artifact."""
    inputs, outputs = find_input_output_files(
        args.input_dir, args.output_dir, test_only=not getattr(args, "all_splits", False)
    )
    todo = [
        (i, o)
        for i, o in zip(inputs[args.rank:: args.world_size], outputs[args.rank:: args.world_size])
        if args.override or not fs.exists(o)
    ]
    logger.info("%d sequences to process", len(todo))
    return todo


def run_real(args, tracker: HandTracker):
    from ..tracker.video import open_sequence
    from ..utils.profiling import PhaseTimers

    timers = PhaseTimers()
    errors = []
    for in_path, out_path in sequences_to_process(args):
        logger.info("Processing %s ...", in_path)
        # Streaming: labels load up front (small), video decodes in bounded
        # chunks overlapped with tracking on the device.
        artifact = eval_sequence_known_streaming(
            tracker, open_sequence(in_path), chunk=args.chunk, timers=timers
        )
        save_artifact(out_path, artifact)
        err = sequence_mean_error(artifact)
        errors.append(err)
        logger.info("%s: mean error %.3f mm -> %s", in_path, err, out_path)
    if errors:
        logger.info("Final mean error: %.4f mm", float(np.nanmean(errors)))
        logger.info("phase breakdown:\n%s", timers.report())
    return errors


def synthetic_scale(i: int, jitter: float) -> Optional[float]:
    """Deterministic per-sequence GT hand scale (None when jitter is 0)."""
    if not jitter:
        return None
    return float(np.random.default_rng(123 + i).uniform(1 - jitter, 1 + jitter))


def synthetic_sequence(args, i: int, device) -> SequenceData:
    """The i-th generated sequence of a ``--synthetic`` run, rendered on
    ``device``."""
    from ..kinematics.hand import from_dict
    from ..tracker.video import rig_from_labels
    from ..utils import synthetic

    labels, images = synthetic.make_labels_dict(
        args.synthetic_frames, rng_seed=args.seed_base + i, mode=args.synthetic_mode,
        hand_scale=synthetic_scale(args.seed_base + i, args.synthetic_scale_jitter),
        device=device,
    )

    def f32(key):
        return np.asarray(labels[key], np.float32)

    return SequenceData(
        images=images,
        T_world_from_camera=f32("camera_to_world_transforms"),
        gt_joint_angles=f32("joint_angles"),
        gt_wrist_xfs=f32("wrist_transforms"),
        gt_confidences=f32("hand_confidences"),
        rig=rig_from_labels(labels),
        hand_model_mm=from_dict(labels["hand_model"]),
        n_frames=len(images),
    )


def run_synthetic(args, tracker: HandTracker, evaluate=eval_sequence_known):
    """Generate, track and save ``args.synthetic`` sequences; ``evaluate``
    maps (tracker, sequence) to the artifact."""
    errors = []
    for i in range(args.synthetic):
        artifact = evaluate(tracker, synthetic_sequence(args, i, tracker.device))
        save_artifact(fs.join(args.output_dir, "synthetic", f"seq_{i:04d}.npy"), artifact)
        err = sequence_mean_error(artifact)
        errors.append(err)
        logger.info("synthetic seq %d: mean error %.3f mm", i, err)
    if errors:
        logger.info("Final mean error: %.4f mm", float(np.nanmean(errors)))
    return errors


def add_eval_flags(parser: argparse.ArgumentParser) -> None:
    """The flags both eval apps share."""
    parser.add_argument("--input-dir", default=None, help="UmeTrack_data/raw_data/real root")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="orbax checkpoint dir, .msgpack or .torch file "
                             "(seeded random weights without it)")
    parser.add_argument("--override", action="store_true")
    parser.add_argument("--chunk", type=int, default=64,
                        help="streaming decode/track chunk length (frames)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="run N synthetic sequences instead of raw_data")
    parser.add_argument("--synthetic-frames", type=int, default=64)
    parser.add_argument("--synthetic-mode", default="separate",
                        choices=["separate", "hand_hand"],
                        help="separate or interacting/occluding hands")
    parser.add_argument("--synthetic-scale-jitter", type=float, default=0.15,
                        help="per-sequence GT hand scale ~U[1-j, 1+j]; 0 disables")
    # Seed bands: corpus training seeds are [0, n_train), corpus test
    # 50_000+, tracker fine-tune 5_000+; eval draws from a reserved band
    # disjoint from every training seed, so held-out means held-out on the
    # motion axis too.
    parser.add_argument("--seed-base", type=int, default=1_000_000,
                        help="first rng seed for synthetic eval sequences "
                        "(reserved band, disjoint from all training seeds)")
    add_runtime_flags(parser, samplers=SAMPLERS)


def make_tracker(args) -> HandTracker:
    """Runtime flags applied: the model (checkpoint or seeded weights) on
    ``--device`` behind a tracker with the CLI's sampler."""
    args.rank, args.world_size = setup_runtime(args)
    model = load_model_cli(args.checkpoint, args.dtype, args.device)
    return HandTracker(model, tracker_config_from_args(args), device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_eval_flags(parser)
    parser.add_argument("--all-splits", action="store_true",
                        help="also process non-'testing' folders")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    tracker = make_tracker(args)
    if args.synthetic:
        return run_synthetic(args, tracker)
    if not args.input_dir:
        parser.error("--input-dir required without --synthetic")
    return run_real(args, tracker)


if __name__ == "__main__":
    main()
