"""Distillation: a fresh student trained against a teacher's poses.

Counterpart of ``umetrack_tpu/apps/distill.py``.  The teacher is the
original UmeTrack torch model's weights (a ``*.torch`` state dict, loaded
through ``models/convert.py::from_reference_state_dict``); the student, a
fresh ``UmeTrackNet``, trains on synthetic crops labelled with the
teacher's pose outputs.  One command runs the loop (train, periodic
orbax checkpoint directory ``ckpt_step_{step:07d}``, held-out
student-teacher gap) and ends with a
tracked evaluation of both on held-out rendered sequences, aggregated into
the metric set of the evaluation apps (MPJPE mm, MPJPA deg, PCK-AUC 0-50
mm, success rate, mean keypoint acceleration) with the teacher's poses as
the reference.  Runs on the GPU unless ``--device cpu`` is given.

    python -m umetrack_torch.apps.distill --teacher <state.torch> --steps 200 [--out <dir>]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..data import bundles
from ..data.transform import RawSequence, parse_raw_buffers, preprocess_sequence
from ..kinematics.skinning import skin_landmarks
from ..models import ModelConfig, UmeTrackNet
from ..models.umetrack import FrameInputs, SkeletonInputs, TemporalState
from ..parallel import ClippedAdamW, LossWeights, TrainBatch, create_train_state, init_train_model, train_step
from ..utils.checkpoints import load_checkpoint, save_checkpoint

logger = logging.getLogger(__name__)


def build_teacher(checkpoint: Optional[str], config: Optional[ModelConfig] = None,
                  device=None) -> UmeTrackNet:
    """The teacher on ``device`` (CUDA unless "cpu"), in eval mode, from a
    state dict of the original model (``*.torch``), a ``.msgpack`` file or
    an orbax checkpoint directory.  The JAX package builds a randomly
    initialised original model when given no checkpoint, which needs the
    original UmeTrack code; the port has none of it, so no checkpoint
    raises."""
    if not checkpoint or not os.path.exists(checkpoint):
        raise FileNotFoundError(
            f"teacher checkpoint {checkpoint!r} not found: pass --teacher <state.torch>, "
            "a state dict of the original UmeTrack model"
        )
    config = config or ModelConfig()
    teacher = UmeTrackNet(config)
    teacher.load_state_dict(load_checkpoint(checkpoint, config))
    return teacher.to(resolve_device(device)).eval()


def _raw_frames(batch_size: int, seed: int, device=None) -> RawSequence:
    """One batch of single-frame synthetic torch_data samples (120 x 160
    frames with the hand rendered on ``device``, collated on the host)."""
    from ..utils.synthetic import make_torchdata_sample

    return bundles.collate([
        parse_raw_buffers(*make_torchdata_sample(
            rng_seed=seed + i, t=1, hand_idx=(seed + i) % 2, render=True, device=device))
        for i in range(batch_size)
    ])


@torch.no_grad()
def _teacher_batch(teacher: UmeTrackNet, raw_batch: RawSequence, crop_size=(96, 96)) -> TrainBatch:
    """Preprocess on the teacher's device (one warp launch for the batch)
    and label the batch with the teacher's pose outputs: the student's GT
    angles and wrists are the teacher's."""
    device = next(teacher.parameters()).device
    model_input, _ = preprocess_sequence(bundles.to_device(raw_batch, device), tuple(crop_size))
    b, _, v = model_input.left_images.shape[:3]
    frame = FrameInputs(
        images=model_input.left_images[:, 0],
        intrinsics=model_input.intrinsics[:, 0],
        extrinsics=model_input.extrinsics_xf[:, 0],
        n_views=torch.full((b,), v, dtype=torch.int32, device=device),
        hand_idx=model_input.hand_idx[:, 0].to(torch.int32),
        use_memory=torch.zeros((b,), dtype=torch.bool, device=device),
    )
    hand = model_input.orig_pose_data.left_hand_model
    skeleton = SkeletonInputs(
        joint_rotation_axes=hand.joint_rotation_axes,
        joint_rest_positions=hand.joint_rest_positions,
    )
    teacher.eval()
    out, _ = teacher.known_skeleton(frame, skeleton, TemporalState.zeros(b, teacher.config, device))
    return TrainBatch(
        frame=frame, skeleton=skeleton, gt_joint_angles=out.joint_angles,
        gt_wrist_world=out.wrist_xfs, hand=hand,
    )


@torch.no_grad()
def _distill_gap_mm(student: UmeTrackNet, batch: TrainBatch) -> torch.Tensor:
    """Held-out student-teacher landmark distance (mm) in eval mode."""
    student.eval()
    b = batch.gt_joint_angles.shape[0]
    device = batch.gt_joint_angles.device
    out, _ = student.known_skeleton(
        batch.frame, batch.skeleton, TemporalState.zeros(b, student.config, device)
    )
    t_lm = skin_landmarks(batch.hand, batch.gt_joint_angles, batch.gt_wrist_world)
    s_lm = skin_landmarks(batch.hand, out.joint_angles, out.wrist_xfs)
    return torch.linalg.vector_norm(t_lm - s_lm, dim=-1).mean() * 1000.0


def _tracked_metrics(student: UmeTrackNet, teacher: UmeTrackNet, n_sequences: int, device) -> dict:
    """Both models tracked over held-out rendered sequences (8 frames
    each); the student's metrics with the teacher's poses as the
    reference."""
    from .. import metrics as metrics_mod
    from ..tracker import HandTracker, sequence_landmarks
    from ..utils import synthetic

    trackers = [HandTracker(m, device=device) for m in (student, teacher)]
    per_seq, valid_list = [], []
    for i in range(n_sequences):
        labels, images = synthetic.make_labels_dict(8, rng_seed=20_000 + i, device=device)
        rig, seq, hand = synthetic.our_sequence(labels, images, device)
        (res_s, _), (res_t, _) = [tr.track_sequence(rig, seq, hand) for tr in trackers]

        def hands_first(a):  # [T, 2, ...] -> [2, T, ...] numpy
            return np.moveaxis(a.cpu().numpy(), 0, 1)

        lm_s = sequence_landmarks(hand, res_s.joint_angles, res_s.wrist_xfs)
        lm_t = sequence_landmarks(hand, res_t.joint_angles, res_t.wrist_xfs)
        valid = hands_first(res_s.valid & res_t.valid)
        per_seq.append(metrics_mod.compute_sequence_metrics(
            hands_first(lm_t), hands_first(lm_s), valid,
            hands_first(res_t.joint_angles), hands_first(res_s.joint_angles),
        ))
        valid_list.append(valid)
    return metrics_mod.aggregate(per_seq, valid_list)


def run_distillation(
    steps: int = 200,
    batch_size: int = 8,
    eval_every: int = 50,
    learning_rate: float = 3e-4,
    teacher_checkpoint: Optional[str] = None,
    out_dir: Optional[str] = None,
    n_eval_sequences: int = 2,
    seed: int = 0,
    device=None,
):
    """Returns (gaps, final_metrics): the held-out distillation gap (mm) at
    every evaluation step, and the final student's tracked metrics against
    the teacher.  AdamW at a constant ``learning_rate``, weight decay 1e-5,
    no clipping (the JAX package's ``optax.adamw``)."""
    device = resolve_device(device)
    config = ModelConfig()
    teacher = build_teacher(teacher_checkpoint, config, device)
    student = init_train_model(config, seed=seed + 1, device=device)
    state = create_train_state(
        student, ClippedAdamW(student.parameters(), learning_rate, 1e-5, max_grad_norm=None)
    )
    weights = LossWeights()
    heldout = _teacher_batch(teacher, _raw_frames(16, seed=10_000, device=device))

    gaps = []
    for step in range(steps):
        batch = _teacher_batch(
            teacher, _raw_frames(batch_size, seed=seed + step * batch_size, device=device))
        metrics = train_step(state, batch, weights)
        if step % eval_every == 0 or step == steps - 1:
            gap = float(_distill_gap_mm(student, heldout))
            gaps.append(gap)
            logger.info("step %d: loss=%.5f heldout distill gap=%.2f mm",
                        step, float(metrics["loss"]), gap)
            if out_dir:
                save_checkpoint(f"{out_dir}/ckpt_step_{step:07d}", student.state_dict())

    final = _tracked_metrics(student, teacher, n_eval_sequences, device)
    final["distill_gap_mm"] = gaps
    return gaps, final


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--eval-every", type=int, default=50)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--teacher", default=None,
                        help="the teacher's weights: a state dict of the original UmeTrack "
                             "model (*.torch), a .msgpack file or an orbax checkpoint dir")
    parser.add_argument("--out", default=None, help="checkpoint directory")
    parser.add_argument("--eval-sequences", type=int, default=2)
    parser.add_argument(
        "--device", default=None, help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'"
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    gaps, final = run_distillation(
        steps=args.steps, batch_size=args.batch_size, eval_every=args.eval_every,
        learning_rate=args.lr, teacher_checkpoint=args.teacher, out_dir=args.out,
        n_eval_sequences=args.eval_sequences, device=args.device,
    )
    print(json.dumps(final, default=float))
    return final


if __name__ == "__main__":
    main()
