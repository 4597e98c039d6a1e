"""Batched and sharded sequence evaluation.

Counterpart of ``umetrack_tpu/parallel/eval.py``.  S sequences are tracked
in lock-step (``track_sequences_batched``'s step: one ``warp_pool`` launch
for all their frames) and each gets its mean landmark error; each protocol
is one captured CUDA graph on the card, its counterpart of ``jax.jit``
(``tracker/compiled.py``), and runs eagerly under a process group.
Across processes the sequences shard by data index in contiguous blocks
(:func:`shard_eval_inputs`, rows ``2i, 2i+1`` of the tracker state go with
sequence ``i``) and the recurrence keeps each sequence on one rank; the
ranks of a model group track the same sequences with the weights sharded
over them (``parallel/mesh.py::shard_variables``).  The per-sequence
results and the global mean are reduced over the data group
(``parallel/collectives.py::gather_blocks``), where the JAX package lets
XLA insert the collectives on its mesh.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..kinematics.hand import HandModel, scaled_hand_model
from ..models.umetrack import UmeTrackNet
from ..tracker.crops import landmarks_from_pose
from ..tracker.compiled import CompiledStep
from ..tracker.tracker import _calibrate_sequences_batched_step, _entry, _sequences_batched_step
from ..tracker.types import CameraRig, FrameObservation, TrackerConfig, TrackState
from .collectives import gather_blocks
from .distributed import is_initialized
from .mesh import Mesh, block, data_group_of


def make_batched_state(model: UmeTrackNet, n_sequences: int, device=None) -> TrackState:
    """Flat ``[2S]``-row tracker state for the batched and sharded path, on
    ``device`` (CUDA unless "cpu")."""
    return TrackState.init(model.config, 2 * n_sequences, device=resolve_device(device))


def _eval_batched_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,
    seqs: FrameObservation,
    init_state: TrackState,
    hand_models_mm: HandModel,
    skel_hand_models_mm: Optional[HandModel],
    lm_hand_models_mm: Optional[HandModel],
    min_num_crops: int,
    sampler: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's (per-sequence error [S], valid slots [S], the masked
    sum and count of the mean [2]) on inputs on the model's device."""
    results, _ = _sequences_batched_step(
        model, config, rigs, seqs, init_state, hand_models_mm, min_num_crops,
        skel_hand_models_mm, sampler,
    )
    # results leaves [T, S, 2, ...] -> [S, T, 2, ...]
    angles = results.joint_angles.transpose(0, 1)
    wrists = results.wrist_xfs.transpose(0, 1)
    valid = results.valid.transpose(0, 1)
    hand_idx = torch.arange(2, device=valid.device)
    lm_models = hand_models_mm if lm_hand_models_mm is None else lm_hand_models_mm
    tracked = landmarks_from_pose(lm_models.unsqueeze_batch(2), angles, wrists, hand_idx)
    gt = landmarks_from_pose(
        hand_models_mm.unsqueeze_batch(2), seqs.gt_joint_angles, seqs.gt_wrist_xfs, hand_idx,
    )  # [S, T, 2, 21, 3]

    err = torch.linalg.vector_norm(tracked - gt, dim=-1).mean(dim=-1)  # [S, T, 2]
    vmask = valid.to(err.dtype)
    n_valid = vmask.sum(dim=(1, 2))
    per_seq_err = (err * vmask).sum(dim=(1, 2)) / torch.clamp(n_valid, min=1.0)
    has_valid = (n_valid > 0).to(err.dtype)
    return per_seq_err, n_valid, torch.stack([(per_seq_err * has_valid).sum(), has_valid.sum()])


def _eval_unknown_step(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,
    seqs: FrameObservation,
    hand_models_mm: HandModel,
    generic_hand_model_mm: HandModel,
    n_calibration_samples: int,
    min_num_crops: int,
    sampler: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's unknown protocol: the calibration, the calibrated
    generic skeletons, the known-skeleton retrack and its metrics."""
    s = rigs.fx.shape[0]
    device = rigs.fx.device
    scales = _calibrate_sequences_batched_step(
        model, config, rigs, seqs, make_batched_state(model, s, device), hand_models_mm,
        n_calibration_samples, 2, sampler,
    )  # [S]
    calibrated = scaled_hand_model(generic_hand_model_mm.map(lambda a: a.expand(s, *a.shape)), scales)
    per_seq, n_valid, totals = _eval_batched_step(
        model, config, rigs, seqs, make_batched_state(model, s, device), hand_models_mm,
        calibrated, calibrated, min_num_crops, sampler,
    )
    return per_seq, n_valid, totals, scales


_EVAL_BATCHED = CompiledStep(_eval_batched_step)
_EVAL_UNKNOWN = CompiledStep(_eval_unknown_step)


def _compiled(step: CompiledStep):
    """``step`` as a captured graph with no process group; under one its
    eager form (the sharded convolutions and the reductions run
    collectives, which a CUDA graph of gloo's cannot hold)."""
    return step.eager if is_initialized() else step


def _global(model: UmeTrackNet, per_seq_err: torch.Tensor, n_valid: torch.Tensor,
            totals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Under a process group the data ranks' per-sequence blocks gathered
    in data order and the masked sum and count reduced; then the mean."""
    if is_initialized():
        group = data_group_of(model)
        per_seq_err, n_valid = gather_blocks(per_seq_err, 0, group), gather_blocks(n_valid, 0, group)
        dist.all_reduce(totals, group=group)
    return per_seq_err, n_valid, totals[0] / torch.clamp(totals[1], min=1.0)


@torch.inference_mode()
def eval_sequences_batched(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...]
    init_state: TrackState,  # leaves [2S, ...]
    hand_models_mm: HandModel,  # [S, ...]
    min_num_crops: int = 1,
    skel_hand_models_mm: Optional[HandModel] = None,
    lm_hand_models_mm: Optional[HandModel] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track S sequences and compute each one's mean landmark error (mm)
    over its valid (frame, hand) slots.

    ``skel_hand_models_mm`` overrides the model's skeleton input and
    ``lm_hand_models_mm`` the skeleton that skins the tracked landmarks (the
    unknown protocol passes the calibrated generic skeleton for both); crops
    and GT landmarks always come from ``hand_models_mm``.

    Returns (per-sequence error [S], valid slots per sequence [S], global
    mean): the mean over the sequences with at least one valid slot.  Under
    a process group the inputs are this rank's shard
    (:func:`shard_eval_inputs`) and the results are global: the data ranks'
    per-sequence blocks gathered in data order, the mean reduced from every
    data rank's masked sum and count."""
    return _global(model, *_entry(_compiled(_EVAL_BATCHED), model, device, dict(
        rigs=rigs, seqs=seqs, init_state=init_state, hand_models_mm=hand_models_mm,
        skel_hand_models_mm=skel_hand_models_mm, lm_hand_models_mm=lm_hand_models_mm,
    ), name="eval_sequences_batched", config=config, min_num_crops=min_num_crops))


@torch.inference_mode()
def eval_sequences_unknown_batched(
    model: UmeTrackNet,
    config: TrackerConfig,
    rigs: CameraRig,  # fields [S, N]
    seqs: FrameObservation,  # leaves [S, T, ...]
    hand_models_mm: HandModel,  # [S, ...] GT skeletons (crops + GT landmarks)
    generic_hand_model_mm: HandModel,  # unbatched generic skeleton
    n_calibration_samples: int = 30,
    min_num_crops: int = 1,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-pass unknown-skeleton protocol for S sequences: the batched
    scale calibration on 2-view frames (``calibrate_sequences_batched``
    with its own ``min_num_crops=2``), then the batched known-skeleton
    retrack with each sequence's calibrated generic skeleton.  With
    :func:`eval_sequences_batched` this covers all four protocol cells
    ({known, unknown} x dataset split).

    Returns (per-sequence error, valid slots, global mean, scales), each
    global under a process group as in :func:`eval_sequences_batched`."""
    per_seq, n_valid, totals, scales = _entry(_compiled(_EVAL_UNKNOWN), model, device, dict(
        rigs=rigs, seqs=seqs, hand_models_mm=hand_models_mm, generic_hand_model_mm=generic_hand_model_mm,
    ), name="eval_sequences_unknown_batched", config=config,
        n_calibration_samples=n_calibration_samples, min_num_crops=min_num_crops)
    if is_initialized():
        scales = gather_blocks(scales, 0, data_group_of(model))
    return (*_global(model, per_seq, n_valid, totals), scales)


def shard_eval_inputs(mesh: Union[Mesh, int], *args):
    """``shard_eval_inputs(mesh, rigs, seqs, init_state, hand_models)``, as
    the JAX package's, or ``shard_eval_inputs(rank, world, rigs, ...)`` for
    a data-only mesh: this data index's contiguous block of the S-leading
    inputs and the matching ``[2S]`` state rows (rows ``2i, 2i+1`` live with
    sequence ``i``), the split a ``NamedSharding`` over ``data`` makes; the
    ranks of one model group take the same block.  Raises unless the data
    axis divides S."""
    if not isinstance(mesh, Mesh):
        mesh, args = Mesh(data=args[0], rank=mesh), args[1:]
    rigs, seqs, init_state, hand_models = args
    s = rigs.fx.shape[0]
    if s % mesh.data:
        raise ValueError(f"{s} sequences do not split over {mesh.data} ranks")

    def leading(tree):
        return tree.map(lambda a: a[block(a.shape[0], mesh)])

    return leading(rigs), leading(seqs), leading(init_state), leading(hand_models)
