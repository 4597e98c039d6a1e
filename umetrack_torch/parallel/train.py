"""The supervised training step: single-frame and TBPTT.

Counterpart of ``umetrack_tpu/parallel/train.py`` on one device.  The loss
avoids differentiating through the wrist decode:

- joint-angle MSE over the 20 actuated DoF;
- wrist supervision on the raw predicted rigid points in crop-cam0 space
  against the GT-transformed canonical points, split into the centroid
  (translation) and the centred (rotation-carrying) error;
- landmark Gaussian NLL: landmarks skinned from the predicted angles and the
  GT wrist, scored against the GT landmarks under the predicted sigmas;
- the masked log-scale MSE of the scale head;
- for a TBPTT window, the squared error of the landmarks' and wrist points'
  second difference over time (``accel``).

The model runs in train mode: BatchNorm normalises with the batch's own
statistics and updates its running stats in place, flax's way
(``models/backbone.py::BatchNorm``).  Two consequences shape this module:

- the TBPTT window runs the WHOLE model once per frame, so each frame's
  batch gives its own statistics and its own running-stat update, as the
  JAX scan does (hoisting the feature extractor over the K frames, as the
  tracker does in eval mode, would make one update over K frames);
- :func:`loss_fn` keeps the running stats of the known-skeleton pass only:
  the scale head's pass restores them (the JAX loss drops that pass's
  ``batch_stats``), while :func:`temporal_loss_fn` keeps both, as its JAX
  counterpart does.

No activation checkpointing: ``torch.utils.checkpoint`` runs the forward
again in backward and would update the running stats a second time.

On the card with no process group, :func:`train_step` and
:func:`temporal_train_step` are captured CUDA graphs, the counterpart of
their ``jax.jit`` (:func:`run_step`, ``tracker/compiled.py``): the first
call of a key runs eagerly and captures, later calls replay the forward,
the backward and the optimizer's update.  Under a process group they run
eagerly (gloo's collectives cannot be captured).

Under a ``torch.distributed`` process group each rank holds a block of the
global batch, and the step computes the JAX step over its mesh: every
normalising count (valid rows, valid windows, scale rows) is summed over
the ranks before the division, so each rank's loss is its share of the
global loss; BatchNorm normalises with the global batch's statistics
(``models/backbone.py``); ``ClippedAdamW`` sums the gradients over the
ranks before clipping; and the returned metrics are summed over the ranks,
i.e. the global batch's.  Per-rank means averaged over ranks would differ
whenever the ranks hold different numbers of valid rows.  On a mesh with a
``model`` axis (``parallel/mesh.py::shard_variables``) the ranks of a model
group hold the same rows, so every such sum runs over the data group
(``model.mesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from .._tree import TensorTree
from ..geometry import affine
from ..kinematics.hand import HandModel, scaled_hand_model
from ..kinematics.skinning import skin_landmarks
from ..models.backbone import BatchNorm
from ..models.umetrack import FrameInputs, SkeletonInputs, TemporalState, UmeTrackNet, make_model
from ..tracker.compiled import CompiledStep
from ..utils.profiling import entry
from .distributed import is_initialized
from .mesh import data_group_of
from .optim import ClippedAdamW


@dataclasses.dataclass
class TrainBatch(TensorTree):
    """One batch of supervised hand samples (meters)."""

    frame: FrameInputs
    skeleton: SkeletonInputs  # [B, 22, 3] each
    gt_joint_angles: torch.Tensor  # [B, 22]
    gt_wrist_world: torch.Tensor  # [B, 4, 4] left convention, meters
    hand: HandModel  # batched [B, ...] (left, meters)
    gt_scales: Optional[torch.Tensor] = None  # [B]
    # Per-row supervision mask: rows whose crops were invalid are not
    # trained against real GT on a meaningless fallback crop.  None = all.
    valid: Optional[torch.Tensor] = None  # [B] bool


@dataclasses.dataclass
class TemporalTrainBatch(TensorTree):
    """A batch of K-frame supervised windows (meters), time axis second:
    ``frames.use_memory`` is False at k=0 and True after, and the extrinsics
    move frame to frame so the memory's motion compensation is in the
    gradient path."""

    frames: FrameInputs  # leaves [B, K, ...]
    skeleton: SkeletonInputs  # [B, 22, 3] each
    gt_joint_angles: torch.Tensor  # [B, K, 22]
    gt_wrist_world: torch.Tensor  # [B, K, 4, 4] left convention, meters
    hand: HandModel  # batched [B, ...] (left, meters)
    gt_scales: Optional[torch.Tensor] = None  # [B]
    valid: Optional[torch.Tensor] = None  # [B, K] bool


@dataclasses.dataclass(frozen=True)
class LossWeights:
    angles: float = 1.0
    wrist_points: float = 1.0
    landmark_nll: float = 0.1
    scale: float = 0.1
    # Extra gain on the centred component of the wrist-point error (1.0 =
    # the plain MSE, which splits exactly into centroid + centred error).
    wrist_rot_gain: float = 1.0
    # Temporal-smoothness weight (temporal_loss_fn only), in meters^2 of
    # acceleration: amplitudes are ~1e-3 m, so useful weights are O(1e3).
    accel: float = 0.0


@dataclasses.dataclass
class TrainState:
    """The model being trained (its parameters and BatchNorm running stats),
    its optimizer, and the number of steps taken."""

    model: UmeTrackNet
    optimizer: ClippedAdamW
    step: int = 0


def create_train_state(model: UmeTrackNet, optimizer: ClippedAdamW) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)


def init_train_model(config=None, seed: int = 0, device=None) -> UmeTrackNet:
    """A model to train from scratch on ``device`` (CUDA unless "cpu"):
    seeded random weights from flax's default distribution, as every JAX
    training entry starts (``models/umetrack.py::init_weights``), with
    fresh BatchNorm running stats (mean 0, var 1)."""
    model = make_model(config, seed=seed, device=resolve_device(device))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.reset_running_stats()
    return model


@contextlib.contextmanager
def running_stats_kept(model: UmeTrackNet):
    """Leave every BatchNorm running stat as it was on entry: a train-mode
    pass inside normalises with batch statistics but keeps no update."""
    stats = [b for m in model.modules() if isinstance(m, BatchNorm)
             for b in (m.running_mean, m.running_var)]
    saved = [b.clone() for b in stats]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(stats, saved):
                b.copy_(s)


def _global_count(count: torch.Tensor, group=None) -> torch.Tensor:
    """A normalising count summed over the data ranks, at least 1."""
    if is_initialized():
        count = count.detach().clone()
        dist.all_reduce(count, group=group)
    return torch.clamp(count, min=1.0)


def _global_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """Detached metrics; under a process group each is the sum of the data
    ranks' shares, i.e. the global batch's value."""
    values = torch.stack([v.detach() for v in metrics.values()])
    if is_initialized():
        dist.all_reduce(values, group=group)
    return dict(zip(metrics, values))


def _rigid_points(model: UmeTrackNet, like: torch.Tensor) -> torch.Tensor:
    """The canonical wrist rigid points, from the wrist decoder's buffer
    (on the device already: no copy from host memory inside a step)."""
    return model.regressor_k.rigid_points.to(like.dtype)


def _x_mirrored(wrist: torch.Tensor, hand_idx: torch.Tensor) -> torch.Tensor:
    """The wrist transforms [..., 4, 4] with their x basis column negated
    where ``hand_idx`` [...] is 1 (right hands)."""
    sign = torch.where(hand_idx == 1, -1.0, 1.0).to(wrist.dtype)
    ones = torch.ones_like(sign)
    return wrist * torch.stack([sign, ones, ones, ones], dim=-1)[..., None, :]


def _frame_losses(
    model: UmeTrackNet,
    out,
    frame: FrameInputs,
    gt_joint_angles: torch.Tensor,
    gt_wrist_world: torch.Tensor,
    hand: HandModel,
    valid: Optional[torch.Tensor] = None,  # [B] bool row mask
    rot_gain: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-frame supervised terms shared by the single-frame and TBPTT
    losses: (angle MSE, wrist rigid-point MSE in cam0, landmark NLL,
    valid-row count), each a sum over valid rows of a per-row mean; callers
    divide by the count, so masked rows contribute exactly nothing."""
    b = gt_joint_angles.shape[0]
    w_row = (
        torch.ones((b,), dtype=torch.float32, device=gt_joint_angles.device)
        if valid is None else valid.to(torch.float32)
    )
    count = w_row.sum()

    # 1) finger-angle MSE (the wrist slots are zero on both sides)
    angle_loss = torch.sum(
        w_row * ((out.joint_angles[:, :20] - gt_joint_angles[:, :20]) ** 2).mean(dim=-1)
    )

    # 2) wrist rigid points in cam0.  Right-hand crop cameras are x-mirrored
    # (det(e0) = -1), so the target uses the GT wrist with its x column
    # mirrored: e0 @ mirror_x(gt) is then a proper rigid transform, and the
    # model's decode chain applied to these targets reproduces
    # gt_wrist_world exactly.
    gt_wrist_cam0 = frame.extrinsics[:, 0] @ _x_mirrored(gt_wrist_world, frame.hand_idx)
    gt_points = affine.transform3(gt_wrist_cam0[:, None], _rigid_points(model, gt_wrist_cam0))
    pred_c = out.wrist_points.mean(dim=-2, keepdim=True)
    gt_c = gt_points.mean(dim=-2, keepdim=True)
    trans_mse = ((pred_c - gt_c) ** 2).mean(dim=(-2, -1))
    rot_mse = (((out.wrist_points - pred_c) - (gt_points - gt_c)) ** 2).mean(dim=(-2, -1))
    point_loss = torch.sum(w_row * (trans_mse + rot_gain * rot_mse))

    # 3) landmark NLL with predicted angles + GT wrist (no SVD in the path);
    # the 1e-12 keeps the norm's gradient finite at zero error
    pred_lm = skin_landmarks(hand, out.joint_angles, gt_wrist_world)
    gt_lm = skin_landmarks(hand, gt_joint_angles, gt_wrist_world)
    err = torch.linalg.vector_norm(pred_lm - gt_lm + 1e-12, dim=-1)  # [B, 21]
    # A 1 mm training-side sigma floor: once sigmas shrink to ~0.5 mm a
    # domain shift makes (err / sigma)^2 explode; the decode is untouched.
    sig = torch.clamp(out.landmark_uncertainty_sigmas, min=1e-3)
    nll = torch.sum(w_row * (torch.log(sig) + 0.5 * (err / sig) ** 2).mean(dim=-1))
    return angle_loss, point_loss, nll, count


def _scale_loss(out_u, gt_scales: torch.Tensor, valid: Optional[torch.Tensor], group) -> torch.Tensor:
    """Log-scale MSE over the valid rows."""
    w_row = torch.ones_like(gt_scales) if valid is None else valid.to(gt_scales.dtype)
    sq = (torch.log(out_u.skel_scales) - torch.log(gt_scales)) ** 2
    return torch.sum(w_row * sq) / _global_count(w_row.sum(), group)


def loss_fn(
    model: UmeTrackNet, batch: TrainBatch, weights: LossWeights = LossWeights()
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-frame loss in train mode -> (total, metrics).  The running
    stats keep the known-skeleton pass's update only."""
    model.train()
    b = batch.gt_joint_angles.shape[0]
    state = TemporalState.zeros(b, model.config, device=batch.gt_joint_angles.device)
    out, _ = model.known_skeleton(batch.frame, batch.skeleton, state)
    angle_loss, point_loss, nll, count = _frame_losses(
        model, out, batch.frame, batch.gt_joint_angles, batch.gt_wrist_world, batch.hand,
        batch.valid, rot_gain=weights.wrist_rot_gain,
    )
    group = data_group_of(model)
    denom = _global_count(count, group)
    angle_loss, point_loss, nll = angle_loss / denom, point_loss / denom, nll / denom
    total = (weights.angles * angle_loss + weights.wrist_points * point_loss
             + weights.landmark_nll * nll)

    scale_loss = torch.zeros((), device=total.device)
    if batch.gt_scales is not None:
        with running_stats_kept(model):
            out_u, _ = model.predict_scale(batch.frame, state)
        scale_loss = _scale_loss(out_u, batch.gt_scales, batch.valid, group)
        total = total + weights.scale * scale_loss

    metrics = {
        "loss": total, "angle_loss": angle_loss, "point_loss": point_loss,
        "landmark_nll": nll, "scale_loss": scale_loss,
    }
    return total, _global_metrics(metrics, group)


def _second_diff(x: torch.Tensor) -> torch.Tensor:  # [K, ...] -> [K-2, ...]
    return x[2:] + x[:-2] - 2.0 * x[1:-1]


def _accel_loss(
    model: UmeTrackNet,
    batch: TemporalTrainBatch,
    angles_t: torch.Tensor,  # [K, B, 22] predicted
    points_t: torch.Tensor,  # [K, B, P, 3] predicted raw wrist points, cam0
    valid_t: torch.Tensor,  # [K, B] bool
) -> torch.Tensor:
    """Squared error between the second differences (acceleration) of the
    predicted and the GT world landmarks and wrist rigid points over the
    window, masked to triples of consecutive valid frames.  Landmarks use
    the GT wrist; wrist points go to world through the inverse of cam0,
    whose 3x3 block is orthogonal (x-mirrored for right hands)."""
    gt_angles_t = batch.gt_joint_angles.transpose(0, 1)
    gt_wrist_t = batch.gt_wrist_world.transpose(0, 1)  # [K, B, 4, 4]
    pred_lm = skin_landmarks(batch.hand, angles_t, gt_wrist_t)
    gt_lm = skin_landmarks(batch.hand, gt_angles_t, gt_wrist_t)

    e0_t = batch.frames.extrinsics[:, :, 0].transpose(0, 1)  # [K, B, 4, 4]
    r0t = e0_t[..., :3, :3].transpose(-1, -2)
    t0 = e0_t[..., :3, 3]

    def to_world(pts):  # [K, B, P, 3] cam0 -> world
        return torch.einsum("kbij,kbpj->kbpi", r0t, pts - t0[:, :, None, :])

    hand_idx_t = batch.frames.hand_idx.transpose(0, 1)
    gt_pts = affine.transform3(
        (e0_t @ _x_mirrored(gt_wrist_t, hand_idx_t))[:, :, None], _rigid_points(model, e0_t)
    )
    valid3 = (valid_t[2:] & valid_t[:-2] & valid_t[1:-1]).to(torch.float32)  # [K-2, B]
    n3 = _global_count(valid3.sum(), data_group_of(model))

    def term(pred, gt):
        d = _second_diff(pred) - _second_diff(gt)
        return torch.sum(valid3 * (d * d).sum(dim=-1).mean(dim=-1)) / n3

    return term(pred_lm, gt_lm) + term(to_world(points_t), to_world(gt_pts))


def temporal_loss_fn(
    model: UmeTrackNet, batch: TemporalTrainBatch, weights: LossWeights = LossWeights()
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """TBPTT loss in train mode -> (total, metrics): the model runs frame
    by frame over the K-frame window threading the ``TemporalState``, so
    gradients reach the memory pathway through real recurrence (with the
    motion compensation active wherever ``frames.use_memory`` is set)."""
    model.train()
    b, k = batch.gt_joint_angles.shape[:2]
    device = batch.gt_joint_angles.device
    state0 = TemporalState.zeros(b, model.config, device=device)
    valid_t = (
        torch.ones((k, b), dtype=torch.bool, device=device)
        if batch.valid is None else batch.valid.transpose(0, 1)
    )

    state = state0
    per_step: List[torch.Tensor] = []
    angles, points = [], []
    for t in range(k):
        frame = batch.frames.map(lambda a: a[:, t])
        out, state = model.known_skeleton(frame, batch.skeleton, state)
        per_step.append(torch.stack(_frame_losses(
            model, out, frame, batch.gt_joint_angles[:, t], batch.gt_wrist_world[:, t],
            batch.hand, valid_t[t], rot_gain=weights.wrist_rot_gain,
        )))
        angles.append(out.joint_angles)
        points.append(out.wrist_points)
    # rows are (sum, sum, sum, count): normalise over ALL valid (row, frame)
    # supervision slots of the window
    sums = torch.stack(per_step).sum(dim=0)
    group = data_group_of(model)
    denom = _global_count(sums[3], group)
    angle_loss, point_loss, nll = sums[0] / denom, sums[1] / denom, sums[2] / denom

    accel_loss = torch.zeros((), device=device)
    if k >= 3:
        accel_loss = _accel_loss(model, batch, torch.stack(angles), torch.stack(points), valid_t)

    total = (weights.angles * angle_loss + weights.wrist_points * point_loss
             + weights.landmark_nll * nll + weights.accel * accel_loss)

    # the scale head on the first frame (zero state, no memory); its
    # running-stat update is kept
    scale_loss = torch.zeros((), device=device)
    if batch.gt_scales is not None:
        out_u, _ = model.predict_scale(batch.frames.map(lambda a: a[:, 0]), state0)
        scale_loss = _scale_loss(
            out_u, batch.gt_scales, None if batch.valid is None else batch.valid[:, 0], group
        )
        total = total + weights.scale * scale_loss
    metrics = {
        "loss": total, "angle_loss": angle_loss, "point_loss": point_loss,
        "landmark_nll": nll, "scale_loss": scale_loss, "accel_loss": accel_loss,
    }
    return total, _global_metrics(metrics, group)


def _update(total: torch.Tensor, optimizer: ClippedAdamW) -> None:
    """Backward into the gradients ``optimizer.prepare`` made, zeroed in
    place, then the optimizer's device update."""
    optimizer.zero_grad(set_to_none=False)
    total.backward()
    optimizer.update()


def _train_update(model: UmeTrackNet, batch: TrainBatch, optimizer: ClippedAdamW,
                  weights: LossWeights) -> Dict[str, torch.Tensor]:
    """:func:`train_step`'s device work: loss, backward, update."""
    total, metrics = loss_fn(model, batch, weights)
    _update(total, optimizer)
    return metrics


def _temporal_update(model: UmeTrackNet, batch: TemporalTrainBatch, optimizer: ClippedAdamW,
                     weights: LossWeights) -> Dict[str, torch.Tensor]:
    """:func:`temporal_train_step`'s device work."""
    total, metrics = temporal_loss_fn(model, batch, weights)
    _update(total, optimizer)
    return metrics


_TRAIN = CompiledStep(_train_update, training=True)
_TEMPORAL = CompiledStep(_temporal_update, training=True)


def run_step(step: CompiledStep, state: TrainState, inputs: dict, resident: Optional[dict] = None,
             eager: bool = False, **static) -> Dict[str, torch.Tensor]:
    """One optimizer step through ``step``: on a CUDA device with no
    process group a captured graph (the first call of a key runs eagerly
    and captures), else eagerly (gloo's collectives cannot be captured;
    ``eager`` asks for it).  The model goes to train mode and the
    optimizer's state is made BEFORE the key is read; the host's counts
    move after the call, which a replay does not run.  Under a profile the
    step is the root span ``entry.<step's function>`` unless the caller's
    entry point opened one."""
    with entry(step.name):
        model, optimizer = state.model, state.optimizer
        model.train()
        optimizer.prepare()
        device = next(model.parameters()).device
        run = step.eager if eager or is_initialized() else step
        metrics = run(model, device, inputs, resident, optimizer=optimizer, **static)
        optimizer.count += 1
        state.step += 1
        return metrics


def train_step(
    state: TrainState, batch: TrainBatch, weights: LossWeights = LossWeights()
) -> Dict[str, torch.Tensor]:
    """One optimizer step on a single-frame batch; ``state`` is updated in
    place (a graph replay on the card, see :func:`run_step`).  Returns the
    metrics (device tensors: reading one waits for the step)."""
    return run_step(_TRAIN, state, dict(batch=batch), weights=weights)


def temporal_train_step(
    state: TrainState, batch: TemporalTrainBatch, weights: LossWeights = LossWeights()
) -> Dict[str, torch.Tensor]:
    """One TBPTT optimizer step over a K-frame window (see
    :func:`train_step`)."""
    return run_step(_TEMPORAL, state, dict(batch=batch), weights=weights)


def synthetic_train_batch(rng_seed: int, batch: int, hand: HandModel, device=None) -> TrainBatch:
    """A random but consistent batch on ``device`` (CUDA unless "cpu"),
    drawn with numpy in the JAX package's order, so both packages make the
    same batch from one seed.  ``hand`` is an unbatched left-hand model in
    mm; it is scaled to meters and broadcast over the batch."""
    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    hand_m = scaled_hand_model(hand, 0.001).map(
        lambda a: a.to(device).expand(batch, *a.shape)
    )

    q, _ = np.linalg.qr(rng.standard_normal((batch, 3, 3)))
    q[..., :, 0] *= np.where(np.linalg.det(q) < 0, -1.0, 1.0)[:, None]
    wrist = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    wrist[:, :3, :3] = q
    wrist[:, :3, 3] = rng.standard_normal((batch, 3)) * 0.05

    intr = np.tile(np.eye(3, dtype=np.float32), (batch, 2, 1, 1))
    intr[..., 0, 0] = rng.uniform(150, 300, (batch, 2))
    intr[..., 1, 1] = intr[..., 0, 0]
    intr[..., 0, 2] = intr[..., 1, 2] = 47.5

    qe, _ = np.linalg.qr(rng.standard_normal((batch * 2, 3, 3)))
    qe[..., :, 0] *= np.where(np.linalg.det(qe) < 0, -1.0, 1.0)[:, None]
    extr = np.tile(np.eye(4, dtype=np.float32), (batch * 2, 1, 1))
    extr[:, :3, :3] = qe
    extr[:, :3, 3] = rng.standard_normal((batch * 2, 3)) * 0.3

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    frame = FrameInputs(
        images=t(rng.uniform(0, 1, (batch, 2, 96, 96))),
        intrinsics=t(intr),
        extrinsics=t(extr.reshape(batch, 2, 4, 4)),
        n_views=torch.full((batch,), 2, dtype=torch.int32, device=device),
        hand_idx=t(rng.integers(0, 2, batch), torch.int32),
        use_memory=torch.zeros((batch,), dtype=torch.bool, device=device),
    )
    return TrainBatch(
        frame=frame,
        skeleton=SkeletonInputs(
            joint_rotation_axes=hand_m.joint_rotation_axes,
            joint_rest_positions=hand_m.joint_rest_positions,
        ),
        gt_joint_angles=t(rng.uniform(-0.5, 0.5, (batch, 22))),
        gt_wrist_world=t(wrist),
        hand=hand_m,
        gt_scales=t(rng.uniform(0.8, 1.2, batch)),
    )
