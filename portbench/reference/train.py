"""The training step's plain reference: the resident corpus, the window
gather with its augmentation, the TBPTT loss and the clipped AdamW update.

A frozen copy of the port's ``parallel/resident.py`` (``ResidentCorpus``,
``corpus_from_arrays``, ``gather_window``), ``parallel/train.py`` (the loss
terms and ``temporal_loss_fn``) and ``parallel/optim.py`` (the schedule
and ``ClippedAdamW``), for one process: every count is this process's own,
and the step runs eagerly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ._tree import TensorTree
from .geometry import affine
from .kinematics.hand import HandModel, scaled_hand_model
from .kinematics.skinning import skin_landmarks
from .models.umetrack import FrameInputs, SkeletonInputs, TemporalState, UmeTrackNet

MM_TO_M = 0.001
Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]


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


def _scale_loss(out_u, gt_scales: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Log-scale MSE over the valid rows."""
    w_row = torch.ones_like(gt_scales) if valid is None else valid.to(gt_scales.dtype)
    sq = (torch.log(out_u.skel_scales) - torch.log(gt_scales)) ** 2
    return torch.sum(w_row * sq) / torch.clamp(w_row.sum(), min=1.0)


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
    n3 = torch.clamp(valid3.sum(), min=1.0)

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
    denom = torch.clamp(sums[3], min=1.0)
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
            out_u, batch.gt_scales, None if batch.valid is None else batch.valid[:, 0]
        )
        total = total + weights.scale * scale_loss
    metrics = {
        "loss": total, "angle_loss": angle_loss, "point_loss": point_loss,
        "landmark_nll": nll, "scale_loss": scale_loss, "accel_loss": accel_loss,
    }
    return total, {name: v.detach() for name, v in metrics.items()}


@dataclasses.dataclass(frozen=True)
class WarmupCosineDecay:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine from
    ``peak_value`` to ``end_value`` over the remaining ``decay_steps -
    warmup_steps``, constant after.  Called with a Python int it returns a
    float (for logs and tests); with a tensor count it returns a float64
    tensor computed on the count's device, which a CUDA graph can replay."""

    init_value: float
    peak_value: float
    warmup_steps: int
    decay_steps: int
    end_value: float = 0.0

    def __post_init__(self):
        if not self.decay_steps - self.warmup_steps > 0:
            raise ValueError(
                f"the cosine decay needs positive decay_steps - warmup_steps, got "
                f"{self.decay_steps} - {self.warmup_steps}"
            )

    @property
    def alpha(self) -> float:
        return 0.0 if self.peak_value == 0.0 else self.end_value / self.peak_value

    def __call__(self, count):
        if isinstance(count, torch.Tensor):
            return self._on_device(count)
        warmup, span = self.warmup_steps, self.decay_steps - self.warmup_steps
        if count < warmup:
            frac = 1.0 - min(max(count, 0), warmup) / warmup
            return (self.init_value - self.peak_value) * frac + self.peak_value
        t = min(count - warmup, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return self.peak_value * ((1.0 - self.alpha) * cosine + self.alpha)

    def _on_device(self, count: torch.Tensor) -> torch.Tensor:
        """The same arithmetic in float64 tensor ops, both branches
        computed and one selected (no host read of the count)."""
        c = count.to(torch.float64)
        warmup, span = self.warmup_steps, self.decay_steps - self.warmup_steps
        frac = 1.0 - torch.clamp(c, 0, warmup) / max(warmup, 1)
        warm = (self.init_value - self.peak_value) * frac + self.peak_value
        t = torch.clamp(c - warmup, max=span)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / span))
        decayed = self.peak_value * ((1.0 - self.alpha) * cosine + self.alpha)
        return torch.where(c < warmup, warm, decayed)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / ||g||`` where the global L2
    norm ``||g||`` is at least ``max_norm`` (optax's clip); returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ClippedAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(learning_rate,
    weight_decay))`` in optax's order of operations (eps 1e-8): the clip
    scales only when the norm reaches the maximum, weight decay applies to
    every parameter scaled by the scheduled learning rate, and the schedule
    is evaluated at the count of updates made so far (the first update of a
    warmup has learning rate 0).  The count, the learning rate and the bias
    corrections are device tensors, as in the program."""

    def __init__(
        self, params: Iterable[torch.nn.Parameter],
        learning_rate: Schedule, weight_decay: float,
        max_grad_norm: Optional[float] = 1.0,
    ):
        self.schedule = learning_rate
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.step_count: Optional[torch.Tensor] = None
        self.global_norm: Optional[torch.Tensor] = None
        super().__init__(params, dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay))

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def prepare(self) -> None:
        """Make what an update writes, where it is missing: a zero gradient
        for each parameter, Adam's moments, the update count and the norm.
        Each later update writes into these tensors in place."""
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if not self.state[p]:
                self.state[p] = dict(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
        if self.step_count is None:
            device = params[0].device
            self.step_count = torch.full((), float(self.count), dtype=torch.float64, device=device)
            self.global_norm = torch.zeros((), device=device)

    @torch.no_grad()
    def update(self) -> None:
        """One update on the device, host state untouched: the clip, then
        AdamW in optax's order of operations, at the learning rate of the
        count of updates made so far."""
        grads = [p.grad for p in self._params()]
        if self.max_grad_norm is not None:
            self.global_norm.copy_(clip_by_global_norm_(grads, self.max_grad_norm))

        neg_lr = -self.schedule(self.step_count).to(torch.float32)
        self.step_count.add_(1.0)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = group["params"]
            gs = [p.grad for p in ps]
            mu = [self.state[p]["exp_avg"] for p in ps]
            nu = [self.state[p]["exp_avg_sq"] for p in ps]
            # optax: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
            # bias corrections in float64, rounded once (optax casts them to the moments' dtype)
            bc1 = (1.0 - torch.pow(b1, self.step_count)).to(torch.float32)
            bc2 = (1.0 - torch.pow(b2, self.step_count)).to(torch.float32)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(upd, neg_lr)
            torch._foreach_add_(ps, upd)


@dataclasses.dataclass
class ResidentCorpus(TensorTree):
    """All training material on the device, sequence-major.  Crops are
    bfloat16 (exact to ~3e-3 of the 0..1 pixel range, far below render
    noise), the geometry f32 in the model's conventions: extrinsics are
    eye-from-world in meters, invalid views inherit view 0's."""

    images: torch.Tensor  # [N, T, 2, V, h, w] bf16 in [0, 1]
    intrinsics: torch.Tensor  # [N, T, 2, V, 3, 3]
    extrinsics_m: torch.Tensor  # [N, T, 2, V, 4, 4]
    n_views: torch.Tensor  # [N, T, 2] int32 (>= 1, floored)
    valid: torch.Tensor  # [N, T, 2] bool supervision mask
    angles: torch.Tensor  # [N, T, 2, 22]
    wrists_m: torch.Tensor  # [N, T, 2, 4, 4] (meters)
    hand: HandModel  # [N, ...] left convention, meters
    scales: torch.Tensor  # [N] GT hand scales

    @property
    def n_sequences(self) -> int:
        return self.images.shape[0]

    @property
    def n_frames(self) -> int:
        return self.images.shape[1]


def _np_rigid_inverse(m: np.ndarray) -> np.ndarray:
    r = np.swapaxes(m[..., :3, :3], -1, -2)
    t = -np.einsum("...ij,...j->...i", r, m[..., :3, 3])
    out = np.tile(np.eye(4, dtype=m.dtype), (*m.shape[:-2], 1, 1))
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    return out


def corpus_from_arrays(
    images, intrinsics, T_world_from_eye, view_valid, hand_valid, n_views,
    angles, wrists_mm, hand_model_mm_batched: HandModel, scales, device=None,
) -> ResidentCorpus:
    """The corpus from stacked numpy arrays (sequence-major), on ``device``."""
    wrists = np.asarray(wrists_mm, np.float32).copy()
    extr = _np_rigid_inverse(T_world_from_eye)
    extr[..., :3, 3] *= MM_TO_M
    vvm = view_valid[..., None, None]
    extr = np.where(vvm, extr, extr[..., 0:1, :, :])
    intr = np.where(vvm, intrinsics, intrinsics[..., 0:1, :, :])
    wrists[..., :3, 3] *= MM_TO_M

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    hand = hand_model_mm_batched.to(device)
    return ResidentCorpus(
        images=dev(images, torch.float32).to(torch.bfloat16),
        intrinsics=dev(intr, torch.float32),
        extrinsics_m=dev(extr, torch.float32),
        n_views=dev(np.maximum(n_views, 1), torch.int32),
        valid=dev(hand_valid & (n_views > 0), torch.bool),
        angles=dev(angles, torch.float32),
        wrists_m=dev(wrists, torch.float32),
        hand=scaled_hand_model(hand, MM_TO_M),
        scales=dev(scales, torch.float32),
    )


def _rows2(a: torch.Tensor) -> torch.Tensor:
    """Each leading row twice in a row (``repeat_interleave(2, 0)``, as a
    copy: no device-side sizes)."""
    return a[:, None].expand(a.shape[0], 2, *a.shape[1:]).reshape(2 * a.shape[0], *a.shape[1:])


def gather_window(
    corpus: ResidentCorpus,
    seq_idx: torch.Tensor,  # [Bs] int64 on the corpus's device
    t0: Union[int, torch.Tensor],  # the window's start: an int or a 0-d int tensor
    window: int,
    generator: Optional[torch.Generator] = None,
) -> TemporalTrainBatch:
    """A TBPTT batch gathered on the device: rows are (sequence, hand)
    pairs in the merged layout (row 2*s + hand, ``hand_idx`` = [0, 1, 0, 1,
    ...]), frames ``t0 .. t0 + window - 1``, with ``t0`` clamped to
    ``[0, T - window]`` as JAX's ``dynamic_slice`` clamps it.  A tensor
    ``t0`` is read on the device only, so one captured step serves every
    window start.

    With a ``generator``, the batch is augmented: each sequence's window is
    reversed in time with probability 0.5, and each row's images get a gain
    U[0.85, 1.15], an offset U[-0.05, 0.05] and pixel noise of sigma
    U[0, 0.03], clipped to [0, 1] (the model must read the pose from the
    hand, not memorise a sequence's exposure or motion direction)."""
    k = window
    bs = seq_idx.shape[0]
    device = corpus.images.device
    n_frames = corpus.n_frames
    reverse = None
    if generator is not None:
        reverse = torch.rand((bs,), generator=generator, device=device) < 0.5
    start = torch.clamp(torch.as_tensor(t0, device=device), 0, n_frames - k)
    # flat (sequence, frame) rows of the window: [Bs * k]
    flat_idx = (seq_idx[:, None] * n_frames + start + torch.arange(k, device=device)).reshape(-1)

    def take(a):  # [N, T, ...] -> [Bs, k, ...]
        win = a.flatten(0, 1).index_select(0, flat_idx).reshape(bs, k, *a.shape[2:])
        if reverse is not None:
            win = torch.where(reverse.reshape(-1, *[1] * (win.dim() - 1)), win.flip(1), win)
        return win

    def rows(a):  # [Bs, k, 2, ...] -> [2*Bs, k, ...]
        a = a.movedim(2, 1)
        return a.reshape(a.shape[0] * 2, k, *a.shape[3:])

    imgs = rows(take(corpus.images)).to(torch.float32)
    if generator is not None:
        def uniform(lo, hi):
            u = torch.rand((2 * bs, 1, 1, 1, 1), generator=generator, device=device)
            return lo + (hi - lo) * u

        gain, off, sigma = uniform(0.85, 1.15), uniform(-0.05, 0.05), uniform(0.0, 0.03)
        noise = torch.randn(imgs.shape, generator=generator, device=device) * sigma
        imgs = torch.clamp(imgs * gain + off + noise, 0.0, 1.0)

    valid = rows(take(corpus.valid))  # [2Bs, k]
    # memory only across consecutive valid frames, as in evaluation
    prev_valid = torch.cat([torch.ones_like(valid[:, :1]), valid[:, :-1]], dim=1)
    use_memory = (torch.arange(k, device=device) > 0) & valid & prev_valid
    frames = FrameInputs(
        images=imgs,
        intrinsics=rows(take(corpus.intrinsics)),
        extrinsics=rows(take(corpus.extrinsics_m)),
        n_views=rows(take(corpus.n_views)),
        hand_idx=torch.arange(2, dtype=torch.int32, device=device).repeat(bs)[:, None].expand(2 * bs, k),
        use_memory=use_memory,
    )
    hand_rows = corpus.hand.map(lambda a: _rows2(a.index_select(0, seq_idx)))
    return TemporalTrainBatch(
        frames=frames,
        skeleton=SkeletonInputs(
            joint_rotation_axes=hand_rows.joint_rotation_axes,
            joint_rest_positions=hand_rows.joint_rest_positions,
        ),
        gt_joint_angles=rows(take(corpus.angles)),
        gt_wrist_world=rows(take(corpus.wrists_m)),
        hand=hand_rows,
        gt_scales=_rows2(corpus.scales.index_select(0, seq_idx)),
        valid=valid,
    )




def train_step(model: UmeTrackNet, optimizer: "ClippedAdamW", corpus: ResidentCorpus,
               seq_idx: torch.Tensor, t0: torch.Tensor, weights: LossWeights, window: int,
               generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """One TBPTT step on a window of the corpus, as the program's resident
    step: train mode, gather, loss, backward, update; the metrics."""
    model.train()
    optimizer.prepare()
    batch = gather_window(corpus, seq_idx, t0, window, generator)
    total, metrics = temporal_loss_fn(model, batch, weights)
    optimizer.zero_grad(set_to_none=False)
    total.backward()
    optimizer.update()
    optimizer.count += 1
    return metrics
