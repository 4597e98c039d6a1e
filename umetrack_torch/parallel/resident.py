"""Device-resident training: the whole crop corpus lives in device memory
and each step gathers its batch there, so the host only draws indices.

Counterpart of ``umetrack_tpu/parallel/resident.py``.  The corpus is the
tracker's own crop distribution (crops made by the real tracker prep from GT
poses, ``apps/train.py::prepare_tracker_sequences``); the supervised terms
and the TBPTT window are ``parallel/train.py``'s.  The sequences and window
starts are drawn from a numpy generator seeded as in the JAX package, so
with ``augment=False`` a run takes the same batches in both packages; the
augmentation draws from a ``torch.Generator`` on the corpus's device.  On
the card the train step, the eval and the diagnosis are captured CUDA
graphs, the counterpart of their ``jax.jit``: the window start is a device
input, so one graph serves every start, and the corpus is read where it
lies.  Under a profile a train step is the root span
``entry.resident_train_step``, the move of its window start the span
``to_device`` (``utils/profiling.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from .._tree import TensorTree
from ..data import bundles
from ..kinematics.hand import HandModel, scaled_hand_model
from ..kinematics.skinning import skin_landmarks
from ..models.umetrack import FrameInputs, SkeletonInputs, TemporalState, UmeTrackNet
from ..tracker.compiled import CompiledStep
from ..utils.profiling import entry, span
from .optim import ClippedAdamW, warmup_cosine_decay_schedule
from .train import (
    LossWeights,
    TemporalTrainBatch,
    TrainState,
    _update,
    create_train_state,
    run_step,
    running_stats_kept,
    temporal_loss_fn,
)

MM_TO_M = 0.001


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


def build_resident_corpus(entries: List[dict], device=None) -> ResidentCorpus:
    """``prepare_tracker_sequences`` entries -> the corpus on ``device``
    (CUDA unless "cpu"); the mm -> m, inverse and view-fallback math is done
    here once instead of per step."""
    def stack(key):
        return np.stack([e[key] for e in entries])

    n_views = stack("n_views")
    return corpus_from_arrays(
        images=stack("images"),
        intrinsics=stack("intrinsics"),
        T_world_from_eye=stack("T_world_from_eye"),
        view_valid=stack("view_valid"),
        hand_valid=stack("hand_valid") if "hand_valid" in entries[0] else np.ones(n_views.shape, bool),
        n_views=n_views,
        angles=stack("angles"),
        wrists_mm=stack("wrists_mm"),
        hand_model_mm_batched=bundles.collate([e["hand_model_mm"] for e in entries]),
        scales=np.asarray([e["scale"] for e in entries], np.float32),
        device=device,
    )


def corpus_from_arrays(
    images, intrinsics, T_world_from_eye, view_valid, hand_valid, n_views,
    angles, wrists_mm, hand_model_mm_batched: HandModel, scales, device=None,
) -> ResidentCorpus:
    """The corpus from stacked numpy arrays (sequence-major), on ``device``
    (CUDA unless "cpu")."""
    device = resolve_device(device)
    wrists = np.asarray(wrists_mm, np.float32).copy()
    extr = _np_rigid_inverse(T_world_from_eye)
    extr[..., :3, 3] *= MM_TO_M
    vvm = view_valid[..., None, None]
    extr = np.where(vvm, extr, extr[..., 0:1, :, :])
    intr = np.where(vvm, intrinsics, intrinsics[..., 0:1, :, :])
    wrists[..., :3, 3] *= MM_TO_M

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    hand = bundles.to_device(hand_model_mm_batched, device)
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


def _resident_update(model: UmeTrackNet, seq_idx: torch.Tensor, t0: torch.Tensor,
                     corpus: ResidentCorpus, optimizer: ClippedAdamW, weights: LossWeights,
                     window: int, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """:func:`resident_train_step`'s device work: gather, loss, backward,
    update."""
    batch = gather_window(corpus, seq_idx, t0, window, generator)
    total, metrics = temporal_loss_fn(model, batch, weights)
    _update(total, optimizer)
    return metrics


_RESIDENT = CompiledStep(_resident_update, training=True)


def resident_train_step(
    state: TrainState,
    corpus: ResidentCorpus,
    seq_idx: torch.Tensor,
    t0: Union[int, torch.Tensor],
    weights: LossWeights,
    window: int,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """One TBPTT step on a window gathered from the corpus (augmented when
    a ``generator`` is given); ``state`` is updated in place.  On the card
    with no process group the step is one captured graph for every
    ``seq_idx`` and ``t0`` (``parallel/train.py::run_step``); the corpus
    stays where it lies."""
    with entry("resident_train_step"):
        device = corpus.images.device
        with span("to_device"):
            t0 = torch.as_tensor(t0, device=device)
        return run_step(
            _RESIDENT, state, dict(seq_idx=seq_idx, t0=t0),
            dict(corpus=corpus), weights=weights, window=window, generator=generator,
        )


def _eval_rollout(model: UmeTrackNet, batch: TemporalTrainBatch):
    """Angles [K, B, 22] and wrists [K, B, 4, 4] of the known-skeleton head
    over the window, the memory threaded through time as in evaluation."""
    b, k = batch.gt_joint_angles.shape[:2]
    state = TemporalState.zeros(b, model.config, device=batch.gt_joint_angles.device)
    angles, wrists = [], []
    for t in range(k):
        out, state = model.known_skeleton(batch.frames.map(lambda a: a[:, t]), batch.skeleton, state)
        angles.append(out.joint_angles)
        wrists.append(out.wrist_xfs)
    return torch.stack(angles), torch.stack(wrists)


def _eval_mpjpe(model: UmeTrackNet, seq_idx: torch.Tensor, t0: torch.Tensor, corpus: ResidentCorpus,
                window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`resident_eval_mpjpe`'s device work."""
    batch = gather_window(corpus, seq_idx, t0, window)
    angles_t, wrists_t = _eval_rollout(model, batch)
    gt_a = batch.gt_joint_angles.transpose(0, 1)
    pred_lm = skin_landmarks(batch.hand, angles_t, wrists_t)  # [K, B, 21, 3] meters
    gt_lm = skin_landmarks(batch.hand, gt_a, batch.gt_wrist_world.transpose(0, 1))
    err = torch.linalg.vector_norm(pred_lm - gt_lm, dim=-1)  # [K, B, 21]
    w = batch.valid.transpose(0, 1).to(torch.float32)[..., None]  # [K, B, 1]
    mpjpe_mm = torch.sum(err * w) / torch.clamp(w.sum() * 21, min=1.0) * 1e3
    dang = (angles_t - gt_a).abs()[..., :20]
    mpjpa_deg = torch.rad2deg(torch.sum(dang * w) / torch.clamp(w.sum() * 20, min=1.0))
    return mpjpe_mm, mpjpa_deg


_EVAL_MPJPE = CompiledStep(_eval_mpjpe)


def _window_call(step: CompiledStep, model: UmeTrackNet, corpus: ResidentCorpus,
                 seq_idx: torch.Tensor, t0: Union[int, torch.Tensor], **static):
    """``step`` on a window of the resident corpus: a captured graph on the
    card (one for every ``seq_idx`` and ``t0`` of a shape)."""
    device = corpus.images.device
    return step(model, device, dict(seq_idx=seq_idx, t0=torch.as_tensor(t0, device=device)),
                dict(corpus=corpus), **static)


def resident_eval_mpjpe(
    model: UmeTrackNet, corpus: ResidentCorpus, seq_idx: torch.Tensor,
    t0: Union[int, torch.Tensor], window: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(MPJPE mm, MPJPA deg) of the known-skeleton head in eval mode over a
    window of the given sequences: the training domain's mirror of the
    protocol metric (predicted wrist AND angles)."""
    model.eval()
    return _window_call(_EVAL_MPJPE, model, corpus, seq_idx, t0, window=window)


def draw_window(rng: np.random.Generator, n_sequences: int, seqs_per_batch: int, n_starts: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A step's (sequence indices [Bs], window start) drawn on the host in
    the JAX package's order (``choice``, then ``integers``) and sent to
    ``device`` in one copy that does not wait for the device's queue
    (pinned memory)."""
    idx = rng.choice(n_sequences, size=seqs_per_batch, replace=n_sequences < seqs_per_batch)
    t0 = rng.integers(0, n_starts)
    host = torch.from_numpy(np.append(idx, t0).astype(np.int64))
    if device.type == "cuda":
        host = host.pin_memory()
    both = host.to(device, non_blocking=True)
    return both[:-1], both[-1]


def run_resident_training(
    model: UmeTrackNet,
    corpus: ResidentCorpus,
    eval_corpus: Optional[ResidentCorpus] = None,
    num_steps: int = 20_000,
    seqs_per_batch: int = 16,
    window: int = 8,
    learning_rate: float = 3e-4,
    weight_decay: float = 1e-5,
    weights: Optional[LossWeights] = None,
    warmup_steps: int = 500,
    log_every: int = 200,
    eval_every: int = 1000,
    seed: int = 0,
    augment: bool = True,
    log_fn: Optional[Callable[[dict], None]] = None,
    checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
    checkpoint_every: int = 0,
    resume: Optional[dict] = None,
    stop_step: Optional[int] = None,
    snapshot_fn: Optional[Callable[[dict], None]] = None,
) -> Tuple[TrainState, List[dict]]:
    """Train ``model`` (in place, on the corpus's device) on windows drawn
    from ``corpus``: AdamW with global-norm clipping at 1.0 and a
    warmup-cosine schedule, the host only drawing indices.  Every
    ``log_every`` steps (and at the last) a history row of the metrics and
    steps/s, with the eval MPJPE / MPJPA every ``eval_every`` steps;
    ``checkpoint_fn(state, step)`` every ``checkpoint_every`` steps.

    A long run can be split: ``stop_step`` ends the loop before that step
    (the schedule still spans ``num_steps``), ``snapshot_fn`` receives
    :func:`loop_snapshot` with every checkpoint and when the loop ends,
    and ``resume`` (such a snapshot, from a run with the same arguments)
    continues from its step with its weights, optimizer, random streams
    and history, as the unsplit run would.  Returns (state, history)."""
    device = corpus.images.device
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, min(warmup_steps, max(num_steps // 10, 1)), num_steps,
        learning_rate * 0.01,
    )
    state = create_train_state(
        model, ClippedAdamW(model.parameters(), schedule, weight_decay, max_grad_norm=1.0)
    )
    weights = weights or LossWeights()
    rng = np.random.default_rng(seed)
    n, t = corpus.n_sequences, corpus.n_frames
    k = min(window, t)
    generator = torch.Generator(device=device).manual_seed(seed) if augment else None
    history = []
    start = 0
    if resume is not None:
        start, history = resume["step"], list(resume["history"])
        model.load_state_dict(resume["model"])
        state.optimizer.restore(resume["optimizer"])
        state.step = start
        rng.bit_generator.state = resume["rng"]
        if generator is not None:
            generator.set_state(resume["generator"])
    end = num_steps if stop_step is None else min(stop_step, num_steps)
    t_start = time.perf_counter()
    for step in range(start, end):
        seq_idx, t0 = draw_window(rng, n, seqs_per_batch, t - k + 1, device)
        metrics = resident_train_step(state, corpus, seq_idx, t0, weights, k, generator)
        if step % log_every == 0 or step == num_steps - 1:
            m = {key: float(v) for key, v in metrics.items()}
            m["step"] = step
            m["steps_per_s"] = (step + 1 - start) / (time.perf_counter() - t_start)
            if eval_every and (step % eval_every == 0 or step == num_steps - 1):
                ec = eval_corpus if eval_corpus is not None else corpus
                eval_idx = torch.arange(min(seqs_per_batch, ec.n_sequences), device=device)
                mpjpe, mpjpa = resident_eval_mpjpe(model, ec, eval_idx, 0, k)
                m["eval_mpjpe_mm"] = float(mpjpe)
                m["eval_mpjpa_deg"] = float(mpjpa)
            history.append(m)
            if log_fn:
                log_fn(m)
        if checkpoint_every and step and step % checkpoint_every == 0:
            if checkpoint_fn is not None:
                checkpoint_fn(state, step)
            if snapshot_fn is not None:
                snapshot_fn(loop_snapshot(state, rng, generator, step + 1, history))
    if snapshot_fn is not None:
        snapshot_fn(loop_snapshot(state, rng, generator, max(end, start), history))
    return state, history


def loop_snapshot(state: TrainState, rng: np.random.Generator, generator: Optional[torch.Generator],
                  step: int, history: List[dict]) -> dict:
    """What :func:`run_resident_training` needs to continue before ``step``,
    on the CPU: the weights and BatchNorm stats, the optimizer's state, the
    window draws' and the augmentation's random streams, and the history
    so far (``torch.save`` writes it, ``torch.load`` reads it back)."""
    return dict(
        step=step,
        model={key: v.detach().cpu().clone() for key, v in state.model.state_dict().items()},
        optimizer=state.optimizer.snapshot(),
        rng=rng.bit_generator.state,
        generator=None if generator is None else generator.get_state(),
        history=list(history),
    )


def _diagnose(model: UmeTrackNet, seq_idx: torch.Tensor, t0: torch.Tensor, corpus: ResidentCorpus,
              window: int) -> Dict[str, torch.Tensor]:
    """:func:`resident_diagnose`'s device work, in the mode the caller set."""
    batch = gather_window(corpus, seq_idx, t0, window)
    with running_stats_kept(model):
        angles_t, wrists_t = _eval_rollout(model, batch)
    gt_a = batch.gt_joint_angles.transpose(0, 1)
    gt_w = batch.gt_wrist_world.transpose(0, 1)
    w = batch.valid.transpose(0, 1).to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1.0)

    def mpjpe(a, wr):
        err = torch.linalg.vector_norm(
            skin_landmarks(batch.hand, a, wr) - skin_landmarks(batch.hand, gt_a, gt_w), dim=-1
        )
        return torch.sum(err.mean(dim=-1) * w) / wsum * 1e3

    t_err = torch.linalg.vector_norm(wrists_t[..., :3, 3] - gt_w[..., :3, 3], dim=-1)
    r_rel = wrists_t[..., :3, :3].transpose(-1, -2) @ gt_w[..., :3, :3]
    cos = torch.clamp((r_rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1, 1)
    rot_deg = torch.rad2deg(torch.arccos(cos))
    return {
        "mpjpe_full_mm": mpjpe(angles_t, wrists_t),
        "mpjpe_angles_only_mm": mpjpe(angles_t, gt_w),
        "mpjpe_wrist_only_mm": mpjpe(gt_a, wrists_t),
        "wrist_trans_mm": torch.sum(t_err * w) / wsum * 1e3,
        "wrist_rot_deg": torch.sum(rot_deg * w) / wsum,
    }


_DIAGNOSE = CompiledStep(_diagnose)


def resident_diagnose(
    model: UmeTrackNet, corpus: ResidentCorpus, seq_idx: torch.Tensor,
    t0: Union[int, torch.Tensor], window: int, bn_train: bool = False,
) -> Dict[str, float]:
    """Error decomposition on a window: which term carries the MPJPE
    (predicted angles with the GT wrist, the predicted wrist with GT angles,
    the wrist's translation and rotation) and, with ``bn_train``, whether
    BatchNorm's batch statistics move it (the running stats are left as
    they were).  The values are read on the host after the step."""
    model.train(bn_train)
    try:
        terms = _window_call(_DIAGNOSE, model, corpus, seq_idx, t0, window=window)
    finally:
        model.eval()
    return {name: float(v) for name, v in terms.items()}
