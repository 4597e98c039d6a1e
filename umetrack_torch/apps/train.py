"""The training app: the UmeTrack model on torch_data sequences or on the
tracker's own crops, on one device.

Counterpart of ``umetrack_tpu/apps/train.py``.  The host loader parses the
idx/bin bytes; the crop + warp preprocessing runs on the device over a whole
batch at once (one warp kernel launch per batch), and single-frame or TBPTT
batches drive ``parallel/train.py``'s step.  ``--synthetic`` trains on
generated data, so the loop runs without UmeTrack_data.  With
``--coordinator host:port --num-processes N --process-id i`` each process
joins a ``torch.distributed`` group (NCCL between cards, gloo with
``--device cpu``; a group the caller has already joined is used as it is)
and the processes form a (data, model) mesh: the config's
``mesh.model_axis`` (1 by default, 0 = auto) splits the large convolutions'
output channels over the model axis (``parallel/mesh.py``), and each data
index trains on its block of every global batch.  Checkpoints are
orbax directories, as the JAX app writes them (``{dir}/step_{step:07d}``
and ``{dir}/final``; ``utils/orbax.py``), which the JAX package loads too.
Runs on the GPU unless ``--device cpu`` is given.

    python -m umetrack_torch.apps.train --synthetic --steps 100 [--window 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import logging
import time
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..config import Config, from_json, to_json
from ..data import Sampler, Split, bundles, find_dataset, iterate_dataset, prefetch_map
from ..data.transform import RawSequence, parse_raw_buffers, preprocess_sequence
from ..kinematics.hand import scaled_hand_model
from ..models.umetrack import FrameInputs, SkeletonInputs
from ..parallel.distributed import finalize
from ..parallel.mesh import Mesh, block, full_state_dict, make_mesh, shard_variables
from ..parallel.resident import _np_rigid_inverse
from ..parallel import (
    ClippedAdamW,
    LossWeights,
    TemporalTrainBatch,
    TrainBatch,
    create_train_state,
    init_train_model,
    temporal_train_step,
    train_step,
    warmup_cosine_decay_schedule,
)
from ..utils.checkpoints import load_checkpoint, save_checkpoint
from .common import add_distributed_flags, join_process_group

logger = logging.getLogger(__name__)


def _skeleton(hand) -> SkeletonInputs:
    return SkeletonInputs(
        joint_rotation_axes=hand.joint_rotation_axes,
        joint_rest_positions=hand.joint_rest_positions,
    )


def _build_train_batch(raw_batch: RawSequence, crop_size) -> TrainBatch:
    """Single-frame batch from a batch of raw sequences on the device: the
    whole batch is preprocessed (one warp launch) and frame T//2 of each
    sequence is kept (deterministic; the loader shuffles the sequences)."""
    model_input, target = preprocess_sequence(raw_batch, tuple(crop_size))
    b, t, v = model_input.left_images.shape[:3]
    ti = t // 2
    device = model_input.left_images.device
    frame = FrameInputs(
        images=model_input.left_images[:, ti],
        intrinsics=model_input.intrinsics[:, ti],
        extrinsics=model_input.extrinsics_xf[:, ti],
        n_views=torch.full((b,), v, dtype=torch.int32, device=device),
        hand_idx=model_input.hand_idx[:, ti].to(torch.int32),
        use_memory=torch.zeros((b,), dtype=torch.bool, device=device),
    )
    hand = model_input.orig_pose_data.left_hand_model
    return TrainBatch(
        frame=frame,
        skeleton=_skeleton(hand),
        gt_joint_angles=target.gt_joint_angles[:, ti],
        gt_wrist_world=target.gt_wrist_xfs[:, ti],
        hand=hand,
        gt_scales=target.gt_scale,
    )


def _build_temporal_batch(
    raw_batch: RawSequence, crop_size, window: int, t0: Optional[int] = None
) -> TemporalTrainBatch:
    """K-frame TBPTT windows from a batch of raw sequences on the device:
    the memory is trained through time (``use_memory`` False at k=0, then
    True) with real frame-to-frame extrinsics motion.  ``t0`` picks the
    window start (clipped to the sequence; default centred): the loader
    passes a random one per batch."""
    model_input, target = preprocess_sequence(raw_batch, tuple(crop_size))
    b, t, v = model_input.left_images.shape[:3]
    k = min(window, t)
    t0 = (t - k) // 2 if t0 is None else min(max(int(t0), 0), t - k)
    device = model_input.left_images.device

    def win(a):
        return a[:, t0:t0 + k]

    frames = FrameInputs(
        images=win(model_input.left_images),
        intrinsics=win(model_input.intrinsics),
        extrinsics=win(model_input.extrinsics_xf),
        n_views=torch.full((b, k), v, dtype=torch.int32, device=device),
        hand_idx=win(model_input.hand_idx).to(torch.int32),
        use_memory=(torch.arange(k, device=device) > 0).expand(b, k),
    )
    hand = model_input.orig_pose_data.left_hand_model
    return TemporalTrainBatch(
        frames=frames,
        skeleton=_skeleton(hand),
        gt_joint_angles=win(target.gt_joint_angles),
        gt_wrist_world=win(target.gt_wrist_xfs),
        hand=hand,
        gt_scales=target.gt_scale,
    )


def _batch_from_sequences(
    items, crop_size, window: int = 1, t0: Optional[int] = None, device=None
) -> Union[TrainBatch, TemporalTrainBatch]:
    """Raw ``{"mono", "labels"}`` items -> one batch on ``device`` (CUDA
    unless "cpu"): a frame per sequence when ``window`` is 1, else a K-frame
    window per sequence starting at ``t0``."""
    raws = [parse_raw_buffers(it["mono"], it["labels"]) for it in items]
    raw_batch = bundles.to_device(bundles.collate(raws), resolve_device(device))
    if window > 1:
        return _build_temporal_batch(raw_batch, crop_size, window, t0)
    return _build_train_batch(raw_batch, crop_size)


def prepare_tracker_sequences(
    n_seqs: int = 96,
    t: int = 16,
    seed0: int = 5000,
    scale_jitter: float = 0.15,
    crop_size=(96, 96),
    device=None,
) -> List[dict]:
    """Tracker-domain training material on the host: the real tracker prep
    (crop cameras from the GT pose, fisheye -> pinhole warps in ONE pool
    warp per sequence, on ``device``: CUDA unless "cpu") over rendered
    synthetic raw_data sequences.  Training on these crops puts the model on
    the distribution the raw_data evaluation sees.  Sequences alternate
    separate / hand_hand and jitter the GT hand scale (what the
    unknown-skeleton protocol recovers).  Every array returned is numpy, so
    nothing of the prep's no-grad tensors reaches a training graph."""
    from ..tracker import TrackerConfig
    from ..tracker import tracker as trk
    from ..utils import synthetic

    device = resolve_device(device)
    cfg = TrackerConfig(crop_size=tuple(crop_size))
    sampler = cfg.resolved_sampler(device)

    def host(a):
        return a.cpu().numpy()

    entries = []
    for i in range(n_seqs):
        rng = np.random.default_rng(seed0 + i)
        scale = float(rng.uniform(1 - scale_jitter, 1 + scale_jitter)) if scale_jitter else 1.0
        labels, images = synthetic.make_labels_dict(
            t, rng_seed=seed0 + i, with_dropout=False,
            mode="hand_hand" if i % 2 else "separate", hand_scale=scale, device=device,
        )
        rig, seq, hand = synthetic.our_sequence(labels, images, device)
        with torch.no_grad():
            crop_sets, crop_images = trk._prepare_frames(cfg, rig, seq, hand, 1, sampler)
        entries.append(dict(
            images=host(crop_images.to(torch.float32)),  # [T, 2, V, h, w]
            intrinsics=host(crop_sets.intrinsics.to(torch.float32)),
            T_world_from_eye=host(crop_sets.T_world_from_eye.to(torch.float32)),
            view_valid=host(crop_sets.view_valid),
            hand_valid=host(crop_sets.hand_valid),  # [T, 2]
            n_views=host(crop_sets.n_views.to(torch.int32)),
            angles=np.asarray(labels["joint_angles"], np.float32),
            wrists_mm=np.asarray(labels["wrist_transforms"], np.float32),
            hand_model_mm=hand.map(host),
            scale=scale,
        ))
        if (i + 1) % 16 == 0:
            logger.info("prepared %d/%d tracker sequences", i + 1, n_seqs)
    return entries


def tracker_domain_batches(
    entries: List[dict], seqs_per_batch: int = 16, window: int = 8, seed: int = 0, device=None,
) -> Iterator[TemporalTrainBatch]:
    """TBPTT batches assembled on the host from :func:`prepare_tracker_sequences`
    entries and uploaded to ``device`` (CUDA unless "cpu"): each sequence
    gives its two hand rows (row 2*s + hand), so a batch has
    ``2 * seqs_per_batch`` rows.  Rows with an invalid hand or no valid
    crop keep their fallback geometry and are masked out of the loss."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = entries[0]["images"].shape[0]
    k = min(window, t)
    mm = 0.001
    while True:
        idxs = rng.choice(len(entries), size=seqs_per_batch, replace=False)
        t0 = int(rng.integers(0, t - k + 1))
        sl = slice(t0, t0 + k)
        cols = {key: [] for key in ("images", "intr", "extr", "n_views", "angles", "wrists", "valid")}
        hands, scales = [], []
        for j in idxs:
            e = entries[int(j)]
            for h in range(2):
                hv = e.get("hand_valid")
                cols["valid"].append(
                    (hv[sl, h] if hv is not None else np.ones(k, bool)) & (e["n_views"][sl, h] > 0)
                )
                cols["images"].append(e["images"][sl, h])  # [k, V, hh, ww]
                extr_m = _np_rigid_inverse(e["T_world_from_eye"][sl, h]).copy()
                extr_m[..., :3, 3] *= mm
                vv = e["view_valid"][sl, h][..., None, None]
                cols["extr"].append(np.where(vv, extr_m, extr_m[:, 0:1]))
                ki = e["intrinsics"][sl, h]
                cols["intr"].append(np.where(vv, ki, ki[:, 0:1]))
                cols["n_views"].append(np.maximum(e["n_views"][sl, h], 1))
                cols["angles"].append(e["angles"][sl, h])
                w = e["wrists_mm"][sl, h].copy()
                w[..., :3, 3] *= mm
                cols["wrists"].append(w)
                hands.append(e["hand_model_mm"])
                scales.append(e["scale"])

        def dev(key, dtype=torch.float32):
            return torch.as_tensor(np.stack(cols[key]), dtype=dtype, device=device)

        hand_m = scaled_hand_model(bundles.to_device(bundles.collate(hands), device), mm)
        b = len(cols["images"])
        frames = FrameInputs(
            images=dev("images"),  # [B, k, V, h, w]
            intrinsics=dev("intr"),
            extrinsics=dev("extr"),
            n_views=dev("n_views", torch.int32),
            hand_idx=torch.arange(2, dtype=torch.int32, device=device).repeat(seqs_per_batch)[:, None]
            .expand(b, k),
            use_memory=(torch.arange(k, device=device) > 0).expand(b, k),
        )
        yield TemporalTrainBatch(
            frames=frames,
            skeleton=_skeleton(hand_m),
            gt_joint_angles=dev("angles"),
            gt_wrist_world=dev("wrists"),
            hand=hand_m,
            gt_scales=torch.as_tensor(np.asarray(scales, np.float32), device=device),
            valid=dev("valid", torch.bool),
        )


def synthetic_batches(
    batch_size: int, crop_size, window: int = 1, device=None, distrib_info=(0, 1),
) -> Iterator[Union[TrainBatch, TemporalTrainBatch]]:
    """Batches of generated torch_data samples (120 x 160 pinhole frames
    with the hand rendered, ``max(window, 1)`` frames each, 50 distinct
    sequences, alternating hands), built on ``device`` (CUDA unless
    "cpu").  Under ``distrib_info=(index, n)`` (a mesh's data index and
    data size) each global batch of ``batch_size`` sequences is split into
    ``n`` contiguous blocks and this rank builds block ``index``, as a
    mesh's ``data`` axis splits it."""
    from ..utils.synthetic import make_torchdata_sample

    rows = block(batch_size, Mesh(data=distrib_info[1], rank=distrib_info[0]))
    seed = 0
    while True:
        items = []
        for j in range(rows.start, rows.stop):
            mono, labels = make_torchdata_sample(
                rng_seed=(seed + j) % 50, t=max(window, 1), hand_idx=(seed + j) % 2,
                render=True, device=device,
            )
            items.append({"mono": mono, "labels": labels})
        seed += batch_size
        yield _batch_from_sequences(items, crop_size, window, device=device)


def dataset_batches(
    cfg: Config, device=None, distrib_info=None,
) -> Iterator[Union[TrainBatch, TemporalTrainBatch]]:
    """Batches of the TRAIN split of ``cfg.data.data_roots``, reshuffled per
    epoch, with a random TBPTT window start per batch when
    ``cfg.train.tbptt_window`` > 1; built on ``device`` (CUDA unless
    "cpu").  Under ``distrib_info=(index, n)`` (a mesh's data index and
    data size; default the config's ``mesh.rank``, ``mesh.world_size``)
    this rank reads shard ``index`` of the sequences and builds
    ``batch_size // n`` rows of each global batch; every rank draws the
    same window starts."""
    device = resolve_device(device)
    rank, world = distrib_info or (cfg.mesh.rank, cfg.mesh.world_size)
    rows = block(cfg.train.batch_size, Mesh(data=world, rank=rank))
    datasets = find_dataset(list(cfg.data.data_roots), list(cfg.data.fields))
    dataset = datasets[Split.TRAIN]
    logger.info("training sequences: %d", len(dataset))
    k = cfg.train.tbptt_window
    rng_t0 = np.random.default_rng(cfg.data.shuffle_seed + 12345)
    epoch = 0
    while True:
        sampler = Sampler(
            len(dataset), shuffle=True, seed=cfg.data.shuffle_seed + epoch,
            distrib_info=(rank, world),
        )
        batch = []
        for item in iterate_dataset(
            dataset, sampler, num_threads=cfg.data.num_io_threads,
            max_prefetch=cfg.data.max_prefetch,
        ):
            batch.append(item)
            if len(batch) == rows.stop - rows.start:
                t0 = None
                if k > 1:
                    t_len = int(batch[0]["mono"].shape[0])
                    t0 = int(rng_t0.integers(0, max(t_len - k, 0) + 1))
                yield _batch_from_sequences(batch, cfg.data.crop_size, k, t0, device)
                batch = []
        epoch += 1


def _checkpoint(model, mesh: Mesh, path: str) -> None:
    """Save the whole model from rank 0.  Every rank calls it: the sharded
    weights are gathered over the model group first."""
    state = full_state_dict(model, mesh)
    if mesh.rank == 0:
        logger.info("saved checkpoint %s", save_checkpoint(path, state))


def run_training(
    cfg: Config,
    batches: Iterator[Union[TrainBatch, TemporalTrainBatch]],
    num_steps: Optional[int] = None,
    init_checkpoint: Optional[str] = None,
    device=None,
    mesh: Optional[Mesh] = None,
):
    """Train a fresh model of ``cfg.model`` (or the weights of
    ``init_checkpoint``: a ``.msgpack`` or ``.torch`` file or an orbax
    directory) on ``device`` (CUDA unless "cpu") for ``num_steps``
    batches (default ``cfg.train.num_steps``): AdamW with global-norm
    clipping at 1.0, a constant or warmup-cosine learning rate.  Batches
    are built one or two ahead in a host thread.  Under a process group
    every rank runs this on ``mesh`` (default ``make_mesh(model_axis=
    cfg.mesh.model_axis)``), with its data index's block of each global
    batch (``synthetic_batches`` / ``dataset_batches`` with ``distrib_info
    =(mesh.data_index, mesh.data)``): the weights are broadcast from rank 0
    and sharded over the model axis, each step trains on the global batch
    (``parallel/train.py``), and each checkpoint is gathered by every rank
    and written by rank 0.  Returns (state, history of the logged losses)."""
    device = resolve_device(device)
    model = init_train_model(cfg.model, seed=0, device=device)
    if init_checkpoint:
        model.load_state_dict(load_checkpoint(init_checkpoint, cfg.model))
        logger.info("resumed weights from %s", init_checkpoint)
    mesh = mesh or make_mesh(model_axis=cfg.mesh.model_axis)
    shard_variables(model, mesh)
    logger.info("mesh: %s, rank %d", mesh.shape, mesh.rank)
    saves = bool(cfg.train.checkpoint_dir)

    num_steps = num_steps or cfg.train.num_steps
    if cfg.train.lr_schedule == "cosine":
        total = max(num_steps, 2)
        lr = warmup_cosine_decay_schedule(
            0.0, cfg.train.learning_rate, min(cfg.train.warmup_steps, max(total // 10, 1)),
            total, cfg.train.learning_rate * 0.01,
        )
    elif cfg.train.lr_schedule == "constant":
        lr = cfg.train.learning_rate
    else:
        raise ValueError(f"lr_schedule {cfg.train.lr_schedule!r}: use 'constant' or 'cosine'")
    # global-norm clipping guards the TBPTT step against rare exploding
    # batches (e.g. NLL spikes right after a domain shift)
    state = create_train_state(
        model, ClippedAdamW(model.parameters(), lr, cfg.train.weight_decay, max_grad_norm=1.0,
                            mesh=mesh)
    )
    weights = LossWeights(
        angles=cfg.train.loss_angles,
        wrist_points=cfg.train.loss_wrist_points,
        landmark_nll=cfg.train.loss_landmark_nll,
        scale=cfg.train.loss_scale,
    )

    t_start = time.time()
    history = []
    # one host thread builds the next batches (parse, collate, upload,
    # preprocess launch) while the device trains on the current one; it
    # builds exactly num_steps of them
    batches = prefetch_map(
        lambda b: b, itertools.islice(iter(batches), num_steps), num_threads=1, max_prefetch=2
    )
    for step, batch in enumerate(batches):
        step_fn = temporal_train_step if isinstance(batch, TemporalTrainBatch) else train_step
        metrics = step_fn(state, batch, weights)
        if step % cfg.train.log_every == 0 or step == num_steps - 1:
            loss = float(metrics["loss"])
            history.append(loss)
            logger.info(
                "step %d: loss=%.5f angles=%.5f points=%.5f nll=%.4f (%.2f steps/s)",
                step, loss, float(metrics["angle_loss"]), float(metrics["point_loss"]),
                float(metrics["landmark_nll"]), (step + 1) / (time.time() - t_start),
            )
        if saves and step > 0 and step % cfg.train.checkpoint_every == 0:
            _checkpoint(model, mesh, f"{cfg.train.checkpoint_dir}/step_{step:07d}")
    if saves:
        _checkpoint(model, mesh, f"{cfg.train.checkpoint_dir}/final")
    return state, history


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument("--data", nargs="*", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument(
        "--window", type=int, default=None,
        help="TBPTT window length (frames); >1 trains the memory through time",
    )
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument(
        "--device", default=None, help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'"
    )
    parser.add_argument("--print-config", action="store_true")
    add_distributed_flags(parser)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = from_json(args.config) if args.config else Config()
    if args.data:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_roots=tuple(args.data)))
    overrides = {
        key: value for key, value in (
            ("batch_size", args.batch_size), ("checkpoint_dir", args.checkpoint_dir),
            ("num_steps", args.steps), ("tbptt_window", args.window),
        ) if value
    }
    if overrides:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **overrides))
    if args.print_config:
        print(to_json(cfg))
        return None

    if not args.synthetic and not cfg.data.data_roots:
        raise SystemExit("--data or the config's data_roots is required (or --synthetic)")
    device = resolve_device(args.device)
    joined = join_process_group(args)
    try:
        mesh = make_mesh(model_axis=cfg.mesh.model_axis)
        shard = (mesh.data_index, mesh.data)
        if args.synthetic:
            batches = synthetic_batches(
                cfg.train.batch_size, cfg.data.crop_size, cfg.train.tbptt_window, device, shard
            )
        else:
            batches = dataset_batches(cfg, device, shard)
        return run_training(cfg, batches, device=device, mesh=mesh)
    finally:
        if joined:
            finalize()


if __name__ == "__main__":
    main()
