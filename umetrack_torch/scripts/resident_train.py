"""Device-resident training driver on the tracker-crop domain.

Counterpart of the repository's ``scripts/resident_train.py``.  Phases:

  gen    -- render and tracker-prep the corpus once (one ``warp_pool``
            launch a sequence on the GPU) and cache it to disk (npz)
  probe  -- overfit probe: train on the first --probe-seqs sequences only
            and watch their MPJPE (the renderer's accuracy ceiling)
  train  -- the full run on all sequences, eval on the held-out corpus,
            the checkpoint, the history JSON and the error decomposition

Seed bands: training corpus 5_000+, monitoring eval corpus 905_000+
(disjoint from the eval apps' 1_000_000+).  The cache is the JAX script's
(``data_synth/resident/{tag}.npz``, the same keys and dtypes), so either
package reads a corpus the other wrote.  Histories go under ``--out-dir``.

    python -m umetrack_torch.scripts.resident_train gen --n-train 256 --n-eval 16
    python -m umetrack_torch.scripts.resident_train train --steps 2000 --ckpt runs_torch/r.msgpack

A run longer than one sitting is split with ``--state`` and ``--stop-step``
(port-only flags): the same command with a later ``--stop-step`` (or none)
continues where the last one stopped, as the unsplit run would.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..apps.common import resolve_dtype
from ..kinematics.hand import HandModel, load_generic_hand_dict
from ..models import ModelConfig
from ..parallel import (
    ClippedAdamW,
    LossWeights,
    create_train_state,
    init_train_model,
    warmup_cosine_decay_schedule,
)
from ..parallel.resident import (
    ResidentCorpus,
    corpus_from_arrays,
    draw_window,
    resident_diagnose,
    resident_eval_mpjpe,
    resident_train_step,
    run_resident_training,
)
from ..utils.checkpoints import load_checkpoint, save_checkpoint

logger = logging.getLogger("resident_train")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE = os.path.join(REPO, "data_synth", "resident")
DEFAULT_OUT_DIR = os.path.join(REPO, "runs_torch")

ENTRY_KEYS = ("images", "intrinsics", "T_world_from_eye", "view_valid", "hand_valid", "n_views",
              "angles", "wrists_mm")
# The JAX package's hand model fields in its pytree order (its dataclass's
# field order), each with whether it holds integers.  Its cache names the
# fields that are set, in this order, ``hand_leaf_0``, ``hand_leaf_1``, ...;
# the port's HandModel orders its fields otherwise and lacks the topology
# and mesh fields, which every hand takes from the generic hand unchanged.
JAX_HAND_FIELDS = (
    ("joint_rotation_axes", False), ("joint_rest_positions", False),
    ("landmark_rest_positions", False), ("landmark_rest_bone_weights", False),
    ("landmark_rest_bone_indices", True), ("hand_scale", False), ("joint_limits", False),
    ("joint_frame_index", True), ("joint_parent", True), ("joint_first_child", True),
    ("joint_next_sibling", True), ("mesh_vertices", False), ("mesh_triangles", True),
    ("dense_bone_weights", False),
)
PORT_HAND_FIELDS = frozenset(HandModel.__dataclass_fields__)


def entry_path(tag):
    return os.path.join(CACHE, f"{tag}.npz")


@functools.lru_cache(maxsize=None)
def hand_leaves():
    """(leaf index, field, is-integer) of the cache's hand leaves: the JAX
    fields that the generic hand sets, in the JAX order."""
    generic = load_generic_hand_dict()
    fields = [(name, is_int) for name, is_int in JAX_HAND_FIELDS if generic.get(name) is not None]
    return tuple((i, name, is_int) for i, (name, is_int) in enumerate(fields))


def save_entries(tag, entries):
    """``prepare_tracker_sequences`` entries -> ``CACHE/{tag}.npz``: the
    per-entry arrays stacked (images as float16), the scales, and the hand
    leaves as the JAX package writes them (floats f32, integers int32)."""
    os.makedirs(CACHE, exist_ok=True)
    flat = {}
    n = len(entries)
    for key in ENTRY_KEYS:
        arr = np.stack([e[key] for e in entries])
        if key == "images":
            arr = arr.astype(np.float16)  # warp output, [0,1]-ish range
        flat[key] = arr
    flat["scale"] = np.asarray([e["scale"] for e in entries], np.float32)
    generic = load_generic_hand_dict()
    for i, name, is_int in hand_leaves():
        dtype = np.int32 if is_int else np.float32
        values = [getattr(e["hand_model_mm"], name, None) for e in entries]
        flat[f"hand_leaf_{i}"] = np.stack([
            np.asarray(generic[name] if v is None else v, dtype) for v in values
        ])
    np.savez_compressed(entry_path(tag), n=n, **flat)
    logger.info("cached %d entries -> %s", n, entry_path(tag))


def _hand_from_leaves(z) -> HandModel:
    """The port's hand model, stacked over the entries, from the cache's
    leaves: floats f32, integers int64, as ``from_dict`` makes them."""
    fields = {}
    for i, name, is_int in hand_leaves():
        if name in PORT_HAND_FIELDS:
            fields[name] = z[f"hand_leaf_{i}"].astype(np.int64 if is_int else np.float32)
    return HandModel(**fields)


def load_entries(tag):
    """``CACHE/{tag}.npz`` -> the list of entries ``save_entries`` took
    (images back to f32)."""
    z = np.load(entry_path(tag), allow_pickle=False)
    arrays = {key: z[key] for key in ENTRY_KEYS}
    hands, scales = _hand_from_leaves(z), z["scale"]
    entries = []
    for i in range(int(z["n"])):
        entry = {key: a[i] for key, a in arrays.items()}
        entry["images"] = entry["images"].astype(np.float32)
        entry["hand_model_mm"] = hands.map(lambda a: a[i])
        entry["scale"] = float(scales[i])
        entries.append(entry)
    return entries


def phase_gen(args):
    """Prepare and cache both splits; returns their entries."""
    from ..apps.train import prepare_tracker_sequences

    device = resolve_device(args.device)
    entries = prepare_tracker_sequences(n_seqs=args.n_train, t=args.t, seed0=5000, device=device)
    save_entries(f"train_{args.n_train}_{args.t}", entries)
    entries_e = prepare_tracker_sequences(n_seqs=args.n_eval, t=args.t, seed0=905_000, device=device)
    save_entries(f"eval_{args.n_eval}_{args.t}", entries_e)
    return entries, entries_e


def load_corpus(tag, device=None) -> ResidentCorpus:
    """``CACHE/{tag}.npz`` -> the resident corpus on ``device`` (CUDA
    unless "cpu"), without the per-entry round trip."""
    z = np.load(entry_path(tag), allow_pickle=False)
    return corpus_from_arrays(
        images=z["images"].astype(np.float32),
        intrinsics=z["intrinsics"],
        T_world_from_eye=z["T_world_from_eye"],
        view_valid=z["view_valid"],
        hand_valid=z["hand_valid"],
        n_views=z["n_views"],
        angles=z["angles"],
        wrists_mm=z["wrists_mm"],
        hand_model_mm_batched=_hand_from_leaves(z),
        scales=z["scale"],
        device=device,
    )


def _corpora(args, device):
    train = load_corpus(f"train_{args.n_train}_{args.t}", device)
    evalc = load_corpus(f"eval_{args.n_eval}_{args.t}", device)
    return train, evalc


def _loss_weights(args) -> LossWeights:
    return LossWeights(
        angles=args.w_angles,
        wrist_points=args.w_points,
        landmark_nll=args.w_nll,
        scale=args.w_scale,
        wrist_rot_gain=args.rot_gain,
        accel=args.w_accel,
    )


def log_fn(m):
    logger.info(
        "step %(step)d: loss=%(loss).4f angle=%(angle_loss).4f "
        "point=%(point_loss).4f nll=%(landmark_nll).4f "
        "accel=%(accel_loss).6f (%(steps_per_s).2f steps/s)" % m
        + (
            "  eval MPJPE %.1f mm MPJPA %.2f deg" % (m["eval_mpjpe_mm"], m["eval_mpjpa_deg"])
            if "eval_mpjpe_mm" in m
            else ""
        )
    )


def inline_diagnose(model, corpus, evalc, window, restrict_seqs=None):
    """``resident_diagnose`` on the first 16 sequences of each split (of the
    probe's sequences for its training split), frames 0 .. window-1."""
    out = {}
    for split, c in (("train", corpus), ("eval", evalc)):
        idx = np.arange(min(16, c.n_sequences)) % c.n_sequences
        if restrict_seqs and split == "train":
            idx = np.arange(16) % restrict_seqs
        d = resident_diagnose(
            model, c, torch.as_tensor(idx, device=c.images.device), 0, min(window, c.n_frames),
        )
        logger.info("diagnose[%s]: %s", split, {k: round(float(v), 2) for k, v in d.items()})
        out[split] = d
    return out


def _run(args, restrict_seqs=None, tag="train"):
    """Train a fresh model (or ``--init-ckpt``'s weights): the probe when
    ``restrict_seqs`` is set, else the full run.  Writes
    ``{out_dir}/history_{tag}.json``, the checkpoint when ``--ckpt`` names
    one, and ``{out_dir}/diagnose_{tag}.json``.  Returns the history."""
    device = resolve_device(args.device)
    corpus, evalc = _corpora(args, device)
    config = ModelConfig(compute_dtype=resolve_dtype(args.dtype))
    model = init_train_model(config, seed=0, device=device)
    if args.init_ckpt:
        model.load_state_dict(load_checkpoint(args.init_ckpt, config))
        logger.info("resumed from %s", args.init_ckpt)
    weights = _loss_weights(args)
    os.makedirs(args.out_dir, exist_ok=True)
    history_path = os.path.join(args.out_dir, f"history_{tag}.json")

    if restrict_seqs:
        _, history = _probe_loop(model, corpus, restrict_seqs, args, weights, log_fn)
    else:
        def checkpoint_fn(state, step):
            if args.ckpt:
                save_checkpoint(args.ckpt, state.model.state_dict())
                logger.info("periodic checkpoint @ step %d -> %s", step, args.ckpt)

        resume = None
        if args.state and os.path.exists(args.state):
            resume = torch.load(args.state, map_location="cpu")
            logger.info("resuming %s before step %d", args.state, resume["step"])

        def snapshot_fn(snapshot):
            tmp = f"{args.state}.tmp"
            torch.save(snapshot, tmp)
            os.replace(tmp, args.state)
            logger.info("training state before step %d -> %s", snapshot["step"], args.state)

        _, history = run_resident_training(
            model, corpus, eval_corpus=evalc,
            num_steps=args.steps, seqs_per_batch=args.seqs_per_batch,
            window=args.window, learning_rate=args.lr,
            weights=weights, log_every=args.log_every,
            eval_every=args.eval_every, seed=args.seed,
            augment=not args.no_augment, log_fn=log_fn,
            checkpoint_fn=checkpoint_fn, checkpoint_every=2000,
            resume=resume, stop_step=args.stop_step, snapshot_fn=snapshot_fn if args.state else None,
        )

    with open(history_path, "w") as fp:
        json.dump(history, fp, indent=1)
    logger.info("history -> %s", history_path)
    if args.ckpt:
        path = save_checkpoint(args.ckpt, model.state_dict())
        logger.info("checkpoint -> %s", path)

    # the error decomposition, while the corpus is on the device
    diagnoses = inline_diagnose(model, corpus, evalc, args.window, restrict_seqs)
    with open(os.path.join(args.out_dir, f"diagnose_{tag}.json"), "w") as fp:
        json.dump(diagnoses, fp, indent=1)
    return history


def _probe_loop(model, corpus, n_probe, args, weights, log_fn):
    """Overfit probe: the full run's shapes, with the sequences drawn from
    the first ``n_probe`` only (in the JAX script's order of draws) and no
    augmentation; eval runs on those same sequences.  ``model`` is trained
    in place.  Returns (state, history)."""
    lr = warmup_cosine_decay_schedule(
        0.0, args.lr, min(500, max(args.steps // 10, 1)), args.steps, args.lr * 0.01,
    )
    state = create_train_state(
        model, ClippedAdamW(model.parameters(), lr, weight_decay=1e-5, max_grad_norm=1.0)
    )
    device = corpus.images.device
    rng = np.random.default_rng(args.seed)
    t = corpus.n_frames
    k = min(args.window, t)
    history = []
    t_start = time.perf_counter()
    for step in range(args.steps):
        seq_idx, t0 = draw_window(rng, n_probe, args.seqs_per_batch, t - k + 1, device)
        metrics = resident_train_step(state, corpus, seq_idx, t0, weights, k)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {kk: float(v) for kk, v in metrics.items()}
            m["step"] = step
            m["steps_per_s"] = (step + 1) / (time.perf_counter() - t_start)
            if step % args.eval_every == 0 or step == args.steps - 1:
                eval_idx = torch.as_tensor(np.arange(args.seqs_per_batch) % n_probe, device=device)
                mpjpe, mpjpa = resident_eval_mpjpe(model, corpus, eval_idx, 0, k)
                m["eval_mpjpe_mm"] = float(mpjpe)
                m["eval_mpjpa_deg"] = float(mpjpa)
            history.append(m)
            log_fn(m)
    return state, history


def build_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("phase", choices=["gen", "probe", "train"])
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-eval", type=int, default=16)
    p.add_argument("--t", type=int, default=16)
    p.add_argument("--probe-seqs", type=int, default=8)
    p.add_argument("--steps", type=int, default=30_000)
    p.add_argument("--seqs-per-batch", type=int, default=16)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--w-angles", type=float, default=1.0)
    p.add_argument("--w-points", type=float, default=20.0)
    p.add_argument("--w-nll", type=float, default=0.1)
    p.add_argument("--w-scale", type=float, default=0.1)
    p.add_argument("--w-accel", type=float, default=200.0,
                   help="temporal-smoothness (2nd-difference) weight; the squared accel "
                   "mismatch is ~1e-6 m^2 so O(1e3) weights give it a comparable gradient share")
    p.add_argument("--rot-gain", type=float, default=1.0,
                   help="extra gain on the rotation-carrying (centered) wrist-point error component")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--init-ckpt", default=None)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint to write: a .msgpack file, any other path an orbax directory")
    p.add_argument("--state", default=None,
                   help="train: the whole training state (weights, optimizer, random streams, "
                   "history), written with every periodic checkpoint and when the run stops; "
                   "a run given an existing file continues from it")
    p.add_argument("--stop-step", type=int, default=None,
                   help="train: stop before this step (the schedule still spans --steps); "
                   "with --state, a later run continues from there")
    p.add_argument("--device", default=None,
                   help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'")
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                   help="where the history and diagnosis JSON go")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resolve_device(args.device)  # no GPU and no --device cpu: raise before any work
    if args.phase == "gen":
        return phase_gen(args)
    if args.phase == "probe":
        return _run(args, restrict_seqs=args.probe_seqs, tag="probe")
    return _run(args, tag="train")


if __name__ == "__main__":
    main()
