"""End-to-end accuracy loop on the self-consistent synthetic benchmark:
corpus -> train -> four-cell eval -> RESULTS.md.

Counterpart of the repository's ``scripts/accuracy_loop.py``.  Hands drawn
through the real camera models (``utils/synthetic.py``) make a torch_data
corpus on disk; TBPTT training with GT supervision; then the eval apps
(``run_eval_known_skeleton`` / ``run_eval_unknown_skeleton`` ->
``load_eval``) over the four protocol cells {known, unknown} x
{separate_hand, hand_hand}.

Phases (run individually or ``all``):
  corpus         -- write the rendered torch_data corpus
  train          -- TBPTT training on the corpus (one ``warp_image_full``
                    launch a batch on the GPU); writes ``--ckpt``
  train-tracker  -- fine-tune on the tracker's own crops (one ``warp_pool``
                    launch a prepared sequence), from ``--init-ckpt``
  eval           -- the eval apps on held-out synthetic raw_data sequences,
                    aggregated into ``{out_dir}/RESULTS.md``

The checkpoint (default ``{out_dir}/synthetic.msgpack``) and the results
table go under ``--out-dir``; the table's training trajectory is read from
``{out_dir}/history_train.json``, which ``resident_train train`` writes.

    python -m umetrack_torch.scripts.accuracy_loop eval --ckpt checkpoints/synthetic_r5.msgpack
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

from .._device import resolve_device
from .resident_train import DEFAULT_OUT_DIR, REPO

logger = logging.getLogger("accuracy_loop")

DEFAULT_CORPUS = os.path.join(REPO, "data_synth")
CHECKPOINT_NAME = "synthetic.msgpack"
CELLS = (
    ("known_skeleton", "separate_hand"),
    ("known_skeleton", "hand_hand"),
    ("unknown_skeleton", "separate_hand"),
    ("unknown_skeleton", "hand_hand"),
)

# The reference's published accuracy per cell for the RESULTS.md comparison
# column (its README's table; real UmeTrack_data, not comparable 1:1 with the
# synthetic corpus -- reported for context only).
REFERENCE_TABLE = {
    "known_skeleton/separate_hand": (9.4, 3.92),
    "known_skeleton/hand_hand": (10.6, 3.47),
    "unknown_skeleton/separate_hand": (10.0, 3.86),
    "unknown_skeleton/hand_hand": (10.9, 3.44),
}


def phase_corpus(args):
    from ..utils.synthetic import write_torchdata_corpus

    out = write_torchdata_corpus(
        args.corpus_root, n_train=args.n_train, n_test=args.n_test,
        t=args.corpus_t, seed0=args.seed, device=resolve_device(args.device),
    )
    print(f"corpus written: {out}", flush=True)


def _train_config(args, data_roots=None):
    """``Config()`` with the loop's training settings: cosine schedule, the
    wrist-point weight rebalanced, no periodic checkpoints."""
    from ..config import Config

    cfg = Config()
    if data_roots is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_roots=data_roots))
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train,
        num_steps=args.steps,
        batch_size=args.batch_size,
        tbptt_window=args.window,
        learning_rate=args.lr,
        lr_schedule="cosine",
        # Rebalanced for the wrist: at the defaults the angle/NLL terms
        # saturate (sub-mm landmarks with GT wrist) while the wrist-point
        # term is still far from converged and its gradients are drowned;
        # 20x makes point_loss fall ~8x faster.
        loss_wrist_points=args.w_points,
        log_every=25,
        checkpoint_dir=None,
    ))


def _save(args, state, history):
    from ..utils.checkpoints import save_checkpoint

    path = save_checkpoint(args.ckpt, state.model.state_dict())
    print(f"checkpoint saved: {path} (final loss {history[-1]:.5f})", flush=True)
    return path


def phase_train(args):
    """TBPTT training on the corpus's training split from ``--init-ckpt``
    or fresh weights; the final state goes to ``--ckpt``."""
    from ..apps import train as train_app

    device = resolve_device(args.device)
    cfg = _train_config(args, (os.path.join(args.corpus_root, "synthetic"),))
    batches = train_app.dataset_batches(cfg, device)
    state, history = train_app.run_training(
        cfg, batches, init_checkpoint=args.init_ckpt, device=device
    )
    return _save(args, state, history)


def phase_train_tracker(args):
    """Fine-tune on the tracker's own crop distribution (the fisheye prep
    path: the raw_data eval domain), from ``--init-ckpt`` (the torch_data
    checkpoint)."""
    from ..apps import train as train_app

    device = resolve_device(args.device)
    entries = train_app.prepare_tracker_sequences(
        n_seqs=args.tracker_seqs, t=args.corpus_t, device=device
    )
    batches = train_app.tracker_domain_batches(
        entries, seqs_per_batch=args.batch_size // 2, window=args.window, device=device
    )
    state, history = train_app.run_training(
        _train_config(args), batches, init_checkpoint=args.init_ckpt, device=device
    )
    return _save(args, state, history)


def phase_eval(args):
    """The eval apps over the four cells, ``load_eval``'s aggregate, and
    the results table.  Returns the summaries."""
    from ..apps import load_eval
    from ..apps import run_eval_known_skeleton as known_app
    from ..apps import run_eval_unknown_skeleton as unknown_app

    for mode, protocol in CELLS:
        out_dir = os.path.join(args.eval_root, f"eval_results_{mode}", "real", protocol)
        syn_mode = "hand_hand" if protocol == "hand_hand" else "separate"
        argv = [
            "--output-dir", out_dir,
            "--checkpoint", args.ckpt,
            "--synthetic", str(args.eval_seqs),
            "--synthetic-frames", str(args.eval_frames),
            "--synthetic-mode", syn_mode,
            "--dtype", args.dtype,
        ]
        if args.device:
            argv += ["--device", args.device]
        print(f"== eval {mode}/{protocol} ==", flush=True)
        if mode == "known_skeleton":
            known_app.main(argv)
        else:
            unknown_app.main(argv)

    summaries = load_eval.main(["--results-root", args.eval_root, "--json"])
    write_results_md(args, summaries)
    return summaries


def results_rows(summaries: dict):
    """The table's lines: header, rule and a row per cell."""
    lines = [
        "| Cell | MPJPE (mm) | MPJPA (deg) | PCK-AUC | Success rate "
        "| Accel (x GT) | Ref MPJPE / MPJPA (real data) |",
        "|---|---|---|---|---|---|---|",
    ]
    for cell, s in summaries.items():
        ref = REFERENCE_TABLE.get(cell)
        ref_txt = f"{ref[0]} / {ref[1]}" if ref else "—"
        acc = s.get("mean_keypoint_acceleration", float("nan"))
        gt_acc = s.get("gt_mean_keypoint_acceleration", float("nan")) or 1.0
        lines.append(
            f"| {cell} | {s['mpjpe_mm']:.2f} | "
            f"{s.get('mpjpa_deg', float('nan')):.2f} | "
            f"{s['pck_auc']:.4f} | {s['success_rate'] * 100:.1f}% | "
            f"{acc / gt_acc:.1f}x | "
            f"{ref_txt} |"
        )
    return lines


def write_results_md(args, summaries: dict):
    """``{out_dir}/RESULTS.md``: the four-cell table of ``summaries``
    (``load_eval``'s) and the training trajectory of
    ``{out_dir}/history_train.json`` when there is one."""
    from ..metrics import MPJPA_CAVEAT

    lines = [
        "# RESULTS — self-consistent synthetic benchmark (PyTorch port)",
        "",
        "Four-cell eval-protocol table on *rendered synthetic* sequences "
        "(the reference's UmeTrack_data and pretrained weights are not "
        "distributed), written by `umetrack_torch/scripts/accuracy_loop.py`.  "
        "Eval runs the port's apps (`run_eval_known_skeleton`, "
        "`run_eval_unknown_skeleton` → `load_eval`) on held-out sequences "
        "from a reserved seed band with per-sequence GT hand scales the "
        "model never saw, rendered by the capsule ray tracer "
        "(`utils/render.py`).",
        "",
        f"- checkpoint: `{os.path.relpath(args.ckpt, REPO)}`",
        f"- eval: {args.eval_seqs} sequences x {args.eval_frames} frames "
        f"per cell, dtype={args.dtype}",
        "- seed partition: train corpus 5000+, monitoring eval 905000+, "
        "gate 901, eval apps 1000000+ (`--seed-base`) — disjoint bands, "
        "so held-out means held-out on the motion axis too.",
        "- reference column: the reference's published numbers on *real* "
        "UmeTrack_data — context, not a like-for-like comparison.",
        "- " + MPJPA_CAVEAT,
        "",
    ]
    lines += results_rows(summaries)
    lines += [
        "",
        "PCK-AUC is normalized to [0, 1] over 0-50 mm thresholds; the "
        "reference prints the same quantity x100.  Accel (x GT) is the "
        "tracked mean 2nd-difference keypoint acceleration over the GT's.",
    ]
    lines += _trajectory_section(os.path.join(args.out_dir, "history_train.json"))
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "RESULTS.md")
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    print(f"wrote {path}", flush=True)
    print(json.dumps(summaries, indent=2))
    return path


def _trajectory_section(hist_path):
    """The training-trajectory table of a resident trainer's history JSON
    (about 12 evaluated rows and the last), so a reader can tell a plateau
    from truncated training."""
    if not os.path.exists(hist_path):
        return []
    with open(hist_path) as fp:
        hist = json.load(fp)
    rows = [h for h in hist if "eval_mpjpe_mm" in h]
    lines = [
        "",
        "## Training trajectory",
        "",
        f"Device-resident TBPTT training (`{os.path.basename(hist_path)}`; "
        "monitoring eval = the held-out sequences of the 905000+ band, "
        "window 8, on-device metric — not the full eval protocol above):",
        "",
        "| step | train loss | train angle MSE (rad^2) | eval MPJPE (mm) "
        "| eval MPJPA (deg) |",
        "|---|---|---|---|---|",
    ]
    step_stride = max(len(rows) // 12, 1)
    sampled = rows[::step_stride]
    # the final row only when the stride did not already land on it
    if rows and (not sampled or sampled[-1] is not rows[-1]):
        sampled.append(rows[-1])
    for h in sampled:
        lines.append(
            f"| {h['step']} | {h['loss']:.4f} | {h['angle_loss']:.5f} | "
            f"{h['eval_mpjpe_mm']:.1f} | {h['eval_mpjpa_deg']:.2f} |"
        )
    lines += [
        "",
        "The error decomposition at the end of training (resident_diagnose, "
        "train and held-out split) is in `diagnose_train.json` beside the "
        "history.",
    ]
    return lines


def build_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("phase", choices=["corpus", "train", "train-tracker", "eval", "all"])
    p.add_argument("--tracker-seqs", type=int, default=96)
    p.add_argument("--corpus-root", default=DEFAULT_CORPUS)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-test", type=int, default=16)
    p.add_argument("--corpus-t", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt", default=None,
                   help=f"the checkpoint trained or evaluated (default {{out_dir}}/{CHECKPOINT_NAME})")
    p.add_argument("--init-ckpt", default=None, help="resume training from an existing checkpoint")
    p.add_argument("--w-points", type=float, default=20.0,
                   help="wrist-point loss weight (see _train_config)")
    p.add_argument("--eval-root", default=os.path.join(REPO, "eval_out"))
    p.add_argument("--eval-seqs", type=int, default=8)
    p.add_argument("--eval-frames", type=int, default=64)
    p.add_argument("--dtype", default="auto")
    p.add_argument("--device", default=None,
                   help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'")
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                   help="where the checkpoint and RESULTS.md go")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resolve_device(args.device)  # no GPU and no --device cpu: raise before any work
    if args.ckpt is None:
        args.ckpt = os.path.join(args.out_dir, CHECKPOINT_NAME)
    if args.phase in ("corpus", "all"):
        phase_corpus(args)
    if args.phase in ("train", "all"):
        phase_train(args)
    if args.phase == "train-tracker":
        phase_train_tracker(args)
    if args.phase in ("eval", "all"):
        phase_eval(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
