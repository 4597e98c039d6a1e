"""The port's accuracy loop (``umetrack_torch/scripts/accuracy_loop.py``)
against the JAX package's ``scripts/accuracy_loop.py`` on the CPU: the
results table written from the same summaries and training history, the
four-cell evaluation through the port's eval apps with the round-5
checkpoint, and the corpus -> train -> train-tracker chain at a tiny size.
Nothing here writes a tracked file: every output goes to a temporary
folder."""
import argparse
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from scripts import accuracy_loop as jal
from umetrack_torch.scripts import accuracy_loop as al
from umetrack_torch.utils.checkpoints import load_checkpoint
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5_CHECKPOINT = os.path.join(REPO, "checkpoints", "synthetic_r5.msgpack")
CELL_NAMES = [f"{mode}/{protocol}" for mode, protocol in al.CELLS]


def _summaries(seed):
    """``load_eval``-shaped summaries, one per cell, drawn with numpy (one
    cell without accelerations, as a 2-frame eval gives)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, cell in enumerate(CELL_NAMES):
        out[cell] = dict(
            n_total_frames=128, n_tracked_frames=int(rng.integers(100, 128)),
            success_rate=float(rng.uniform(0.5, 1.0)), mpjpe_mm=float(rng.uniform(10, 60)),
            pck_auc=float(rng.uniform(0.1, 0.9)), mpjpa_deg=float(rng.uniform(5, 20)),
            mean_keypoint_acceleration=float("nan") if i == 3 else float(rng.uniform(0.1, 20)),
            gt_mean_keypoint_acceleration=float("nan") if i == 3 else float(rng.uniform(0.05, 0.2)),
        )
    return out


def test_results_table_matches_the_jax_writer(tmp_path, monkeypatch):
    """The JAX writer (its ``REPO`` moved to a temporary folder, so the
    repository's RESULTS.md and checkpoints/ are never touched) and the
    port's, given the same summaries and the JAX round-5 history: the same
    table and trajectory rows, byte for byte."""
    jax_root, out_dir = tmp_path / "jax", tmp_path / "port"
    (jax_root / "checkpoints").mkdir(parents=True)
    out_dir.mkdir()
    for folder in (jax_root / "checkpoints", out_dir):
        shutil.copy(os.path.join(REPO, "checkpoints", "history_train.json"), folder)
    monkeypatch.setattr(jal, "REPO", str(jax_root))
    summaries = _summaries(0)
    args = argparse.Namespace(ckpt=R5_CHECKPOINT, eval_seqs=8, eval_frames=64, dtype="auto",
                              out_dir=str(out_dir))
    jal.write_results_md(args, summaries)
    path = al.write_results_md(args, summaries)
    assert path == str(out_dir / "RESULTS.md")

    def rows(p):
        with open(p, encoding="utf-8") as fp:
            return [line for line in fp.read().splitlines() if line.startswith("|")]

    jrows, ours = rows(jax_root / "RESULTS.md"), rows(path)
    assert len(ours) == 2 + 4 + 2 + 13 and ours == jrows
    assert ours[2:6] == al.results_rows(summaries)[2:]


def test_eval_runs_the_four_cells_on_the_cpu(tmp_path, capsys):
    """``accuracy_loop eval`` with the round-5 capsule checkpoint on one
    sequence of 3 frames per cell: four result folders, ``load_eval``'s
    four summaries with finite MPJPE / MPJPA / PCK-AUC, and a four-row
    table in ``{out_dir}/RESULTS.md``."""
    eval_root, out_dir = tmp_path / "eval", tmp_path / "out"
    assert al.main([
        "eval", "--ckpt", R5_CHECKPOINT, "--eval-seqs", "1", "--eval-frames", "3",
        "--device", "cpu", "--eval-root", str(eval_root), "--out-dir", str(out_dir),
    ]) == 0
    for mode, protocol in al.CELLS:
        folder = eval_root / f"eval_results_{mode}" / "real" / protocol / "synthetic"
        assert sorted(os.listdir(folder)) == ["seq_0000.npy"]
    text = capsys.readouterr().out
    summaries = json.loads(text[text.index("{", text.index(f"wrote {out_dir}")):])
    assert list(summaries) == CELL_NAMES
    for s in summaries.values():
        assert s["n_total_frames"] == 2 * 3 and s["success_rate"] > 0
        assert all(math.isfinite(s[k]) for k in ("mpjpe_mm", "mpjpa_deg", "pck_auc"))
    with open(out_dir / "RESULTS.md", encoding="utf-8") as fp:
        table = [line for line in fp.read().splitlines() if line.startswith("| ") and "/" in line
                 and not line.startswith("| Cell")]
    assert [line.split(" | ")[0][2:] for line in table] == CELL_NAMES


def test_corpus_train_and_tracker_fine_tune_chain(tmp_path):
    """``corpus`` -> ``train`` -> ``train-tracker`` at a tiny size: each
    phase's checkpoint loads, and the fine-tune starts from the torch_data
    checkpoint's weights."""
    common = [
        "--device", "cpu", "--corpus-root", str(tmp_path / "corpus"), "--out-dir", str(tmp_path),
        "--n-train", "2", "--n-test", "1", "--corpus-t", "3", "--steps", "2", "--batch-size", "2",
        "--window", "2", "--tracker-seqs", "1",
    ]
    al.main(["corpus"] + common)
    assert sorted(os.listdir(tmp_path / "corpus" / "synthetic")) == ["testing", "training"]
    al.main(["train"] + common)
    first = load_checkpoint(str(tmp_path / "synthetic.msgpack"))
    tracker_ckpt = str(tmp_path / "tracker")  # an orbax directory
    al.main(["train-tracker", "--init-ckpt", str(tmp_path / "synthetic.msgpack"),
             "--ckpt", tracker_ckpt] + common)
    second = load_checkpoint(tracker_ckpt)
    assert set(first) == set(second)
    assert all(torch.isfinite(v).all() for v in second.values() if v.is_floating_point())
    # step 0 of a warmup updates at learning rate 0; step 1 moves the weights
    moved = [k for k in first if first[k].is_floating_point() and not torch.equal(first[k], second[k])]
    assert moved


@pytest.mark.parametrize("phase", ["corpus", "train", "train-tracker", "eval"])
def test_phases_need_a_gpu_unless_told_cpu(phase, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        al.main([phase, "--out-dir", str(tmp_path)])
