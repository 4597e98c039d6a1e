"""Aggregate per-sequence eval artifacts into summary metrics.

Counterpart of ``umetrack_tpu/apps/load_eval.py``: success rate, mean
keypoint error, PCK-AUC over 0-50 mm, keypoint accelerations, and MPJPA
(mean per-joint angular error, degrees) when the artifacts contain joint
angles.  Artifacts are pickles that the eval apps wrote: point it at
results you produced yourself only.
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import logging
import pickle

from .. import metrics
from ..data import fs

logger = logging.getLogger(__name__)


def aggregate_metrics(output_dir: str) -> dict:
    metrics_all = []
    valid_all = []
    for cur_dir, _, filenames in fs.walk(output_dir):
        for fname in sorted(fnmatch.filter(filenames, "*.npy")):
            with open(fs.join(cur_dir, fname), "rb") as fp:
                data = pickle.load(fp)
            valid_all.append(data["valid_tracking"])
            metrics_all.append(
                metrics.compute_sequence_metrics(
                    data["gt_keypoints"],
                    data["tracked_keypoints"],
                    data["valid_tracking"],
                    gt_joint_angles=data.get("gt_joint_angles"),
                    tracked_joint_angles=data.get("tracked_joint_angles"),
                )
            )
    return metrics.aggregate(metrics_all, valid_all)


def print_summary(summary: dict) -> None:
    if not summary:
        print("  (no artifacts found)")
        return
    print(
        f"  Tracked {summary['n_tracked_frames']} out of "
        f"{summary['n_total_frames']}, success rate: "
        f"{summary['success_rate'] * 100:.2f}%"
    )
    print(f"  Mean keypoint error: {summary['mpjpe_mm']:.4f} mm")
    if "mpjpa_deg" in summary:
        print(f"  MPJPA: {summary['mpjpa_deg']:.4f} deg")
        print(f"  ({metrics.MPJPA_CAVEAT})")
    print(f"  AUC score: {summary['pck_auc']:.4f}")
    print(
        f"  Mean keypoint accelerations: "
        f"{summary['mean_keypoint_acceleration']:.4f}"
    )
    print(
        f"  GT mean keypoint accelerations: "
        f"{summary['gt_mean_keypoint_acceleration']:.4f}"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--results-root", required=True,
                        help="root holding eval_results_*/ dirs, or one dir")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    summaries = {}
    # Either a single artifact dir, or the original project's layout
    # eval_results_{mode}/real/{protocol}.
    candidates = []
    for mode in ["known_skeleton", "unknown_skeleton"]:
        for protocol in ["separate_hand", "hand_hand"]:
            d = fs.join(
                args.results_root, f"eval_results_{mode}", "real", protocol
            )
            if fs.exists(d):
                candidates.append((f"{mode}/{protocol}", d))
    if not candidates:
        candidates = [("all", args.results_root)]

    for name, d in candidates:
        summary = aggregate_metrics(d)
        summaries[name] = summary
        if not args.json:
            print(f"Evaluation for {name}")
            print_summary(summary)
    if args.json:
        print(json.dumps(summaries))
    return summaries


if __name__ == "__main__":
    main()
