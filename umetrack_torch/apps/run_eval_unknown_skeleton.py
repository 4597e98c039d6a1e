"""Unknown-skeleton raw_data evaluation (online scale calibration).

Counterpart of ``umetrack_tpu/apps/run_eval_unknown_skeleton.py``: pass 1
tracks with the scale-prediction head on 2-view frames and averages the
first N predicted scales; the generic skeleton scaled by that mean is then
used to retrack the sequence with the known-skeleton protocol (crop cameras
still come from the GT skeleton).  Per-sequence pickles feed ``load_eval``.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

from ..kinematics.hand import VENDORED_HAND_JSON, from_dict, load_generic_hand_dict
from .run_eval_known_skeleton import (
    add_eval_flags,
    make_tracker,
    run_synthetic,
    sequences_to_process,
)
from .sequence_eval import (
    eval_sequence_unknown,
    eval_sequence_unknown_streaming,
    save_artifact,
    sequence_mean_error,
)

logger = logging.getLogger(__name__)

# the generic hand the unknown-skeleton protocol scales (the data asset)
DEFAULT_GENERIC_HAND = VENDORED_HAND_JSON


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_eval_flags(parser)
    parser.add_argument("--generic-hand-model", default=DEFAULT_GENERIC_HAND)
    parser.add_argument("--n-calibration-samples", type=int, default=30)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    tracker = make_tracker(args)
    generic = from_dict(load_generic_hand_dict(args.generic_hand_model))

    if args.synthetic:
        return run_synthetic(
            args, tracker,
            lambda tr, seq: eval_sequence_unknown(tr, seq, generic, args.n_calibration_samples),
        )
    if not args.input_dir:
        parser.error("--input-dir required without --synthetic")
    from ..tracker.video import open_sequence

    errors = []
    for in_path, out_path in sequences_to_process(args):
        logger.info("Processing %s ...", in_path)
        # Streaming two-pass protocol: bounded-memory decode per pass.
        artifact = eval_sequence_unknown_streaming(
            tracker, open_sequence(in_path), generic, args.n_calibration_samples,
            chunk=args.chunk,
        )
        save_artifact(out_path, artifact)
        err = sequence_mean_error(artifact)
        errors.append(err)
        logger.info("%s: mean error %.3f mm", in_path, err)
    if errors:
        logger.info("Final mean error: %.4f mm", float(np.nanmean(errors)))
    return errors


if __name__ == "__main__":
    main()
