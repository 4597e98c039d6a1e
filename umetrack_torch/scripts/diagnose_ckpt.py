"""Error decomposition of a checkpoint on the resident corpus (train or
eval split): which term carries the MPJPE (angles against the wrist's
translation and rotation), and whether BatchNorm's batch statistics in
place of its running ones move it.

Counterpart of the repository's ``scripts/diagnose_ckpt.py``; the split is
read from the cache ``resident_train gen`` writes.  Prints the JSON.

    python -m umetrack_torch.scripts.diagnose_ckpt --ckpt runs_torch/r.msgpack --split eval
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..apps.common import resolve_dtype
from ..models import ModelConfig, UmeTrackNet
from ..parallel.resident import resident_diagnose
from ..utils.checkpoints import load_checkpoint
from .resident_train import load_corpus


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-eval", type=int, default=16)
    p.add_argument("--t", type=int, default=16)
    p.add_argument("--split", default="train", choices=["train", "eval"])
    p.add_argument("--seqs", type=int, default=16)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--bn-train", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    tag = (f"train_{args.n_train}_{args.t}" if args.split == "train"
           else f"eval_{args.n_eval}_{args.t}")
    corpus = load_corpus(tag, device)
    config = ModelConfig(compute_dtype=resolve_dtype(args.dtype))
    model = UmeTrackNet(config)
    model.load_state_dict(load_checkpoint(args.ckpt, config))
    model.to(device)
    idx = torch.as_tensor(np.arange(args.seqs) % corpus.n_sequences, device=device)
    out = resident_diagnose(model, corpus, idx, 0, args.window, bn_train=args.bn_train)
    out = {k: float(v) for k, v in out.items()}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
