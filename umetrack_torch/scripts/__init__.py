"""The accuracy workflow's drivers, each the counterpart of the script of
the same name in the repository's ``scripts/``:

- ``resident_train``: the resident corpus cache (``gen``), the overfit
  probe (``probe``) and the full device-resident training run (``train``);
- ``diagnose_ckpt``: a checkpoint's error split into its terms on a cached
  split;
- ``accuracy_loop``: the torch_data corpus, its training and the tracker
  fine-tune, and the four-cell evaluation through the eval apps into a
  results table.

Each runs with ``python -m umetrack_torch.scripts.<name>``, on the GPU
unless ``--device cpu`` is given.  Histories, checkpoints and the results
table go under ``--out-dir`` (default ``runs_torch/``).
"""
