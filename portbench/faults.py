"""Faults planted in the program, to show that the comparison refuses them.

Each fault wraps one of the program's functions for the length of a
``with plant(name):`` block.  The tracking faults wrap the tracker's entry
points; the training faults wrap the resident trainer's window gather and
its optimizer update, so a captured step records the fault.  The exchange
between chips has no fault here: every cell runs on one chip.

- ``state_unchanged``: a step hands back the state it was given;
- ``half_batch``: half of the batch left out: the tracker answers the
  second half of its rows with the first half's answers; the trainer's loss
  is the mean over the first half of its rows only;
- ``answer_altered``: one joint angle of a valid hand in each tracker
  call, or the first gradient leaf of each training step (doubled),
  changed where it is made.
"""
from __future__ import annotations

import contextlib

import torch

TRACKING = ("state_unchanged", "half_batch", "answer_altered")
TRAINING = ("half_batch", "answer_altered")


def applicable(cell: dict, config: dict) -> tuple:
    """The faults a cell can have: a cell whose every call starts from a
    zero state (the unknown-skeleton protocol) carries no state, so it
    cannot hand one back unchanged."""
    if cell["entry"] == "train":
        return TRAINING
    if config["skeleton"] == "unknown":
        return tuple(f for f in TRACKING if f != "state_unchanged")
    return TRACKING


def _half(a: torch.Tensor, dim: int) -> torch.Tensor:
    n = a.shape[dim]
    keep = a.narrow(dim, 0, n - n // 2)
    return torch.cat([keep, keep.narrow(dim, 0, n // 2)], dim=dim)


def _tracking(name: str, result, state, state_in, rows_dim: int):
    if name == "state_unchanged":
        return result, state_in
    if name == "half_batch":
        return result.map(lambda a: _half(a, rows_dim)), state.map(lambda a: _half(a, 0))
    angles = result.joint_angles.contiguous().clone()
    valid = result.valid.reshape(-1).nonzero()
    slot = int(valid[0]) if len(valid) else 0  # a slot the comparison reads
    angles.view(-1, angles.shape[-1])[slot, 3] += 0.1
    return result.map(lambda a: angles if a is result.joint_angles else a), state


@contextlib.contextmanager
def _patched(module, attr, wrapper):
    original = getattr(module, attr)
    setattr(module, attr, wrapper(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def plant(name: str, training: bool = False):
    """The program with fault ``name`` for the block's length."""
    if training:
        from umetrack_torch.parallel import resident, train

        if name == "half_batch":
            def gather(original):
                def broken(corpus, seq_idx, t0, window, generator=None):
                    batch = original(corpus, seq_idx, t0, window, generator)
                    rows = batch.valid.shape[0]
                    keep = torch.arange(rows, device=batch.valid.device) < rows - rows // 2
                    batch.valid = batch.valid & keep[:, None]
                    return batch
                return broken

            with _patched(resident, "gather_window", gather):
                yield
        elif name == "answer_altered":
            def update(original):
                def broken(total, optimizer):
                    optimizer.zero_grad(set_to_none=False)
                    total.backward()
                    first = next(p for g in optimizer.param_groups for p in g["params"])
                    first.grad.mul_(2.0)
                    optimizer.update()
                return broken

            with _patched(resident, "_update", update), _patched(train, "_update", update):
                yield
        else:
            raise ValueError(f"no training fault {name!r}")
        return
    if name not in TRACKING:
        raise ValueError(f"no tracking fault {name!r}")
    import umetrack_torch.tracker as program

    def batched(original):
        def broken(model, config, rigs, seqs, init_state, *args, **kwargs):
            result, state = original(model, config, rigs, seqs, init_state, *args, **kwargs)
            return _tracking(name, result, state, init_state, 1)
        return broken

    def frame(original):
        def broken(model, config, rig, obs, state_in, *args, **kwargs):
            result, state = original(model, config, rig, obs, state_in, *args, **kwargs)
            return _tracking(name, result, state, state_in, 0)
        return broken

    with _patched(program, "track_sequences_batched", batched), _patched(program, "track_frame", frame):
        yield
