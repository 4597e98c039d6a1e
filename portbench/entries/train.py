"""The device-resident trainer: ``resident_train_step`` steps back to back on
windows of a corpus held on the card, as ``run_resident_training``'s loop.

Set-up renders the corpus's sequences, has the program crop them with the
tracker's own preparation (one pool warp for every frame) into its
``ResidentCorpus``, draws flax's initial weights from the seed on the
card, and builds ONE training object (model, ``ClippedAdamW`` with the
recipe's warmup-cosine schedule, the augmentation's generator), which it
drives through its first ``checked_steps`` steps (the first one eager and
captured, the rest replays) before handing that same object to the window.
Each step draws its window on the host with the benchmark's copy of
``draw_window`` (16 sequences, a start, one pinned copy) and calls the
program's step without waiting for it.

The comparison follows those first steps with the reference, from the same
initial weights, on a corpus the reference cuts itself from the same
rendered frames, with the same windows and a generator seeded alike:

- ``loss_gap``: each step's loss, relative to the reference's;
- ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step, over 1 - beta1), by the worst leaf: the gap
  between the two norms of a leaf over the larger of the reference's norm
  of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over the checked steps, by the
  worst leaf, measured the same way.

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding, such as a bias under a normalisation) are left
out of both leaf numbers.
"""
from __future__ import annotations

import importlib
import statistics

import numpy as np
import torch

from .. import yardstick
from ..reference import exact_float32
from ..sides import PROGRAM, REFERENCE, side
from ..traffic import render_recording
from ..weights import state_dict_for

NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def draw_window(rng: np.random.Generator, n_sequences: int, seqs_per_batch: int, n_starts: int,
                device: torch.device):
    """A step's (sequence indices [Bs], window start) drawn on the host
    (``choice``, then ``integers``) and sent to ``device`` in one copy that
    does not wait for the device's queue (pinned memory).  A copy of the
    port's ``parallel/resident.py::draw_window``."""
    idx = rng.choice(n_sequences, size=seqs_per_batch, replace=n_sequences < seqs_per_batch)
    t0 = rng.integers(0, n_starts)
    host = torch.from_numpy(np.append(idx, t0).astype(np.int64))
    if device.type == "cuda":
        host = host.pin_memory()
    both = host.to(device, non_blocking=True)
    return both[:-1], both[-1]


def corpus_arrays(sd, rec, tcfg, sampler: str) -> dict:
    """The crop material of every rendered frame, cut by side ``sd``'s own
    tracker preparation, as the arrays ``corpus_from_arrays`` takes."""
    tracker = importlib.import_module(f"{sd.package}.tracker.tracker")
    rigs, hands = sd.rig(rec), sd.hand_model(rec.hand)
    seqs = sd.frames(rec, slice(None), torch.arange(rec.n_frames, device=rec.scales.device))
    with torch.no_grad():
        crop_sets, crop_images = tracker._prepare_frames(
            tcfg, rigs.unsqueeze_batch(1), seqs, hands.unsqueeze_batch(1), 1, sampler)

    def host(a):
        return a.cpu().numpy()

    return dict(
        images=host(crop_images.float()), intrinsics=host(crop_sets.intrinsics.float()),
        T_world_from_eye=host(crop_sets.T_world_from_eye.float()), view_valid=host(crop_sets.view_valid),
        hand_valid=host(crop_sets.hand_valid), n_views=host(crop_sets.n_views.to(torch.int32)),
        angles=host(rec.frames["gt_joint_angles"]), wrists_mm=host(rec.frames["gt_wrist_xfs"]),
        hand_model_mm_batched=hands.map(lambda a: a.cpu()), scales=host(rec.scales),
    )


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        device = ctx.device
        from umetrack_torch.parallel import optim, resident, train

        self.resident = resident
        self.rec = render_recording(ctx.seed, tr["sequences"], tr["frames"], tr["modes"],
                                    tr["hand_scale"], tr["dropout"], device)
        self.init = state_dict_for(ctx.config, ctx.seed, device, ctx.root)
        port = side(PROGRAM)
        tcfg = port.tracker_config(ctx.config)
        self.corpus = resident.corpus_from_arrays(
            **corpus_arrays(port, self.rec, tcfg, tcfg.resolved_sampler(device)), device=device)
        model = port.model(ctx.config, self.init, device, ctx.compute_dtype)
        schedule = optim.warmup_cosine_decay_schedule(*self.schedule_args())
        self.state = train.create_train_state(
            model, optim.ClippedAdamW(model.parameters(), schedule, tr["weight_decay"], max_grad_norm=1.0))
        self.weights = train.LossWeights(**tr["loss_weights"])
        self.window = min(tr["window"], self.corpus.n_frames)
        self.rng = np.random.default_rng(ctx.seed)
        self.generator = torch.Generator(device=device).manual_seed(ctx.seed) if tr["augment"] else None
        # the first steps, kept for the comparison; the first one captures
        self.windows, self.losses = [], []
        for i in range(tr["checked_steps"]):
            self.step()
            self.windows.append(self.last_window)
            self.losses.append(self.last_metrics["loss"])
            if i == 0:
                self.first_moment = {name: self.state.optimizer.state[p]["exp_avg"].clone()
                                     for name, p in model.named_parameters()}
        self.changed = {name: p.detach().clone() for name, p in model.named_parameters()}

    def schedule_args(self) -> tuple:
        tr = self.ctx.traffic
        lr, steps = tr["learning_rate"], tr["num_steps"]
        return 0.0, lr, min(tr["warmup_steps"], max(steps // 10, 1)), steps, lr * 0.01

    def step(self) -> int:
        ctx = self.ctx
        with ctx.spans("step"):
            seq_idx, t0 = draw_window(self.rng, self.corpus.n_sequences, ctx.traffic["seqs_per_batch"],
                                      self.corpus.n_frames - self.window + 1, ctx.device)
            self.last_metrics = self.resident.resident_train_step(
                self.state, self.corpus, seq_idx, t0, self.weights, self.window, self.generator)
        self.last_window = (seq_idx, t0)
        return 1

    def drain(self) -> None:
        self.ctx.sync()

    def release(self) -> None:
        from umetrack_torch.tracker import compiled

        compiled.release()
        del self.state, self.corpus, self.last_metrics
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def check(self, readings) -> dict:
        ctx, tr = self.ctx, self.ctx.traffic
        ref = side(REFERENCE)
        rt = importlib.import_module(f"{REFERENCE}.train")
        device = ctx.device
        tcfg = ref.tracker_config(ctx.config)
        corpus = rt.corpus_from_arrays(**corpus_arrays(ref, self.rec, tcfg, "plain"), device=device)
        model = ref.model(ctx.config, self.init, device)
        params = dict(model.named_parameters())
        optimizer = rt.ClippedAdamW(params.values(), rt.WarmupCosineDecay(*self.schedule_args()),
                                    tr["weight_decay"], max_grad_norm=1.0)
        weights = rt.LossWeights(**tr["loss_weights"])
        generator = torch.Generator(device=device).manual_seed(ctx.seed) if tr["augment"] else None
        losses = []
        with exact_float32():
            for i, (seq_idx, t0) in enumerate(self.windows):
                def step():
                    return rt.train_step(model, optimizer, corpus, seq_idx, t0, weights, self.window,
                                         generator)
                if i == 0 and ctx.trace and ctx.on_card:
                    metrics, readings.flops_per_call = yardstick.count_flops(step)
                else:
                    metrics = step()
                losses.append(metrics["loss"])
                if i == 0:
                    first_moment = {n: optimizer.state[p]["exp_avg"].clone() for n, p in params.items()}
        b1 = optimizer.param_groups[0]["betas"][0]
        grads = {n: float(m.double().norm()) / (1 - b1) for n, m in first_moment.items()}
        got_grads = {n: float(m.double().norm()) / (1 - b1) for n, m in self.first_moment.items()}
        floor = statistics.median(grads.values())
        kept = [n for n, g in grads.items() if g >= NEGLIGIBLE * floor]
        init = {n: v.to(device) for n, v in self.init.items()}
        change = {n: float((p.detach().double() - init[n].double()).norm()) for n, p in params.items()}
        got_change = {n: float((p.double() - init[n].double()).norm()) for n, p in self.changed.items()}
        return {
            "loss_gap": max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(self.losses, losses)),
            "grad_gap": worst_leaf(got_grads, grads, kept),
            "change_gap": worst_leaf(got_change, change, kept),
        }


def worst_leaf(got: dict, want: dict, leaves) -> float:
    """The largest gap between a leaf's two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    floor = statistics.median(want[n] for n in leaves)
    return max(abs(got[n] - want[n]) / max(want[n], floor) for n in leaves)
