"""The batched evaluation: ``track_sequences_batched`` over S sequences x T
frames a call, the frames resident on the device.

Known skeleton (``"skeleton": "known"`` in the configuration): the calls
run back to back, each continuing the previous call's ``TrackState``, as a
long recording tracked in T-frame chunks.  Unknown skeleton: each call is
the two-pass protocol from a zero state, ``calibrate_sequences_batched``
(the scale head on 2-view frames, the mean of the first N valid
predictions), then ``track_sequences_batched`` with each sequence's
calibrated generic skeleton, kept on the device between the two.

Traffic: S sequences of L rendered frames; a call's frames are one entry
of the file's ``calls`` cycle, ``[start, step]`` (frames start, start +
step, ...), so the rendered sequences are played forward and back with no
jump and every row of a call is a distinct frame of a distinct sequence.
Each distinct call's frames are gathered on the device during set-up.

The comparison: a sample of the window's calls drawn from the seed, and
the first call of the set-up (the zero state), each recomputed by the
reference from the same inputs and the program's own state going in.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import compare, yardstick
from ..reference import exact_float32
from ..sides import PROGRAM, REFERENCE, side
from ..traffic import call_frames, generic_hand, render_recording, check_rng
from ..weights import state_dict_for


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.unknown = ctx.config["skeleton"] == "unknown"
        device = ctx.device
        self.rec = render_recording(ctx.seed, tr["sequences"], tr["frames"], tr["modes"],
                                    tr["hand_scale"], tr["dropout"], device)
        self.state_dict = state_dict_for(ctx.config, ctx.seed, device, ctx.root)
        self.frame_idx = [call_frames(c, tr["frames_per_call"]).to(device) for c in tr["calls"]]
        self.port = port = side(PROGRAM)
        self.model = port.model(ctx.config, self.state_dict, device, ctx.compute_dtype)
        self.tcfg = port.tracker_config(ctx.config)
        self.rigs = port.rig(self.rec)
        self.hands = port.hand_model(self.rec.hand)
        self.inputs = [port.frames(self.rec, slice(None), idx) for idx in self.frame_idx]
        s = self.rec.n_sequences
        self.zero = port.zero_state(self.model, 2 * s, device)
        if self.unknown:
            generic = port.hand_model(generic_hand(device))
            self.generic = generic.map(lambda a: a.expand(s, *a.shape))
        self.state = self.zero
        self.records = []  # (call index, state in, result, state out, scales)
        # warm-up: every distinct call once, from the state the window hands on
        for _ in range(max(2, len(self.inputs))):
            self.step()
        self.warmup_calls = len(self.records)

    def step(self) -> int:
        k = len(self.records)
        seqs = self.inputs[k % len(self.inputs)]
        tr = self.ctx.traffic
        port = self.port
        with self.ctx.spans("entry"):
            if self.unknown:
                scales = port.tracker.calibrate_sequences_batched(
                    self.model, self.tcfg, self.rigs, seqs, self.zero, self.hands,
                    n_calibration_samples=tr["n_calibration_samples"], min_num_crops=2,
                    device=self.ctx.device)
                skel = port.hand.scaled_hand_model(self.generic, scales)
                state_in = self.zero
            else:
                scales, skel, state_in = None, None, self.state
            result, state_out = port.tracker.track_sequences_batched(
                self.model, self.tcfg, self.rigs, seqs, state_in, self.hands, 1,
                skel_hand_models_mm=skel, device=self.ctx.device)
        self.state = state_out
        self.records.append((k, state_in, result, state_out, scales))
        return seqs.images.shape[0] * seqs.images.shape[1]

    def drain(self) -> None:
        self.ctx.sync()

    def release(self) -> None:
        from umetrack_torch.tracker import compiled

        compiled.release()
        del self.model
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def sampled(self) -> list:
        """The records compared: the first call, and ``check_calls`` of the
        window's calls drawn from the seed."""
        rng = check_rng(self.ctx.seed)
        pool = np.arange(self.warmup_calls, len(self.records))
        n = min(self.ctx.traffic["check_calls"], len(pool))
        return [self.records[0]] + [self.records[i] for i in sorted(rng.choice(pool, n, replace=False))]

    def _reference_call(self, ref, model, tcfg, rigs, hands, seqs, state_in):
        """(scales or None, result, state out) of one call on the reference."""
        ctx, s = self.ctx, self.rec.n_sequences
        if not self.unknown:
            return (None, *ref.tracker.track_sequences_batched(model, tcfg, rigs, seqs, state_in, hands, 1))
        zero = ref.zero_state(model, 2 * s, ctx.device)
        scales = ref.tracker.calibrate_sequences_batched(
            model, tcfg, rigs, seqs, zero, hands, ctx.traffic["n_calibration_samples"], 2)
        generic = ref.hand_model(generic_hand(ctx.device))
        skel = ref.hand.scaled_hand_model(generic.map(lambda a: a.expand(s, *a.shape)), scales)
        return (scales, *ref.tracker.track_sequences_batched(model, tcfg, rigs, seqs, zero, hands, 1, skel))

    def check(self, readings) -> dict:
        ctx, rec = self.ctx, self.rec
        ref = side(REFERENCE)
        model = ref.model(ctx.config, self.state_dict, ctx.device)
        tcfg = ref.tracker_config(ctx.config)
        rigs, hands = ref.rig(rec), ref.hand_model(rec.hand)
        gaps = []
        with exact_float32():
            if ctx.trace and ctx.on_card:
                self._yardstick(readings, ref, model, tcfg, rigs, hands)
            for k, state_in, result, state_out, scales in self.sampled():
                seqs = ref.frames(rec, slice(None), self.frame_idx[k % len(self.frame_idx)])
                want_scales, want, want_state = self._reference_call(
                    ref, model, tcfg, rigs, hands, seqs, ref.state(state_in))
                if self.unknown:  # every call starts from zero: no state is carried
                    g = compare.tracking_gaps(result, want)
                    g["scale_gap"] = compare.scale_gap(scales, want_scales)
                else:
                    g = compare.tracking_gaps(result, want, state_out, want_state)
                gaps.append(g)
        return compare.widest(gaps)

    def _yardstick(self, readings, ref, model, tcfg, rigs, hands) -> None:
        """The work of a call counted on the reference, and the pool warp's
        least time a call, over the distinct calls' inputs."""
        seqs = ref.frames(self.rec, slice(None), self.frame_idx[0])
        zero = ref.zero_state(model, 2 * self.rec.n_sequences, self.ctx.device)
        _, readings.flops_per_call = yardstick.count_flops(
            lambda: self._reference_call(ref, model, tcfg, rigs, hands, seqs, zero))
        passes = (2, 1) if self.unknown else (1,)
        bounds = []
        for idx in self.frame_idx:
            seqs_k = ref.frames(self.rec, slice(None), idx)
            bounds.append(sum(
                yardstick.pool_warp_bound_s(*ref.tracker.tracker.pool_warp_operands(
                    tcfg, rigs, seqs_k, hands, min_num_crops))
                for min_num_crops in passes))
        readings.warp_bound_s_per_call = sum(bounds) / len(bounds)
        readings.warp_launches_per_call = len(passes)
