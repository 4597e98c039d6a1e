"""The real-time tracker: ``track_frame`` on one headset, a closed loop.

One rig and two hands; each frame is handed over when the previous pose is
back on the host, since the state carries.  A frame's four uint8 views and
its per-frame labels sit in pinned host memory, as a camera driver would
leave them, and the entry moves them to the card itself.  A rendered
sequence is replayed forward and back (no jump where it turns).  Each
frame is timed on the host clock from the call to the moment its pose
(joint angles and wrist transforms) is readable on the host.

The comparison: a sample of the window's frames drawn from the seed, and
the first frame of the set-up (the zero state), each recomputed by the
reference from the same frame and the program's own state going in.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare
from ..reference import exact_float32
from ..sides import PROGRAM, REFERENCE, side
from ..traffic import FRAME_FIELDS, pingpong, render_recording, check_rng
from ..weights import state_dict_for

WARMUP_FRAMES = 3  # the capture, then replays from the carried state's strides
# The CPU tests' rehearsal of a cell on this entry (never read by a run):
# its traffic cut to a few rendered frames, since the CPU renders ~2 s a frame.
REHEARSAL = dict(frames=3, check_frames=2)


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        device = ctx.device
        self.rec = render_recording(ctx.seed, 1, tr["frames"], tr["modes"], tr["hand_scale"],
                                    tr["dropout"], device)
        self.state_dict = state_dict_for(ctx.config, ctx.seed, device, ctx.root)
        self.port = port = side(PROGRAM)
        self.model = port.model(ctx.config, self.state_dict, device, ctx.compute_dtype)
        self.tcfg = port.tracker_config(ctx.config)
        self.rig = port.rig(self.rec, 0)
        self.hand = port.hand_model(self.rec.hand, 0)
        pin = ctx.on_card

        def host(a):
            a = a.cpu()
            return a.pin_memory() if pin else a

        self.host_frames = [
            port.tracker.FrameObservation(**{k: host(self.rec.frames[k][0, f]) for k in FRAME_FIELDS})
            for f in range(self.rec.n_frames)]
        self.order = pingpong(self.rec.n_frames)
        self.state = port.zero_state(self.model, 2, device)
        self.records = []  # (frame index, state in, result, state out)
        self.latencies_s = []
        for _ in range(WARMUP_FRAMES):
            self.step()
        self.latencies_s.clear()

    def step(self) -> int:
        f = self.order[len(self.records) % len(self.order)]
        spans = self.ctx.spans
        t0 = time.perf_counter()
        with spans("entry"):
            result, state_out = self.port.tracker.track_frame(
                self.model, self.tcfg, self.rig, self.host_frames[f], self.state, self.hand, 1,
                known=True, device=self.ctx.device)
        with spans("readback"):
            result.joint_angles.cpu()
            result.wrist_xfs.cpu()
        self.latencies_s.append(time.perf_counter() - t0)
        self.records.append((f, self.state, result, state_out))
        self.state = state_out
        return 1

    def drain(self) -> None:
        self.ctx.sync()

    def release(self) -> None:
        from umetrack_torch.tracker import compiled

        compiled.release()
        del self.model
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def check(self, readings) -> dict:
        ctx, rec = self.ctx, self.rec
        ref = side(REFERENCE)
        model = ref.model(ctx.config, self.state_dict, ctx.device)
        tcfg = ref.tracker_config(ctx.config)
        rig, hand = ref.rig(rec, 0), ref.hand_model(rec.hand, 0)
        rng = check_rng(ctx.seed)
        pool = np.arange(WARMUP_FRAMES, len(self.records))
        n = min(ctx.traffic["check_frames"], len(pool))
        picked = [0] + sorted(rng.choice(pool, n, replace=False).tolist())
        gaps = []
        with exact_float32():
            for i in picked:
                f, state_in, result, state_out = self.records[i]
                want, want_state = ref.tracker.track_frame(
                    model, tcfg, rig, ref.frames(rec, 0, f), ref.state(state_in), hand, 1, True)
                gaps.append(compare.tracking_gaps(result, want, state_out, want_state))
        return compare.widest(gaps)
