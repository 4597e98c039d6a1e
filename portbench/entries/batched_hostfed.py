"""The batched evaluation fed from the host: ``known.batched``'s calls, with
each call's frames handed to ``track_sequences_batched`` in pinned host
memory, so that the program's entry copies them to the card in every call.

This is offline evaluation of recorded sessions whose frames are decoded on
the host and tracked in T-frame chunks: every chunk crosses the host link.
Everything else is :mod:`.batched`'s: the traffic, the state carried from
call to call, the warm-up, the comparison with the reference (which reads
the same rendered frames on the device) and the readings behind its
metrics.  Set-up gathers each distinct call's frames once into pinned host
memory, where :mod:`.batched`'s set-up assigns ``inputs``; on the CPU (the tests' rehearsal) they stay in ordinary memory,
since pinning needs CUDA.
"""
from __future__ import annotations

import torch

from . import batched

REHEARSAL = batched.REHEARSAL


class Session(batched.Session):
    @property
    def inputs(self) -> list:
        """Each distinct call's ``FrameObservation``, in host memory."""
        return self._host_inputs

    @inputs.setter
    def inputs(self, on_device: list) -> None:
        pin = self.ctx.on_card

        def host(a: torch.Tensor) -> torch.Tensor:
            return torch.empty(a.shape, dtype=a.dtype, pin_memory=pin).copy_(a)

        self._host_inputs = [obs.map(host) for obs in on_device]
