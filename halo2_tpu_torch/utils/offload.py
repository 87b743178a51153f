"""Moving device tensors to host memory and back, for the large-k prover.

At 2^22 rows the Lagrange SRS (512 MiB) and a proving key's Lagrange forms
(fixed columns and permutation sigmas, 256 MiB a column) are dead once the
last Lagrange-basis commitment of a proof is made; `start_offload` copies
them to host memory while the prover goes on, and `HostCopy.join` frees
their device memory before the extended-domain phases need it (the
reference's background-thread offloads, commitment.py:188-221 and
keygen.py:199-234).

On the card the copy runs on a side CUDA stream into pinned memory, after
the work the current stream has enqueued; the pending copy holds the
device tensors until `join` has waited for its event, so the caching
allocator cannot hand their memory to the current stream while the side
stream still reads it.  On the CPU it is a copy into another CPU tensor
through the same states, so the tests run it.
"""

from __future__ import annotations

import torch

_side_streams: dict = {}


def _side_stream(device: torch.device):
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    return stream


class HostCopy:
    """Host copies of some device tensors, in flight until join()."""

    def __init__(self, tensors):
        self._device_tensors = list(tensors)
        self.device = self._device_tensors[0].device
        if self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            side = _side_stream(self.device)
            side.wait_stream(main)
            self._hosts = [torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                           for t in self._device_tensors]
            with torch.cuda.stream(side):
                for host, t in zip(self._hosts, self._device_tensors):
                    host.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(side)
        else:
            self._hosts = [t.clone() for t in self._device_tensors]
            self._event = None

    def join(self) -> list:
        """Wait for the copies, let the device tensors go, and return the
        host tensors."""
        if self._event is not None:
            self._event.synchronize()
        self._device_tensors = None
        return self._hosts


def onload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host copy back on `device` (asynchronous from pinned memory on
    the card; on the CPU the host tensor itself)."""
    return host.to(device, non_blocking=True)
