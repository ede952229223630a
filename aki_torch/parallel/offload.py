"""``host_offload_params``: the training state in host memory between steps
(counterpart of JAX's ``pinned_host`` placement of the whole state,
``aki_tpu/train/runner.py:158-175, 215-228``).

The state is every storage behind the model's parameters (a DTensor's
local shard: FSDP2's padded flat shard, a ``tensor`` block, an expert
slice), its buffers and the optimizer's tensors (the AdamW moments and
step counts). :class:`HostOffload` works per distinct storage:

- after the step each storage's bytes are copied into a host byte buffer
  of its own (pinned when the device is a card; allocated once and reused
  while the storage lives), then the storage is resized to 0 bytes;
- before the step each storage is resized back and its bytes copied in
  (``non_blocking`` from pinned memory).

The storages stay the same objects, so every view of them stays valid:
parameters and their DTensors, FSDP2's flat shard, the optimizer's
references, tensor blocks. The step itself is unchanged: AdamW runs on
the device, and the gradients are the step's temporaries (the Trainer
drops them before the state goes out). This is not FSDP2's
``CPUOffloadPolicy``, which steps AdamW on the host and gathers from host
memory inside the step.

On a CPU device the same code runs: the host buffers are plain CPU
tensors, and the storages are emptied all the same.
"""

from __future__ import annotations

import contextlib

import torch


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _bytes(storage: torch.UntypedStorage) -> torch.Tensor:
    """A uint8 tensor over the whole of ``storage``."""
    return torch.empty(0, dtype=torch.uint8, device=storage.device).set_(storage)


class HostOffload:
    """Moves ``state``'s storages (:class:`~aki_torch.train.step.TrainState`:
    its model and optimizer) between ``device`` and host buffers. Each move
    returns the ms its copies took on a card (CUDA events; 0.0 on the CPU)."""

    def __init__(self, state, device: torch.device):
        self.state = state
        self.cuda = device.type == "cuda"
        self.host: dict[int, torch.Tensor] = {}      # storage -> its host bytes
        self.parked: list[tuple[torch.UntypedStorage, torch.Tensor]] = []

    def tensors(self):
        """The state's tensors (DTensors by their local shards)."""
        model, opt = self.state.model, self.state.optimizer.opt
        yield from (_local(t) for t in (*model.parameters(), *model.buffers()))
        for st in opt.state.values():
            yield from (_local(v) for v in st.values() if isinstance(v, torch.Tensor))

    def storages(self) -> list[torch.UntypedStorage]:
        """The distinct storages behind :meth:`tensors` (empty ones too), by
        their ``_cdata`` (the storage object, the same across resizes)."""
        out = {}
        for t in self.tensors():
            st = t.untyped_storage()
            out.setdefault(st._cdata, st)
        return list(out.values())

    def _timed(self, copies) -> float:
        if not self.cuda:
            copies()
            return 0.0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        copies()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    @torch.no_grad()
    def to_host(self) -> float:
        """Copy every storage into its host buffer, then empty it."""
        if self.parked:
            raise RuntimeError("host offload: the state is already on the host")
        live = [st for st in self.storages() if st.nbytes()]
        host = {}
        for st in live:
            buf = self.host.get(st._cdata)
            if buf is None or buf.numel() != st.nbytes():
                buf = torch.empty(st.nbytes(), dtype=torch.uint8, pin_memory=self.cuda)
            host[st._cdata] = buf
        self.host = host          # buffers of storages that died are let go

        def copies():
            for st in live:
                host[st._cdata].copy_(_bytes(st), non_blocking=self.cuda)

        ms = self._timed(copies)
        for st in live:
            st.resize_(0)
        self.parked = [(st, host[st._cdata]) for st in live]
        return ms

    @torch.no_grad()
    def to_device(self) -> float:
        """Give every emptied storage its bytes back from its host buffer."""
        parked, self.parked = self.parked, []

        def copies():
            for st, buf in parked:
                st.resize_(buf.numel())
                _bytes(st).copy_(buf, non_blocking=self.cuda)

        return self._timed(copies)

    @contextlib.contextmanager
    def resident(self):
        """The state on the device inside the block (a checkpoint's save or
        restore), back on the host after it if it was there before."""
        if not self.parked:
            yield
            return
        self.to_device()
        try:
            yield
        finally:
            self.to_host()


def resident(state):
    """``state.offload.resident()``, or nothing to do without an offload."""
    return contextlib.nullcontext() if state.offload is None else state.offload.resident()
