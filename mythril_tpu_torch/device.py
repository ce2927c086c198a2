"""Device resolution for the port's entry points.

Entry points take `device=None`, which means the CUDA card. A caller that
asks for the card on a machine without one gets an error, never a silent
run on the CPU; `device="cpu"` is for tests, which run the plain twins."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The torch.device an entry point should place its tensors on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mythril_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_COPY_STREAMS = {}


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's side stream for work that lands on the host while the
    current stream goes on (one a device, made at first use)."""
    side = _COPY_STREAMS.get(device)
    if side is None:
        side = _COPY_STREAMS[device] = torch.cuda.Stream(device=device)
    return side


def start_host_copy(tensors):
    """Start copying `tensors` to the host; returns (host tensors, event).

    On the card the copies run on a side stream, after everything queued on
    the current stream so far, into pinned memory, so the current stream
    can go on with the next chunk while they stream; `event.synchronize()`
    waits for them. CPU tensors are returned as they are, with no event."""
    tensors = list(tensors)
    if not tensors or not tensors[0].is_cuda:
        return tensors, None
    dev = tensors[0].device
    side = copy_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    hosts = []
    with torch.cuda.stream(side):
        for tensor in tensors:
            host = torch.empty(tensor.shape, dtype=tensor.dtype,
                               pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            tensor.record_stream(side)
            hosts.append(host)
        event = torch.cuda.Event()
        event.record(side)
    return hosts, event


def wait_host_copy(event) -> None:
    """Block until the copies behind a `start_host_copy` event landed."""
    if event is not None:
        event.synchronize()
