"""Serialization: cloudpickle for code/closures, out-of-band buffers for arrays
and tensors.

Mirrors the responsibilities of the reference's
python/ray/_private/serialization.py (cloudpickle + pickle5 out-of-band
buffers + zero-copy numpy reads). Large numpy buffers are extracted
out-of-band (pickle protocol 5) so they can be placed in shared memory
without a copy.

torch tensors take a reducer of their own (`_reduce_tensor`), because
torch's pickling ships a view's whole storage in band, records the CUDA
device index and cannot be loaded where CUDA is absent. A tensor travels
as its dtype name, shape, `requires_grad`, device type and class
(`nn.Parameter` keeps its class), plus the view's bytes as one
out-of-band buffer: a uint8 view of a contiguous host copy, so bfloat16
and every other dtype numpy lacks travel too. A CPU tensor comes back
on the CPU, as a copy of its own: never a view of the buffer, which may
be shared memory other readers map. A CUDA tensor is copied to the host
when it is serialized and comes back on the consumer's current CUDA
device; in a process that
sees no GPU, or that holds no lease whatever it sees (a ray:// client,
`refuse_cuda_loads`), its load raises `GpuLeaseRequiredError`, never a
CPU tensor. torch is found through `sys.modules`: serializing imports it
only for a payload that already holds a tensor.
"""
from __future__ import annotations

import io
import pickle
import sys
import warnings
from typing import Any, List, Optional, Tuple

import cloudpickle


class GpuLeaseRequiredError(RuntimeError):
    """A CUDA tensor was loaded in a process that holds no GPU lease."""


_cuda_refused = False


def refuse_cuda_loads(refuse: bool) -> None:
    """Whether this process refuses CUDA tensors' records even where it
    sees a GPU: a ray:// client holds no lease."""
    global _cuda_refused
    _cuda_refused = refuse


def _reduce_tensor(t):
    import torch

    device_type = t.device.type
    if device_type not in ("cpu", "cuda"):
        raise TypeError(f"cannot serialize a tensor on {t.device}")
    kind = "parameter" if isinstance(t, torch.nn.Parameter) else "tensor"
    host = t.detach()
    if device_type == "cuda":
        host = host.cpu()
    host = host.contiguous()
    # reshape(-1) makes a 0-d tensor 1-d, so it has a byte view too
    data = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (kind, str(t.dtype).removeprefix("torch."), tuple(t.shape),
             bool(t.requires_grad), device_type, pickle.PickleBuffer(data)))


def holds_tensor(meta: bytes) -> bool:
    """Whether a serialized payload may hold a tensor (its meta names
    `_rebuild_tensor`). A false positive only costs a cache."""
    return _TENSOR_MARK in meta


def _rebuild_tensor(kind: str, dtype: str, shape: Tuple[int, ...],
                    requires_grad: bool, device_type: str, buf):
    import torch

    mv = memoryview(buf).cast("B")
    if device_type == "cuda":
        if _cuda_refused or not torch.cuda.is_available():
            raise GpuLeaseRequiredError(
                "a CUDA tensor cannot be loaded here: this process holds "
                "no GPU lease (ask for one with num_gpus=)")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    n = mv.nbytes
    flat = torch.empty(n, dtype=torch.uint8, device=device)
    if n:
        # always a copy: the buffer may be shared memory that other
        # readers map, and a tensor is written in place
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # read-only buf
            src = torch.frombuffer(mv, dtype=torch.uint8)
        flat.copy_(src)
    t = flat.view(getattr(torch, dtype)).reshape(shape)
    if kind == "parameter":
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


_TENSOR_MARK = _rebuild_tensor.__name__.encode()


class _OOBPickler(cloudpickle.CloudPickler):
    """Cloudpickle with protocol-5 out-of-band buffer capture (in band
    when `buffers` is None) and the tensor reducer."""

    def __init__(self, file, buffers: Optional[List[pickle.PickleBuffer]]):
        super().__init__(file, protocol=5,
                         buffer_callback=None if buffers is None
                         else buffers.append)

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def serialize(obj: Any) -> Tuple[bytes, List[memoryview]]:
    """Serialize to (meta_bytes, raw_buffers).

    Buffers are raw memoryviews of large contiguous arrays (numpy,
    tensors' host bytes), suitable for placement in shared memory with
    no extra copy.
    """
    buffers: List[pickle.PickleBuffer] = []
    f = io.BytesIO()
    _OOBPickler(f, buffers).dump(obj)
    views = []
    for b in buffers:
        try:
            views.append(b.raw())
        except BufferError:
            # non-contiguous buffer: fall back to a contiguous copy
            import numpy as np

            views.append(memoryview(np.ascontiguousarray(b)).cast("B"))
    return f.getvalue(), views


def deserialize(meta: bytes, buffers: List[memoryview]) -> Any:
    return pickle.loads(meta, buffers=[pickle.PickleBuffer(b) for b in buffers])


def dumps(obj: Any) -> bytes:
    """In-band serialization (control plane messages, small payloads)."""
    f = io.BytesIO()
    _OOBPickler(f, None).dump(obj)
    return f.getvalue()


def loads(data: bytes) -> Any:
    return pickle.loads(data)
