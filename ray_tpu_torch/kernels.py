"""Build, bind and launch the port's hand-written Hopper kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface (`_build/<name>-<source hash>.so`, built
at first use, all sources compiled in parallel) and loaded with ctypes.
Pointers come from `data_ptr()`, the stream from PyTorch's current
stream. The wrappers check device, dtype, shape, strides and alignment
and raise on anything the kernel does not take; they allocate outputs
with `torch.empty`, raise if the launch returned a CUDA error, and add
one to `LAUNCHES[name]` for every launch.

Nothing here falls back to a plain version: the callers in `ops/` choose
the plain PyTorch version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_SOURCES = ("flash_fwd", "ce_fwd")
_LOG2E = 1.4426950408889634

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in _SOURCES}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _bind(lib: ctypes.CDLL, name: str) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    if name == "flash_fwd":
        fn = lib.flash_fwd_bf16
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i] + [ll] * 9 \
            + [i, f, p]
    else:
        fn = lib.ce_fwd_bf16
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.ce_fwd_takes.argtypes = [i, i]
        lib.ce_fwd_takes.restype = i
    fn.restype = i


def build() -> Dict[str, str]:
    """Compile (where no build of the current source exists) and load
    every kernel library. Returns each newly compiled source's nvcc
    output (register and shared-memory use from `-Xptxas -v`)."""
    with _lock:
        _BUILD.mkdir(exist_ok=True)
        pending = []
        for name in _SOURCES:
            if name in _libs:
                continue
            src = _CSRC / f"{name}.cu"
            digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
            so = _BUILD / f"{name}-{digest}.so"
            proc = None
            if not so.exists():
                tmp = _BUILD / f"{name}-{digest}.so.{os.getpid()}.tmp"
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", str(tmp), str(src)]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                pending.append((name, so, tmp, proc))
            else:
                pending.append((name, so, None, None))
        logs: Dict[str, str] = {}
        for name, so, tmp, proc in pending:
            if proc is not None:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
                os.replace(tmp, so)
                logs[name] = out
            lib = ctypes.CDLL(str(so))
            _bind(lib, name)
            _libs[name] = lib
        return logs


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _bthd_strides(t: torch.Tensor, name: str) -> Tuple[int, int, int]:
    """(batch, time, head) strides in elements of a [B, T, H, D] tensor,
    checked for the kernel's 16-byte vector loads."""
    sb, st, sh, sd = t.stride()
    if sd != 1 or sb % 8 or st % 8 or sh % 8 or t.data_ptr() % 16:
        raise ValueError(f"flash_fwd: {name} needs unit stride on head_dim "
                         f"and 16-byte aligned rows, got {t.stride()}")
    return sb, st, sh


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward on the card. q [B, Tq, H, D], k/v [B, Tk, H, D],
    bf16 CUDA tensors, D 64 or 128. Returns O [B, Tq, H, D] bf16 and the
    natural-log LSE [B*H, Tq] fp32."""
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        raise ValueError("flash_fwd: q, k, v must be CUDA tensors on one "
                         "device")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"flash_fwd: bf16 only, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_fwd: q [B, Tq, H, D], k/v [B, Tk, H, D]")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash_fwd: k/v shape {tuple(k.shape)} vs q "
                         f"{tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_fwd: head_dim {d} not in (64, 128)")
    if tq == 0 or tk == 0 or b * h == 0:
        raise ValueError("flash_fwd: empty input")
    if causal and tq > tk:
        raise ValueError("flash_fwd: causal attention needs tq <= tk "
                         "(queries align to the end of the kv sequence)")
    strides = (_bthd_strides(q, "q") + _bthd_strides(k, "k")
               + _bthd_strides(v, "v"))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=dev)
    lib = _lib("flash_fwd")
    err = lib.flash_fwd_bf16(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, tq, tk, d, *strides, int(causal),
        sm_scale * _LOG2E, torch.cuda.current_stream(dev).cuda_stream)
    _launched("flash_fwd", err)
    return o, lse


def ce_fwd_supported(d: int, dtype: torch.dtype,
                     device: torch.device) -> bool:
    """Whether ce_fwd takes rows of width d in this dtype on this CUDA
    device: bf16, and what `ce_fwd_takes` in csrc/ce_fwd.cu says of d (a
    multiple of 16, the x tile within the device's shared memory). Builds
    the kernel on first use."""
    if dtype != torch.bfloat16:
        return False
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    ok = _lib("ce_fwd").ce_fwd_takes(index, d)
    if ok < 0:
        raise RuntimeError(f"ce_fwd_takes: CUDA error {-ok}")
    return ok == 1


def _ce_splits(n: int, v: int, device: torch.device) -> int:
    """Vocab splits per 64-row tile: enough CTAs to cover the SMs once
    (a CTA's 170 KB of shared memory at d = 768 keeps one per SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms // ((n + 63) // 64), (v + 255) // 256))


def ce_fwd(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
           vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row CE of x @ w.T on the card. x [N, d], w [V, d] contiguous
    bf16 CUDA tensors (rows >= vocab_size masked), targets [N] int64.
    Returns (loss [N], lse [N]) fp32."""
    dev = x.device
    if not (x.is_cuda and w.device == dev and targets.device == dev):
        raise ValueError("ce_fwd: x, w, targets must be CUDA tensors on "
                         "one device")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"ce_fwd: x [N, d], w [V, d], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, d = x.shape
    v = w.shape[0]
    if w.dtype != x.dtype or not ce_fwd_supported(d, x.dtype, dev):
        raise ValueError(f"ce_fwd: needs bf16 and d % 16 == 0 within "
                         f"shared memory, got {x.dtype}/{w.dtype}, d={d}")
    if targets.dtype != torch.int64 or targets.shape != (n,):
        raise ValueError(f"ce_fwd: targets must be int64 [{n}]")
    if not (x.is_contiguous() and w.is_contiguous()
            and targets.is_contiguous()):
        raise ValueError("ce_fwd: inputs must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ce_fwd: x and w must be 16-byte aligned")
    if n == 0 or not 0 < vocab_size <= v:
        raise ValueError(f"ce_fwd: n={n}, vocab_size={vocab_size}, V={v}")
    splits = _ce_splits(n, v, dev)
    loss = torch.empty(n, dtype=torch.float32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    # per-split (max, sum-exp, target logit) of every row, merged by the
    # kernel's second pass
    part = torch.empty(3 * 4 * splits * n, dtype=torch.float32, device=dev)
    lib = _lib("ce_fwd")
    err = lib.ce_fwd_bf16(dev.index, x.data_ptr(), w.data_ptr(),
                          targets.data_ptr(), loss.data_ptr(),
                          lse.data_ptr(), part.data_ptr(), n, d, v,
                          vocab_size, splits,
                          torch.cuda.current_stream(dev).cuda_stream)
    _launched("ce_fwd", err)
    return loss, lse
