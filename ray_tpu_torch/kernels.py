"""Build, bind and launch the port's hand-written Hopper kernels.

Each `csrc/<name>.cu` (with the shared `csrc/common.cuh`) is compiled by
`nvcc` for sm_90a into a shared library with a plain C interface
(`_build/<name>-<source hash>.so`, built at first use, all sources
compiled in parallel) and loaded with ctypes.
Pointers come from `data_ptr()`, the stream from PyTorch's current
stream (`ce_bwd` also forks a side stream from it and joins it back). The
wrappers check device, dtype, shape, strides and alignment
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
from typing import Dict, Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_SOURCES = ("flash_fwd", "flash_bwd", "ce_fwd", "ce_bwd")
_LOG2E = 1.4426950408889634

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused",
    "ce_fwd", "ce_probs", "ce_dx", "ce_dw")}
# bytes of the CE backward's bf16 probability scratch, at most
CE_SCRATCH_BYTES = 128 << 20

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
        fns = [(lib.flash_fwd_bf16, [i, p, p, p, p, p, i, i, i, i, i]
                + [ll] * 9 + [i, f, p])]
    elif name == "flash_bwd":
        fns = [(lib.flash_bwd_dq_bf16, [i] + [p] * 7 + [i] * 5 + [ll] * 12
                + [i, f, f, p]),
               (lib.flash_bwd_dkv_bf16, [i] + [p] * 8 + [i] * 5 + [ll] * 12
                + [i, f, f, p]),
               (lib.flash_bwd_fused_bf16, [i] + [p] * 9 + [i] * 5
                + [ll] * 12 + [i, f, f, p]),
               (lib.flash_bwd_kv_keys, [i]),
               (lib.flash_bwd_kv_smem, [i, i])]
    elif name == "ce_fwd":
        fns = [(lib.ce_fwd_bf16, [i, p, p, p, p, p, p, i, i, i, i, i, p]),
               (lib.ce_fwd_takes, [i, i])]
    else:
        fns = [(lib.ce_probs_bf16, [i, p, p, p, p] + [i] * 6 + [p]),
               (lib.ce_dx_bf16, [i, p, p, p] + [i] * 7 + [p]),
               (lib.ce_dw_bf16, [i, p, p, p] + [i] * 6 + [p]),
               (lib.ce_bwd_takes, [i, i])]
    for fn, argtypes in fns:
        fn.argtypes = argtypes
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
            digest = hashlib.sha1(
                src.read_bytes() + (_CSRC / "common.cuh").read_bytes()
            ).hexdigest()[:12]
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


def _bthd_strides(t: torch.Tensor, kernel: str, name: str
                  ) -> Tuple[int, int, int]:
    """(batch, time, head) strides in elements of a [B, T, H, D] tensor,
    checked for the kernel's 16-byte vector loads."""
    sb, st, sh, sd = t.stride()
    if sd != 1 or sb % 8 or st % 8 or sh % 8 or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} needs unit stride on head_dim "
                         f"and 16-byte aligned rows, got {t.stride()}")
    return sb, st, sh


def _flash_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> Optional[str]:
    """Why the attention kernels do not take these inputs, or None when
    they do. Never raises."""
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        return "q, k, v must be CUDA tensors on one device"
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return f"bf16 only, got {q.dtype}/{k.dtype}/{v.dtype}"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return "q [B, Tq, H, D], k/v [B, Tk, H, D]"
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        return f"k/v shape {tuple(k.shape)} vs q {tuple(q.shape)}"
    if d not in (64, 128):
        return f"head_dim {d} not in (64, 128)"
    if tq == 0 or tk == 0 or b * h == 0:
        return "empty input"
    if causal and tq > tk:
        return ("causal attention needs tq <= tk (queries align to the end "
                "of the kv sequence)")
    return None


def flash_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> bool:
    """Whether the attention kernels take q, k, v: CUDA tensors on one
    device, all bf16, q [B, Tq, H, D] and k, v [B, Tk, H, D] with D 64 or
    128, none empty, and not causal with Tq > Tk. Never raises."""
    return _flash_refusal(q, k, v, causal) is None


def _flash_check(kernel: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, causal: bool
                 ) -> Tuple[int, int, int, int, int]:
    """Checks shared by the attention kernels; returns (B, Tq, Tk, H, D)."""
    why = _flash_refusal(q, k, v, causal)
    if why is not None:
        raise ValueError(f"{kernel}: {why}")
    b, tq, h, d = q.shape
    return b, tq, k.shape[1], h, d


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward on the card. q [B, Tq, H, D], k/v [B, Tk, H, D],
    bf16 CUDA tensors, D 64 or 128. Returns O [B, Tq, H, D] bf16 and the
    natural-log LSE [B*H, Tq] fp32."""
    b, tq, tk, h, d = _flash_check("flash_fwd", q, k, v, causal)
    dev = q.device
    strides = (_bthd_strides(q, "flash_fwd", "q")
               + _bthd_strides(k, "flash_fwd", "k")
               + _bthd_strides(v, "flash_fwd", "v"))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=dev)
    lib = _lib("flash_fwd")
    err = lib.flash_fwd_bf16(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, tq, tk, d, *strides, int(causal),
        sm_scale * _LOG2E, torch.cuda.current_stream(dev).cuda_stream)
    _launched("flash_fwd", err)
    return o, lse


def _flash_bwd_args(kernel: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                    dcor: torch.Tensor, causal: bool) -> tuple:
    """Checks of the backward kernels' inputs; returns (shape, strides)."""
    b, tq, tk, h, d = _flash_check(kernel, q, k, v, causal)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{kernel}: dO must match q, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("dcor", dcor)):
        if (t.shape != (b * h, tq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{kernel}: {name} must be contiguous, 16-byte "
                             f"aligned fp32 [{b * h}, {tq}] on q's device")
    strides = sum((_bthd_strides(t, kernel, name) for name, t in
                   (("q", q), ("k", k), ("v", v), ("dO", do))), ())
    return (b, h, tq, tk, d), strides


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, dcor: torch.Tensor,
                 causal: bool, sm_scale: float) -> torch.Tensor:
    """dQ on the card. q, dO [B, Tq, H, D], k/v [B, Tk, H, D] bf16 CUDA
    tensors (D 64 or 128), the forward's natural-log LSE and
    dcor = rowsum(dO * O), both [B*H, Tq] fp32. Returns dQ [B, Tq, H, D]
    bf16."""
    shape, strides = _flash_bwd_args("flash_bwd_dq", q, k, v, do, lse,
                                     dcor, causal)
    dev = q.device
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    err = _lib("flash_bwd").flash_bwd_dq_bf16(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dcor.data_ptr(), dq.data_ptr(), *shape, *strides,
        int(causal), sm_scale * _LOG2E, sm_scale,
        torch.cuda.current_stream(dev).cuda_stream)
    _launched("flash_bwd_dq", err)
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, dcor: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV on the card, inputs as `flash_bwd_dq`. Returns (dK, dV)
    [B, Tk, H, D] bf16."""
    shape, strides = _flash_bwd_args("flash_bwd_dkv", q, k, v, do, lse,
                                     dcor, causal)
    dev = q.device
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    err = _lib("flash_bwd").flash_bwd_dkv_bf16(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dcor.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *shape, *strides, int(causal), sm_scale * _LOG2E, sm_scale,
        torch.cuda.current_stream(dev).cuda_stream)
    _launched("flash_bwd_dkv", err)
    return dk, dv


# how flash_bwd_fused adds each CTA's dQ partial into the fp32 buffer
FLASH_DQ_ACCUMULATION = "float2 red.global.add from registers"


def flash_bwd_kv_config(d: int) -> Dict[str, int]:
    """The dK/dV main loop's tile at head_dim d, as the built library
    says: keys per CTA (64 per consumer warpgroup) and the dynamic shared
    memory per CTA of its two instances, `flash_bwd_dkv` and
    `flash_bwd_fused`."""
    lib = _lib("flash_bwd")
    return {"keys_per_cta": lib.flash_bwd_kv_keys(d),
            "dkv_smem_bytes": lib.flash_bwd_kv_smem(d, 0),
            "fused_smem_bytes": lib.flash_bwd_kv_smem(d, 1)}


def flash_bwd_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, dcor: torch.Tensor,
                    causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK and dV in one pass on the card (the single-pass backward:
    `flash_bwd_dkv`'s main loop with a dQ stage), inputs as
    `flash_bwd_dq`. Returns dQ [B, Tq, H, D] fp32 (zero-filled here, then
    summed by the kernel with atomics, so its last bits vary from run to
    run; the caller casts it, as the JAX package does outside its kernel)
    and dK, dV [B, Tk, H, D] bf16, bit-equal to `flash_bwd_dkv`'s."""
    shape, strides = _flash_bwd_args("flash_bwd_fused", q, k, v, do, lse,
                                     dcor, causal)
    dev = q.device
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    err = _lib("flash_bwd").flash_bwd_fused_bf16(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dcor.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *shape, *strides, int(causal), sm_scale * _LOG2E,
        sm_scale, torch.cuda.current_stream(dev).cuda_stream)
    _launched("flash_bwd_fused", err)
    return dq, dk, dv


def _takes(lib: str, fn: str, d: int, device: torch.device) -> bool:
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    ok = getattr(_lib(lib), fn)(index, d)
    if ok < 0:
        raise RuntimeError(f"{fn}: CUDA error {-ok}")
    return ok == 1


def ce_fwd_supported(d: int, dtype: torch.dtype,
                     device: torch.device) -> bool:
    """Whether ce_fwd takes rows of width d in this dtype on this CUDA
    device: bf16, and what `ce_fwd_takes` in csrc/ce_fwd.cu says of d (a
    multiple of 16, the x tile within the device's shared memory). Builds
    the kernel on first use."""
    return dtype == torch.bfloat16 and _takes("ce_fwd", "ce_fwd_takes", d,
                                              device)


def ce_bwd_supported(d: int, dtype: torch.dtype,
                     device: torch.device) -> bool:
    """Whether the CE backward kernels take rows of width d in this dtype
    on this CUDA device: bf16, and what `ce_bwd_takes` in csrc/ce_bwd.cu
    says of d (a multiple of 64, the copy rings within the device's shared
    memory). Builds the kernels on first use."""
    return dtype == torch.bfloat16 and _takes("ce_bwd", "ce_bwd_takes", d,
                                              device)


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


def ce_chunk_width(n: int, v: int) -> int:
    """Vocabulary columns per chunk of the CE backward, from the shape
    alone: the largest multiple of 128 whose bf16 probabilities [n, width]
    fit CE_SCRATCH_BYTES, at least 128 and at most v rounded up to 128
    (8192 at n = 8192: 7 chunks of V = 50304)."""
    fit = CE_SCRATCH_BYTES // (2 * max(n, 1)) // 128 * 128
    return max(128, min(fit, -(-v // 128) * 128))


def _ce_bwd_check(kernel: str, x: torch.Tensor, w: torch.Tensor,
                  lse: torch.Tensor, vocab_size: int) -> Tuple[int, int, int]:
    """Checks of the CE backward kernels' inputs; returns (N, d, V)."""
    dev = x.device
    if not (x.is_cuda and w.device == dev and lse.device == dev):
        raise ValueError(f"{kernel}: x, w, lse must be CUDA tensors on one "
                         f"device")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{kernel}: x [N, d], w [V, d], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, d = x.shape
    v = w.shape[0]
    if w.dtype != x.dtype or not ce_bwd_supported(d, x.dtype, dev):
        raise ValueError(f"{kernel}: needs bf16 and a width ce_bwd_takes, "
                         f"got {x.dtype}/{w.dtype}, d={d}")
    if lse.dtype != torch.float32 or lse.shape != (n,):
        raise ValueError(f"{kernel}: lse must be fp32 [{n}]")
    if not (x.is_contiguous() and w.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError(f"{kernel}: inputs must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{kernel}: x and w must be 16-byte aligned")
    if n == 0 or not 0 < vocab_size <= v:
        raise ValueError(f"{kernel}: n={n}, vocab_size={vocab_size}, V={v}")
    return n, d, v


def ce_probs(x: torch.Tensor, w: torch.Tensor, lse: torch.Tensor,
             vocab_size: int, c0: int, width: int) -> torch.Tensor:
    """One launch of `ce_probs` alone, for holding it against its plain
    version: P = exp(x w^T - lse) for the vocab columns [c0, c0 + width),
    zero at columns at or past vocab_size, as bf16 [N, width]. Inputs as
    `ce_bwd`."""
    n, d, v = _ce_bwd_check("ce_probs", x, w, lse, vocab_size)
    if not (0 <= c0 and 0 < width and c0 + width <= v):
        raise ValueError(f"ce_probs: columns [{c0}, {c0 + width}) of {v}")
    dev = x.device
    ldp = -(-width // 128) * 128
    p = torch.empty((n, ldp), dtype=torch.bfloat16, device=dev)
    _launched("ce_probs", _lib("ce_bwd").ce_probs_bf16(
        dev.index, x.data_ptr(), w.data_ptr(), lse.data_ptr(), p.data_ptr(),
        n, d, c0, width, ldp, vocab_size,
        torch.cuda.current_stream(dev).cuda_stream))
    return p[:, :width]


def ce_bwd(x: torch.Tensor, w: torch.Tensor, xg: torch.Tensor,
           lse: torch.Tensor, vocab_size: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CE backward's two products on the card: (dx_unscaled = P w
    [N, d], dW_unscaled = P^T xg [V, d]) in fp32, P = exp(x w^T - lse)
    with the columns at or past vocab_size zero (those rows of dW zero,
    those rows of w never read). x, xg [N, d] and w [V, d] contiguous bf16
    CUDA tensors (xg = x times the upstream gradient), lse [N] fp32
    (natural log). Walks the vocabulary in `ce_chunk_width(N, V)` columns:
    per chunk `ce_probs` writes P into a bf16 scratch, then `ce_dx` adds
    P w to dx and `ce_dw` writes the chunk's rows of dW. ce_dx and ce_dw
    only read P, so ce_dw runs on a side stream forked from the current
    one after ce_probs and joined back before the next chunk's ce_probs:
    the two overlap (alone, each fills 1.45 waves of the H100's 132 SMs
    at GPT-2's shape). The caller sees one stream's order."""
    n, d, v = _ce_bwd_check("ce_bwd", x, w, lse, vocab_size)
    if (xg.shape != x.shape or xg.dtype != x.dtype or xg.device != x.device
            or not xg.is_contiguous() or xg.data_ptr() % 16):
        raise ValueError("ce_bwd: xg must be a contiguous, 16-byte aligned "
                         "tensor like x")
    dev = x.device
    vc = ce_chunk_width(n, v)
    dx = torch.empty((n, d), dtype=torch.float32, device=dev)
    dw = torch.empty((v, d), dtype=torch.float32, device=dev)
    p = torch.empty((n, vc), dtype=torch.bfloat16, device=dev)
    lib = _lib("ce_bwd")
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    for c0 in range(0, v, vc):
        width = min(vc, v - c0)
        _launched("ce_probs", lib.ce_probs_bf16(
            dev.index, x.data_ptr(), w.data_ptr(), lse.data_ptr(),
            p.data_ptr(), n, d, c0, width, vc, vocab_size, main.cuda_stream))
        side.wait_stream(main)
        _launched("ce_dx", lib.ce_dx_bf16(
            dev.index, p.data_ptr(), w.data_ptr(), dx.data_ptr(), n, d, c0,
            width, vc, vocab_size, int(c0 == 0), main.cuda_stream))
        _launched("ce_dw", lib.ce_dw_bf16(
            dev.index, p.data_ptr(), xg.data_ptr(), dw.data_ptr(), n, d, c0,
            width, vc, vocab_size, side.cuda_stream))
        main.wait_stream(side)
    return dx, dw


_side_streams: Dict[int, torch.cuda.Stream] = {}


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream `ce_bwd` runs ce_dw on beside the current one, one per
    device."""
    with _lock:
        if dev.index not in _side_streams:
            _side_streams[dev.index] = torch.cuda.Stream(dev)
        return _side_streams[dev.index]
