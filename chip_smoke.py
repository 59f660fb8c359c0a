#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's Hopper kernels from `ray_tpu_torch/csrc/` (nvcc,
sm_90a), holds each against its plain PyTorch version on the card, then
drives the port's paths at full width and depth, random weights from
fixed seeds. GPT-2 small (124M): scoring (`gpt2_forward` logits and
`gpt2_loss`, bf16, tokens [4, 512]), continuous-batching serving
(`ContinuousBatchingEngine`, 6 concurrent greedy requests, once in fp32
and once in bf16), one training step's gradients against the same
weights in fp32 on the CPU (`train_check`) and `TrainStep` + `adamw` at
tokens [8, 1024], a warm-up step and 10 timed steps (`train`). Llama
small (the JAX package's ~125M-class Llama: GQA 12/4 heads, RoPE,
SwiGLU), the main path of the third slice: scoring (`llama_score`),
serving in fp32 and bf16, then training with the single-pass attention
backward (Llama's only trained route): gradients against fp32 on the CPU
(`llama_train_check`) and `TrainStep` + `adamw` at tokens [4, 2048]
(`llama_train`). The GPT-2 loss's backward is the chunked CE backward
(`kernels.ce_bwd`: ce_probs, ce_dx and ce_dw per vocabulary chunk, 7
chunks a step), held on three shapes (`ce_bwd`). Inputs the attention
kernels refuse run the plain route on the card (`plain_route`: Llama tiny
in bf16, GPT-2 tiny in fp32, causal tq > tk, no kernel launched, each
such call counted in `ops.attention.PLAIN_CALLS`, which the main paths
must leave at 0). Every
phase prints one JSON line; a phase that fails ends the run with a
non-zero exit code and no result line. The line before last lists each
kernel with its launches on its training path, its error against the
plain version, its time, the plain version's and the library's time and
the card's bound; the last line is {"ok": true, "device": {...}}.

Times are CUDA-event medians (kernels: a CUDA graph of launches
replayed between events; SDPA's backward, which a graph cannot capture,
and the CE backward's split by kernel: their kernels' CUPTI durations)
on the card named on the first line of
output (name and power limit from nvidia-smi); bounds use the H100 SXM
data-sheet peaks (989 TFLOP/s dense bf16, 3.35 TB/s HBM3).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_TOL = 2e-2          # as tests/test_ops.py for bf16 attention
LSE_TOL = 2e-3           # fp32 row logsumexp of bf16 products
CE_TOL = 2e-3            # fp32 loss / lse of bf16 products, d = 768
# bf16 activations through 12 layers against the same weights in fp32:
# logits have std ~0.55 for this random model; on an H100 the largest
# of the 2048 x 50257 differences was 0.032 and the loss moved 2e-4, so
# these bounds leave ~3x and ~25x of room
LOGITS_TOL = 0.1
LOSS_TOL = 5e-3
# bf16 attention gradients against the plain fp32 backward: rtol as
# tests/test_ops.py:87-89 for bf16 gradients, atol GRAD_ATOL_FRAC of the
# largest reference value, and GRAD_NORM_TOL in relative Frobenius norm.
# Most causal dQ/dK/dV values are far below the largest (median |ref|
# ~0.03 against ~5 at T 2048), so an atol of GRAD_TOL alone would pass a
# wrong scale or a dropped kv tile. tests/test_torch_chip_gates.py holds
# these gates on the CPU against an emulation of the kernels' bf16 casts
# (it passes within half of GRAD_NORM_TOL) and against both faults.
GRAD_TOL = 5e-2
GRAD_ATOL_FRAC = 2e-3
GRAD_NORM_TOL = 1e-2
# the fused kernel against the two-pass kernels: dK and dV are the same
# arithmetic (bit-equal); dQ is the same fp32 sum in another order, rounded
# once to bf16, so at most one bf16 ulp (2^-7 of the value) apart
TWO_PASS_DQ_RTOL = 2 ** -7
TWO_PASS_DQ_ATOL_FRAC = 1e-4
TWO_PASS_DQ_NORM_TOL = 2e-3
# CE backward: the kernels' fp32 products (P W, P^T xg) against the plain
# version's, and the finished bf16 dx and dW against the plain backward:
# largest error over the largest magnitude of the reference; P enters
# the kernels' second product rounded to bf16 (2^-9 of each term), and a
# kernel that wrote zeros would be 1.0 off
CE_GRAD_TOL = 2e-2
# ce_probs against its plain version, both bf16: the same fp32 logits up
# to summation order, so at most one bf16 ulp apart (2^-7 of the value)
CE_PROBS_RTOL = 2 ** -7
# fp32 on the card against fp32 on the CPU (tf32 off): the same
# arithmetic in another summation order
FP32_TOL = 1e-4
# one training step in bf16 on the card against the same weights in fp32
# on the CPU: per parameter, |g_card - g_cpu| / |g_cpu| (Frobenius norms)
TRAIN_GRAD_TOL = 5e-2
# bf16 serving against the same weights in fp32 on the CPU, fed the
# engine's own tokens: each emitted token's logprob as the engine reports
# it, within LOGITS_TOL of the fp32 logprob of that token; and the token a
# greedy choice up to bf16 rounding: its fp32 logprob within two such
# errors (one on the chosen token, one on the best) of the fp32 best
SERVE_LP_TOL = LOGITS_TOL
SERVE_GREEDY_TOL = 2 * LOGITS_TOL


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def window_ms(fn, iters: int = 10, reps: int = 10, warmup: int = 3
              ) -> list:
    """Milliseconds per call of fn in each of `iters` CUDA-event windows,
    each around `reps` back-to-back calls (so the card, not the host's
    launch path, sets the pace when it is the slower), after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def median_ms(fn, **kw) -> float:
    return statistics.median(window_ms(fn, **kw))


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device milliseconds per call of fn: `reps` calls captured once in
    a CUDA graph, the graph replayed between CUDA events, median over
    `iters` replays. Host launch cost is left out, so a kernel shorter
    than its Python wrapper is still timed as the card runs it."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def device_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call of fn, for work a CUDA graph cannot
    capture (autograd's backward): the sum of its kernels' durations as
    CUPTI reports them through torch.profiler, gaps between kernels left
    out, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "the profiler recorded no device activity")
    return us / 1e3 / calls


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def norm_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """|a - ref| / |ref|, Frobenius norms."""
    ref = ref.float()
    return float((a.float() - ref).norm() / ref.norm().clamp_min(1e-30))


def hold_grads(label: str, got, ref) -> dict:
    """(dQ, dK, dV) against the plain backward's: each finite, within
    allclose(rtol=GRAD_TOL, atol=GRAD_ATOL_FRAC * max|ref|) and within
    GRAD_NORM_TOL in relative norm. Returns the errors and the reference's
    median and largest magnitudes."""
    out = {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        a, r = a.float(), r.float()
        check(torch.isfinite(a).all().item(), f"{label}: non-finite {name}")
        top = float(r.abs().max())
        rel = norm_err(a, r)
        out.update({f"{name}_max_abs_err": max_err(a, r),
                    f"{name}_rel_norm_err": rel,
                    f"{name}_ref_median_abs": float(r.abs().median()),
                    f"{name}_ref_max_abs": top})
        check(torch.allclose(a, r, atol=GRAD_ATOL_FRAC * top, rtol=GRAD_TOL)
              and rel <= GRAD_NORM_TOL,
              f"{label} {name}: max error {out[f'{name}_max_abs_err']} "
              f"(largest |ref| {top}), relative norm error {rel}")
    out["ref_max_abs"] = max(out[f"{n}_ref_max_abs"] for n in ("dq", "dk",
                                                                "dv"))
    return out


# ------------------------------------------------------------ phases


def kernel_label(mangled: str) -> str:
    """A readable name for a kernel's mangled name: the CE backward's GEMM
    by its epilogue and tile (BM, BN, BK, STAGES, WARPS_M, MIN_BLOCKS),
    the others by name and template width, and the dK/dV main loop's
    instance (`flash_bwd_kv_kernel<64, dkv>` / `<64, fused>`)."""
    epi = re.search(r"(Probs|Dx|Dw)Epi", mangled)
    if "gemm_kernel" in mangled and epi:
        tile = re.findall(r"Li(\d+)E", mangled)[:6]
        return f"ce_{epi.group(1).lower()}<{','.join(tile)}>"
    # [a-z_]: the anonymous namespace's file hash (digits) is left out
    m = re.search(
        r"((?:flash|ce)_[a-z_]+?_kernel)(?:ILi(\d+)E(?:Lb([01])E)?)?", mangled)
    if not m:
        return mangled
    args = [m.group(2)] if m.group(2) else []
    if m.group(3):
        args.append("fused" if m.group(3) == "1" else "dkv")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_lines(out: str) -> list:
    """nvcc's `-Xptxas -v` register and spill lines, each prefixed with
    the kernel (and template width or tile) they describe."""
    lines, name = [], "?"
    for ln in out.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name = kernel_label(m.group(1))
        elif "registers" in ln or "spill" in ln:
            lines.append(f"{name}: {ln.strip()}")
    return lines


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    logs = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs),
          "ptxas": [ln for out in logs.values() for ln in ptxas_lines(out)],
          # the dK/dV main loop's tile: keys per CTA, dynamic shared
          # memory per CTA of each instance (ptxas counts only static)
          "flash_bwd_kv": {d: kernels.flash_bwd_kv_config(d)
                           for d in (64, 128)}})


def qkv(gen, b, tq, tk, h, d) -> list:
    """bf16 q, k, v on the card; for tq == tk as the model makes them:
    head views of one fused product."""
    dev = torch.device("cuda")
    if tq == tk:
        fused = torch.randn(b, tq, 3 * h * d, generator=gen,
                            device=dev).to(torch.bfloat16)
        return [t.reshape(b, tq, h, d) for t in fused.split(h * d, dim=-1)]
    return [torch.randn(b, t, h, d, generator=gen,
                        device=dev).to(torch.bfloat16)
            for t in (tq, tk, tk)]


def phase_flash(kernels, attention, gen) -> dict:
    cases = [(4, 512, 512, 12, 64, True),    # GPT-2 small, the main path
             (2, 128, 640, 12, 64, True),    # tq < tk: end-aligned mask
             (2, 256, 256, 8, 128, False),   # non-causal, head_dim 128
             (2, 300, 300, 12, 64, True)]    # ragged length
    results = []
    for b, tq, tk, h, d, causal in cases:
        q, k, v = qkv(gen, b, tq, tk, h, d)
        o, lse = kernels.flash_fwd(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        ref = attention.mha_reference(q, k, v, causal)
        ref_lse = torch.logsumexp(
            attention._masked_logits(q, k, causal, d ** -0.5),
            dim=-1).reshape(b * h, tq)
        err = max_err(o, ref)
        lse_err = max_err(lse, ref_lse)
        check(torch.isfinite(o.float()).all().item(), "flash_fwd: non-finite")
        # atol and rtol both BF16_TOL, as np.testing.assert_allclose
        close = torch.allclose(o.float(), ref.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)
        check(close and lse_err <= LSE_TOL,
              f"flash_fwd {(b, tq, tk, h, d, causal)}: err {err}, "
              f"lse err {lse_err}")
        results.append({"shape": [b, tq, tk, h, d], "causal": causal,
                        "max_abs_err": err, "lse_max_abs_err": lse_err})
    b, t, h, d = 4, 512, 12, 64
    q, k, v = qkv(gen, b, t, t, h, d)
    pairs = t * (t + 1) / 2  # visible (query, key) pairs under the mask
    flops = 4 * b * h * d * pairs
    nbytes = 4 * b * t * h * d * 2 + b * h * t * 4
    ms = graph_ms(lambda: kernels.flash_fwd(q, k, v, True, d ** -0.5))
    host_ms = median_ms(lambda: kernels.flash_fwd(q, k, v, True, d ** -0.5))
    plain_ms = graph_ms(lambda: attention.mha_reference(q, k, v, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    bms, by = bound(flops, nbytes)
    emit({"phase": "flash_fwd", "tol": BF16_TOL, "lse_tol": LSE_TOL,
          "cases": results, "ms": ms, "host_paced_ms": host_ms,
          "plain_ms": plain_ms,
          "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
          "bound_ms": bms, "bound_by": by, "tflops": flops / ms / 1e9})
    return {"name": "flash_fwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/attention.py:82",
            "max_abs_err": results[0]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def phase_ce(kernels, fused_ce, gen) -> dict:
    dev = torch.device("cuda")
    # ragged rows, a partial d chunk and padded vocab, before the main shape
    n, d, v, vocab = 100, 80, 640, 600
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(v, d, generator=gen, device=dev) * 0.1
         ).to(torch.bfloat16)
    t = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    got, want = (kernels.ce_fwd(x, w, t, vocab),
                 fused_ce._ce_reference(x, w, t, vocab))
    small = [max_err(a, b) for a, b in zip(got, want)]
    check(max(small) <= CE_TOL, f"ce_fwd {(n, d, v, vocab)}: err {small}")

    n, d, v, vocab = 2048, 768, 50304, 50257
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(v, d, generator=gen, device=dev) * 0.02
         ).to(torch.bfloat16)
    t = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    loss, lse = kernels.ce_fwd(x, w, t, vocab)
    torch.cuda.synchronize()
    ref_loss, ref_lse = fused_ce._ce_reference(x, w, t, vocab)
    err, lse_err = max_err(loss, ref_loss), max_err(lse, ref_lse)
    check(torch.isfinite(loss).all().item(), "ce_fwd: non-finite loss")
    check(err <= CE_TOL and lse_err <= CE_TOL,
          f"ce_fwd: loss err {err}, lse err {lse_err}")
    # padding rows of w must be masked: poison them and expect no change
    w_poison = w.clone()
    w_poison[vocab:] = 100.0
    loss_p, _ = kernels.ce_fwd(x, w_poison, t, vocab)
    check(max_err(loss_p, loss) == 0.0, "ce_fwd: padded vocab not masked")

    def product():
        # cuBLAS's bf16 product over the padded W, written in fp32
        return torch.mm(x, w.T, out_dtype=torch.float32)

    def library():
        # the product, then the kernel's masking, logsumexp and gather
        lg = product()
        lg[:, vocab:] = -math.inf
        lse_l = lg.logsumexp(dim=-1)
        return lse_l - lg.gather(1, t[:, None])[:, 0], lse_l

    lib_err = max(max_err(a, b) for a, b in zip(library(),
                                                (ref_loss, ref_lse)))
    check(lib_err <= CE_TOL, f"ce_fwd library yardstick: err {lib_err}")
    flops = 2 * n * vocab * d
    nbytes = x.numel() * 2 + w.numel() * 2 + t.numel() * 8 + 2 * n * 4
    ms = graph_ms(lambda: kernels.ce_fwd(x, w, t, vocab))
    plain_ms = graph_ms(lambda: fused_ce._ce_reference(x, w, t, vocab),
                        reps=2)
    lib_ms = graph_ms(library, reps=5)
    product_ms = graph_ms(product, reps=5)
    bms, by = bound(flops, nbytes)
    emit({"phase": "ce_fwd", "tol": CE_TOL, "shape": [n, d, v, vocab],
          "small_case_max_abs_err": max(small), "loss_max_abs_err": err,
          "lse_max_abs_err": lse_err, "ms": ms,
          "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_max_abs_err": lib_err,
          "library_product_ms": product_ms, "flops": flops,
          "bytes": nbytes, "bound_ms": bms, "bound_by": by,
          "tflops": flops / ms / 1e9,
          "library_product_tflops": 2 * n * v * d / product_ms / 1e9})
    return {"name": "ce_fwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/ce_fwd.cu",
            "replaces": "ray_tpu/ops/fused_ce.py:52",
            "max_abs_err": max(err, lse_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def phase_flash_bwd(kernels, attention, gen) -> list:
    """flash_bwd_dq and flash_bwd_dkv against the plain backward, from
    the same q, k, v, dO and the forward kernel's O and LSE."""
    dev = torch.device("cuda")
    cases = [(8, 1024, 1024, 12, 64, True),   # GPT-2 small training
             (2, 300, 300, 12, 64, True),     # ragged length
             (2, 128, 384, 12, 64, True),     # tq < tk: end-aligned mask
             (2, 256, 256, 8, 64, False),     # non-causal
             (2, 256, 256, 8, 128, True)]     # head_dim 128
    results = []
    for b, tq, tk, h, d, causal in cases:
        q, k, v = qkv(gen, b, tq, tk, h, d)
        do = torch.randn(b, tq, h, d, generator=gen,
                         device=dev).to(torch.bfloat16)
        scale = d ** -0.5
        o, lse = kernels.flash_fwd(q, k, v, causal, scale)
        # the forward at the training shapes, before its O and LSE feed
        # both the kernels and the plain backward
        fwd_ref = attention.mha_reference(q, k, v, causal, scale)
        lse_ref = torch.logsumexp(
            attention._masked_logits(q, k, causal, scale),
            dim=-1).reshape(b * h, tq)
        o_err, lse_err = max_err(o, fwd_ref), max_err(lse, lse_ref)
        check(torch.allclose(o.float(), fwd_ref.float(), atol=BF16_TOL,
                             rtol=BF16_TOL) and lse_err <= LSE_TOL,
              f"flash_fwd {(b, tq, tk, h, d, causal)}: err {o_err}, "
              f"lse err {lse_err}")
        del fwd_ref, lse_ref
        dcor = attention.softmax_correction(o, do)
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, dcor, causal, scale)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, dcor, causal, scale)
        torch.cuda.synchronize()
        ref = attention._flash_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale)
        held = hold_grads(f"flash_bwd {(b, tq, tk, h, d, causal)}",
                          (dq, dk, dv), ref)
        results.append({"shape": [b, tq, tk, h, d], "causal": causal,
                        "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
                        **held})
        if len(results) == 1:
            main = (q, k, v, o, lse, do, dcor)
    q, k, v, o, lse, do, dcor = main
    b, t, h, d = q.shape
    scale = d ** -0.5
    pairs = b * h * t * (t + 1) / 2  # visible (query, key) pairs
    tensor = b * t * h * d * 2
    rows = b * h * t * 4             # one fp32 value per query row
    dq_bound = bound(6 * d * pairs, 5 * tensor + 2 * rows)
    dkv_bound = bound(8 * d * pairs, 6 * tensor + 2 * rows)

    def dq_fn():
        return kernels.flash_bwd_dq(q, k, v, do, lse, dcor, True, scale)

    def dkv_fn():
        return kernels.flash_bwd_dkv(q, k, v, do, lse, dcor, True, scale)

    dq_ms, dkv_ms = graph_ms(dq_fn), graph_ms(dkv_fn)
    dq_host, dkv_host = median_ms(dq_fn), median_ms(dkv_fn)
    plain_ms = graph_ms(lambda: attention._flash_bwd_reference(
        q, k, v, o, lse, do, True, scale), reps=2, iters=5)
    # the library's yardstick: SDPA's backward for dQ, dK and dV together
    # (autograd; device time from CUPTI)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    emit({"phase": "flash_bwd", "tol": GRAD_TOL,
          "atol_of_max_ref": GRAD_ATOL_FRAC, "rel_norm_tol": GRAD_NORM_TOL,
          "fwd_tol": BF16_TOL,
          "lse_tol": LSE_TOL, "cases": results,
          "dq_ms": dq_ms, "dkv_ms": dkv_ms, "dq_host_paced_ms": dq_host,
          "dkv_host_paced_ms": dkv_host, "plain_ms_dq_dk_dv": plain_ms,
          "library_ms_dq_dk_dv": lib_ms, "dq_bound_ms": dq_bound[0],
          "dkv_bound_ms": dkv_bound[0],
          "dq_tflops": 6 * d * pairs / dq_ms / 1e9,
          "dkv_tflops": 8 * d * pairs / dkv_ms / 1e9})
    main_case = results[0]
    common = {"route": "cuda", "source": "ray_tpu_torch/csrc/flash_bwd.cu",
              "plain_ms": plain_ms, "library_ms": lib_ms}
    return [{**common, "name": "flash_bwd_dq",
             "replaces": "ray_tpu/ops/attention.py:197",
             "max_abs_err": main_case["dq_max_abs_err"], "ms": dq_ms,
             "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
            {**common, "name": "flash_bwd_dkv",
             "replaces": "ray_tpu/ops/attention.py:251",
             "max_abs_err": max(main_case["dk_max_abs_err"],
                                main_case["dv_max_abs_err"]),
             "ms": dkv_ms, "bound_ms": dkv_bound[0],
             "bound_by": dkv_bound[1]}]


def gqa_qkv(gen, b, t, h, kv_heads, d) -> list:
    """bf16 q [B, T, H, D] and k, v with `kv_heads` heads, each repeated
    H / kv_heads times in a row: the inputs a Llama block hands the
    attention kernels."""
    dev = torch.device("cuda")
    q = torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, t, kv_heads, d, generator=gen, device=dev)
            .to(torch.bfloat16).repeat_interleave(h // kv_heads, dim=2)
            for _ in range(2))
    return [q, k, v]


def phase_flash_bwd_fused(kernels, attention, gen) -> dict:
    """flash_bwd_fused against the plain backward and against the
    two-pass kernels, from the same q, k, v, dO and the forward kernel's O
    and LSE (held against the plain forward first); the spread of its fp32
    dQ between two runs (atomics); times at the Llama and GPT-2 training
    shapes."""
    dev = torch.device("cuda")
    cases = [(4, 2048, 2048, 12, 64, True),   # Llama small training (GQA)
             (8, 1024, 1024, 12, 64, True),   # GPT-2 small training
             (2, 300, 300, 12, 64, True),     # ragged length
             (2, 128, 384, 12, 64, True),     # tq < tk: end-aligned mask
             (2, 256, 256, 8, 64, False),     # non-causal
             (2, 1024, 1024, 8, 128, True)]   # head_dim 128
    results, timed = [], []
    for i, (b, tq, tk, h, d, causal) in enumerate(cases):
        if i == 0:
            q, k, v = gqa_qkv(gen, b, tq, h, 4, d)
        else:
            q, k, v = qkv(gen, b, tq, tk, h, d)
        do = torch.randn(b, tq, h, d, generator=gen,
                         device=dev).to(torch.bfloat16)
        scale = d ** -0.5
        o, lse = kernels.flash_fwd(q, k, v, causal, scale)
        fwd_ref = attention.mha_reference(q, k, v, causal, scale)
        lse_ref = torch.logsumexp(
            attention._masked_logits(q, k, causal, scale),
            dim=-1).reshape(b * h, tq)
        o_err, lse_err = max_err(o, fwd_ref), max_err(lse, lse_ref)
        check(torch.allclose(o.float(), fwd_ref.float(), atol=BF16_TOL,
                             rtol=BF16_TOL) and lse_err <= LSE_TOL,
              f"flash_fwd {(b, tq, tk, h, d, causal)}: err {o_err}, "
              f"lse err {lse_err}")
        del fwd_ref, lse_ref
        dcor = attention.softmax_correction(o, do)
        acc1, dk1, dv1 = kernels.flash_bwd_fused(q, k, v, do, lse, dcor,
                                                 causal, scale)
        # dQ as the model takes it: the fp32 sum cast to bf16
        got = (acc1.to(q.dtype), dk1, dv1)
        torch.cuda.synchronize()
        label = f"flash_bwd_fused {(b, tq, tk, h, d, causal)}"
        ref = attention._flash_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale)
        held = hold_grads(label, got, ref)
        del ref
        two = (kernels.flash_bwd_dq(q, k, v, do, lse, dcor, causal, scale),
               *kernels.flash_bwd_dkv(q, k, v, do, lse, dcor, causal, scale))
        two_errs = [max_err(a, t) for a, t in zip(got, two)]
        dq_two = two[0].float()
        dq_two_rel = norm_err(got[0], dq_two)
        check(torch.equal(dk1, two[1]) and torch.equal(dv1, two[2]),
              f"{label}: dK / dV differ from the two-pass kernel's")
        check(torch.allclose(got[0].float(), dq_two, rtol=TWO_PASS_DQ_RTOL,
                             atol=TWO_PASS_DQ_ATOL_FRAC
                             * float(dq_two.abs().max()))
              and dq_two_rel <= TWO_PASS_DQ_NORM_TOL,
              f"{label}: dQ vs the two-pass kernel's: max {two_errs[0]}, "
              f"relative norm {dq_two_rel}")
        del two, dq_two
        # dK and dV are written without atomics: the same bits every run
        acc2, dk2, dv2 = kernels.flash_bwd_fused(q, k, v, do, lse, dcor,
                                                 causal, scale)
        check(torch.equal(dk1, dk2) and torch.equal(dv1, dv2),
              "flash_bwd_fused: dK / dV differ between two runs")
        spread = max_err(acc1, acc2)
        results.append({
            "shape": [b, tq, tk, h, d], "causal": causal,
            "o_max_abs_err": o_err, "lse_max_abs_err": lse_err, **held,
            "vs_two_pass_max_abs": two_errs,
            "vs_two_pass_dq_rel_norm": dq_two_rel,
            "dq_fp32_run_to_run_max_abs": spread,
            "dq_fp32_run_to_run_rel": spread / max(
                float(acc1.abs().max()), 1e-30)})
        if i < 2:
            timed.append((q, k, v, o, lse, do, dcor))
    times = []
    for q, k, v, o, lse, do, dcor in timed:
        b, t, h, d = q.shape
        scale = d ** -0.5
        pairs = b * h * t * (t + 1) / 2  # visible (query, key) pairs
        tensor = b * t * h * d * 2
        rows = b * h * t * 4
        # q, k, v, dO, LSE and D read; dK, dV written in bf16, dQ in fp32
        fused_bound = bound(10 * d * pairs, 4 * tensor + 2 * rows
                            + 2 * tensor + 2 * tensor)

        def fused():
            dq, dk, dv = kernels.flash_bwd_fused(q, k, v, do, lse, dcor,
                                                 True, scale)
            return dq.to(q.dtype), dk, dv

        def two_pass():
            return (kernels.flash_bwd_dq(q, k, v, do, lse, dcor, True, scale),
                    kernels.flash_bwd_dkv(q, k, v, do, lse, dcor, True,
                                          scale))

        def zero_and_cast():
            return torch.zeros(q.shape, dtype=torch.float32,
                               device=dev).to(q.dtype)

        fused_ms = graph_ms(fused)
        times.append({"shape": [b, t, t, h, d], "fused_ms": fused_ms,
                      "dq_accumulation": kernels.FLASH_DQ_ACCUMULATION,
                      "keys_per_cta": kernels.flash_bwd_kv_config(d)[
                          "keys_per_cta"],
                      "two_pass_ms": graph_ms(two_pass),
                      "zero_fill_and_cast_ms": graph_ms(zero_and_cast),
                      "fused_host_paced_ms": median_ms(fused),
                      "bound_ms": fused_bound[0],
                      "bound_by": fused_bound[1],
                      "fused_tflops": 10 * d * pairs / fused_ms / 1e9})
    q, k, v, o, lse, do, dcor = timed[0]
    scale = q.shape[-1] ** -0.5
    plain_ms = graph_ms(lambda: attention._flash_bwd_reference(
        q, k, v, o, lse, do, True, scale), reps=2, iters=5)
    # the library's yardstick: SDPA's backward for dQ, dK and dV together
    # on the same repeated-head inputs (autograd; device time from CUPTI)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out, qt, kt, vt
    emit({"phase": "flash_bwd_fused", "tol": GRAD_TOL,
          "atol_of_max_ref": GRAD_ATOL_FRAC, "rel_norm_tol": GRAD_NORM_TOL,
          "two_pass_dq_rtol": TWO_PASS_DQ_RTOL,
          "two_pass_dq_rel_norm_tol": TWO_PASS_DQ_NORM_TOL,
          "fwd_tol": BF16_TOL,
          "lse_tol": LSE_TOL, "cases": results, "times": times,
          "fused_ms_includes": "zero-fill of the fp32 dQ and its bf16 cast",
          "plain_ms_dq_dk_dv": plain_ms, "library_ms_dq_dk_dv": lib_ms})
    main = results[0]
    return {"name": "flash_bwd_fused", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "ray_tpu/ops/attention.py:326",
            "max_abs_err": max(main["dq_max_abs_err"],
                               main["dk_max_abs_err"],
                               main["dv_max_abs_err"]),
            "ms": times[0]["fused_ms"], "plain_ms": plain_ms,
            "bound_ms": times[0]["bound_ms"],
            "bound_by": times[0]["bound_by"], "library_ms": lib_ms}


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return max_err(a, ref) / max(float(ref.float().abs().max()), 1e-30)


def kernel_split_ms(fn, labels: dict, calls: int = 3) -> dict:
    """Device milliseconds per call of fn spent in the kernels whose names
    hold each label's substring (CUPTI durations through torch.profiler,
    summed over all their launches in a call), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(labels, 0.0)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, part in labels.items():
            if part in ev.name:
                out[label] += ev.time_range.elapsed_us() / 1e3 / calls
    check(all(ms > 0 for ms in out.values()),
          f"the profiler did not see every kernel: {out}")
    return out


# the CE backward's kernels by the epilogue in their (demangled) names
CE_BWD_KERNELS = {"ce_probs": "ProbsEpi", "ce_dx": "DxEpi", "ce_dw": "DwEpi"}


def phase_ce_bwd(kernels, fused_ce, gen) -> list:
    """kernels.ce_bwd (ce_probs, ce_dx and ce_dw per vocabulary chunk)
    against the plain version of its products (P W and P^T xg in fp32),
    from the forward kernel's LSE, which is held against the plain forward
    first; ce_probs alone against its plain version on a chunk; then the
    finished gradients (the one-hot terms and scaling added as the
    model's backward adds them) against the plain backward. On a ragged
    one-chunk case, GPT-2's training shape (7 chunks) and a case of 4
    chunks whose last is partial and holds the vocab padding."""
    dev = torch.device("cuda")

    def inputs(n, d, v, vocab):
        x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(v, d, generator=gen, device=dev) * 0.02
             ).to(torch.bfloat16)
        t = torch.randint(0, vocab, (n,), generator=gen, device=dev)
        g = torch.rand(n, generator=gen, device=dev) / n
        loss, lse = kernels.ce_fwd(x, w, t, vocab)
        torch.cuda.synchronize()
        ref_loss, ref_lse = fused_ce._ce_reference(x, w, t, vocab)
        fwd_err = max(max_err(loss, ref_loss), max_err(lse, ref_lse))
        check(fwd_err <= CE_TOL, f"ce_fwd {(n, d, v, vocab)}: err {fwd_err}")
        return (x, w, t, lse, g), fwd_err

    def compare(args, vocab):
        x, w, t, lse, g = args
        n, v = x.shape[0], w.shape[0]
        vc = kernels.ce_chunk_width(n, v)
        chunks = -(-v // vc)
        c0 = (chunks - 1) * vc  # the last chunk: partial, holds the padding
        p = kernels.ce_probs(x, w, lse, vocab, c0, v - c0)
        p_ref = fused_ce._ce_probs_reference(x, w, lse, vocab, c0, v - c0)
        check(torch.allclose(p.float(), p_ref.float(), rtol=CE_PROBS_RTOL,
                             atol=0.0),
              f"ce_probs {(n, v, vocab)} chunk at {c0}: max error "
              f"{max_err(p, p_ref)}")
        p_err = max_err(p, p_ref)
        del p, p_ref
        xg = (x.float() * g[:, None]).to(x.dtype)
        kernels.reset_launches()
        got = kernels.ce_bwd(x, w, xg, lse, vocab)
        torch.cuda.synchronize()
        launches = {k: kernels.LAUNCHES[k] for k in CE_BWD_KERNELS}
        check(launches == dict.fromkeys(CE_BWD_KERNELS, chunks),
              f"ce_bwd {(n, v)}: launches {launches}, {chunks} chunks")
        want = fused_ce._ce_bwd_products(x, w, xg, lse, vocab)
        check(all(torch.isfinite(a).all().item() for a in got),
              "ce_bwd: non-finite product")
        errs = [max_err(a, b) for a, b in zip(got, want)]
        rels = [rel_err(a, b) for a, b in zip(got, want)]
        check(max(rels) <= CE_GRAD_TOL, f"ce_bwd: errors {errs}, {rels}")
        check(not got[1][vocab:].any().item(), "ce_dw: padded rows not zero")
        del want
        # padding rows of w are never read: poison them and expect the
        # same bits (the scatter of the one-hot rows uses atomics, so the
        # check is on the kernels' own outputs)
        w_poison = w.clone()
        w_poison[vocab:vocab + 20] = float("nan")
        w_poison[vocab + 20:] = 1e4
        poisoned = kernels.ce_bwd(x, w_poison, xg, lse, vocab)
        check(torch.equal(poisoned[0], got[0])
              and torch.equal(poisoned[1], got[1]),
              "ce_bwd: padded vocab rows reached the gradients")
        del got, poisoned, w_poison
        grads = fused_ce._ce_bwd_kernels(*args, vocab)
        grad_rels = [rel_err(a, b) for a, b in
                     zip(grads, fused_ce._ce_bwd_reference(*args, vocab))]
        check(max(grad_rels) <= CE_GRAD_TOL,
              f"ce_bwd gradients: relative errors {grad_rels}")
        return xg, {"shape": [n, x.shape[1], v, vocab], "chunk_width": vc,
                    "chunks": chunks, "launches": launches,
                    "probs_max_abs_err": p_err,
                    "dx_max_abs_err": errs[0], "dw_max_abs_err": errs[1],
                    "dx_rel_err": rels[0], "dw_rel_err": rels[1],
                    "grad_dx_rel_err": grad_rels[0],
                    "grad_dw_rel_err": grad_rels[1],
                    "poisoned_padding_unchanged": True}

    cases = []
    # ragged rows and a padded vocab in one chunk, then several chunks,
    # the last partial and holding the padding, before the main shape
    for shape in ((100, 128, 640, 600), (20000, 256, 13056, 13000)):
        args, fwd_err = inputs(*shape)
        cases.append({**compare(args, shape[3])[1], "fwd_max_abs_err":
                      fwd_err})
        del args
    n, d, v, vocab = 8192, 768, 50304, 50257
    args, fwd_err = inputs(n, d, v, vocab)
    x, w, t, lse, g = args
    xg, main = compare(args, vocab)
    cases.append({**main, "fwd_max_abs_err": fwd_err})

    def probs():
        # the library's route to P: fp32-out product, mask, softmax
        lg = torch.mm(x, w.T, out_dtype=torch.float32)
        lg[:, vocab:] = -math.inf
        return torch.softmax(lg, dim=-1).to(torch.bfloat16)

    # ce_dx and ce_dw each read a P that ce_probs wrote: their library
    # yardstick is one product from a P made before the timing
    p_lib = probs()

    def lib_dx():
        return torch.mm(p_lib, w, out_dtype=torch.float32)

    def lib_dw():
        return torch.mm(p_lib.T, xg, out_dtype=torch.float32)

    def lib_pair():
        # P once, then both products
        pr = probs()
        return (torch.mm(pr, w, out_dtype=torch.float32),
                torch.mm(pr.T, xg, out_dtype=torch.float32))

    def pair():
        return kernels.ce_bwd(x, w, xg, lse, vocab)

    got = pair()
    lib_err = max(rel_err(a, b) for a, b in zip(lib_pair(), got))
    check(lib_err <= CE_GRAD_TOL, f"ce_bwd library yardstick: {lib_err}")
    del got
    pair_ms = graph_ms(pair, reps=3, iters=5)
    split = kernel_split_ms(pair, CE_BWD_KERNELS)
    plain_ms = graph_ms(lambda: fused_ce._ce_bwd_reference(*args, vocab),
                        reps=1, iters=3)
    lib_probs_ms = graph_ms(probs, reps=2, iters=5)
    lib_dx_ms = graph_ms(lib_dx, reps=2, iters=5)
    lib_dw_ms = graph_ms(lib_dw, reps=2, iters=5)
    lib_pair_ms = graph_ms(lib_pair, reps=2, iters=5)
    del p_lib
    # at the scoring shape's N (2048 rows): two chunks, 32768 columns wide
    (xs, ws, _, lses, gs), _ = inputs(2048, d, v, vocab)
    xgs = (xs.float() * gs[:, None]).to(xs.dtype)
    pair_ms_2048 = graph_ms(lambda: kernels.ce_bwd(xs, ws, xgs, lses, vocab),
                            reps=3, iters=5)
    # each kernel's inputs read once and outputs written once, P [N, vocab]
    # bf16 among them; the pair's are x, the live W, xg, LSE, dx and dW
    product = 2 * n * vocab * d  # each of the three products
    xb, wb, pb = x.numel() * 2, vocab * d * 2, 2 * n * vocab
    bounds = {"ce_probs": bound(product, xb + wb + n * 4 + pb),
              "ce_dx": bound(product, pb + wb + n * d * 4),
              "ce_dw": bound(product, pb + xb + v * d * 4)}
    pair_bound = bound(3 * product, 2 * xb + wb + n * 4 + n * d * 4
                       + v * d * 4)
    emit({"phase": "ce_bwd", "tol_relative": CE_GRAD_TOL,
          "probs_rtol": CE_PROBS_RTOL, "fwd_tol": CE_TOL, "cases": cases,
          "library_rel_err": lib_err, "pair_ms": pair_ms,
          "kernel_ms": split, "kernel_ms_method": "CUPTI, per backward",
          "plain_ms_dx_dw": plain_ms, "library_probs_ms": lib_probs_ms,
          "library_dx_ms": lib_dx_ms, "library_dw_ms": lib_dw_ms,
          "library_pair_ms": lib_pair_ms,
          "bound_ms": {k: b[0] for k, b in bounds.items()},
          "pair_bound_ms": pair_bound[0], "pair_bound_by": pair_bound[1],
          "pair_tflops": 3 * product / pair_ms / 1e9,
          "pair_ms_n2048": pair_ms_2048,
          "pair_tflops_n2048": 3 * product / 4 / pair_ms_2048 / 1e9,
          "scratch_bytes": 2 * n * kernels.ce_chunk_width(n, v)})
    common = {"route": "cuda", "source": "ray_tpu_torch/csrc/ce_bwd.cu",
              "plain_ms": plain_ms}
    return [{**common, "name": "ce_probs",
             "replaces": "ray_tpu/ops/fused_ce.py:146",
             "max_abs_err": main["probs_max_abs_err"],
             "ms": split["ce_probs"], "bound_ms": bounds["ce_probs"][0],
             "bound_by": bounds["ce_probs"][1], "library_ms": lib_probs_ms},
            {**common, "name": "ce_dx",
             "replaces": "ray_tpu/ops/fused_ce.py:146",
             "max_abs_err": main["dx_max_abs_err"], "ms": split["ce_dx"],
             "bound_ms": bounds["ce_dx"][0], "bound_by": bounds["ce_dx"][1],
             "library_ms": lib_dx_ms},
            {**common, "name": "ce_dw",
             "replaces": "ray_tpu/ops/fused_ce.py:178",
             "max_abs_err": main["dw_max_abs_err"], "ms": split["ce_dw"],
             "bound_ms": bounds["ce_dw"][0], "bound_by": bounds["ce_dw"][1],
             "library_ms": lib_dw_ms}]


def phase_score(kernels, gpt2, tree):
    """The scoring entry points on the kernel path; the launch counts
    are read by the caller after the serve phase."""
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen)
    tok_d, tgt_d = tokens.cuda(), targets.cuda()

    logits = gpt2.gpt2_forward(params, tok_d, cfg)
    torch.cuda.synchronize()
    after_fwd = dict(kernels.LAUNCHES)
    loss = float(gpt2.gpt2_loss(params, tok_d, tgt_d, cfg))
    after_loss = dict(kernels.LAUNCHES)
    none = dict.fromkeys(kernels.LAUNCHES, 0)
    check(after_fwd == {**none, "flash_fwd": cfg.num_layers},
          f"forward launches {after_fwd}")
    check(after_loss == {**none, "flash_fwd": 2 * cfg.num_layers,
                         "ce_fwd": 1}, f"loss launches {after_loss}")

    # the same weights through the port's CPU path in fp32: plain PyTorch
    # versions of both kernels, and the chunked loss
    cpu_cfg = gpt2.GPT2Config(dtype=torch.float32)
    cpu_params = tree.tree_map(lambda p: p.float().cpu(), params)
    t0 = time.perf_counter()
    ref_logits = gpt2.gpt2_forward(cpu_params, tokens, cpu_cfg)
    ref_loss = float(gpt2.gpt2_loss(cpu_params, tokens, targets, cpu_cfg))
    cpu_s = time.perf_counter() - t0
    check(logits.shape == (4, 512, cfg.padded_vocab)
          and logits.dtype == torch.float32, f"logits {logits.shape}")
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    live = slice(0, cfg.vocab_size)
    err = max_err(logits[..., live].cpu(), ref_logits[..., live])
    mean_err = float((logits[..., live].cpu() - ref_logits[..., live])
                     .abs().mean())
    check(err <= LOGITS_TOL, f"logits err {err} > {LOGITS_TOL}")
    window = (math.log(cfg.vocab_size) - 0.5, math.log(cfg.vocab_size) + 0.7)
    check(window[0] <= loss <= window[1], f"loss {loss} outside {window}")
    check(abs(loss - ref_loss) <= LOSS_TOL,
          f"loss {loss} vs fp32 CPU {ref_loss}")
    emit({"phase": "score", "model": "gpt2-small", "dtype": "bfloat16",
          "tokens": [4, 512], "launches_forward": after_fwd,
          "launches_forward_and_loss": after_loss,
          "logits_max_abs_err": err, "logits_mean_abs_err": mean_err,
          "logits_tol": LOGITS_TOL, "loss": loss, "cpu_fp32_loss": ref_loss,
          "loss_tol": LOSS_TOL, "loss_window": window,
          "cpu_reference_s": cpu_s})
    return params, cpu_params, cfg, tok_d, tgt_d


def phase_llama_score(kernels, llama, tree):
    """Llama small's scoring entry points on the kernel path (the caller
    sets the counts to 0 first): `llama_forward` logits and `llama_loss`
    (log-softmax over the full fp32 logits, no CE kernel), bf16, against
    the same weights in fp32 on the CPU."""
    cfg = llama.LlamaConfig.small()
    params = llama.llama_init(cfg, torch.Generator().manual_seed(10),
                              device="cuda")
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen)
    tok_d, tgt_d = tokens.cuda(), targets.cuda()

    logits = llama.llama_forward(params, tok_d, cfg)
    torch.cuda.synchronize()
    after_fwd = dict(kernels.LAUNCHES)
    loss = float(llama.llama_loss(params, tok_d, tgt_d, cfg))
    after_loss = dict(kernels.LAUNCHES)
    none = dict.fromkeys(kernels.LAUNCHES, 0)
    check(after_fwd == {**none, "flash_fwd": cfg.num_layers},
          f"llama forward launches {after_fwd}")
    check(after_loss == {**none, "flash_fwd": 2 * cfg.num_layers},
          f"llama loss launches {after_loss}")

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = tree.tree_map(lambda p: p.float().cpu(), params)
    t0 = time.perf_counter()
    ref_logits = llama.llama_forward(cpu_params, tokens, cpu_cfg)
    ref_loss = float(llama.llama_loss(cpu_params, tokens, targets, cpu_cfg))
    cpu_s = time.perf_counter() - t0
    check(logits.shape == (4, 512, cfg.padded_vocab)
          and logits.dtype == torch.float32, f"logits {logits.shape}")
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    err = max_err(logits.cpu(), ref_logits)
    mean_err = float((logits.cpu() - ref_logits).abs().mean())
    check(err <= LOGITS_TOL, f"llama logits err {err} > {LOGITS_TOL}")
    window = (math.log(cfg.vocab_size) - 0.5, math.log(cfg.vocab_size) + 0.7)
    check(window[0] <= loss <= window[1], f"loss {loss} outside {window}")
    check(abs(loss - ref_loss) <= LOSS_TOL,
          f"llama loss {loss} vs fp32 CPU {ref_loss}")
    emit({"phase": "llama_score", "model": "llama-small",
          "dtype": "bfloat16", "tokens": [4, 512],
          "launches_forward": after_fwd,
          "launches_forward_and_loss": after_loss,
          "logits_max_abs_err": err, "logits_mean_abs_err": mean_err,
          "logits_tol": LOGITS_TOL, "loss": loss, "cpu_fp32_loss": ref_loss,
          "loss_tol": LOSS_TOL, "loss_window": window,
          "cpu_reference_s": cpu_s})
    return params, cpu_params, cfg, tok_d, tgt_d


def phase_score_timing(model: str, forward, loss, params, cfg, tok_d,
                       tgt_d) -> None:
    """Host-paced time per scoring call: CUDA events around 5 back-to-back
    calls, 20 such windows; median, fastest and slowest window."""
    n = tok_d.numel()
    line = {"phase": "score_timing", "model": model, "windows": 20,
            "calls_per_window": 5}
    for name, fn in (("forward", lambda: forward(params, tok_d, cfg)),
                     ("loss", lambda: loss(params, tok_d, tgt_d, cfg))):
        times = window_ms(fn, iters=20, reps=5)
        med = statistics.median(times)
        line.update({f"{name}_ms": med, f"{name}_ms_min": min(times),
                     f"{name}_ms_max": max(times),
                     f"{name}_tokens_per_s": n / med * 1e3})
    emit(line)


def named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) of a parameter tree, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def card_vs_cpu_grads(tree, loss_fn, params, cfg, tokens, targets):
    """One step's loss and gradients in bf16 on the card against the same
    weights in fp32 through the port's CPU path (the plain versions):
    (loss, CPU loss, leaf names, card gradients, per-leaf relative error
    |g_card - g_cpu| / |g_cpu|, CPU seconds)."""
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = tree.tree_map(lambda p: p.float().cpu(), params)

    def loss_and_grads(p, c, tok, tgt):
        leaves = tree.tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_()
        loss = loss_fn(p, tok, tgt, c)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss, grads = loss_and_grads(params, cfg, tokens.cuda(), targets.cuda())
    t0 = time.perf_counter()
    ref_loss, ref_grads = loss_and_grads(cpu_params, cpu_cfg, tokens,
                                         targets)
    cpu_s = time.perf_counter() - t0
    names = [n for n, _ in named_leaves(params)]
    errs = {}
    for name, g, r in zip(names, grads, ref_grads):
        check(torch.isfinite(g.float()).all().item(), f"{name}: non-finite")
        errs[name] = float((g.float().cpu() - r).norm()
                           / max(float(r.norm()), 1e-30))
    return loss, ref_loss, names, grads, errs, cpu_s


def train_check_line(model, loss, ref_loss, errs, cpu_s) -> dict:
    worst = max(errs, key=errs.get)
    check(abs(loss - ref_loss) <= LOSS_TOL,
          f"train_check {model}: loss {loss} vs fp32 CPU {ref_loss}")
    check(errs[worst] <= TRAIN_GRAD_TOL,
          f"train_check {model}: {worst} gradient error {errs[worst]}")
    return {"phase": "train_check", "model": model, "dtype": "bfloat16",
            "tokens": [2, 256], "loss": loss, "cpu_fp32_loss": ref_loss,
            "loss_tol": LOSS_TOL, "grad_rel_err_max": errs[worst],
            "grad_rel_err_worst_leaf": worst,
            "grad_rel_err_median": statistics.median(errs.values()),
            "grad_tol": TRAIN_GRAD_TOL, "cpu_reference_s": cpu_s}


def check_tokens(vocab_size: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab_size, (2, 256), generator=gen)
            for _ in range(2)]


def phase_train_check(gpt2, tree) -> None:
    """One step's loss and gradients of GPT-2 small in bf16 on the card
    (the four backward kernels) against the same weights in fp32 through
    the port's CPU path (the plain versions)."""
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(4),
                            device="cuda")
    loss, ref_loss, names, grads, errs, cpu_s = card_vs_cpu_grads(
        tree, gpt2.gpt2_loss, params, cfg, *check_tokens(cfg.vocab_size, 5))
    wte_grad = grads[names.index("wte")]
    check(not wte_grad[cfg.vocab_size:].any().item(),
          "padded wte rows have a gradient")
    emit({**train_check_line("gpt2-small", loss, ref_loss, errs, cpu_s),
          "padded_wte_grad_zero": True})


def phase_llama_train_check(kernels, llama, tree) -> None:
    """One step's loss and gradients of Llama small in bf16 on the card,
    its attention backward the single-pass kernel (Llama's only trained
    route), against the same weights in fp32 through the port's CPU
    path."""
    cfg = llama.LlamaConfig.small()
    params = llama.llama_init(cfg, torch.Generator().manual_seed(14),
                              device="cuda")
    kernels.reset_launches()
    loss, ref_loss, _, _, errs, cpu_s = card_vs_cpu_grads(
        tree, llama.llama_loss, params, cfg,
        *check_tokens(cfg.vocab_size, 15))
    launches = dict(kernels.LAUNCHES)
    check(launches == {**dict.fromkeys(launches, 0), "flash_fwd": 12,
                       "flash_bwd_fused": 12},
          f"llama_train_check launches {launches}")
    emit({**train_check_line("llama-small", loss, ref_loss, errs, cpu_s),
          "phase": "llama_train_check", "launches": launches})


def reset_counts(kernels) -> None:
    """Every kernel's launch count, and the calls of the plain attention
    route on the card, to 0."""
    from ray_tpu_torch.ops import attention

    kernels.reset_launches()
    attention.PLAIN_CALLS["attention"] = 0


def check_no_plain_route(path: str) -> int:
    """Fails if an attention call of `path` took the plain route on the
    card since reset_counts(); returns the count (0)."""
    from ray_tpu_torch.ops import attention

    n = attention.PLAIN_CALLS["attention"]
    check(n == 0, f"{path}: {n} attention calls took the plain route on "
          f"the card")
    return n


def phase_plain_route(kernels, attention, gpt2, llama, tree) -> None:
    """Inputs the attention kernels refuse (`kernels.flash_takes`) take the
    plain route on the card, as the JAX package takes its reference off
    `_shapes_ok`: Llama tiny in bf16 (head_dim 32) and GPT-2 tiny in fp32,
    forward, loss and one gradient, against the same weights in fp32 on
    the CPU; and causal attention with tq > tk. No kernel launches; every
    attention call on the card (one per layer in the forward and in the
    loss, then the causal one) is counted as a plain-route call."""
    reset_counts(kernels)
    results, want_plain = [], 1
    for model, cfg, forward, loss_fn, seed, tols in (
            ("llama-tiny", llama.LlamaConfig.tiny(), llama.llama_forward,
             llama.llama_loss, 20, (LOGITS_TOL, LOSS_TOL, TRAIN_GRAD_TOL)),
            ("gpt2-tiny", dataclasses.replace(gpt2.GPT2Config.tiny(),
                                              dtype=torch.float32),
             gpt2.gpt2_forward, gpt2.gpt2_loss, 22,
             (FP32_TOL, FP32_TOL, FP32_TOL))):
        init = llama.llama_init if model.startswith("llama") \
            else gpt2.gpt2_init
        params = init(cfg, torch.Generator().manual_seed(seed),
                      device="cuda")
        gen = torch.Generator().manual_seed(seed + 1)
        tokens, targets = (torch.randint(0, cfg.vocab_size, (2, 128),
                                         generator=gen) for _ in range(2))
        with torch.no_grad():
            logits = forward(params, tokens.cuda(), cfg)
            ref_logits = forward(
                tree.tree_map(lambda p: p.float().cpu(), params), tokens,
                dataclasses.replace(cfg, dtype=torch.float32))
        want_plain += 2 * cfg.num_layers
        live = slice(0, cfg.vocab_size)
        check(torch.isfinite(logits).all().item(), f"{model}: non-finite")
        logits_err = max_err(logits[..., live].cpu(), ref_logits[..., live])
        loss, ref_loss, _, _, errs, _ = card_vs_cpu_grads(
            tree, loss_fn, params, cfg, tokens, targets)
        worst = max(errs, key=errs.get)
        check(logits_err <= tols[0] and abs(loss - ref_loss) <= tols[1]
              and errs[worst] <= tols[2],
              f"{model} on the plain route: logits err {logits_err}, loss "
              f"{loss} vs {ref_loss}, {worst} gradient error {errs[worst]}")
        results.append({"model": model, "dtype": str(cfg.dtype),
                        "tokens": [2, 128], "logits_max_abs_err": logits_err,
                        "loss": loss, "cpu_fp32_loss": ref_loss,
                        "grad_rel_err_max": errs[worst],
                        "grad_rel_err_worst_leaf": worst,
                        "tols": list(tols)})
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v = qkv(gen, 2, 256, 128, 4, 64)
    o, lse = attention.flash_attention(q, k, v, True)
    ref = attention.mha_reference(q.float().cpu(), k.float().cpu(),
                                  v.float().cpu(), True)
    causal_err = max_err(o.cpu(), ref)
    check(torch.allclose(o.float().cpu(), ref, atol=BF16_TOL, rtol=BF16_TOL)
          and lse.shape == (2 * 4, 256),
          f"causal tq > tk on the plain route: err {causal_err}")
    launches = dict(kernels.LAUNCHES)
    check(not any(launches.values()),
          f"a kernel launched on the plain route: {launches}")
    plain = attention.PLAIN_CALLS["attention"]
    check(plain == want_plain,
          f"plain-route attention calls {plain}, expected {want_plain}")
    emit({"phase": "plain_route", "cases": results,
          "causal_tq_gt_tk_max_abs_err": causal_err, "launches": launches,
          "plain_attention_calls": plain})


TRAIN_STEPS = 10
_NO_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_bwd_fused": 0, "ce_fwd": 0, "ce_probs": 0, "ce_dx": 0,
                "ce_dw": 0}
LLAMA_TRAIN_LAUNCHES_PER_STEP = {**_NO_LAUNCHES, "flash_fwd": 12,
                                 "flash_bwd_fused": 12}


def train_launches_per_step(kernels, cfg, tokens: int) -> dict:
    """GPT-2's launches a training step: 12 of each attention kernel, one
    ce_fwd, and one of each CE backward kernel per vocabulary chunk (7 at
    tokens [8, 1024])."""
    chunks = -(-cfg.padded_vocab
               // kernels.ce_chunk_width(tokens, cfg.padded_vocab))
    return {**_NO_LAUNCHES, "flash_fwd": 12, "flash_bwd_dq": 12,
            "flash_bwd_dkv": 12, "ce_fwd": 1, "ce_probs": chunks,
            "ce_dx": chunks, "ce_dw": chunks}


def train_run(kernels, phase: str, model: str, loss_fn, cfg, params,
              b: int, t: int, seed: int, per_step: dict) -> dict:
    """TrainStep + adamw(3e-4, weight_decay=0.1), bf16, one fixed batch of
    tokens [b, t]: a warm-up step and TRAIN_STEPS timed ones. Launches are
    counted from 0 over all of them and must be `per_step` times the
    steps; returns the counts."""
    from ray_tpu_torch.observability import flops
    from ray_tpu_torch.observability.step_timer import StepTimer
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import TrainStep

    seq = torch.randint(0, cfg.vocab_size, (b, t + 1),
                        generator=torch.Generator().manual_seed(seed))
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    fpt = flops.train_flops_per_token(cfg, t)
    timer = StepTimer()
    step = TrainStep(loss_fn, adamw(3e-4, weight_decay=0.1),
                     flops_per_token=fpt, device="cuda", timer=timer)
    state = step.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    state, m = step(state, batch)  # warm-up
    timer.end_step()
    losses, times = [float(m["loss"])], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        timer.end_step()
    launches = dict(kernels.LAUNCHES)
    steps = TRAIN_STEPS + 1
    check(all(launches[k] > 0 for k, n in per_step.items() if n),
          f"a kernel never launched on the training path: {launches}")
    check(launches == {k: n * steps for k, n in per_step.items()},
          f"training launches {launches} over {steps} steps")
    plain = check_no_plain_route(phase)
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    med = statistics.median(times)
    peak = flops.device_peak_flops(0)
    flops_per_step = fpt * b * t
    emit({"phase": phase, "model": model, "dtype": "bfloat16",
          "tokens": [b, t], "optimizer": "adamw(3e-4, weight_decay=0.1)",
          "steps_timed": TRAIN_STEPS, "losses": losses,
          "launches_per_step": {k: n / steps for k, n in launches.items()},
          "plain_attention_calls": plain, "step_ms": med, "step_ms_min": min(times),
          "step_ms_max": max(times), "tokens_per_s": b * t / med * 1e3,
          "flops_per_step": flops_per_step, "peak_flops": peak,
          "mfu": flops.mfu(flops_per_step, med / 1e3, peak),
          "step_timer": summarize(timer),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return launches


def phase_train(kernels, gpt2) -> dict:
    """The GPT-2 training path: GPT-2 small at tokens [8, 1024], the
    two-pass attention backward and the CE kernels."""
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(6),
                            device="cuda")
    return train_run(
        kernels, "train", "gpt2-small",
        lambda p, bt: gpt2.gpt2_loss(p, bt["tokens"], bt["targets"], cfg),
        cfg, params, 8, 1024, 7,
        train_launches_per_step(kernels, cfg, 8 * 1024))


def phase_llama_train(kernels, llama) -> dict:
    """The Llama training path, the main path of the third slice: Llama
    small at tokens [4, 2048], its attention backward the single-pass
    kernel, its loss log-softmax over the full fp32 logits (no CE
    kernel)."""
    cfg = llama.LlamaConfig.small()
    params = llama.llama_init(cfg, torch.Generator().manual_seed(16),
                              device="cuda")
    return train_run(
        kernels, "llama_train", "llama-small",
        lambda p, bt: llama.llama_loss(p, bt["tokens"], bt["targets"], cfg),
        cfg, params, 4, 2048, 17, LLAMA_TRAIN_LAUNCHES_PER_STEP)


def summarize(timer) -> dict:
    """The StepTimer's view of the timed steps: median device_step and
    data_wait, and the median MFU its records give."""
    from ray_tpu_torch.observability.step_timer import summarize_records

    recs = list(timer.records)[1:]
    phases = summarize_records(recs)["phases"]
    return {"device_step_p50_ms": phases["device_step"]["p50_ms"],
            "data_wait_p50_ms": phases["data_wait"]["p50_ms"],
            "mfu_median": statistics.median(r.get("mfu", 0.0)
                                            for r in recs)}


SERVE_LENGTHS = [8, 40, 77, 120, 160, 200]
SERVE_NEW = 32


def serve_prompts(cfg) -> list:
    gen = torch.Generator().manual_seed(3)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in SERVE_LENGTHS]


def run_engine(engine_mod, params, cfg, prompts):
    """ContinuousBatchingEngine(max_batch=4) answering `prompts`, each
    submitted from a thread of its own. Returns each stream's tokens and
    per-token logprobs, the wall seconds and each time to first token."""
    new = SERVE_NEW
    eng = engine_mod.ContinuousBatchingEngine(params, cfg, max_batch=4)
    results = [None] * len(prompts)
    scores = [None] * len(prompts)
    ttft = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            t0 = time.perf_counter()
            toks = []
            stream = eng.stream(prompts[i], new, timeout_s=300.0)
            for tok in stream:
                if not toks:
                    ttft[i] = time.perf_counter() - t0
                toks.append(tok)
            results[i] = toks
            scores[i] = stream.scores
        except Exception as err:  # noqa: BLE001 — re-raised below
            errors.append(err)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    check(not errors, f"serve errors: {errors!r}")
    check(all(r is not None and len(r) == new for r in results),
          "serve: a stream did not finish")
    check(not eng._thread.is_alive(), "engine loop still running")
    return results, scores, wall, ttft


def serve_line(model: str, dtype: str, prompts, wall, ttft) -> dict:
    return {"phase": "serve", "model": model, "dtype": dtype,
            "max_batch": 4, "requests": len(prompts),
            "prompt_lens": SERVE_LENGTHS, "new_tokens": SERVE_NEW,
            "wall_s": wall,
            "decode_tokens_per_s": len(prompts) * SERVE_NEW / wall,
            "ttft_median_ms": statistics.median(ttft) * 1e3}


def generated(generate_mod, params, cfg, prompts) -> list:
    return [generate_mod.generate(params, cfg, [p],
                                  max_new_tokens=SERVE_NEW)[0].tolist()
            for p in prompts]


def phase_serve_fp32(model: str, cfg, params, engine_mod,
                     generate_mod) -> None:
    """A model at fp32, where the oracle is token identity with
    generate() at batch 1 while the engine decodes at batch 4."""
    prompts = serve_prompts(cfg)
    results, _, wall, ttft = run_engine(engine_mod, params, cfg, prompts)
    want = generated(generate_mod, params, cfg, prompts)
    mismatched = [i for i, (r, w) in enumerate(zip(results, want))
                  if r != w]
    check(not mismatched, f"serve {model}: streams {mismatched} differ "
          f"from generate()")
    emit({**serve_line(model, "float32", prompts, wall, ttft),
          "streams_equal_generate": len(prompts)})


def phase_serve_bf16(model: str, forward, engine_mod, generate_mod, params,
                     cpu_params, cfg) -> None:
    """A model in bf16, the precision a user serves in, on the score
    phase's weights. bf16 rounds differently at batch 1 and batch 4, so
    near-tied greedy choices may flip between the engine and generate();
    the oracle is the same weights in fp32 on the CPU (`forward`), fed
    each stream's own tokens (SERVE_LP_TOL, SERVE_GREEDY_TOL)."""
    prompts = serve_prompts(cfg)
    results, scores, wall, ttft = run_engine(engine_mod, params, cfg,
                                             prompts)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    lp_err, greedy_gap = 0.0, 0.0
    for p, toks, lps in zip(prompts, results, scores):
        seq = torch.tensor(p + toks[:-1])[None]
        logits = forward(cpu_params, seq, cpu_cfg)
        logp = torch.log_softmax(
            logits[0, len(p) - 1:, :cfg.vocab_size], dim=-1)
        ref = logp.gather(1, torch.tensor(toks)[:, None])[:, 0]
        lp_err = max(lp_err, max_err(torch.tensor(lps), ref))
        greedy_gap = max(greedy_gap, float((logp.max(dim=-1).values
                                            - ref).max()))
    check(lp_err <= SERVE_LP_TOL,
          f"serve {model} bf16: logprob err {lp_err} > {SERVE_LP_TOL}")
    check(greedy_gap <= SERVE_GREEDY_TOL,
          f"serve {model} bf16: a token {greedy_gap} below the fp32 best")
    want = generated(generate_mod, params, cfg, prompts)
    emit({**serve_line(model, "bfloat16", prompts, wall, ttft),
          "logprob_max_abs_err": lp_err, "logprob_tol": SERVE_LP_TOL,
          "greedy_gap_max": greedy_gap, "greedy_tol": SERVE_GREEDY_TOL,
          "streams_equal_generate": sum(r == w for r, w in
                                        zip(results, want))})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ray_tpu_torch")):
        print("chip_smoke: ray_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from ray_tpu_torch import kernels, tree
    from ray_tpu_torch.models import engine as engine_mod
    from ray_tpu_torch.models import generate as generate_mod
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.ops import attention, fused_ce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        phase_build(kernels)
        rows = [phase_flash(kernels, attention, gen),
                phase_ce(kernels, fused_ce, gen)]
        # the GPT-2 scoring and serving path: every count from 0, read
        # after both entry points
        reset_counts(kernels)
        params, cpu_params, cfg, tok_d, tgt_d = phase_score(kernels, gpt2,
                                                            tree)
        scfg = gpt2.GPT2Config(dtype=torch.float32)
        phase_serve_fp32("gpt2-small", scfg, gpt2.gpt2_init(
            scfg, torch.Generator().manual_seed(2), device="cuda"),
            engine_mod, generate_mod)
        phase_serve_bf16("gpt2-small", gpt2.gpt2_forward, engine_mod,
                         generate_mod, params, cpu_params, cfg)
        launches = dict(kernels.LAUNCHES)
        for name in ("flash_fwd", "ce_fwd"):
            check(launches[name] > 0,
                  f"{name} never launched on the scoring path")
        check_no_plain_route("the GPT-2 scoring and serving path")
        phase_score_timing("gpt2-small", gpt2.gpt2_forward, gpt2.gpt2_loss,
                           params, cfg, tok_d, tgt_d)
        del params, cpu_params
        # the Llama scoring and serving path, counted from 0 the same way
        reset_counts(kernels)
        params, cpu_params, cfg, tok_d, tgt_d = phase_llama_score(
            kernels, llama, tree)
        lcfg = llama.LlamaConfig(dtype=torch.float32)
        phase_serve_fp32("llama-small", lcfg, llama.llama_init(
            lcfg, torch.Generator().manual_seed(12), device="cuda"),
            engine_mod, generate_mod)
        phase_serve_bf16("llama-small", llama.llama_forward, engine_mod,
                         generate_mod, params, cpu_params, cfg)
        launches = dict(kernels.LAUNCHES)
        check(launches["flash_fwd"] > 0,
              "flash_fwd never launched on the Llama scoring path")
        check_no_plain_route("the Llama scoring and serving path")
        phase_score_timing("llama-small", llama.llama_forward,
                           llama.llama_loss, params, cfg, tok_d, tgt_d)
        del params, cpu_params
    # training needs autograd, so it runs outside inference mode and on
    # parameters of its own
    rows += phase_flash_bwd(kernels, attention, gen)
    rows += phase_ce_bwd(kernels, fused_ce, gen)
    fused_row = phase_flash_bwd_fused(kernels, attention, gen)
    phase_train_check(gpt2, tree)
    phase_llama_train_check(kernels, llama, tree)
    phase_plain_route(kernels, attention, gpt2, llama, tree)
    # the training paths, each counted from 0: GPT-2's reaches seven of
    # the kernels, Llama's the single-pass backward
    launches = phase_train(kernels, gpt2)
    for row in rows:
        row["launches"] = launches[row["name"]]
    fused_row["launches"] = phase_llama_train(kernels, llama)[
        "flash_bwd_fused"]
    rows.insert(4, fused_row)
    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
