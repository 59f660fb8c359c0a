#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's Hopper kernels from `ray_tpu_torch/csrc/` (nvcc,
sm_90a), holds each against its plain PyTorch version on the card, then
drives the port's paths at the full width of GPT-2 small (124M, random
weights from fixed seeds): scoring (`gpt2_forward` logits and
`gpt2_loss`, bf16, tokens [4, 512]) and continuous-batching serving
(`ContinuousBatchingEngine`, 6 concurrent greedy requests, once in fp32
and once in bf16); then training, the main path of the second slice:
one step's gradients against the same weights in fp32 on the CPU
(`train_check`), and `TrainStep` + `adamw` at tokens [8, 1024], a
warm-up step and 10 timed steps (`train`). Every phase prints one JSON
line; a phase that fails ends the run with a non-zero exit code and no
result line. The line before last lists each kernel with its launches
on the training path, its error against the plain version, its time,
the plain version's and the library's time and the card's bound; the
last line is {"ok": true, "device": {...}}.

Times are CUDA-event medians (kernels: a CUDA graph of launches
replayed between events; SDPA's backward, which a graph cannot capture:
its kernels' CUPTI durations) on the card named on the first line of
output (name and power limit from nvidia-smi); bounds use the H100 SXM
data-sheet peaks (989 TFLOP/s dense bf16, 3.35 TB/s HBM3).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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
# bf16 attention gradients against the plain fp32 backward, atol and rtol,
# as tests/test_ops.py:87-89 for bf16 gradients
GRAD_TOL = 5e-2
# CE backward: the kernels' fp32 products (P W, P^T xg) against the plain
# version's, and the finished bf16 dx and dW against the plain backward:
# largest error over the largest magnitude of the reference; P enters
# the kernels' second product rounded to bf16 (2^-9 of each term), and a
# kernel that wrote zeros would be 1.0 off
CE_GRAD_TOL = 2e-2
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


# ------------------------------------------------------------ phases


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    logs = kernels.build()
    ptxas = [ln.strip() for out in logs.values() for ln in out.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs), "ptxas": ptxas})


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
        got = (dq, dk, dv)
        errs = [max_err(a, r) for a, r in zip(got, ref)]
        check(all(torch.isfinite(a.float()).all().item() for a in got),
              "flash_bwd: non-finite gradient")
        close = all(torch.allclose(a.float(), r.float(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL) for a, r in zip(got, ref))
        check(close, f"flash_bwd {(b, tq, tk, h, d, causal)}: errors {errs}")
        results.append({"shape": [b, tq, tk, h, d], "causal": causal,
                        "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
                        "dq_max_abs_err": errs[0], "dk_max_abs_err": errs[1],
                        "dv_max_abs_err": errs[2],
                        "ref_max_abs": max(float(r.float().abs().max())
                                           for r in ref)})
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
    emit({"phase": "flash_bwd", "tol": GRAD_TOL, "fwd_tol": BF16_TOL,
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


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return max_err(a, ref) / max(float(ref.float().abs().max()), 1e-30)


def phase_ce_bwd(kernels, fused_ce, gen) -> list:
    """ce_dx and ce_dw against the plain version of their own products
    (P W and P^T xg in fp32), from the forward kernel's LSE, which is held
    against the plain forward first; then the finished gradients (the
    one-hot terms and scaling added as the model's backward adds them)
    against the plain backward."""
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
        xg = (x.float() * g[:, None]).to(x.dtype)
        got = (kernels.ce_dx(x, w, lse, vocab),
               kernels.ce_dw(x, w, xg, lse, vocab))
        torch.cuda.synchronize()
        want = fused_ce._ce_bwd_products(x, w, xg, lse, vocab)
        check(all(torch.isfinite(a).all().item() for a in got),
              "ce_bwd: non-finite product")
        errs = [max_err(a, b) for a, b in zip(got, want)]
        rels = [rel_err(a, b) for a, b in zip(got, want)]
        check(max(rels) <= CE_GRAD_TOL, f"ce_bwd: errors {errs}, {rels}")
        check(not got[1][vocab:].any().item(), "ce_dw: padded rows not zero")
        del got, want
        grads = fused_ce._ce_bwd_kernels(*args, vocab)
        grad_rels = [rel_err(a, b) for a, b in
                     zip(grads, fused_ce._ce_bwd_reference(*args, vocab))]
        check(max(grad_rels) <= CE_GRAD_TOL,
              f"ce_bwd gradients: relative errors {grad_rels}")
        return xg, errs, rels, grad_rels

    # ragged rows and a padded vocab, before the main shape
    small_args, small_fwd_err = inputs(100, 128, 640, 600)
    _, small_errs, small_rels, small_grad_rels = compare(small_args, 600)
    n, d, v, vocab = 8192, 768, 50304, 50257
    args, fwd_err = inputs(n, d, v, vocab)
    x, w, t, lse, g = args
    xg, errs, rels, grad_rels = compare(args, vocab)
    # padding rows of w are never read: poison them and expect the same
    # bits from both kernels (the scatter of the one-hot rows uses
    # atomics, so the check is on the kernels' own outputs)
    w_poison = w.clone()
    w_poison[vocab:vocab + 20] = float("nan")
    w_poison[vocab + 20:] = 1e4
    for fn in (lambda w_: kernels.ce_dx(x, w_, lse, vocab),
               lambda w_: kernels.ce_dw(x, w_, xg, lse, vocab)):
        check(torch.equal(fn(w_poison), fn(w)),
              "ce_bwd: padded vocab rows reached the gradients")

    def probs():
        # the library's route to P: fp32-out product, mask, softmax
        lg = torch.mm(x, w.T, out_dtype=torch.float32)
        lg[:, vocab:] = -math.inf
        return torch.softmax(lg, dim=-1).to(torch.bfloat16)

    def lib_dx():
        return torch.mm(probs(), w, out_dtype=torch.float32)

    def lib_dw():
        return torch.mm(probs().T, xg, out_dtype=torch.float32)

    lib_err = max(rel_err(lib_dx(), kernels.ce_dx(x, w, lse, vocab)),
                  rel_err(lib_dw(), kernels.ce_dw(x, w, xg, lse, vocab)))
    check(lib_err <= CE_GRAD_TOL, f"ce_bwd library yardstick: {lib_err}")
    dx_ms = graph_ms(lambda: kernels.ce_dx(x, w, lse, vocab), reps=3,
                     iters=5)
    dw_ms = graph_ms(lambda: kernels.ce_dw(x, w, xg, lse, vocab), reps=3,
                     iters=5)
    plain_ms = graph_ms(lambda: fused_ce._ce_bwd_reference(*args, vocab),
                        reps=1, iters=3)
    lib_dx_ms = graph_ms(lib_dx, reps=2, iters=5)
    lib_dw_ms = graph_ms(lib_dw, reps=2, iters=5)
    # at the scoring shape's N (2048 rows) ce_dx has 64 CTAs for the
    # card's 132 SMs, ce_dw its usual 1572
    (xs, ws, _, lses, gs), _ = inputs(2048, d, v, vocab)
    xgs = (xs.float() * gs[:, None]).to(xs.dtype)
    dx_ms_2048 = graph_ms(lambda: kernels.ce_dx(xs, ws, lses, vocab),
                          reps=3, iters=5)
    dw_ms_2048 = graph_ms(lambda: kernels.ce_dw(xs, ws, xgs, lses, vocab),
                          reps=3, iters=5)
    flops = 4 * n * vocab * d
    dx_bound = bound(flops, x.numel() * 2 + w.numel() * 2 + n * 4
                     + n * d * 4)
    dw_bound = bound(flops, 2 * x.numel() * 2 + w.numel() * 2 + n * 4
                     + v * d * 4)
    emit({"phase": "ce_bwd", "tol_relative": CE_GRAD_TOL,
          "fwd_tol": CE_TOL, "shape": [n, d, v, vocab],
          "small_case": {"shape": [100, 128, 640, 600],
                         "fwd_max_abs_err": small_fwd_err,
                         "dx_max_abs_err": small_errs[0],
                         "dw_max_abs_err": small_errs[1],
                         "dx_rel_err": small_rels[0],
                         "dw_rel_err": small_rels[1],
                         "grad_dx_rel_err": small_grad_rels[0],
                         "grad_dw_rel_err": small_grad_rels[1]},
          "fwd_max_abs_err": fwd_err,
          "dx_max_abs_err": errs[0], "dw_max_abs_err": errs[1],
          "dx_rel_err": rels[0], "dw_rel_err": rels[1],
          "grad_dx_rel_err": grad_rels[0], "grad_dw_rel_err": grad_rels[1],
          "poisoned_padding_unchanged": True,
          "library_rel_err": lib_err, "dx_ms": dx_ms, "dw_ms": dw_ms,
          "plain_ms_dx_dw": plain_ms, "library_dx_ms": lib_dx_ms,
          "library_dw_ms": lib_dw_ms, "dx_bound_ms": dx_bound[0],
          "dw_bound_ms": dw_bound[0], "dx_tflops": flops / dx_ms / 1e9,
          "dw_tflops": flops / dw_ms / 1e9, "dx_ms_n2048": dx_ms_2048,
          "dw_ms_n2048": dw_ms_2048,
          "dx_tflops_n2048": flops / 4 / dx_ms_2048 / 1e9,
          "dw_tflops_n2048": flops / 4 / dw_ms_2048 / 1e9})
    common = {"route": "cuda", "source": "ray_tpu_torch/csrc/ce_bwd.cu",
              "plain_ms": plain_ms}
    return [{**common, "name": "ce_dx",
             "replaces": "ray_tpu/ops/fused_ce.py:146",
             "max_abs_err": errs[0], "ms": dx_ms, "bound_ms": dx_bound[0],
             "bound_by": dx_bound[1], "library_ms": lib_dx_ms},
            {**common, "name": "ce_dw",
             "replaces": "ray_tpu/ops/fused_ce.py:178",
             "max_abs_err": errs[1], "ms": dw_ms, "bound_ms": dw_bound[0],
             "bound_by": dw_bound[1], "library_ms": lib_dw_ms}]


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


def phase_score_timing(gpt2, params, cfg, tok_d, tgt_d) -> None:
    """Host-paced time per scoring call: CUDA events around 5 back-to-back
    calls, 20 such windows; median, fastest and slowest window."""
    n = tok_d.numel()
    line = {"phase": "score_timing", "windows": 20, "calls_per_window": 5}
    for name, fn in (("forward", lambda: gpt2.gpt2_forward(params, tok_d,
                                                            cfg)),
                     ("loss", lambda: gpt2.gpt2_loss(params, tok_d, tgt_d,
                                                     cfg))):
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


def phase_train_check(gpt2, tree) -> None:
    """One step's loss and gradients of GPT-2 small in bf16 on the card
    (the four backward kernels) against the same weights in fp32 through
    the port's CPU path (the plain versions)."""
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(4),
                            device="cuda")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = tree.tree_map(lambda p: p.float().cpu(), params)

    def loss_and_grads(p, c, tok, tgt):
        leaves = tree.tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_()
        loss = gpt2.gpt2_loss(p, tok, tgt, c)
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
    worst = max(errs, key=errs.get)
    wte_grad = grads[names.index("wte")]
    check(not wte_grad[cfg.vocab_size:].any().item(),
          "padded wte rows have a gradient")
    check(abs(loss - ref_loss) <= LOSS_TOL,
          f"train_check: loss {loss} vs fp32 CPU {ref_loss}")
    check(errs[worst] <= TRAIN_GRAD_TOL,
          f"train_check: {worst} gradient error {errs[worst]}")
    emit({"phase": "train_check", "model": "gpt2-small", "dtype": "bfloat16",
          "tokens": [2, 256], "loss": loss, "cpu_fp32_loss": ref_loss,
          "loss_tol": LOSS_TOL, "grad_rel_err_max": errs[worst],
          "grad_rel_err_worst_leaf": worst,
          "grad_rel_err_median": statistics.median(errs.values()),
          "grad_tol": TRAIN_GRAD_TOL, "padded_wte_grad_zero": True,
          "cpu_reference_s": cpu_s})


TRAIN_STEPS = 10
TRAIN_LAUNCHES_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12,
                           "flash_bwd_dkv": 12, "ce_fwd": 1, "ce_dx": 1,
                           "ce_dw": 1}


def phase_train(kernels, gpt2) -> dict:
    """The training path: TrainStep + adamw(3e-4, weight_decay=0.1) on
    GPT-2 small, bf16, one fixed batch of tokens [8, 1024]: a warm-up
    step and TRAIN_STEPS timed ones. Launches are counted from 0 over
    all of them; returns the counts."""
    from ray_tpu_torch.observability import flops
    from ray_tpu_torch.observability.step_timer import StepTimer
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import TrainStep

    cfg = gpt2.GPT2Config.small()
    b, t = 8, 1024
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(6),
                            device="cuda")
    seq = torch.randint(0, cfg.vocab_size, (b, t + 1),
                        generator=torch.Generator().manual_seed(7))
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    fpt = flops.train_flops_per_token(cfg, t)
    timer = StepTimer()
    step = TrainStep(
        lambda p, bt: gpt2.gpt2_loss(p, bt["tokens"], bt["targets"], cfg),
        adamw(3e-4, weight_decay=0.1), flops_per_token=fpt, device="cuda",
        timer=timer)
    state = step.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
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
    check(all(launches[k] > 0 for k in TRAIN_LAUNCHES_PER_STEP),
          f"a kernel never launched on the training path: {launches}")
    check(launches == {k: n * steps for k, n in
                       TRAIN_LAUNCHES_PER_STEP.items()},
          f"training launches {launches} over {steps} steps")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    med = statistics.median(times)
    peak = flops.device_peak_flops(0)
    flops_per_step = fpt * b * t
    summary = summarize(timer)
    emit({"phase": "train", "model": "gpt2-small", "dtype": "bfloat16",
          "tokens": [b, t], "optimizer": "adamw(3e-4, weight_decay=0.1)",
          "steps_timed": TRAIN_STEPS, "losses": losses,
          "launches_per_step": {k: n / steps for k, n in launches.items()},
          "step_ms": med, "step_ms_min": min(times),
          "step_ms_max": max(times), "tokens_per_s": b * t / med * 1e3,
          "flops_per_step": flops_per_step, "peak_flops": peak,
          "mfu": flops.mfu(flops_per_step, med / 1e3, peak),
          "step_timer": summary,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return launches


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


def serve_line(dtype: str, prompts, wall, ttft) -> dict:
    return {"phase": "serve", "model": "gpt2-small", "dtype": dtype,
            "max_batch": 4, "requests": len(prompts),
            "prompt_lens": SERVE_LENGTHS, "new_tokens": SERVE_NEW,
            "wall_s": wall,
            "decode_tokens_per_s": len(prompts) * SERVE_NEW / wall,
            "ttft_median_ms": statistics.median(ttft) * 1e3}


def generated(generate_mod, params, cfg, prompts) -> list:
    return [generate_mod.generate(params, cfg, [p],
                                  max_new_tokens=SERVE_NEW)[0].tolist()
            for p in prompts]


def phase_serve_fp32(gpt2, engine_mod, generate_mod) -> None:
    """GPT-2 small at fp32, where the oracle is token identity with
    generate() at batch 1 while the engine decodes at batch 4."""
    cfg = gpt2.GPT2Config(dtype=torch.float32)
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(2),
                            device="cuda")
    prompts = serve_prompts(cfg)
    results, _, wall, ttft = run_engine(engine_mod, params, cfg, prompts)
    want = generated(generate_mod, params, cfg, prompts)
    mismatched = [i for i, (r, w) in enumerate(zip(results, want))
                  if r != w]
    check(not mismatched, f"serve: streams {mismatched} differ from "
          f"generate()")
    emit({**serve_line("float32", prompts, wall, ttft),
          "streams_equal_generate": len(prompts)})


def phase_serve_bf16(gpt2, engine_mod, generate_mod, params, cpu_params,
                     cfg) -> None:
    """GPT-2 small in bf16, the precision a user serves in, on the score
    phase's weights. bf16 rounds differently at batch 1 and batch 4, so
    near-tied greedy choices may flip between the engine and generate();
    the oracle is the same weights in fp32 on the CPU, fed each stream's
    own tokens (SERVE_LP_TOL, SERVE_GREEDY_TOL)."""
    prompts = serve_prompts(cfg)
    results, scores, wall, ttft = run_engine(engine_mod, params, cfg,
                                             prompts)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    lp_err, greedy_gap = 0.0, 0.0
    for p, toks, lps in zip(prompts, results, scores):
        seq = torch.tensor(p + toks[:-1])[None]
        logits = gpt2.gpt2_forward(cpu_params, seq, cpu_cfg)
        logp = torch.log_softmax(
            logits[0, len(p) - 1:, :cfg.vocab_size], dim=-1)
        ref = logp.gather(1, torch.tensor(toks)[:, None])[:, 0]
        lp_err = max(lp_err, max_err(torch.tensor(lps), ref))
        greedy_gap = max(greedy_gap, float((logp.max(dim=-1).values
                                            - ref).max()))
    check(lp_err <= SERVE_LP_TOL,
          f"serve bf16: logprob err {lp_err} > {SERVE_LP_TOL}")
    check(greedy_gap <= SERVE_GREEDY_TOL,
          f"serve bf16: a token {greedy_gap} below the fp32 best")
    want = generated(generate_mod, params, cfg, prompts)
    emit({**serve_line("bfloat16", prompts, wall, ttft),
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
    from ray_tpu_torch.models import gpt2
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
        # the scoring and serving path: every count from 0, read after
        # both entry points
        kernels.reset_launches()
        params, cpu_params, cfg, tok_d, tgt_d = phase_score(kernels, gpt2,
                                                            tree)
        phase_serve_fp32(gpt2, engine_mod, generate_mod)
        phase_serve_bf16(gpt2, engine_mod, generate_mod, params, cpu_params,
                         cfg)
        launches = dict(kernels.LAUNCHES)
        for name in ("flash_fwd", "ce_fwd"):
            check(launches[name] > 0,
                  f"{name} never launched on the scoring path")
        phase_score_timing(gpt2, params, cfg, tok_d, tgt_d)
    del params, cpu_params
    # training needs autograd, so it runs outside inference mode and on
    # parameters of its own
    rows += phase_flash_bwd(kernels, attention, gen)
    rows += phase_ce_bwd(kernels, fused_ce, gen)
    phase_train_check(gpt2, tree)
    # the training path, the main path of this slice: counts from 0
    launches = phase_train(kernels, gpt2)
    for row in rows:
        row["launches"] = launches[row["name"]]
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
