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
(`llama_train`). The mesh form of both steps (`mesh_train`): one NCCL
rank, `parallel.make_mesh`, the models' partition specs, the same
weights and batches, each loss against the one-device step's. Then
checkpoints and the trainer (`trainer_resume`): GPT-2 small through
`train.TorchTrainer.fit()` with an `async_save` every 4 steps, failing
once and resuming bit-equal to an uninterrupted run, a mesh <->
one-device reshard, a Llama small round trip, and what a checkpoint
costs (bytes, snapshot, writer, restore, steps with a write in
flight). The MoE decoder (Mixtral-style, the two-pass attention
backward): one step's gradients at `MoEConfig()`'s widths cut to 2
layers against fp32 on the CPU taking the card's expert choices, and
the card's routing against the CPU's (`moe_train_check`); `TrainStep` +
`adamw` at Mixtral 8x7B's widths cut to 2 layers, tokens [1, 4096]
(`moe_train`), and its mesh form in `mesh_train`. Sequence parallelism
on one NCCL rank (`seq_parallel`): ring and Ulysses attention at
[1, 4096, 32, 128], Ulysses around `flash_attention` too, and
`all_to_all` at axis size 1. The GPT-2
loss's backward is the chunked CE backward
(`kernels.ce_bwd`: ce_probs, ce_dx and ce_dw per vocabulary chunk, 7
chunks a step), held on three shapes (`ce_bwd`). Inputs the attention
kernels refuse run the plain route on the card (`plain_route`: Llama tiny
in bf16, GPT-2 tiny in fp32, causal tq > tk, no kernel launched, each
such call counted in `ops.attention.PLAIN_CALLS`, which the main paths
must leave at 0). The paged KV prefix cache: its device ops against the
CPU's (`kv_ops`), and serving with it (`serve_paged`, both models in
fp32: 8 requests sharing a 256-token system prompt, with and without
the cache, a weight swap, a cancel, an 8-block pool; `serve_paged_int8`:
GPT-2 small bf16 on the int8 pool). Speculative decoding, multi-tenant
LoRA and adoption, with no kernel launched (`serve_spec`, both models
in fp32: the paged traffic twice with `speculate_k=4`, scripted drafts,
a request filling the window; `serve_lora`, both models: two tenants
and base in one batch, speculated too, a hot swap; `serve_adopt`, GPT-2
small: prefilled KV adopted with no prefill): every stream equals
generate(). `dq_seeds` holds flash_bwd_dq over
8 seeds at each of three shapes against emulations of its bf16
rounding. Last, the actor runtime (`runtime`): `ray_tpu_torch.init()`
on the card, CUDA tensors through the object store and a GPU actor both
ways (512 MB through the native arena, timed), a `num_gpus=1` actor
scoring GPT-2 small on the kernels (its own launches held, its loss
against the driver's), `kill()` returning the GPU once the process has
exited, and a second GPU actor serving 8 concurrent requests, each
stream equal to generate(); the GPU actor's cold start and its scoring
call against the driver's are timed. Then the runtime beyond one node
(`cluster`): a head without a GPU, a node agent started as `python -m
ray_tpu_torch start --address` counting the card, a STRICT_PACK
placement group reserving it on the agent's node, a GPU actor in the
group scoring GPT-2 small (its launches held, its loss against the
driver's, a printed line reaching the driver's log subscription), a job
scoring the same tokens through the named actor, the agent SIGKILLed
(the dead node detected, its orphaned GPU worker gone before a second
agent joins and a GPU actor there scores again). The live weight
fabric (`fabric`): `TorchTrainer` trains GPT-2 small bf16 in this
process at tokens [8, 1024] for 3 steps, each step's launches held, and
every `report()` publishes the params; a GPU actor builds its bf16 engine
from version 1 and a `WeightSync` hot-swaps it to each later version
between decode ticks (a request in flight across each swap completes,
the actor's streams equal `generate()` here, its loss bit-equal with its
launches held, every leaf's hash equal; version 1 collected; a tenant
adapter paged over the fabric and hot-swapped on a re-publish).
Disaggregated serving (`disagg`): GPT-2 small fp32 prefilled here behind
the prefix cache and its KV published through the chunk fabric to a GPU
decode actor (or a decode replica here), every stream equal to
`generate()`; a fresh decode actor killed by its chaos plan mid-stream,
the request failed over to the replica here with the same tokens, a
`DisaggAutoscaler` watching the actor_state channel replacing the dead
actor through its tier factory once the card's lease is back, and a
request pinned to the replacement equal to `generate()`; the SLO policy
scaling decode replicas here on the card from 1 to 2 under a burst and
back to 1 when idle, nothing dropped; an int8 prefill tier under an
evict_storm serving a plain engine's streams from its host arena, a
second prefill server adopting the first's published prefix, and an
export / import between pools on the card, byte for byte; no kernel
launches in this process. The online learning loop (`online`):
`OnlineTrainer` on GPT-2 small bf16, the learner in this process on the
flash kernels (12 launches of each a step, no CE kernel), a
RolloutSampler GPU actor hot-swapping each delta publication (staleness
<= 1, `wpe` frozen, its last stream equal to `generate()` on the last
version), then a per-tenant LoRA trainer whose adapter a fabric-backed
pool pages in. MPMD pipelines (`pipeline`): Llama small bf16 as a
two-stage `PipelineTrainer` (1F1B, [8, 1024] in 4 microbatches, adamw)
whose stage 0 (the embedding) is a CPU actor and stage 1 (the blocks,
norm_f, lm_head and the loss) a GPU actor on the flash kernels, each
loss against a dense reference on the card, each launch counted in the
stage's process; the same under GPipe on a `PipelineConductor`, then
stage 0 killed mid-run (the run raises at once), then a new pipeline
under that name on the card's lease again. The trainer's worker gang
(`train_gang`): two fits of
GPT-2 tiny on 2-rank gloo gangs of CPU ranks, one killed by a chaos plan
and restarted from its checkpoint; one card holds no gang of GPU ranks.
The runtime's user surface (`runtime_surface`): a named GPU actor in a
runtime_env (env_vars, a working_dir, py_modules; CUDA_VISIBLE_DEVICES
in env_vars refused) scoring GPT-2 small on the kernels (its launches
counted in its process, its loss bit-equal to this driver's), its span
under a driver span (and in the merged timeline), its CUPTI trace from
`util.profiling.profile_actor` while it scores in a loop (the
`flash_fwd` and `ce_fwd` kernels named among its GPU kernel events,
their counts and device time printed), its metric in the Prometheus
text and its calls in the state API, a `ray://` client in a subprocess
getting the same loss and refused a CUDA tensor, and the control-plane
microbenchmark (`_private/perf.py`) on this machine's CPUs.
Every phase prints one JSON line; a phase that fails ends the run with a
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

import concurrent.futures as cf
import contextlib
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

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_TOL = 2e-2          # as tests/test_ops.py for bf16 attention
LSE_TOL = 2e-3           # fp32 row logsumexp of bf16 products
# ce_fwd's per-row loss and LSE against the plain forward (fp32 logits of
# the same bf16 inputs): the kernel sums the same bf16 products in fp32 in
# another order. On the CPU, _ce_reference's arithmetic in 12 k-chunks
# against fp64 stays within 1.3e-6 at logit spread 0.55 and 3.6e-6 at
# spread 4.2; on an H100 the mma.sync kernel was within 3.8e-6 and 3.1e-5
# of the plain forward (fp32 sums of 768 products, logits up to ~20 at
# spread 4.2). A dropped ragged last vocab tile moves the LSE by ~2e-3 and
# a dropped 64-deep d chunk of one tile by ~3e-4
# (tests/test_torch_chip_gates.py).
CE_FWD_TOL = 1e-4
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (seconds
    since the script started)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
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


def hold_output(label: str, o, ref_o) -> dict:
    """An attention output O against the plain fp32 one, held as
    `hold_grads` holds a gradient: finite, allclose(rtol=GRAD_TOL,
    atol=GRAD_ATOL_FRAC * max|ref|), relative norm <= GRAD_NORM_TOL. Most
    causal O values are far below the largest (median |ref| ~0.04 against
    ~3 at T 2048), so an allclose of BF16_TOL alone would pass O 5 % off
    in half the rows. Returns the errors and the reference's median and
    largest |O|."""
    o, ref_o = o.float(), ref_o.float()
    check(torch.isfinite(o).all().item(), f"{label}: non-finite O")
    top = float(ref_o.abs().max())
    rel = norm_err(o, ref_o)
    out = {"max_abs_err": max_err(o, ref_o), "rel_norm_err": rel,
           "ref_median_abs": float(ref_o.abs().median()),
           "ref_max_abs": top}
    check(torch.allclose(o, ref_o, atol=GRAD_ATOL_FRAC * top, rtol=GRAD_TOL)
          and rel <= GRAD_NORM_TOL,
          f"{label} o: max error {out['max_abs_err']} (largest |ref| {top}),"
          f" relative norm error {rel}")
    return out


def hold_forward(label: str, o, lse, ref_o, ref_lse) -> dict:
    """The attention forward's O and LSE against the plain forward's: O
    by `hold_output`, the LSE within LSE_TOL. Returns the errors."""
    out = {**hold_output(label, o, ref_o),
           "lse_max_abs_err": max_err(lse, ref_lse)}
    check(out["lse_max_abs_err"] <= LSE_TOL,
          f"{label} lse: max error {out['lse_max_abs_err']}")
    return out


def hold_ce_forward(label: str, loss, lse, ref_loss, ref_lse) -> dict:
    """ce_fwd's per-row loss and LSE against the plain forward's: both
    finite and within CE_FWD_TOL absolute. Returns the errors."""
    check(torch.isfinite(loss).all().item()
          and torch.isfinite(lse).all().item(),
          f"{label}: non-finite loss or lse")
    out = {"loss_max_abs_err": max_err(loss, ref_loss),
           "lse_max_abs_err": max_err(lse, ref_lse)}
    check(max(out.values()) <= CE_FWD_TOL,
          f"{label}: loss err {out['loss_max_abs_err']}, lse err "
          f"{out['lse_max_abs_err']} (tol {CE_FWD_TOL})")
    return out


def held_flash_fwd(kernels, attention, q, k, v, causal: bool,
                   scale: float):
    """flash_fwd's O and LSE, held by `hold_forward` against the plain
    forward in fp32 from the same bf16 inputs; returns O, the LSE and the
    errors."""
    b, tq, h, d = q.shape
    o, lse = kernels.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    qf, kf, vf = q.float(), k.float(), v.float()
    ref_o = attention.mha_reference(qf, kf, vf, causal, scale)
    ref_lse = torch.logsumexp(
        attention._masked_logits(qf, kf, causal, scale),
        dim=-1).reshape(b * h, tq)
    label = f"flash_fwd {(b, tq, k.shape[1], h, d, causal)}"
    return o, lse, hold_forward(label, o, lse, ref_o, ref_lse)


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


def ptxas_warnings(out: str) -> dict:
    """nvcc's warning lines and ptxas's performance notes (`(C7520)
    Potential Performance Loss: wgmma.mma_async instructions are
    serialized ...`, which `-Xptxas -v` prints as info lines) by kernel:
    the function a line names, else the entry function compiled last."""
    found, name = {}, "?"
    for ln in out.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name = kernel_label(m.group(1))
        elif re.search(r"warning|Performance Loss", ln, re.IGNORECASE):
            f = re.search(r"function '(\w+)'", ln)
            found.setdefault(kernel_label(f.group(1)) if f else name,
                             []).append(ln.strip())
    return found


def gate_ptxas(logs: dict):
    """nvcc's output of every kernel source (`kernels.build()`'s logs):
    the register and spill lines and the warnings by kernel. Fails if any
    kernel has a warning or ptxas's performance note (`(C7520)` wgmma
    serialized, `(C7512)` register pressure) or a line that shows a
    spill."""
    ptxas = [ln for out in logs.values() for ln in ptxas_lines(out)]
    warnings = {}
    for out in logs.values():
        warnings.update(ptxas_warnings(out))
    faults = [f"{k}: {ln}" for k, lines in warnings.items() for ln in lines]
    faults += [ln for ln in ptxas if re.search(r"[1-9]\d* bytes spill", ln)]
    check(not faults, f"ptxas warnings or spills: {faults}")
    return ptxas, warnings


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    logs = kernels.build()
    ptxas, warnings = gate_ptxas(logs)
    ce_tile = kernels.ce_fwd_config()
    check((ce_tile["rows"], ce_tile["cols"]) == (kernels.CE_FWD_ROWS,
                                                 kernels.CE_FWD_COLS),
          f"ce_fwd's tile {ce_tile} is not the partition's")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs), "ptxas": ptxas,
          "ptxas_warnings": warnings,
          # dynamic shared memory per CTA of each attention kernel and of
          # ce_fwd (ptxas counts only static), the dK/dV main loop's keys
          # per CTA and ce_fwd's tile
          "flash_q": {d: kernels.flash_q_config(d) for d in (64, 128)},
          "flash_bwd_kv": {d: kernels.flash_bwd_kv_config(d)
                           for d in (64, 128)},
          "ce_fwd": ce_tile})


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
    """flash_fwd against the plain fp32 forward (`hold_forward`) on seven
    cases, then timed at the scoring and both training shapes beside the
    plain version and SDPA."""
    cases = [(4, 512, 512, 12, 64, True),    # GPT-2 small scoring
             (8, 1024, 1024, 12, 64, True),  # GPT-2 small training
             (4, 2048, 2048, 12, 64, True),  # Llama small training
             (2, 128, 640, 12, 64, True),    # tq < tk: end-aligned mask
             (2, 256, 256, 8, 128, False),   # non-causal, head_dim 128
             (2, 300, 300, 12, 64, True),    # ragged length
             (1, 4096, 4096, 32, 128, True)]  # MoE training (Mixtral)
    results = []
    for b, tq, tk, h, d, causal in cases:
        q, k, v = qkv(gen, b, tq, tk, h, d)
        held = held_flash_fwd(kernels, attention, q, k, v, causal,
                              d ** -0.5)[2]
        results.append({"shape": [b, tq, tk, h, d], "causal": causal,
                        **held})
    times = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, t, h, d in ((4, 512, 12, 64), (8, 1024, 12, 64),
                       (4, 2048, 12, 64)):
        q, k, v = qkv(gen, b, t, t, h, d)
        pairs = t * (t + 1) / 2  # visible (query, key) pairs under the mask
        flops = 4 * b * h * d * pairs
        nbytes = 4 * b * t * h * d * 2 + b * h * t * 4
        bms, by = bound(flops, nbytes)

        def fwd():
            return kernels.flash_fwd(q, k, v, True, d ** -0.5)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = graph_ms(fwd)
        times.append({
            "shape": [b, t, t, h, d], "ms": ms,
            "host_paced_ms": median_ms(fwd),
            "plain_ms": graph_ms(lambda: attention.mha_reference(q, k, v,
                                                                 True),
                                 reps=2 if t > 512 else 20),
            "library_ms": graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "flops": flops, "bytes": nbytes, "bound_ms": bms,
            "bound_by": by, "tflops": flops / ms / 1e9})
        del q, k, v, qt, kt, vt
    emit({"phase": "flash_fwd", "tol": GRAD_TOL,
          "atol_of_max_ref": GRAD_ATOL_FRAC, "rel_norm_tol": GRAD_NORM_TOL,
          "lse_tol": LSE_TOL, "cases": results, "times": times})
    main = times[0]  # the scoring shape, [4, 512, 12, 64]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/attention.py:82",
            "max_abs_err": results[0]["max_abs_err"], **{
                k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}


def ce_inputs(gen, n: int, d: int, v: int, vocab: int, w_scale: float):
    """bf16 x [n, d] ~ N(0, 1), w [v, d] ~ w_scale N(0, 1) and int64
    targets below vocab, on the card."""
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(v, d, generator=gen, device=dev) * w_scale
         ).to(torch.bfloat16)
    t = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    return x, w, t


# phase_ce's cases: (name, N, d, V, vocab, w scale). A small one with
# ragged rows, a partial d chunk and padded vocab; GPT-2 small's LM head
# at the scoring shape's N (2048) and at the training step's (8192, its
# one launch a step); and N 2048 with a trained head's logit spread
# (~4 rather than ~0.55), which drives the online max's rescaling. The
# first two draw from the run's generator, as they always have; the
# others from one of their own, so that the later phases' inputs stay
# as they were (flash_bwd's dQ allclose fails on other draws at [8,
# 1024]: PERF.md §7).
CE_FWD_CASES = [("small", 100, 80, 640, 600, 0.1),
                ("scoring", 2048, 768, 50304, 50257, 0.02),
                ("training", 8192, 768, 50304, 50257, 0.02),
                ("wide_spread", 2048, 768, 50304, 50257, 0.15)]
CE_FWD_OWN_SEED = 30


def time_ce_fwd(kernels, fused_ce, x, w, t, vocab: int) -> dict:
    """ce_fwd by graph replay and host-paced, beside the plain version,
    the library route (fp32-out product over the padded W, mask,
    logsumexp, gather; held to CE_FWD_TOL too) and cuBLAS's product
    alone, with the bound."""
    n, d = x.shape
    v = w.shape[0]

    def fwd():
        return kernels.ce_fwd(x, w, t, vocab)

    def product():
        # cuBLAS's bf16 product over the padded W, written in fp32
        return torch.mm(x, w.T, out_dtype=torch.float32)

    def library():
        # the product, then the kernel's masking, logsumexp and gather
        lg = product()
        lg[:, vocab:] = -math.inf
        lse_l = lg.logsumexp(dim=-1)
        return lse_l - lg.gather(1, t[:, None])[:, 0], lse_l

    lib_err = hold_ce_forward(f"ce_fwd library yardstick N {n}", *library(),
                              *fused_ce._ce_reference(x, w, t, vocab))
    flops = 2 * n * vocab * d
    nbytes = x.numel() * 2 + vocab * d * 2 + t.numel() * 8 + 2 * n * 4
    big = n > 2048
    ms = graph_ms(fwd, reps=5 if big else 20)
    bms, by = bound(flops, nbytes)
    product_ms = graph_ms(product, reps=2 if big else 5)
    return {"shape": [n, d, v, vocab], "ms": ms,
            "host_paced_ms": median_ms(fwd, reps=5 if big else 10),
            "plain_ms": graph_ms(
                lambda: fused_ce._ce_reference(x, w, t, vocab),
                reps=1 if big else 2, iters=3 if big else 10),
            "library_ms": graph_ms(library, reps=2 if big else 5),
            "library_max_abs_err": max(lib_err.values()),
            "library_product_ms": product_ms, "flops": flops,
            "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "share_of_bound": bms / ms, "tflops": flops / ms / 1e9,
            "library_product_tflops": 2 * n * v * d / product_ms / 1e9}


def phase_ce(kernels, fused_ce, gen) -> dict:
    """ce_fwd against the plain forward (`hold_ce_forward`) on the
    CE_FWD_CASES, with its padding rows poisoned at the scoring shape;
    timed at both of GPT-2's N."""
    cases, timed = [], {}
    own = torch.Generator(device="cuda").manual_seed(CE_FWD_OWN_SEED)
    for i, (name, n, d, v, vocab, scale) in enumerate(CE_FWD_CASES):
        x, w, t = ce_inputs(gen if i < 2 else own, n, d, v, vocab, scale)
        loss, lse = kernels.ce_fwd(x, w, t, vocab)
        torch.cuda.synchronize()
        held = hold_ce_forward(f"ce_fwd {name} {(n, d, v, vocab)}", loss, lse,
                               *fused_ce._ce_reference(x, w, t, vocab))
        logits = x[:256].float() @ w[:vocab].float().T
        cases.append({"case": name, "shape": [n, d, v, vocab],
                      "w_scale": scale, **held,
                      "logit_std": float(logits.std()),
                      "logit_range": float(logits.max() - logits.min())})
        del logits
        if name == "scoring":
            # padding rows of w must be masked: poison them, same bits
            w_poison = w.clone()
            w_poison[vocab:] = 100.0
            check(torch.equal(kernels.ce_fwd(x, w_poison, t, vocab)[0], loss),
                  "ce_fwd: padded vocab not masked")
            del w_poison
        if name in ("scoring", "training"):
            timed[name] = time_ce_fwd(kernels, fused_ce, x, w, t, vocab)
        del x, w, t, loss, lse
    emit({"phase": "ce_fwd", "tol": CE_FWD_TOL, "cases": cases,
          "poisoned_padding_unchanged": True,
          "times": list(timed.values())})
    main = timed["scoring"]
    return {"name": "ce_fwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/ce_fwd.cu",
            "replaces": "ray_tpu/ops/fused_ce.py:52",
            "max_abs_err": max(cases[1]["loss_max_abs_err"],
                               cases[1]["lse_max_abs_err"]), **{
                k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}


# the online learner's attention shape (GPT-2 small at [8, 127]): its
# LSE and D rows start 4 bytes off a 16-byte boundary, which the backward
# kernels' TMA of those rows must take; it draws from a generator of its
# own so the other cases and the later phases keep their inputs
ONLINE_FLASH_CASE = (8, 127, 127, 12, 64, True)


def own_generator(case, gen):
    """`gen`, or for ONLINE_FLASH_CASE a generator of its own."""
    if case != ONLINE_FLASH_CASE:
        return gen
    return torch.Generator(device="cuda").manual_seed(127)


def phase_flash_bwd(kernels, attention, gen) -> list:
    """flash_bwd_dq and flash_bwd_dkv against the plain backward, from
    the same q, k, v, dO and the forward kernel's O and LSE."""
    dev = torch.device("cuda")
    cases = [(8, 1024, 1024, 12, 64, True),   # GPT-2 small training
             (2, 300, 300, 12, 64, True),     # ragged length
             ONLINE_FLASH_CASE,
             (2, 128, 384, 12, 64, True),     # tq < tk: end-aligned mask
             (2, 256, 256, 8, 64, False),     # non-causal
             (2, 256, 256, 8, 128, True),     # head_dim 128
             (1, 4096, 4096, 32, 128, True)]  # MoE training (Mixtral)
    results = []
    for b, tq, tk, h, d, causal in cases:
        g = own_generator((b, tq, tk, h, d, causal), gen)
        q, k, v = qkv(g, b, tq, tk, h, d)
        do = torch.randn(b, tq, h, d, generator=g,
                         device=dev).to(torch.bfloat16)
        scale = d ** -0.5
        # the forward at the training shapes, before its O and LSE feed
        # both the kernels and the plain backward
        o, lse, fwd = held_flash_fwd(kernels, attention, q, k, v, causal,
                                     scale)
        o_err, lse_err = fwd["max_abs_err"], fwd["lse_max_abs_err"]
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


LOG2E = 1.4426950408889634  # the kernels' float constant


def dq_reference_and_emulation(attention, q, k, v, o, lse, do,
                               scale: float):
    """Causal dQ three ways, from the forward's O and LSE:
    - the plain backward's (`_flash_bwd_reference`: P and dS = P (dP - D)
      in fp32, dQ = scale dS K in fp32, rounded to bf16);
    - an emulation of flash_bwd_dq's rounding: the same with dS rounded
      to bf16 before the product, as the kernel feeds it to its tensor
      cores (the emulation tests/test_torch_chip_gates.py applies);
    - the same emulation in the kernel's own forms, S and dP summed in
      float64 and P = 2^(S scale log2(e) - LSE log2(e)): its distance
      from the first emulation is what summation order and the exp form
      alone move dQ, through dS elements that round to the other bf16
      neighbour."""
    b, t, h, _ = q.shape
    lse4 = lse.reshape(b, h, t, 1)
    dcor = attention.softmax_correction(o, do).reshape(b, h, t, 1)
    kf = k.float()

    def dq_of(ds):
        return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)

    p = torch.exp(attention._masked_logits(q, k, True, scale) - lse4)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float()) - dcor)
    del p
    ref, emu = dq_of(ds), dq_of(ds.to(torch.bfloat16).float())
    del ds
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()).float()
    x = (s * (scale * LOG2E)).masked_fill(
        ~torch.ones(t, t, dtype=torch.bool, device=q.device).tril(),
        -math.inf)
    del s
    p = torch.exp2((x.double() - lse4.double()
                    * torch.tensor(LOG2E, dtype=torch.float32).item()
                    ).float())
    del x
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double()).float()
    ds = (p * (dp - dcor)).to(torch.bfloat16).float()
    del p, dp
    return ref, emu, dq_of(ds)


def allowance_used(got, ref) -> float:
    """The largest |got - ref| over hold_grads' allowance at that element,
    atol GRAD_ATOL_FRAC * max|ref| + rtol GRAD_TOL * |ref|: above 1 the
    allclose fails."""
    got, ref = got.float(), ref.float()
    allow = GRAD_ATOL_FRAC * ref.abs().max() + GRAD_TOL * ref.abs()
    return float(((got - ref).abs() / allow).max())


def hold_dq_rounding(label: str, dq, emu, emu_exact) -> dict:
    """flash_bwd_dq's dQ against the emulations of its rounding
    (`dq_reference_and_emulation`): no farther, in relative norm, from the
    float64-summed emulation than the fp32 emulation is, twice over (two
    emulations that differ in summation order alone set the scale; a
    wrong scale, tile or mask is far outside it)."""
    floor = norm_err(emu, emu_exact)
    out = {"floor_rel_norm": floor,
           "vs_emulation_rel_norm": norm_err(dq, emu),
           "vs_exact_emulation_rel_norm": norm_err(dq, emu_exact),
           "vs_emulation_max_abs_err": max_err(dq, emu)}
    check(out["vs_exact_emulation_rel_norm"] <= 2 * max(floor, 1e-6),
          f"{label}: dQ {out['vs_exact_emulation_rel_norm']} from the "
          f"emulation of its rounding, two emulations {floor} apart")
    return out


# the GPT-2 and Llama training shapes, and the MoE step's (Mixtral's
# heads at head_dim 128 over 4096 keys, where the bf16 rounding of dS
# alone can take dQ past hold_grads' allowance at some seeds)
DQ_SEED_SHAPES = [(8, 1024, 12, 64), (4, 2048, 12, 64),
                  (1, 4096, 32, 128)]
DQ_SEEDS = range(8)


def phase_dq_seeds(kernels, attention) -> None:
    """flash_bwd_dq's dQ over seeds 0-7 at the causal training shapes,
    from the forward kernel's O and LSE: against the plain backward's dQ
    by hold_grads' allowance and relative norm (reported, not gated: the
    question is whether a miss is the kernel's or the bf16 rounding of
    dS, which the emulation shares), and against the emulations of its
    rounding by `hold_dq_rounding`."""
    cases = []
    for b, t, h, d in DQ_SEED_SHAPES:
        for seed in DQ_SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v = qkv(gen, b, t, t, h, d)
            do = torch.randn(b, t, h, d, generator=gen,
                             device="cuda").to(torch.bfloat16)
            scale = d ** -0.5
            o, lse = kernels.flash_fwd(q, k, v, True, scale)
            dq = kernels.flash_bwd_dq(q, k, v, do, lse,
                                      attention.softmax_correction(o, do),
                                      True, scale)
            ref, emu, emu_exact = dq_reference_and_emulation(
                attention, q, k, v, o, lse, do, scale)
            held = hold_dq_rounding(f"flash_bwd_dq {(b, t, h, d)} seed "
                                    f"{seed}", dq, emu, emu_exact)
            cases.append({"shape": [b, t, h, d], "seed": seed,
                          "ref_max_abs": float(ref.float().abs().max()),
                          "kernel_allowance_used": allowance_used(dq, ref),
                          "kernel_rel_norm_err": norm_err(dq, ref),
                          "kernel_max_abs_err": max_err(dq, ref),
                          "emulation_allowance_used":
                              allowance_used(emu, ref),
                          "emulation_rel_norm_err": norm_err(emu, ref),
                          "exact_emulation_allowance_used":
                              allowance_used(emu_exact, ref),
                          **held})
            del q, k, v, do, o, lse, dq, ref, emu, emu_exact
    worst = max(cases, key=lambda c: c["kernel_allowance_used"])
    emit({"phase": "dq_seeds", "tol": GRAD_TOL,
          "atol_of_max_ref": GRAD_ATOL_FRAC,
          "kernel_over_allowance": sum(c["kernel_allowance_used"] > 1
                                       for c in cases),
          "emulation_over_allowance": sum(c["emulation_allowance_used"] > 1
                                          for c in cases),
          "exact_emulation_over_allowance": sum(
              c["exact_emulation_allowance_used"] > 1 for c in cases),
          "worst": worst, "cases": cases})


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
             ONLINE_FLASH_CASE,
             (2, 128, 384, 12, 64, True),     # tq < tk: end-aligned mask
             (2, 256, 256, 8, 64, False),     # non-causal
             (2, 1024, 1024, 8, 128, True)]   # head_dim 128
    results, timed = [], []
    for i, (b, tq, tk, h, d, causal) in enumerate(cases):
        g = own_generator((b, tq, tk, h, d, causal), gen)
        if i == 0:
            q, k, v = gqa_qkv(g, b, tq, h, 4, d)
        else:
            q, k, v = qkv(g, b, tq, tk, h, d)
        do = torch.randn(b, tq, h, d, generator=g,
                         device=dev).to(torch.bfloat16)
        scale = d ** -0.5
        o, lse, fwd = held_flash_fwd(kernels, attention, q, k, v, causal,
                                     scale)
        o_err, lse_err = fwd["max_abs_err"], fwd["lse_max_abs_err"]
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
        x, w, t = ce_inputs(gen, n, d, v, vocab, 0.02)
        g = torch.rand(n, generator=gen, device=dev) / n
        loss, lse = kernels.ce_fwd(x, w, t, vocab)
        torch.cuda.synchronize()
        fwd_err = max(hold_ce_forward(
            f"ce_fwd {(n, d, v, vocab)}", loss, lse,
            *fused_ce._ce_reference(x, w, t, vocab)).values())
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
          "probs_rtol": CE_PROBS_RTOL, "fwd_tol": CE_FWD_TOL, "cases": cases,
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


def card_vs_cpu_grads(tree, loss_fn, params, cfg, tokens, targets,
                      tape=None):
    """One step's loss and gradients in bf16 on the card against the same
    weights in fp32 through the port's CPU path (the plain versions):
    (loss, CPU loss, leaf names, card gradients, per-leaf relative error
    |g_card - g_cpu| / |g_cpu|, CPU seconds). With a `RoutingTape`, the
    CPU pass takes the experts the card chose."""
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = tree.tree_map(lambda p: p.float().cpu(), params)

    def loss_and_grads(p, c, tok, tgt):
        leaves = tree.tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_()
        loss = loss_fn(p, tok, tgt, c)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    with tape.record() if tape else contextlib.nullcontext():
        loss, grads = loss_and_grads(params, cfg, tokens.cuda(),
                                     targets.cuda())
    t0 = time.perf_counter()
    with tape.replay() if tape else contextlib.nullcontext():
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


def hold_launches(what: str, launches: dict, per_step: dict,
                  steps: int) -> None:
    """Every kernel launched exactly per_step[k] times a step, over
    `steps` steps: one launch more or fewer of any kernel fails."""
    check(launches == {k: n * steps for k, n in per_step.items()},
          f"{what}: launches {launches} over {steps} steps, expected "
          f"{per_step} a step")


def train_batch(cfg, b: int, t: int, seed: int) -> dict:
    """The fixed training batch of tokens [b, t] from `seed`, on the CPU."""
    seq = torch.randint(0, cfg.vocab_size, (b, t + 1),
                        generator=torch.Generator().manual_seed(seed))
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def train_run(kernels, phase: str, model: str, loss_fn, cfg, params,
              b: int, t: int, seed: int, per_step: dict, mesh=None,
              param_specs=None):
    """TrainStep + adamw(3e-4, weight_decay=0.1), bf16, one fixed batch of
    tokens [b, t]: a warm-up step and TRAIN_STEPS timed ones, then one
    more step traced for its host launches. Launches are counted from 0
    over the warm-up and timed steps and must be `per_step` times the
    steps. With `mesh`, the mesh form of TrainStep on `param_specs`.
    Returns the counts and the phase's line, not yet emitted."""
    from ray_tpu_torch.observability import flops
    from ray_tpu_torch.observability.step_timer import StepTimer
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import TrainStep

    batch = train_batch(cfg, b, t, seed)
    fpt = flops.train_flops_per_token(cfg, t)
    timer = StepTimer()
    step = TrainStep(loss_fn, adamw(3e-4, weight_decay=0.1),
                     flops_per_token=fpt, device="cuda", timer=timer,
                     mesh=mesh, param_specs=param_specs)
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
    hold_launches(f"{phase} {model}", launches, per_step, steps)
    plain = check_no_plain_route(phase)
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    med = statistics.median(times)
    peak = flops.device_peak_flops(0)
    flops_per_step = fpt * b * t
    _, host = launches_of(lambda: step(state, batch))
    return launches, {
        "phase": phase, "model": model, "dtype": "bfloat16",
        "tokens": [b, t], "optimizer": "adamw(3e-4, weight_decay=0.1)",
        "steps_timed": TRAIN_STEPS, "losses": losses,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "plain_attention_calls": plain, "step_ms": med,
        "step_ms_min": min(times), "step_ms_max": max(times),
        "tokens_per_s": b * t / med * 1e3,
        "flops_per_step": flops_per_step, "peak_flops": peak,
        "mfu": flops.mfu(flops_per_step, med / 1e3, peak),
        "step_timer": summarize(timer),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "host_launches_per_step": host["launches"],
        "device_ops_per_step": host["device_ops"],
        "traced_step_device_busy_ms": host["device_busy_ms"],
        "traced_step_wall_ms": host["wall_ms"],
        # the traced step's own wall time, the profiler's cost included
        "traced_step_idle_share": 1 - host["device_busy_ms"]
        / host["wall_ms"],
        "traced_step_top_device_ms": host["top_device_ms"]}


def gpt2_train_args(kernels, gpt2) -> tuple:
    """GPT-2 small at tokens [8, 1024] from fixed seeds: the two-pass
    attention backward and the CE kernels."""
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(6),
                            device="cuda")
    return ("gpt2-small",
            lambda p, bt: gpt2.gpt2_loss(p, bt["tokens"], bt["targets"],
                                         cfg),
            cfg, params, 8, 1024, 7,
            train_launches_per_step(kernels, cfg, 8 * 1024))


def llama_train_args(llama) -> tuple:
    """Llama small at tokens [4, 2048] from fixed seeds: its attention
    backward the single-pass kernel, its loss log-softmax over the full
    fp32 logits (no CE kernel)."""
    cfg = llama.LlamaConfig.small()
    params = llama.llama_init(cfg, torch.Generator().manual_seed(16),
                              device="cuda")
    return ("llama-small",
            lambda p, bt: llama.llama_loss(p, bt["tokens"], bt["targets"],
                                           cfg),
            cfg, params, 4, 2048, 17, LLAMA_TRAIN_LAUNCHES_PER_STEP)


def phase_train(kernels, gpt2):
    """The GPT-2 training path (one device); returns the launch counts
    and the phase's line."""
    launches, line = train_run(kernels, "train",
                               *gpt2_train_args(kernels, gpt2))
    emit(line)
    return launches, line


def phase_llama_train(kernels, llama):
    """The Llama training path (one device), the main path of the third
    slice; returns the launch counts and the phase's line."""
    launches, line = train_run(kernels, "llama_train",
                               *llama_train_args(llama))
    emit(line)
    return launches, line


# The MoE decoder (Mixtral-style): attention through flash_attention's
# two-pass backward at head_dim 128 (Mixtral) or 64 (MoEConfig()'s
# default widths), experts, routing and the balancing loss plain torch.
# moe_train: Mixtral 8x7B's published widths (MoEConfig.mixtral_8x7b())
# cut to 2 layers, ~2.23 B parameters: ~18 GB of bf16 parameters,
# gradients and AdamW moments on one card; tokens [1, 4096], its context.
MOE_LAYERS = 2
MOE_TRAIN_TOKENS = (1, 4096)
MOE_LAUNCHES_PER_STEP = {**_NO_LAUNCHES, "flash_fwd": MOE_LAYERS,
                         "flash_bwd_dq": MOE_LAYERS,
                         "flash_bwd_dkv": MOE_LAYERS}
# the routing of the same bf16 router logits on the card and on the CPU:
# the dispatch (which token goes to which slot) equal, the combine
# weights (fp32 softmax of the same inputs, normalised) within this
ROUTING_COMBINE_TOL = 1e-5


class RoutingTape:
    """Records the expert choices `ops.moe.top_k_stable` makes (each
    call's indices, in call order: the forward's routing of each layer,
    then the balancing loss's), or replays them: a replayed call takes
    the recorded indices and the values of its own probabilities there.
    bf16 router logits on the card can put a token in another expert
    than fp32 logits on the CPU; a gradient then differs by that token's
    whole contribution (~sqrt(flips / tokens) of the leaf at random
    init), which says nothing of the arithmetic. Replayed, the CPU pass
    computes the card's function in fp32."""

    def __init__(self, moe_ops):
        self.moe_ops = moe_ops
        self.calls: list = []

    @contextlib.contextmanager
    def _patched(self, fn):
        orig = self.moe_ops.top_k_stable
        self.moe_ops.top_k_stable = fn
        try:
            yield self
        finally:
            self.moe_ops.top_k_stable = orig

    def record(self):
        orig = self.moe_ops.top_k_stable

        def fn(probs, k):
            vals, idx = orig(probs, k)
            self.calls.append(idx.detach().cpu())
            return vals, idx

        self.calls = []
        return self._patched(fn)

    def replay(self):
        it = iter(self.calls)

        def fn(probs, k):
            idx = next(it).to(probs.device)
            return probs.gather(-1, idx), idx

        return self._patched(fn)


def hold_routing(label: str, got, ref) -> dict:
    """(dispatch, combine) of `_top_k_routing` against the same function
    on the same logits elsewhere: every token in the same expert slot, or
    dropped in both, and the combine weights within ROUTING_COMBINE_TOL.
    Returns the kept share of the (token, choice) pairs."""
    (dispatch, combine), (ref_dispatch, ref_combine) = got, ref
    moved = int((dispatch.cpu() != ref_dispatch.cpu()).sum())
    err = max_err(combine.cpu(), ref_combine.cpu())
    check(moved == 0 and err <= ROUTING_COMBINE_TOL,
          f"{label}: {moved} dispatch entries differ, combine error {err}")
    t = ref_dispatch.shape[0]
    kept = float(ref_dispatch.sum()) / t
    return {"dispatch_entries_differing": moved, "combine_max_abs_err": err,
            "kept_choices_per_token": kept}


def routing_line(moe, moe_ops, params, cfg, tokens) -> dict:
    """The card's routing of `tokens`, layer by layer: held by
    `hold_routing` against the CPU's routing of the same router logits,
    with the share of (token, choice) pairs dropped at the capacity."""
    with torch.no_grad():
        _, router = moe.moe_forward(params, tokens.cuda(), cfg, True)
    t = router[0].shape[0]
    cap = moe_ops.capacity_of(t, cfg.top_k, cfg.capacity_factor,
                              cfg.num_experts)
    layers = []
    for i, lg in enumerate(router):
        got = moe_ops._top_k_routing(lg, cfg.top_k, cfg.num_experts, cap)
        ref = moe_ops._top_k_routing(lg.cpu(), cfg.top_k, cfg.num_experts,
                                     cap)
        held = hold_routing(f"routing, layer {i}", got, ref)
        held["dropped_share"] = 1 - held["kept_choices_per_token"] / cfg.top_k
        layers.append(held)
    return {"capacity": cap, "capacity_factor": cfg.capacity_factor,
            "layers": layers,
            "dropped_share": statistics.mean(x["dropped_share"]
                                             for x in layers)}


def top_k_sets(moe_ops, logits, k: int) -> torch.Tensor:
    """Each token's set of top-k experts, as sorted indices [T, k]."""
    idx = moe_ops.top_k_stable(torch.softmax(logits.float(), -1), k)[1]
    return idx.sort(-1).values.cpu()


def phase_moe_train_check(kernels, moe, moe_ops, tree) -> None:
    """One step of the MoE decoder at MoEConfig()'s widths (d_model 768,
    12 / 4 heads, head_dim 64, d_ff 2048, 8 experts, top 2) cut to
    MOE_LAYERS layers, tokens [2, 256]: the loss and every gradient in
    bf16 on the card against fp32 on the CPU taking the card's expert
    choices (`RoutingTape`), each leaf within TRAIN_GRAD_TOL and the loss
    within LOSS_TOL; the card's routing against the CPU's on the same
    logits (`hold_routing`); and, reported, the tokens whose top-2 set
    differs between the card's bf16 router logits and the CPU's fp32
    ones."""
    cfg = dataclasses.replace(moe.MoEConfig(), num_layers=MOE_LAYERS)
    params = moe.moe_init(cfg, torch.Generator().manual_seed(40),
                          device="cuda")
    tokens, targets = check_tokens(cfg.vocab_size, 41)
    reset_counts(kernels)
    tape = RoutingTape(moe_ops)
    loss, ref_loss, names, grads, errs, cpu_s = card_vs_cpu_grads(
        tree, moe.moe_loss, params, cfg, tokens, targets, tape=tape)
    launches = dict(kernels.LAUNCHES)
    hold_launches("moe_train_check", launches, MOE_LAUNCHES_PER_STEP, 1)
    check_no_plain_route("moe_train_check")
    line = train_check_line("moe-default-2l", loss, ref_loss, errs, cpu_s)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        card_router = moe.moe_forward(params, tokens.cuda(), cfg, True)[1]
        cpu_router = moe.moe_forward(
            tree.tree_map(lambda p: p.detach().float().cpu(), params),
            tokens, cpu_cfg, True)[1]
    flips = [int((top_k_sets(moe_ops, a, cfg.top_k)
                  != top_k_sets(moe_ops, b, cfg.top_k)).any(-1).sum())
             for a, b in zip(card_router, cpu_router)]
    emit({**line, "phase": "moe_train_check", "launches": launches,
          "routing": "the CPU pass takes the card's expert choices",
          "routing_held": routing_line(moe, moe_ops, params, cfg, tokens),
          "cpu_own_routing": {
              "tokens_top2_set_differs_by_layer": flips,
              "tokens": tokens.numel()},
          "card": card_line()})


def moe_train_args(moe) -> tuple:
    """Mixtral 8x7B's widths cut to MOE_LAYERS layers at tokens [1, 4096]
    from fixed seeds: (train_run's arguments, seconds moe_init took)."""
    cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(),
                              num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = moe.moe_init(cfg, torch.Generator().manual_seed(42),
                          device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    return ("mixtral-8x7b-2l",
            lambda p, bt: moe.moe_loss(p, bt["tokens"], bt["targets"], cfg),
            cfg, params, *MOE_TRAIN_TOKENS, 43,
            MOE_LAUNCHES_PER_STEP), init_s


def phase_moe_train(kernels, moe, moe_ops):
    """The MoE training path (one device): TrainStep + adamw at Mixtral
    8x7B's widths, 2 layers, tokens [1, 4096]; then the trained model's
    routing of the batch (`routing_line`: the dropped share at capacity
    factor 1.25). Returns the launch counts and the phase's line."""
    from ray_tpu_torch.observability import flops

    args, init_s = moe_train_args(moe)
    launches, line = train_run(kernels, "moe_train", *args)
    _, _, cfg, params, b, t, seed, _ = args
    del args
    line.update({
        "num_layers": cfg.num_layers, "d_model": cfg.d_model,
        "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
        "num_experts": cfg.num_experts, "top_k": cfg.top_k,
        "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
        "params_total": flops.params_size(params),
        "params_active_jax_count": flops.param_count(cfg),
        # `mfu` takes JAX's count, which charges each active expert three
        # d x d_ff matrices; it has two (w_in, w_out)
        "mfu_two_matrix_experts": flops.mfu(
            (flops.train_flops_per_token(cfg, t) - 6.0 * cfg.num_layers
             * cfg.top_k * cfg.d_model * cfg.d_ff) * b * t,
            line["step_ms"] / 1e3, line["peak_flops"]),
        "moe_init_s": init_s,
        "routing": routing_line(moe, moe_ops, params, cfg,
                                train_batch(cfg, b, t, seed)["tokens"]),
        "card": card_line()})
    emit(line)
    return launches, line


# the mesh step on one NCCL rank against the one-device step, on the same
# weights and batch: the same kernels on the same tensors (at world 1
# every block is the whole parameter). GPT-2's kernels are deterministic,
# so its losses should be equal bit for bit (they were on an H100 80GB
# HBM3 at 700 W, PERF.md). Llama's single-pass backward sums dQ with
# atomics, so its one-device step differs from itself run to run; over
# 11 AdamW steps on bf16 weights that noise grew to 1.4e-2 in the loss on
# that card (8e-5 after one update), while the loss falls ~0.23 a step.
# The phase also reruns the one-device step and prints that spread. The
# MoE step's attention backward is the two-pass pair (no atomics), so its
# losses are held as GPT-2's.
MESH_LOSS_TOL = {"gpt2-small": 1e-3, "llama-small": 5e-2,
                 "mixtral-8x7b-2l": 1e-3}


def phase_mesh_train(kernels, gpt2, llama, moe, one_device: dict) -> list:
    """The mesh TrainStep on one NCCL rank (a file:// store, world 1),
    `make_mesh(MeshConfig())`, the models' partition specs: GPT-2 small
    [8, 1024], Llama small [4, 2048] and the 2-layer Mixtral-width MoE
    [1, 4096] on the weights and batches of `train`, `llama_train` and
    `moe_train`. Every loss within MESH_LOSS_TOL of the one-device
    step's, the same kernel launches a step, no plain route; beside it
    the one-device step run again, for its own spread. Each run's state
    is freed before the next. The process group is destroyed at the
    end."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    tmp = tempfile.mkdtemp(prefix="mesh-train-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        lines = []
        # a step updates its parameters in place: fresh ones each run
        for make_args, specs in (
                (lambda: gpt2_train_args(kernels, gpt2),
                 gpt2.gpt2_partition_specs(gpt2.GPT2Config.small())),
                (lambda: llama_train_args(llama),
                 llama.llama_partition_specs(llama.LlamaConfig.small())),
                (lambda: moe_train_args(moe)[0],
                 moe.moe_partition_specs(dataclasses.replace(
                     moe.MoEConfig.mixtral_8x7b(), num_layers=MOE_LAYERS)))):
            _, again = train_run(kernels, "train_repeat", *make_args())
            launches, line = train_run(kernels, "mesh_train", *make_args(),
                                       mesh=mesh, param_specs=specs)
            ref = one_device[line["model"]]
            tol = MESH_LOSS_TOL[line["model"]]
            diffs = [abs(a - r) for a, r in zip(line["losses"],
                                                ref["losses"])]
            check(max(diffs) <= tol,
                  f"mesh_train {line['model']}: losses {line['losses']} "
                  f"against one-device {ref['losses']}")
            check(line["launches_per_step"] == ref["launches_per_step"],
                  f"mesh_train {line['model']}: launches "
                  f"{line['launches_per_step']} against one-device "
                  f"{ref['launches_per_step']}")
            line.update({
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                "backend": dist.get_backend(),
                "loss_tol": tol,
                "loss_max_abs_diff": max(diffs),
                "losses_bit_equal": line["losses"] == ref["losses"],
                "one_device_repeat_loss_max_abs_diff": max(
                    abs(a - r) for a, r in zip(again["losses"],
                                               ref["losses"])),
                "one_device_repeat_step_ms": again["step_ms"],
                "one_device_step_ms": ref["step_ms"],
                "one_device_step_ms_min": ref["step_ms_min"],
                "one_device_step_ms_max": ref["step_ms_max"],
                "one_device_host_launches_per_step":
                    ref["host_launches_per_step"],
                "one_device_max_memory_allocated_bytes":
                    ref["max_memory_allocated_bytes"]})
            emit(line)
            lines.append(line)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


SEQ_SHAPE = (1, 4096, 32, 128)  # [B, T, H, D]: Mixtral's heads, context


def phase_seq_parallel(kernels, attention) -> None:
    """Sequence parallelism on one NCCL rank (world 1, every mesh axis of
    size 1), the causal attention of Mixtral's shape [1, 4096, 32, 128]
    in bf16 inside `shard_map` split on `sp`: `ring_attention`,
    `ulysses_attention` (around `mha_reference`, and around
    `flash_attention`, whose `flash_fwd` launch is counted), each held by
    `hold_output` against `mha_reference` in fp32 on the same inputs and
    timed beside `mha_reference` in bf16; and `all_to_all` at axis size 1,
    the identity in both forms. No kernel but that one `flash_fwd`, no
    plain-route attention call. The process group is destroyed at the
    end."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses import ulysses_attention
    from ray_tpu_torch.parallel import (MeshConfig, P, all_to_all,
                                        make_mesh, shard_map)
    from ray_tpu_torch.parallel.mesh import axis_env

    tmp = tempfile.mkdtemp(prefix="seq-parallel-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(50)
        q, k, v = qkv(gen, SEQ_SHAPE[0], SEQ_SHAPE[1], SEQ_SHAPE[1],
                      *SEQ_SHAPE[2:])
        spec = P(None, "sp")
        runs = {
            "ring": lambda a, b, c: ring_attention(a, b, c, "sp", True),
            "ulysses_mha": lambda a, b, c: ulysses_attention(a, b, c, "sp",
                                                             True),
            "ulysses_flash": lambda a, b, c: ulysses_attention(
                a, b, c, "sp", True, attn_fn=attention.flash_attention)}
        with torch.no_grad():
            ref = attention.mha_reference(q.float(), k.float(), v.float(),
                                          True)
            reset_counts(kernels)
            outs = {name: shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                    out_specs=spec)(q, k, v).to_local()
                    for name, fn in runs.items()}
            launches = dict(kernels.LAUNCHES)
            hold_launches("seq_parallel", launches,
                          {**_NO_LAUNCHES, "flash_fwd": 1}, 1)
            plain = check_no_plain_route("seq_parallel")
            line = {"phase": "seq_parallel", "shape": list(SEQ_SHAPE),
                    "dtype": "bfloat16", "causal": True,
                    "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                    "backend": dist.get_backend(), "launches": launches,
                    "plain_attention_calls": plain}
            for name, out in outs.items():
                check(out.shape == q.shape and out.dtype == q.dtype,
                      f"{name}: {out.shape} {out.dtype}")
                line[name] = hold_output(f"seq_parallel {name}", out, ref)
            del outs, ref
            for name, fn in runs.items():
                line[name]["ms"] = median_ms(
                    lambda fn=fn: shard_map(fn, mesh=mesh,
                                            in_specs=(spec,) * 3,
                                            out_specs=spec)(q, k, v),
                    iters=5, reps=2, warmup=1)
            line["mha_reference_bf16_ms"] = median_ms(
                lambda: attention.mha_reference(q, k, v, True), iters=5,
                reps=2, warmup=1)
            x = q.contiguous()
            with axis_env(mesh):
                tiled = all_to_all(x, "sp", split_axis=2, concat_axis=1,
                                   tiled=True)
                untiled = all_to_all(x, "sp", split_axis=0, concat_axis=2)
            check(torch.equal(tiled, x)
                  and torch.equal(untiled, x.movedim(0, 2)),
                  "all_to_all at axis size 1 is not the identity")
            line["all_to_all_size1_identity"] = True
        line["card"] = card_line()
        emit(line)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


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


# trainer_resume: GPT-2 through TorchTrainer, 12 steps, an async
# checkpoint every 4, attempt 0 failing after step 10's report
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL_AFTER = 12, 4, 10
RESHARD_STEPS = 2   # steps before a save, and after each restore
LLAMA_RESUME_STEPS = 2


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def state_bytes(state) -> int:
    from ray_tpu_torch.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(state)
               if isinstance(x, torch.Tensor))


def same_bits(a, b) -> bool:
    """Two train states (plain or DTensor leaves) hold the same bits."""
    from ray_tpu_torch.tree import tree_leaves
    from torch.distributed.tensor import DTensor

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, DTensor):
            x, y = x.to_local(), y.to_local()
        if isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif int(x) != int(y):
            return False
    return True


def check_launches(kernels, what: str, per_step: dict, steps: int) -> dict:
    launches = dict(kernels.LAUNCHES)
    hold_launches(what, launches, per_step, steps)
    check_no_plain_route(what)
    return launches


def resume_gpt2(kernels, gpt2, tmp: str) -> dict:
    """GPT-2 small [8, 1024] through `TorchTrainer.fit()` (spmd mode):
    12 steps of TrainStep + adamw, `report` every step and `async_save`
    of the whole state every 4th; attempt 0 raises after step 10's
    report, attempt 1 restores step 8's checkpoint onto a fresh state and
    runs to 12. Held bit-equal to the same 12 steps uninterrupted (its
    steps timed with no write in flight)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.observability import flops
    from ray_tpu_torch.observability.step_timer import StepTimer
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.tree import tree_leaves

    _, loss_fn, cfg, _, b, t, seed, per_step = gpt2_train_args(kernels,
                                                               gpt2)
    batch = train_batch(cfg, b, t, seed)
    fpt = flops.train_flops_per_token(cfg, t)

    def fresh():
        step = train.TrainStep(loss_fn, adamw(3e-4, weight_decay=0.1),
                               flops_per_token=fpt, device="cuda")
        return step, step.init_state(gpt2_train_args(kernels, gpt2)[3])

    # the uninterrupted run, its steps synchronised as the session's are
    step, ref = fresh()
    step.timer = StepTimer()
    reset_counts(kernels)
    ref_losses, ref_ms = [], []
    for _ in range(RESUME_STEPS):
        t0 = time.perf_counter()
        ref, m = step(ref, batch)
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        ref_losses.append(float(m["loss"]))
        step.timer.end_step()
    check_launches(kernels, "trainer_resume uninterrupted", per_step,
                   RESUME_STEPS)

    rec = {"losses": {}, "snapshot_ms": [], "report_ms": [], "ckpts": [],
           "steps": [], "restore_ms": None}

    def in_flight() -> bool:
        return any(not c.committed for c in rec["ckpts"])

    def train_fn(config):
        step, state = fresh()
        resume = train.get_checkpoint()
        if resume is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = train.restore(resume.path, like=state)
            torch.cuda.synchronize()
            rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
            rec["restored_step"] = int(state["step"])
        attempt = train.get_context().attempt
        for s in range(int(state["step"]) + 1, RESUME_STEPS + 1):
            busy = in_flight()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            ms = (time.perf_counter() - t0) * 1e3
            rec["steps"].append({"attempt": attempt, "step": s, "ms": ms,
                                 "write_in_flight": busy and in_flight()})
            loss = float(m["loss"])
            rec["losses"][(attempt, s)] = loss
            ck = None
            if s % RESUME_EVERY == 0:
                t0 = time.perf_counter()
                with train.get_step_timer().phase("checkpoint"):
                    ck = train.async_save(
                        os.path.join(tmp, "work", f"a{attempt}-s{s}"), state)
                rec["snapshot_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["ckpts"].append(ck)
            t0 = time.perf_counter()
            train.report({"step": s, "loss": loss}, checkpoint=ck)
            if ck is not None:
                rec["report_ms"].append((time.perf_counter() - t0) * 1e3)
            if attempt == 0 and s == RESUME_FAIL_AFTER:
                raise RuntimeError("scripted failure after step "
                                   f"{RESUME_FAIL_AFTER}'s report")
        rec["state"] = state

    reset_counts(kernels)
    result = train.TorchTrainer(
        train_fn, run_config=train.RunConfig(
            name="gpt2", storage_path=os.path.join(tmp, "exp"),
            checkpoint_config=train.CheckpointConfig(num_to_keep=2),
            failure_config=train.FailureConfig(max_failures=1)),
        restart_backoff_base_s=0.01).fit()
    steps_run = RESUME_FAIL_AFTER + RESUME_STEPS - 8
    launches = check_launches(kernels, "trainer_resume GPT-2 fit", per_step,
                              steps_run)
    check(result.error is None, f"fit failed: {result.error!r}")
    check(rec.get("restored_step") == 8,
          f"attempt 1 resumed from step {rec.get('restored_step')}, not 8")
    first = [rec["losses"][(0, s)] for s in range(1, RESUME_FAIL_AFTER + 1)]
    resumed = [rec["losses"][(1, s)] for s in range(9, RESUME_STEPS + 1)]
    check(first == ref_losses[:RESUME_FAIL_AFTER],
          f"attempt 0 losses {first} vs uninterrupted {ref_losses}")
    check(resumed == ref_losses[8:],
          f"resumed losses {resumed} vs uninterrupted {ref_losses[8:]}")
    final = rec["state"]
    check(same_bits(final, ref), "resumed parameters, moments, count or "
          "step differ from the uninterrupted run's")
    ck_root = os.path.join(result.path, "checkpoints")
    kept = sorted(os.listdir(ck_root))
    with open(os.path.join(result.checkpoint.path, "metrics.json")) as f:
        last = json.load(f)
    check(len(kept) == 2 and last["step"] == RESUME_STEPS
          and result.checkpoint.path == os.path.join(ck_root, kept[-1]),
          f"kept {kept}, result checkpoint {result.checkpoint.path} of "
          f"step {last['step']}")
    for c in rec["ckpts"]:
        check(c.committed and c.write_s is not None,
              f"checkpoint {c.path} not committed")
    # a measurement, not a gate: a fast disk may commit within a step
    flight = [x["ms"] for x in rec["steps"] if x["write_in_flight"]]
    history = result.metrics_history
    return {
        "model": "gpt2-small", "dtype": "bfloat16", "tokens": [b, t],
        "steps": RESUME_STEPS, "checkpoint_every": RESUME_EVERY,
        "failed_after_step": RESUME_FAIL_AFTER, "resumed_from_step": 8,
        "steps_run": steps_run, "launches": launches,
        "losses_uninterrupted": ref_losses, "losses_resumed": resumed,
        "losses_bit_equal": True, "state_bit_equal": True,
        "kept_checkpoints": kept, "result_checkpoint_step": last["step"],
        "checkpoint_bytes": dir_bytes(result.checkpoint.path),
        "state_tensor_bytes": state_bytes(final),
        "leaves": len(tree_leaves(final)),
        "async_save_ms": rec["snapshot_ms"],
        "report_with_checkpoint_ms": rec["report_ms"],
        "writer_ms": [c.write_s * 1e3 for c in rec["ckpts"]],
        "restore_ms": rec["restore_ms"],
        "step_ms_write_in_flight": flight,
        "step_ms_write_in_flight_median": statistics.median(flight)
        if flight else None,
        "step_ms_no_checkpointing": ref_ms,
        "step_ms_no_checkpointing_median": statistics.median(ref_ms[1:]),
        "step_ms_trainer": [x["ms"] for x in rec["steps"]],
        "step_timer_checkpoint_ms": {
            str(h["step"]): h["checkpoint_ms"] for h in history},
        "step_timer_step_time_ms": {
            str(h["step"]): h["step_time_ms"] for h in history}}


def reshard_gpt2(kernels, gpt2, tmp: str) -> dict:
    """GPT-2 small's mesh-form state (DTensors on one NCCL rank, the
    model's partition specs) after 2 steps, saved and restored into the
    one-device TrainStep; that saved and restored back into the mesh
    form. Two steps on each side are held bit-equal to the mesh step
    continuing without a save."""
    import torch.distributed as dist
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train.optim import adamw

    _, loss_fn, cfg, _, b, t, seed, per_step = gpt2_train_args(kernels,
                                                               gpt2)
    batch = train_batch(cfg, b, t, seed)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")

        def fresh(on_mesh: bool):
            kw = dict(mesh=mesh, param_specs=gpt2.gpt2_partition_specs(
                cfg)) if on_mesh else {}
            step = train.TrainStep(loss_fn, adamw(3e-4, weight_decay=0.1),
                                   device="cuda", **kw)
            return step, step.init_state(gpt2_train_args(kernels, gpt2)[3])

        def run(step, state, n):
            losses = []
            for _ in range(n):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            return state, losses

        reset_counts(kernels)
        mesh_step, state = fresh(True)
        state, _ = run(mesh_step, state, RESHARD_STEPS)
        train.async_save(os.path.join(tmp, "mesh"), state).wait()
        _, want = run(mesh_step, state, RESHARD_STEPS)
        del state
        one_step, one = fresh(False)
        one = train.restore(os.path.join(tmp, "mesh"), like=one)
        train.async_save(os.path.join(tmp, "one"), one).wait()
        _, got_one = run(one_step, one, RESHARD_STEPS)
        del one
        mesh_step2, back = fresh(True)
        back = train.restore(os.path.join(tmp, "one"), like=back)
        _, got_mesh = run(mesh_step2, back, RESHARD_STEPS)
        launches = check_launches(kernels, "trainer_resume reshard",
                                  per_step, 4 * RESHARD_STEPS)
    finally:
        dist.destroy_process_group()
    check(got_one == want and got_mesh == want,
          f"reshard: one-device {got_one}, mesh again {got_mesh}, mesh "
          f"continuing {want}")
    return {"model": "gpt2-small", "mesh": dict(zip(
        mesh.mesh_dim_names, mesh.mesh.shape)), "steps_each": RESHARD_STEPS,
        "losses_mesh_continuing": want, "losses_one_device_restored":
        got_one, "losses_mesh_restored": got_mesh, "bit_equal": True,
        "launches": launches}


def resume_llama(kernels, llama, tmp: str) -> dict:
    """Llama small [4, 2048]: 2 steps, a save, a restore onto a fresh
    state (bit-equal to the saved state), then 2 more steps on the
    restored and on the unrestored state: losses within
    MESH_LOSS_TOL["llama-small"] (the fused backward's atomics)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.optim import adamw

    model, loss_fn, cfg, _, b, t, seed, per_step = llama_train_args(llama)
    batch = train_batch(cfg, b, t, seed)

    def fresh():
        step = train.TrainStep(loss_fn, adamw(3e-4, weight_decay=0.1),
                               device="cuda")
        return step, step.init_state(llama_train_args(llama)[3])

    reset_counts(kernels)
    step, state = fresh()
    for _ in range(LLAMA_RESUME_STEPS):
        state, _ = step(state, batch)
    train.async_save(os.path.join(tmp, "llama"), state).wait()
    step2, back = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = train.restore(os.path.join(tmp, "llama"), like=back)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(back, state), "llama: the restored state differs from "
          "the saved one")
    want, got = [], []
    for _ in range(LLAMA_RESUME_STEPS):
        state, m = step(state, batch)
        want.append(float(m["loss"]))
        back, m = step2(back, batch)
        got.append(float(m["loss"]))
    launches = check_launches(kernels, "trainer_resume llama", per_step,
                              3 * LLAMA_RESUME_STEPS)
    tol = MESH_LOSS_TOL[model]
    diff = max(abs(a - r) for a, r in zip(got, want))
    check(diff <= tol, f"llama resumed losses {got} vs unrestored {want}")
    return {"model": model, "dtype": "bfloat16", "tokens": [b, t],
            "restored_bit_equal": True, "losses_unrestored": want,
            "losses_restored": got, "loss_max_abs_diff": diff,
            "loss_tol": tol, "restore_ms": restore_ms,
            "checkpoint_bytes": dir_bytes(os.path.join(tmp, "llama")),
            "launches": launches}


def phase_trainer_resume(kernels, gpt2, llama) -> None:
    """Checkpoints and the trainer's fit loop on the card: `resume_gpt2`,
    `reshard_gpt2` and `resume_llama`, each counted from 0, in a
    temporary directory removed at the end whatever happens."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="trainer-resume-")
    try:
        line = {"phase": "trainer_resume", "card": card_line(),
                "gpt2": resume_gpt2(kernels, gpt2, tmp)}
        shutil.rmtree(tmp)
        os.makedirs(tmp)
        line["reshard"] = reshard_gpt2(kernels, gpt2, tmp)
        shutil.rmtree(tmp)
        os.makedirs(tmp)
        line["llama"] = resume_llama(kernels, llama, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"{tmp} was not removed")
    line["tmp_removed"] = True
    emit(line)


SERVE_LENGTHS = [8, 40, 77, 120, 160, 200]
SERVE_NEW = 32
PAGED_NEW = 32


def serve_prompts(cfg) -> list:
    gen = torch.Generator().manual_seed(3)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in SERVE_LENGTHS]


def run_engine(engine_mod, params, cfg, prompts, **engine_kw):
    """ContinuousBatchingEngine(max_batch=4, **engine_kw) answering
    `prompts`, each submitted from a thread of its own. Returns each
    stream's tokens and per-token logprobs, the wall seconds and each
    time to first token."""
    new = SERVE_NEW
    eng = engine_mod.ContinuousBatchingEngine(params, cfg, max_batch=4,
                                              **engine_kw)
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
                     generate_mod):
    """A model at fp32, where the oracle is token identity with
    generate() at batch 1 while the engine decodes at batch 4. Returns
    the prompts and generate()'s streams."""
    prompts = serve_prompts(cfg)
    results, _, wall, ttft = run_engine(engine_mod, params, cfg, prompts)
    want = generated(generate_mod, params, cfg, prompts)
    mismatched = [i for i, (r, w) in enumerate(zip(results, want))
                  if r != w]
    check(not mismatched, f"serve {model}: streams {mismatched} differ "
          f"from generate()")
    emit({**serve_line(model, "float32", prompts, wall, ttft),
          "streams_equal_generate": len(prompts)})
    return prompts, want


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


# GPT-2 small's KV block, [layers, block tokens, heads, head_dim]
KV_OPS_BLOCK = (12, 16, 12, 64)


def phase_kv_ops(kvcache) -> None:
    """Each device op of the paged KV cache on the card against the same
    op on CPU tensors, at GPT-2 small's block shape in fp32 and bf16: the
    fp ops (write, copy-on-write, gather, extract) bit for bit, the int8
    ops (quantize, write, copy-on-write, verbatim write, dequantizing
    gather) byte for byte in the blocks and their scales."""
    layers, bs, heads, hd = KV_OPS_BLOCK
    n = 8
    pool_shape, scale_shape = ((layers, n, bs, heads, hd),
                               (layers, n, 1, heads, hd))
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(31)
        pools = [torch.randn(pool_shape, generator=gen).to(dtype)
                 for _ in range(2)]
        blks = [torch.randn((layers, 3, bs, heads, hd), generator=gen)
                .to(dtype) for _ in range(2)]
        blks[0][:, :, :, 0, :8] = 0       # channels whose amax is 0
        window = [torch.randn((layers, 64, heads, hd), generator=gen)
                  .to(dtype) for _ in range(2)]
        qpools = [torch.randint(-127, 128, pool_shape, generator=gen,
                                dtype=torch.int8) for _ in range(2)]
        qpools += [torch.rand(scale_shape, generator=gen) * 0.05
                   for _ in range(2)]
        rows = torch.cat([torch.arange(0, 16), torch.arange(32, 48)])

        def ops(dev):
            def on(ts):
                return [t.to(dev).clone() for t in ts]

            def idx(*v):
                return torch.tensor(v, device=dev)

            pk, pv = on(pools)
            bk, bv = on(blks)
            out = {}
            kvcache._write_block(pk, pv, idx(5, 1, 6), bk, bv)
            out["write_block"] = [pk.clone(), pv.clone()]
            kvcache._cow_extend_block(pk, pv, idx(2), idx(5), bk[:, 1:2],
                                      bv[:, 1:2], 7)
            out["cow_extend_block"] = [pk.clone(), pv.clone()]
            out["gather_prefix"] = list(kvcache._gather_prefix(
                pk, pv, idx(2, 5, 1), 40))
            out["extract_block"] = list(kvcache._extract_block(
                *on(window), rows.to(dev), bs))
            out["quantize"] = list(kvcache._quantize(bk))
            q = on(qpools)
            kvcache._write_block_q(*q, idx(5, 1, 6), bk, bv)
            out["write_block_q"] = [t.clone() for t in q]
            kvcache._cow_extend_block_q(*q, idx(2), idx(5), bk[:, 1:2],
                                        bv[:, 1:2], 7)
            out["cow_extend_block_q"] = [t.clone() for t in q]
            kvcache._write_block_qraw(*q, idx(7, 0),
                                      *[t[:, 1:3].clone() for t in q])
            out["write_block_qraw"] = [t.clone() for t in q]
            out["gather_prefix_q"] = list(kvcache._gather_prefix_q(
                *q, idx(2, 5, 7), 40, dtype))
            return out

        cpu, card = ops("cpu"), ops("cuda")
        torch.cuda.synchronize()
        for name, want in cpu.items():
            got = [t.cpu() for t in card[name]]
            same = all(g.dtype == w.dtype and g.shape == w.shape
                       and torch.equal(g, w) for g, w in zip(got, want))
            check(same, f"kv op {name} ({dtype}) on the card differs from "
                  f"the CPU")
            results.setdefault(name, []).append(str(dtype))
    emit({"phase": "kv_ops", "block": list(KV_OPS_BLOCK), "pool_blocks": n,
          "bit_equal_to_cpu": results})


# the paged serving traffic: one system prompt of 256 tokens (16 full
# blocks of 16) and a distinct tail per request; request 1's tail begins
# with the whole of request 0's 8-token tail, so its prefill widens
# request 0's cached partial block (copy-on-write)
PAGED_SYSTEM = 256
PAGED_TAILS = [8, 24, 40, 64, 17, 33, 50, 12]


def paged_prompts(cfg, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    system = torch.randint(0, cfg.vocab_size, (PAGED_SYSTEM,), generator=gen)
    tails = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
             for n in PAGED_TAILS]
    tails[1][:PAGED_TAILS[0]] = tails[0]
    return [torch.cat([system, t]).tolist() for t in tails]


def run_paged(eng, prompts, new: int):
    """Submit `prompts` in order, each once a slot is free and after the
    one before it has its first token (so admission follows the list);
    a thread drains each stream. Returns each stream's tokens, its cache
    outcome and reused tokens, and its time to first token (seconds,
    from submit)."""
    n = len(prompts)
    results, outcomes, ttft, errors, threads = [None] * n, [], [], [], []

    def drain(i, first, stream):
        try:
            results[i] = [first] + list(stream)
        except Exception as err:  # noqa: BLE001 — re-raised below
            errors.append(err)

    for i, p in enumerate(prompts):
        deadline = time.monotonic() + 300
        while eng.free_slots == 0:
            check(time.monotonic() < deadline, "no slot freed")
            time.sleep(0.001)
        t0 = time.perf_counter()
        stream = eng.stream(p, new, timeout_s=300.0)
        first = next(stream)
        ttft.append(time.perf_counter() - t0)
        outcomes.append((stream.cache_outcome, stream.reused_tokens))
        th = threading.Thread(target=drain, args=(i, first, stream))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=600)
    check(not errors, f"paged serve errors: {errors!r}")
    check(all(r is not None and len(r) == new for r in results),
          "paged serve: a stream did not finish")
    return results, outcomes, ttft


_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def launches_of(fn):
    """(fn's result, its host launches: the CUDA runtime calls that put a
    kernel, a copy or a fill on the card, as torch.profiler records them
    on the host, the device operations CUPTI saw, their summed durations
    (the card's busy time), the traced call's wall time, synchronised on
    both sides, and the five names that took longest)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host = device = 0
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device += 1
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
        elif ev.name.startswith(_LAUNCH_CALLS):
            host += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return out, {"launches": host, "device_ops": device,
                 "device_busy_ms": sum(by_name.values()) / 1e3,
                 "wall_ms": wall_ms,
                 "top_device_ms": [[n[:72], us / 1e3] for n, us in top]}


def _untraced(fn):
    return fn(), None


def host_ms(fn):
    """(fn's result, the host milliseconds it took, the card's work
    included: a synchronise on each side)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def replay_admissions(engine_mod, kvcache, params, cfg, prompts) -> dict:
    """The paged admissions of `prompts` in order, on a pool of their own
    (the engine's default size), each beside the same prompt prefilled
    whole: the largest |logit| difference of the first token, cached
    against uncached; the launches of each step of the first three
    admissions (a miss, the copy-on-write, a hit), traced; and the host
    time of the later admissions, cached and whole, untraced."""
    probe = engine_mod._model_fns(cfg)[1](cfg, 1, max_len=1, device="cuda")
    empty = torch.zeros((cfg.num_layers, 0) + probe[0]["k"].shape[2:],
                        dtype=probe[0]["k"].dtype, device="cuda")
    bs, blocks = kvcache.resolve_pool_config(cfg, slots=4)
    kv = kvcache.PagedKVCache(cfg, block_size=bs, num_blocks=blocks,
                              device="cuda")
    slab = [torch.zeros((cfg.num_layers, 1, cfg.max_seq_len)
                        + empty.shape[2:], dtype=empty.dtype, device="cuda")
            for _ in range(2)]

    def cached(toks, trace):
        m = kv.lookup(toks, len(toks) - 1)
        (pk, pv), gather = trace(lambda: kv.gather(m))
        suffix = torch.from_numpy(toks[m.tokens:])[None].cuda()
        (logits, ck, cv), prefill = trace(
            lambda: engine_mod._prefill_paged(params, suffix, cfg, pk, pv))
        table, commit = trace(lambda: kv.commit(toks, ck, cv, m))
        _, splice = trace(lambda: engine_mod._splice_slot(
            *slab, ck, cv, 0, len(toks)))
        steps = {"gather": gather, "prefill": prefill, "commit": commit,
                 "splice": splice}
        return m, logits, table, steps

    def whole(toks):
        logits, ck, cv = engine_mod._prefill_paged(
            params, torch.from_numpy(toks)[None].cuda(), cfg, empty, empty)
        engine_mod._splice_slot(*slab, ck, cv, 0, len(toks))
        return logits

    v = cfg.vocab_size
    gap, counts, tables, ms_cached, ms_whole = 0.0, {}, [], [], []
    for i, p in enumerate(prompts):
        toks = torch.tensor(p).numpy()
        if i < 3:
            m, logits, table, steps = cached(toks, launches_of)
            counts[f"{m.outcome}_{i}"] = {"reused_tokens": m.tokens,
                                          **steps}
            full, whole_counts = launches_of(lambda: whole(toks))
            counts[f"{m.outcome}_{i}"]["whole_prefill"] = whole_counts
        else:
            (m, logits, table, _), ms = host_ms(lambda: cached(toks,
                                                               _untraced))
            full, ms_full = host_ms(lambda: whole(toks))
            ms_cached.append(ms)
            ms_whole.append(ms_full)
        tables.append(table)
        gap = max(gap, max_err(logits[:, :v], full[:, :v]))
    st = kv.stats()
    for table in tables:
        kv.release(table)
    return {"first_token_logit_max_abs_diff": gap,
            "replay_cow_copies": st["cow_copies"],
            "launches_per_admission": counts,
            "admission_ms_cached_median": statistics.median(ms_cached),
            "admission_ms_whole_prefill_median": statistics.median(ms_whole),
            "admission_ms_cached": ms_cached,
            "admission_ms_whole_prefill": ms_whole}


def phase_serve_paged(model: str, cfg, params, engine_mod, generate_mod,
                      kvcache, tree, distinct):
    """The paged prefix cache under shared-prefix traffic, fp32, max_batch
    4, PAGED_NEW tokens a request: every stream equals batch-1
    generate(); hits, reuse, a copy-on-write and no pin left; the median
    time to first token with the cache and without it; the cached first
    token's logits against an uncached prefill's, and the device
    operations of an admission. Then, on the same engine, a weight swap
    (a pre-swap prompt misses and follows the new weights) and a cancel
    (the slot is admitted again); and an engine with an 8-block pool
    serving `distinct` = (prompts, their generate() streams). Returns the
    paged prompts and their generate() streams."""
    prompts = paged_prompts(cfg, 41)
    want = [generate_mod.generate(params, cfg, [p],
                                  max_new_tokens=PAGED_NEW)[0].tolist()
            for p in prompts]
    eng = engine_mod.ContinuousBatchingEngine(params, cfg, max_batch=4)
    try:
        results, outcomes, ttft = run_paged(eng, prompts, PAGED_NEW)
        mismatched = [i for i, (r, w) in enumerate(zip(results, want))
                      if r != w]
        check(not mismatched, f"serve_paged {model}: streams {mismatched} "
              f"differ from generate()")
        st = eng.kv_stats()
        check(st["hits"] + st["partial_hits"] >= len(prompts) - 1
              and st["reused_tokens"] > 0 and st["cow_copies"] >= 1
              and st["pinned_blocks"] == 0,
              f"serve_paged {model}: cache counters {st}")
        # a weight swap between requests: no stale prefix matches
        scaled = tree.tree_map(lambda x: x * 1.25, params)
        check(eng.update_params(scaled, version=2).wait(60.0),
              "weight swap never applied")
        swapped = eng.stream(prompts[2], PAGED_NEW, timeout_s=300.0)
        swapped_toks = list(swapped)
        check(swapped.cache_outcome == "miss"
              and swapped_toks == generate_mod.generate(
                  scaled, cfg, [prompts[2]],
                  max_new_tokens=PAGED_NEW)[0].tolist(),
              f"serve_paged {model}: after the swap {swapped.cache_outcome}"
              f", stream differs from generate() under the new weights")
        del scaled
        # a cancel: the slot frees at a tick boundary and admits again
        long = eng.stream(prompts[3], 4 * PAGED_NEW, timeout_s=300.0)
        it = iter(long)
        next(it)
        check(eng.cancel_slot(long, reason="deadline"), "cancel refused")
        rest = list(it)
        deadline = time.monotonic() + 60
        while eng.free_slots < 4:
            check(time.monotonic() < deadline, "cancelled slot never freed")
            time.sleep(0.001)
        again = eng.generate(prompts[4], 4, timeout_s=300.0)
        after = eng.kv_stats()
        check(eng.cancelled == 1 and len(rest) < 4 * PAGED_NEW - 1
              and len(again) == 4 and after["pinned_blocks"] == 0
              and after["invalidations"] == 1,
              f"serve_paged {model}: cancel {after}")
    finally:
        eng.stop()
    # the same requests without the cache
    eng = engine_mod.ContinuousBatchingEngine(params, cfg, max_batch=4,
                                              prefix_cache=False)
    try:
        plain_results, _, plain_ttft = run_paged(eng, prompts, PAGED_NEW)
        plain_st = eng.kv_stats()
    finally:
        eng.stop()
    check(plain_results == want,
          f"serve_paged {model}: uncached streams differ from generate()")
    replay = replay_admissions(engine_mod, kvcache, params, cfg, prompts)
    # an exhausted pool: distinct prompts, 8 blocks
    d_prompts, d_want = distinct
    d_results, _, _, _ = run_engine(engine_mod, params, cfg, d_prompts,
                                    kv_pool_blocks=8)
    check(d_results == d_want,
          f"serve_paged {model}: an 8-block pool changed a stream")
    emit({"phase": "serve_paged", "model": model, "dtype": "float32",
          "max_batch": 4, "requests": len(prompts),
          "system_tokens": PAGED_SYSTEM, "tails": PAGED_TAILS,
          "new_tokens": PAGED_NEW, "streams_equal_generate": len(prompts),
          "outcomes": outcomes,
          "ttft_median_ms": statistics.median(ttft) * 1e3,
          "ttft_ms": [x * 1e3 for x in ttft],
          "ttft_median_ms_no_cache": statistics.median(plain_ttft) * 1e3,
          "ttft_ms_no_cache": [x * 1e3 for x in plain_ttft],
          "prefilled_tokens": st["prefilled_tokens"],
          "reused_tokens": st["reused_tokens"],
          "prefilled_tokens_no_cache": plain_st["prefilled_tokens"],
          "kv_stats": {k: st[k] for k in (
              "lookups", "hits", "partial_hits", "misses", "cow_copies",
              "inserted_blocks", "evictions", "num_blocks", "pool_bytes",
              "pinned_blocks", "spliced_tokens", "prefill_calls")},
          **replay,
          "swap_outcome": swapped.cache_outcome,
          "cancelled": 1, "cancelled_stream_tokens": 1 + len(rest),
          "exhausted_pool": {"kv_pool_blocks": 8,
                             "requests": len(d_prompts),
                             "streams_equal_generate": len(d_prompts)}})
    return prompts, want


def phase_serve_paged_int8(cfg, params, engine_mod, generate_mod,
                           kvcache) -> None:
    """GPT-2 small in bf16 with the int8 pool (`kv_int8=True`) under the
    shared-prefix traffic: its first stream (a miss: no gather) equals an
    fp-pool engine's; the hits reuse dequantized blocks; a hit's
    dequantized prefix lies within 0.05 of the exact rows and its
    first-token logits within 0.05 relative (the JAX package's contract,
    tests/test_speculate.py); the pool reports capacity factor 2."""
    prompts = paged_prompts(cfg, 43)
    eng = engine_mod.ContinuousBatchingEngine(params, cfg, max_batch=4)
    try:
        fp_first = eng.generate(prompts[0], PAGED_NEW, timeout_s=300.0)
    finally:
        eng.stop()
    eng = engine_mod.ContinuousBatchingEngine(params, cfg, max_batch=4,
                                              kv_int8=True)
    try:
        results, outcomes, ttft = run_paged(eng, prompts, PAGED_NEW)
        st = eng.kv_stats()
    finally:
        eng.stop()
    check(results[0] == fp_first,
          "serve_paged_int8: the miss stream differs from the fp pool's")
    check(st["hits"] + st["partial_hits"] >= len(prompts) - 1
          and st["capacity_factor"] == 2 and st["int8"]
          and st["pinned_blocks"] == 0,
          f"serve_paged_int8: cache counters {st}")
    # the tolerance contract on one hit: the system prompt committed,
    # then request 2 gathered back out of the int8 pool
    probe = engine_mod._model_fns(cfg)[1](cfg, 1, max_len=1, device="cuda")
    empty = torch.zeros((cfg.num_layers, 0) + probe[0]["k"].shape[2:],
                        dtype=probe[0]["k"].dtype, device="cuda")
    kv = kvcache.PagedKVCache(cfg, block_size=16, num_blocks=64, int8=True,
                              device="cuda")
    full = torch.tensor(prompts[2])[None].cuda()
    ref_logits, ck, cv = engine_mod._prefill_paged(params, full, cfg, empty,
                                                   empty)
    system = full[0, :PAGED_SYSTEM].cpu().numpy()
    kv.commit(system, ck, cv, kv.lookup(system, PAGED_SYSTEM - 1))
    m = kv.lookup(full[0].cpu().numpy(), full.shape[1] - 1)
    gk, gv = kv.gather(m)
    ref_k = ck[:, :m.tokens].float()
    kv_err = float((gk.float() - ref_k).abs().max() / ref_k.abs().max())
    got, _, _ = engine_mod._prefill_paged(params, full[:, m.tokens:], cfg,
                                          gk, gv)
    live = slice(0, cfg.vocab_size)
    ref = ref_logits[0, live].float()
    logit_err = float((got[0, live].float() - ref).abs().max()
                      / ref.abs().max())
    check(m.tokens == PAGED_SYSTEM and kv_err < 0.05 and logit_err < 0.05,
          f"serve_paged_int8: {m.tokens} tokens matched, prefix err "
          f"{kv_err}, logits err {logit_err}")
    emit({"phase": "serve_paged_int8", "model": "gpt2-small",
          "dtype": "bfloat16", "max_batch": 4, "requests": len(prompts),
          "miss_stream_equals_fp_pool": True, "outcomes": outcomes,
          "ttft_median_ms": statistics.median(ttft) * 1e3,
          "prefix_max_rel_err": kv_err, "first_logits_max_rel_err": logit_err,
          "tol": 0.05, "capacity_factor": st["capacity_factor"],
          "num_blocks": st["num_blocks"], "pool_bytes": st["pool_bytes"],
          "hits": st["hits"], "partial_hits": st["partial_hits"],
          "reused_tokens": st["reused_tokens"],
          "cow_copies": st["cow_copies"]})


# speculative decoding: drafts per slot; the boundary request fills the
# window (prompt + new tokens = max_seq_len)
SPEC_K = 4
SPEC_BOUNDARY = {"gpt2-small": (1000, 24), "llama-small": (2000, 48)}
SPEC_REPEATS = 3
_SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_verify_ticks",
              "spec_emitted_tokens")


def spec_counts(eng, before=None) -> dict:
    """The engine's speculation counters since `before` (a dict this
    function returned), with their acceptance rate and tokens per verify
    step."""
    st = eng.speculation_stats()
    d = {k: st[k] - (before or {}).get(k, 0) for k in _SPEC_KEYS}
    d["acceptance_rate"] = (d["spec_accepted"] / d["spec_proposed"]
                            if d["spec_proposed"] else 0.0)
    d["tokens_per_verify"] = (d["spec_emitted_tokens"]
                              / d["spec_verify_ticks"]
                              if d["spec_verify_ticks"] else 0.0)
    return d


def scripted_source(chain, corrupt_at=None):
    """Drafts replaying the true greedy `chain` (full acceptance), one
    position corrupted (partial), as tests/test_speculate.py scripts."""
    def src(ctx, k):
        if chain[:len(ctx)] != ctx:
            return []
        out = list(chain[len(ctx):len(ctx) + k])
        if corrupt_at is not None and len(out) > corrupt_at:
            out[corrupt_at] = (out[corrupt_at] + 1) % 50
        return out
    return src


def stream_gap(engine_mod, params, cfg, prompt, got, want) -> dict:
    """Where a speculated stream first leaves generate()'s: the stream
    index, the top-2 margin of the plain step's logits for it, and the
    largest |difference| between the logits a verify step (the position
    in its last column) and a plain one-token step give there."""
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = list(prompt) + list(want)
    pos = len(prompt) + i - 1   # the position whose logits pick token i
    probe = engine_mod._model_fns(cfg)[1](cfg, 1, max_len=1, device="cuda")
    empty = torch.zeros((cfg.num_layers, 0) + probe[0]["k"].shape[2:],
                        dtype=probe[0]["k"].dtype, device="cuda")
    decode = engine_mod._model_fns(cfg)[2]

    def logits_at(base: int):
        _, ck, cv = engine_mod._prefill_paged(
            params, torch.tensor([seq[:base]], device="cuda"), cfg, empty,
            empty)
        cache = [{"k": k[None], "v": v[None]} for k, v in zip(ck, cv)]
        toks = torch.tensor([seq[base:pos + 1]], device="cuda")
        out, _ = decode(params, toks, cfg, cache,
                        torch.tensor([base], device="cuda"))
        return out[0, -1, :cfg.vocab_size].float()

    out = {"first_diff_index": i, "got": got[i], "want": want[i]}
    if i == 0:
        return out  # the prefill's token: no step of the loop chose it
    plain = logits_at(pos)
    verify = logits_at(max(len(prompt), pos - SPEC_K))
    top = plain.topk(2).values
    out.update(top2_margin=float(top[0] - top[1]),
               verify_vs_plain_max_abs=max_err(verify, plain))
    return out


def check_streams(phase: str, engine_mod, params, cfg, jobs, got,
                  want) -> None:
    """Fails when a stream differs from its reference, after printing
    where the first one left it (`stream_gap`)."""
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        i = bad[0]
        emit({"phase": f"{phase}_stream_differs", "streams": bad,
              **stream_gap(engine_mod, params, cfg, jobs[i], got[i],
                           want[i])})
    check(not bad, f"{phase}: streams {bad} differ from generate()")


def step_cost(fn) -> dict:
    """One decode step's host launches and its host time (median of 10,
    the results copied to the host as the engine does)."""
    fn()
    _, counts = launches_of(fn)
    ms = [host_ms(fn)[1] for _ in range(10)]
    return {**counts, "host_ms_median": statistics.median(ms)}


def tick_costs(engine_mod, params, cfg) -> dict:
    """A plain step (tokens [4]) and a verify step (tokens [4, k+1]) of
    four slots, each its host launches and time."""
    cache = engine_mod._model_fns(cfg)[1](cfg, 4, device="cuda")
    gen = torch.Generator().manual_seed(5)
    pos = torch.tensor([300, 301, 302, 303], device="cuda")
    out = {}
    for name, shape in (("plain_tick", (4,)),
                        ("verify_tick", (4, SPEC_K + 1))):
        tok = torch.randint(0, cfg.vocab_size, shape, generator=gen).cuda()

        def step():
            nxt, lp = engine_mod._tick(params, cfg, cache, tok, pos)
            return nxt.cpu(), lp.cpu()

        out[name] = step_cost(step)
    return out


def phase_serve_spec(model: str, cfg, params, engine_mod, generate_mod,
                     paged) -> None:
    """Speculative decoding (`speculate_k` 4), fp32, max_batch 4, on the
    serve_paged traffic (`paged` = its prompts and generate() streams):
    round A the 8 requests on an empty engine, round B the same again,
    drafted from the output memory; SPEC_REPEATS times each, a swap to the
    same weights emptying the cache and the memory before each repeat,
    beside a speculate_k=0 engine doing the same. Every stream equals
    generate()'s. Then scripted drafts (full, partial and zero
    acceptance), and a request filling the window (SPEC_BOUNDARY) beside
    two longer ones, every step a verify step: its own padded columns and
    then its idle slot at max_seq_len - 1 run past the window."""
    prompts, want = paged
    Engine = engine_mod.ContinuousBatchingEngine
    spec = Engine(params, cfg, max_batch=4, speculate_k=SPEC_K)
    plain = Engine(params, cfg, max_batch=4)
    rates = {r: {"speculate": [], "plain": []} for r in "AB"}
    counts = {r: [] for r in "AB"}
    try:
        for rep in range(SPEC_REPEATS):
            for eng in (spec, plain):
                check(eng.update_params(params, version=rep).wait(60.0),
                      "serve_spec: a weight swap never applied")
            for rnd in "AB":
                for name, eng in (("speculate", spec), ("plain", plain)):
                    before = spec_counts(spec)
                    t0 = time.perf_counter()
                    got, _, _ = run_paged(eng, prompts, PAGED_NEW)
                    wall = time.perf_counter() - t0
                    check_streams(f"serve_spec {model} round {rnd} {name}",
                                  engine_mod, params, cfg, prompts, got,
                                  want)
                    rates[rnd][name].append(len(prompts) * PAGED_NEW / wall)
                    if name == "speculate":
                        counts[rnd].append(spec_counts(spec, before))
        pinned = spec.kv_stats()["pinned_blocks"]
    finally:
        spec.stop()
        plain.stop()
    check(pinned == 0, f"serve_spec {model}: {pinned} blocks left pinned")
    check(all(c["spec_accepted"] > 0 for c in counts["B"]),
          f"serve_spec {model}: round B accepted no draft {counts['B']}")
    # the acceptance spectrum on request 0
    chain = prompts[0] + want[0]
    scripted = {}
    for mode, src in (("full", scripted_source(chain)),
                      ("partial", scripted_source(chain, corrupt_at=2)),
                      ("zero", lambda ctx, k: [0] * k)):
        eng = Engine(params, cfg, max_batch=4, speculate_k=SPEC_K,
                     draft_source=src)
        try:
            got = eng.generate(prompts[0], PAGED_NEW, timeout_s=300.0)
            scripted[mode] = spec_counts(eng)
        finally:
            eng.stop()
        check_streams(f"serve_spec {model} {mode} drafts", engine_mod,
                      params, cfg, prompts[:1], [got], want[:1])
    rate = {m: c["acceptance_rate"] for m, c in scripted.items()}
    check(rate["full"] == 1.0 and 0.0 < rate["partial"] < 1.0
          and rate["zero"] == 0.0,
          f"serve_spec {model}: scripted acceptance {rate}")
    # the end of the window
    plen, new = SPEC_BOUNDARY[model]
    check(plen + new == cfg.max_seq_len, "the boundary must fill the window")
    gen = torch.Generator().manual_seed(47)
    edge = torch.randint(0, cfg.vocab_size, (plen,), generator=gen).tolist()
    jobs = [(edge, new), (prompts[1], new + 16), (prompts[2], new + 16)]
    refs = [generate_mod.generate(params, cfg, [p], max_new_tokens=n)[0]
            .tolist() for p, n in jobs]
    eng = Engine(params, cfg, max_batch=4, speculate_k=SPEC_K,
                 draft_source=lambda ctx, k: [0] * k)
    try:
        streams = []
        for p, n in jobs:  # admitted in this order, one a tick
            streams.append(eng.stream(p, n, timeout_s=300.0))
            first = next(streams[-1])
            streams[-1] = (first, streams[-1])
        got = [[first] + list(s) for first, s in streams]
        edge_pos = int(eng._pos.max())
        boundary = spec_counts(eng)
        alive = eng._thread.is_alive()
    finally:
        eng.stop()
    check(alive, f"serve_spec {model}: the loop died at the window's end")
    check_streams(f"serve_spec {model} boundary", engine_mod, params, cfg,
                  [p for p, _ in jobs], got, refs)
    check(edge_pos == cfg.max_seq_len - 1
          and boundary["spec_verify_ticks"] >= new + 15,
          f"serve_spec {model}: boundary slot at {edge_pos}, {boundary}")
    emit({"phase": "serve_spec", "model": model, "dtype": "float32",
          "speculate_k": SPEC_K, "max_batch": 4, "requests": len(prompts),
          "new_tokens": PAGED_NEW, "repeats": SPEC_REPEATS,
          "streams_equal_generate": True,
          "rounds": {r: {
              "spec": counts[r],
              "acceptance_rate": [c["acceptance_rate"] for c in counts[r]],
              "tokens_per_verify": [c["tokens_per_verify"]
                                    for c in counts[r]],
              "spec_verify_ticks": [c["spec_verify_ticks"]
                                    for c in counts[r]],
              "decode_tokens_per_s_speculate": statistics.median(
                  rates[r]["speculate"]),
              "decode_tokens_per_s_plain": statistics.median(
                  rates[r]["plain"]),
              "decode_tokens_per_s_all": rates[r]} for r in "AB"},
          "scripted": scripted,
          "boundary": {"prompt_tokens": plen, "new_tokens": new,
                       "idle_slot_position": edge_pos, **boundary},
          **tick_costs(engine_mod, params, cfg)})


LORA_RANK = 8
# 2 x the JAX package's default adapter: a delta near 0.7 of a weight's
# own spread, so every tenant's stream leaves base's (at scale 1 and rank
# 3-4 the tiny models' streams often do not move)
LORA_SCALE = 2.0
# a tenant slot's logits against the plain decode on merged weights:
# the same function summed in another order, in fp32
LORA_LOGITS_TOL = 1e-3


def run_jobs(eng, jobs, new: int) -> list:
    """(prompt, adapter) jobs submitted together from threads of their
    own; each stream's tokens."""
    with cf.ThreadPoolExecutor(len(jobs)) as pool:
        futs = [pool.submit(eng.generate, p, new, timeout_s=300.0,
                            adapter_id=t) for p, t in jobs]
        return [f.result(timeout=600) for f in futs]


def phase_serve_lora(model: str, cfg, params, engine_mod, lora_mod,
                     generate_mod, serve) -> None:
    """Multi-tenant LoRA, fp32, max_batch 4, an AdapterPool with its
    defaults (8 rows, rank 8) and two tenants (rank LORA_RANK, scale
    LORA_SCALE): the `serve` prompts 0 and 1 (`serve` = the prompts and
    their generate() streams), each as tenant 0, tenant 1 and base, all
    six at once. Mixed streams equal the sequential ones, base equals
    generate(), each tenant's stream differs from base and from the
    other's; speculated (k 4) mixed batches, twice, equal them; a tenant
    slot's logits lie within LORA_LOGITS_TOL of the plain decode on
    `merge_lora_params` weights and a base slot's equal the decode
    without adapters; a hot swap of tenant 0 mid-decode leaves the others'
    streams as they were."""
    prompts, want = serve
    adapters = {f"t{i}": lora_mod.make_lora_adapter(
        cfg, LORA_RANK, seed=40 + i, scale=LORA_SCALE) for i in range(2)}
    jobs = [(p, t) for p in prompts[:2] for t in ("t0", "t1", None)]
    Engine = engine_mod.ContinuousBatchingEngine

    def pool():
        return lora_mod.AdapterPool(cfg, source=lora_mod.LocalAdapterSource(
            dict(adapters)), device="cuda")

    eng = Engine(params, cfg, max_batch=4, lora_pool=pool())
    try:
        mixed = run_jobs(eng, jobs, SERVE_NEW)
        seq = [eng.generate(p, SERVE_NEW, timeout_s=300.0, adapter_id=t)
               for p, t in jobs]
        # a hot swap of t0 while t1 and base decode
        live = [eng.stream(p, SERVE_NEW, timeout_s=300.0, adapter_id=t)
                for p, t in jobs[1:3]]
        firsts = [next(s) for s in live]
        eng.lora_pool.source.publish("t0", lora_mod.make_lora_adapter(
            cfg, LORA_RANK, seed=77, scale=LORA_SCALE))
        swapped = eng.lora_pool.refresh("t0")
        during = [[f] + list(s) for f, s in zip(firsts, live)]
        version = eng.lora_pool.resident_version("t0")
        pool_stats = eng.lora_pool.stats()
    finally:
        eng.stop()
    check(mixed == seq, f"serve_lora {model}: mixed streams differ from "
          f"the sequential ones")
    check_streams(f"serve_lora {model} base", engine_mod, params, cfg,
                  prompts[:2], [mixed[2], mixed[5]], want[:2])
    for i in (0, 3):
        check(len({tuple(x) for x in mixed[i:i + 3]}) == 3,
              f"serve_lora {model}: a tenant's stream equals base's or the "
              f"other tenant's (prompt {i // 3})")
    check(swapped and version == 2 and during == mixed[1:3],
          f"serve_lora {model}: the hot swap of t0 changed another stream")
    check(pool_stats["pinned"] == 0, f"serve_lora {model}: pins left")
    spec = Engine(params, cfg, max_batch=4, lora_pool=pool(),
                  speculate_k=SPEC_K)
    try:
        spec_runs = [run_jobs(spec, jobs, SERVE_NEW) for _ in range(2)]
        spec_st = spec.speculation_stats()
    finally:
        spec.stop()
    check(all(r == mixed for r in spec_runs),
          f"serve_lora {model}: speculated mixed streams differ")
    # the LoRA step against merged weights, and its cost
    p = pool()
    rows = np.asarray([p.acquire("t0"), p.acquire("t1"), 0, 0])
    decode = engine_mod._model_fns(cfg)[2]
    gen = torch.Generator().manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (4, SPEC_K + 1),
                        generator=gen).cuda()
    pos = torch.tensor([10, 20, 30, 40], device="cuda")

    def fresh():
        return engine_mod._model_fns(cfg)[1](cfg, 4, device="cuda")

    got, _ = p.dispatch_tick(
        lambda la: decode(params, tok, cfg, fresh(), pos, la), rows)
    base, _ = decode(params, tok, cfg, fresh(), pos)
    errs = []
    for slot in (0, 1):
        merged = generate_mod.merge_lora_params(
            params, cfg, p.adapter_slice(int(rows[slot])))
        ref, _ = decode(merged, tok, cfg, fresh(), pos)
        errs.append(max_err(got[slot, :, :cfg.vocab_size],
                            ref[slot, :, :cfg.vocab_size]))
    check(max(errs) <= LORA_LOGITS_TOL,
          f"serve_lora {model}: tenant logits {errs} off the merged decode")
    check(torch.equal(got[2:], base[2:]),
          f"serve_lora {model}: a base slot's logits moved under LoRA")
    cache = fresh()
    costs = {
        "lora_tick": step_cost(lambda: [x.cpu() for x in p.dispatch_tick(
            lambda la: engine_mod._tick(params, cfg, cache, tok[:, 0], pos,
                                        la), rows)]),
        "base_tick": step_cost(lambda: [x.cpu() for x in engine_mod._tick(
            params, cfg, cache, tok[:, 0], pos)])}
    emit({"phase": "serve_lora", "model": model, "dtype": "float32",
          "max_batch": 4, "pool_slots": p.slots, "rank_max": p.rank_max,
          "tenants": 2, "rank": LORA_RANK, "scale": LORA_SCALE,
          "requests": len(jobs), "new_tokens": SERVE_NEW,
          "mixed_equal_sequential": True, "base_equal_generate": 2,
          "tenants_differ": True, "hot_swap_left_others_unchanged": True,
          "speculated_mixed_equal": len(spec_runs),
          "speculated": {k: spec_st[k] for k in (
              "spec_proposed", "spec_accepted", "spec_verify_ticks",
              "acceptance_rate", "tokens_per_verify")},
          "tenant_logits_vs_merged_max_abs": errs,
          "logits_tol": LORA_LOGITS_TOL, "pool": {k: pool_stats[k] for k in (
              "acquires", "hits", "misses", "swaps", "page_in_bytes")},
          **costs})


def phase_serve_adopt(cfg, params, engine_mod, kvcache, paged) -> None:
    """Adoption, GPT-2 small fp32: the serve_paged prompts 0-3 prefilled
    by `_prefill_with_cache` on a cache of their own, their KV rows and
    first tokens adopted by a `prefix_cache=False` engine. Streams equal
    generate(); no prefill runs there; every prompt token is spliced; a
    wrong dtype or row count raises on the caller's thread and the engine
    then serves the next adoption. The host time of an adoption (the
    splice) beside a prefill admission's (prefill and splice)."""
    prompts, want = (x[:4] for x in paged)
    probe = engine_mod._model_fns(cfg)[1](cfg, 1, max_len=1, device="cuda")
    empty = torch.zeros((cfg.num_layers, 0) + probe[0]["k"].shape[2:],
                        dtype=probe[0]["k"].dtype, device="cuda")
    bs, blocks = kvcache.resolve_pool_config(cfg, slots=4)
    kv = kvcache.PagedKVCache(cfg, block_size=bs, num_blocks=blocks,
                              device="cuda")
    fills = []
    for p in prompts:
        ck, cv, table, first, score, outcome, _, _ = \
            engine_mod._prefill_with_cache(params, cfg, kv, np.asarray([p]),
                                           empty)
        kv.release(table)
        fills.append((ck[:, :len(p)], cv[:, :len(p)], first, score,
                      outcome))
    eng = engine_mod.ContinuousBatchingEngine(params, cfg, max_batch=4,
                                              prefix_cache=False)
    try:
        streams = [eng.adopt_prefill(len(p), f, ck, cv, PAGED_NEW, score=s,
                                     cache_outcome=o, timeout_s=300.0)
                   for p, (ck, cv, f, s, o) in zip(prompts, fills)]
        got = [list(s) for s in streams]
        st = eng.kv_stats()
        ck, cv, f, s, _ = fills[0]
        refused = 0
        for bad in ((ck.to(torch.bfloat16), cv.to(torch.bfloat16)),
                    (ck[:, :-1], cv[:, :-1])):
            try:
                eng.adopt_prefill(len(prompts[0]), f, *bad, PAGED_NEW)
            except ValueError:
                refused += 1
        again = list(eng.adopt_prefill(len(prompts[0]), f, ck, cv,
                                       PAGED_NEW, timeout_s=300.0))
    finally:
        eng.stop()
    check_streams("serve_adopt", engine_mod, params, cfg, prompts, got, want)
    check(st["prefill_calls"] == 0 and st["adopted"] == len(prompts)
          and st["spliced_tokens"] == sum(len(p) for p in prompts),
          f"serve_adopt: counters {st}")
    check(refused == 2 and again == want[0],
          f"serve_adopt: {refused} of 2 bad layouts refused, the next "
          f"adoption {'right' if again == want[0] else 'wrong'}")
    slab = [torch.zeros((cfg.num_layers, 1, cfg.max_seq_len)
                        + empty.shape[2:], dtype=empty.dtype, device="cuda")
            for _ in range(2)]
    adopt_ms, prefill_ms = [], []
    for p, (ck, cv, _, _, _) in zip(prompts, fills):
        adopt_ms.append(host_ms(lambda: engine_mod._splice_slot(
            *slab, ck, cv, 0, len(p)))[1])

        def admit():
            out = engine_mod._prefill_with_cache(
                params, cfg, None, np.asarray([p]), empty)
            engine_mod._splice_slot(*slab, out[0], out[1], 0, len(p))

        prefill_ms.append(host_ms(admit)[1])
    emit({"phase": "serve_adopt", "model": "gpt2-small", "dtype": "float32",
          "max_batch": 4, "adopted": st["adopted"],
          "prefill_calls": st["prefill_calls"],
          "spliced_tokens": st["spliced_tokens"],
          "prompt_tokens": [len(p) for p in prompts],
          "outcomes_at_prefill": [f[4] for f in fills],
          "streams_equal_generate": len(prompts), "refused_layouts": refused,
          "adoption_host_ms": adopt_ms,
          "adoption_host_ms_median": statistics.median(adopt_ms),
          "prefill_admission_host_ms": prefill_ms,
          "prefill_admission_host_ms_median": statistics.median(prefill_ms)})


# ----------------------------------------------------------------- runtime
# The actor runtime (ray_tpu_torch.init / remote / put / get / kill) on
# the card: a one-node cluster whose GPU is leased whole to one actor at
# a time, CUDA tensors through the object store, GPT-2 small scored and
# served from GPU actors.

RUNTIME_CPUS = 4
RUNTIME_BIG_BYTES = 512 << 20
RUNTIME_TIMING_CALLS = 10
# kill() -> the GPU back in available_resources(), its process gone
GPU_RETURN_BOUND_S = 15.0
RUNTIME_SERVE_LENGTHS = [8, 40, 77, 120, 160, 200, 24, 96]


def runtime_tensors(gen) -> dict:
    """CUDA tensors of each kind the object plane must carry."""
    base = torch.randn(256, 384, device="cuda", generator=gen)
    return {
        "bf16": torch.randn(64, 128, device="cuda",
                            generator=gen).to(torch.bfloat16),
        "fp32": torch.randn(33, 17, device="cuda", generator=gen),
        "int64": torch.randint(-2 ** 40, 2 ** 40, (1000,), device="cuda",
                               generator=gen),
        "non_contiguous": base.t()[::3],
        "zero_d": torch.tensor(1.25, device="cuda"),
    }


def same_tensors(label: str, got: dict, want: dict) -> None:
    for name, t in want.items():
        g = got[name]
        check(g.device.type == "cuda" and g.dtype == t.dtype
              and g.shape == t.shape and torch.equal(g, t),
              f"{label}: {name} came back {g.device} {g.dtype} "
              f"{tuple(g.shape)}, not equal to what was sent")


def _no_tf32() -> None:
    """The driver's matmul settings (main()), in an actor's process.
    Imported here: this function is pickled by value with the actor
    class, and torch.backends.cudnn is an object pickle cannot send."""
    from torch.backends import cuda as backends_cuda
    from torch.backends import cudnn as backends_cudnn

    backends_cuda.matmul.allow_tf32 = False
    backends_cudnn.allow_tf32 = False


def boot_clock() -> float:
    """Seconds since boot: one clock for every process of the machine."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start() -> float:
    """This process's start on boot_clock() (field 22 of
    /proc/self/stat, in clock ticks)."""
    import os

    with open("/proc/self/stat", "rb") as f:
        stat = f.read()
    ticks = int(stat[stat.rindex(b")") + 2:].split()[19])
    return ticks / os.sysconf("SC_CLK_TCK")


def _where(init_at: float) -> dict:
    """Where an actor runs, and when (boot_clock()) its process started,
    its __init__ began (after the imports its class needs) and its CUDA
    context was up."""
    import os

    torch.zeros(1, device="cuda")  # the CUDA context
    return {"pid": os.getpid(), "ppid": os.getppid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "process_start": _process_start(), "init_at": init_at,
            "cuda_ready_at": boot_clock()}


def cold_start_split(t0: float, where: dict, t_first: float) -> dict:
    """A GPU actor's cold start in spans (boot_clock(), clock-tick
    resolution for the process start): the driver's .remote() to the
    process's start, its imports until __init__, __init__ and the CUDA
    context, then the first result back to the driver."""
    return {"spawn_s": where["process_start"] - t0,
            "imports_s": where["init_at"] - where["process_start"],
            "init_and_cuda_s": where["cuda_ready_at"] - where["init_at"],
            "reply_s": t_first - where["cuda_ready_at"]}


class RuntimeGpuActor:
    """The runtime phase's first GPU actor: objects both ways, the 512 MB
    transfer, and GPT-2 small scoring on the kernels."""

    def __init__(self):
        self.init_at = boot_clock()
        _no_tf32()
        self.big = None
        self.params = None

    def ready(self) -> dict:
        return _where(self.init_at)

    def echo(self, tensors: dict):
        return {k: t.device.type for k, t in tensors.items()}, tensors

    def take(self, box):
        """The whole get, then its two copies again, one by one, on the
        same arena block: out of the arena into host memory, and host to
        device (what the tensor's rebuild does)."""
        import warnings

        import ray_tpu_torch as rt
        from ray_tpu_torch._private import worker as worker_mod

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.big = rt.get(box[0])
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        store = worker_mod.global_worker.store
        entry = store._entries[box[0].id]
        (off, n), = entry.layout
        mapping = store._attach(entry.shm_name)
        t0 = time.perf_counter()
        raw = bytes(mapping.buf[off:off + n])
        t1 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(raw, dtype=torch.uint8)
        dst = torch.empty(n, dtype=torch.uint8, device="cuda")
        dst.copy_(src)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(torch.equal(dst.view(self.big.dtype).view(self.big.shape),
                          self.big), "runtime: the timed copies differ")
        return get_s, self.big.device.type, {
            "copy_out_s": t1 - t0, "h2d_s": t2 - t1,
            "rest_s": get_s - (t2 - t0)}

    def give(self):
        big, self.big = self.big, None
        return big

    def load(self, params) -> list:
        from ray_tpu_torch import tree

        self.params = params
        return sorted({t.device.type for t in tree.tree_leaves(params)})

    def score(self, tokens, targets):
        """gpt2_forward then gpt2_loss, counted from 0 as phase_score
        counts them: this process's launches come back with the loss."""
        from ray_tpu_torch import kernels
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.ops import attention

        cfg = gpt2.GPT2Config.small()
        kernels.reset_launches()
        attention.PLAIN_CALLS["attention"] = 0
        with torch.inference_mode():
            gpt2.gpt2_forward(self.params, tokens, cfg)
            loss = gpt2.gpt2_loss(self.params, tokens, targets, cfg)
        torch.cuda.synchronize()
        return (loss.clone(), dict(kernels.LAUNCHES),
                attention.PLAIN_CALLS["attention"])

    def loss(self, tokens, targets) -> float:
        from ray_tpu_torch.models import gpt2

        with torch.inference_mode():
            return float(gpt2.gpt2_loss(self.params, tokens, targets,
                                        gpt2.GPT2Config.small()))


def put_split(rt, big) -> dict:
    """The legs of a CUDA tensor's put, again one by one on the same
    tensor: the device-to-host copy into a fresh tensor, serializing the
    host copy, and a put of the host copy (serializing it and copying it
    into a fresh arena block); then, for scale, the same host copy into
    fresh pageable memory and again into memory already touched."""
    from ray_tpu_torch._private import serialization

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = big.cpu()
    t1 = time.perf_counter()
    serialization.serialize(host)
    t2 = time.perf_counter()
    ref = rt.put(host)
    t3 = time.perf_counter()
    dst = torch.empty_like(host)
    t4 = time.perf_counter()
    dst.copy_(host)
    t5 = time.perf_counter()
    dst.copy_(host)
    t6 = time.perf_counter()
    del ref
    return {"d2h_s": t1 - t0, "serialize_s": t2 - t1,
            "host_put_s": t3 - t2, "host_copy_fresh_s": t5 - t4,
            "host_copy_touched_s": t6 - t5}


FRESH_INTERPRETER = """
import json, pickle, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import ray_tpu_torch._private.worker
t2 = time.perf_counter()
with open(sys.argv[1], "rb") as f:
    pickle.loads(f.read())
t3 = time.perf_counter()
torch.zeros(1, device="cuda")
t4 = time.perf_counter()
print(json.dumps({"import_torch_s": t1 - t0, "import_worker_s": t2 - t1,
                  "load_actor_class_s": t3 - t2, "cuda_context_s": t4 - t3,
                  "inside_s": t4 - t0}))
"""


def fresh_interpreter_split(actor_cls) -> dict:
    """Where a GPU worker's start goes, timed in a fresh interpreter on
    the card (the page cache warm, as for the runtime's second GPU
    actor): torch's import, the worker's modules, loading the actor's
    class as the worker gets it, the CUDA context; `start_s` is the
    interpreter's own start and exit, the wall time less the rest."""
    import tempfile

    from ray_tpu_torch._private import serialization

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "actor_class.pkl")
        with open(path, "wb") as f:
            f.write(serialization.dumps(actor_cls))
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", FRESH_INTERPRETER, path],
                             cwd=here, capture_output=True, text=True,
                             timeout=300, check=True)
        wall = time.perf_counter() - t0
    split = json.loads(out.stdout.strip().splitlines()[-1])
    split["wall_s"] = wall
    split["start_s"] = wall - split.pop("inside_s")
    return split


class RuntimeServeActor:
    """The runtime phase's second GPU actor: a ContinuousBatchingEngine
    on GPT-2 small in fp32 (the driver's weights, drawn from the same
    seed on the card), answering concurrent actor calls."""

    def __init__(self, seed: int):
        from ray_tpu_torch.models import engine, gpt2

        self.init_at = boot_clock()
        _no_tf32()
        cfg = gpt2.GPT2Config(dtype=torch.float32)
        params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(seed),
                                device="cuda")
        self.engine = engine.ContinuousBatchingEngine(params, cfg,
                                                      max_batch=4)

    def ready(self) -> dict:
        return _where(self.init_at)

    def generate(self, prompt, new: int) -> list:
        return self.engine.generate(prompt, new, timeout_s=300.0)

    def stop(self) -> bool:
        self.engine.stop()
        return not self.engine._thread.is_alive()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def phase_runtime(gpt2, generate_mod) -> None:
    """init / remote / put / get / kill on a one-node cluster holding the
    card: host workers see no GPU; CUDA tensors come back bit-equal
    through the store and through a GPU actor both ways (a 512 MB one
    through the native arena, timed); a host task cannot load one; a GPU
    actor scores GPT-2 small on the kernels (its launches held) with the
    driver's loss; kill() returns the GPU once the process has exited;
    a second GPU actor serves 8 concurrent greedy requests, each stream
    equal to generate()."""
    import ray_tpu_torch as rt

    torch.cuda.empty_cache()
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        line = runtime_body(rt, gpt2, generate_mod)
    finally:
        rt.shutdown()
    emit(line)


def runtime_body(rt, gpt2, generate_mod) -> dict:
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    res = rt.cluster_resources()
    check(res.get("GPU") == 1.0, f"runtime: cluster_resources {res}")
    want_visible = rt._visible_gpu_ids(1)[0]

    @rt.remote
    def host_sees():
        import os

        import torch

        return (torch.cuda.is_available(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    host = rt.get(host_sees.remote(), timeout=300.0)
    check(host == (False, ""), f"runtime: a host worker sees {host}")

    # CUDA tensors through the store, read back in the driver
    gen = torch.Generator(device="cuda").manual_seed(40)
    tensors = runtime_tensors(gen)
    check(w.store._arena is not None, "runtime: no native arena")
    for name, t in tensors.items():
        ref = rt.put(t)
        same_tensors("runtime driver get", {name: rt.get(ref)}, {name: t})
    # a put holds the tensor as it was: later writes change no get
    x = torch.arange(1024, dtype=torch.float32, device="cuda")
    ref = rt.put(x)
    x.add_(1)
    rt.get(ref).add_(1)
    check(torch.equal(rt.get(ref), x - 1),
          "runtime: a write after put changed what get returns")
    ref = rt.put(tensors)

    @rt.remote
    def host_get(box):
        from ray_tpu_torch._private.serialization import \
            GpuLeaseRequiredError

        try:
            rt.get(box[0])
        except GpuLeaseRequiredError as e:
            return str(e)
        return "loaded"

    said = rt.get(host_get.remote([ref]), timeout=300.0)
    check(ref.id in said and "no GPU lease" in said,
          f"runtime: a host task's get of CUDA tensors said {said!r}")

    # the first GPU actor: cold start, objects both ways, 512 MB
    GpuActor = rt.remote(num_gpus=1)(RuntimeGpuActor)
    t0, t0_boot = time.perf_counter(), boot_clock()
    a = GpuActor.remote()
    where = rt.get(a.ready.remote(), timeout=300.0)
    cold_s = time.perf_counter() - t0
    cold_split = cold_start_split(t0_boot, where, boot_clock())
    check(where["visible"] == want_visible and where["count"] == 1
          and where["ppid"] == os.getpid(),
          f"runtime: GPU actor {where}, want CUDA_VISIBLE_DEVICES="
          f"{want_visible!r}, one device, spawned cold by this driver")
    check(rt.available_resources().get("GPU") == 0.0,
          "runtime: the GPU is not leased to the actor")
    for label, arg in (("actor, value", tensors),
                       ("actor, ref", rt.put(tensors))):
        devices, back = rt.get(a.echo.remote(arg), timeout=300.0)
        check(set(devices.values()) == {"cuda"},
              f"runtime {label}: the actor got {devices}")
        same_tensors(f"runtime {label}", back, tensors)
    big = torch.empty(RUNTIME_BIG_BYTES // 4, device="cuda")
    big.uniform_(generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_ref = rt.put(big)
    put_s = time.perf_counter() - t0
    entry = w.store._entries[big_ref.id]
    check((entry.shm_name or "").startswith("arena:"),
          f"runtime: 512 MB put went to {entry.shm_name}, not the arena")
    get_s, dev, get_legs = rt.get(a.take.remote([big_ref]), timeout=300.0)
    check(dev == "cuda", f"runtime: the actor got the 512 MB on {dev}")
    put_legs = put_split(rt, big)
    t0 = time.perf_counter()
    back = rt.get(a.give.remote(), timeout=300.0)
    torch.cuda.synchronize()
    back_s = time.perf_counter() - t0
    check(back.device.type == "cuda" and torch.equal(back, big),
          "runtime: 512 MB back from the actor differs")
    del back, big, big_ref
    gb = RUNTIME_BIG_BYTES / 1e9

    # scoring from the actor: the kernel path, the driver's loss
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    tgen = torch.Generator().manual_seed(1)
    tok_d = torch.randint(0, cfg.vocab_size, (4, 512), generator=tgen).cuda()
    tgt_d = torch.randint(0, cfg.vocab_size, (4, 512), generator=tgen).cuda()
    check(rt.get(a.load.remote(rt.put(params)), timeout=300.0) == ["cuda"],
          "runtime: the actor's weights are not all on cuda")
    loss_a, launches, plain = rt.get(a.score.remote(tok_d, tgt_d),
                                     timeout=300.0)
    hold_launches("runtime: the GPU actor's scoring", launches,
                  {**_NO_LAUNCHES, "flash_fwd": 2 * cfg.num_layers,
                   "ce_fwd": 1}, 1)
    check(plain == 0, f"runtime: {plain} attention calls took the plain "
          f"route in the actor")
    with torch.inference_mode():
        loss_d = gpt2.gpt2_loss(params, tok_d, tgt_d, cfg)
    bit_equal = bool(loss_a.device.type == "cuda"
                     and torch.equal(loss_a, loss_d))
    check(bit_equal or abs(float(loss_a) - float(loss_d)) <= LOSS_TOL,
          f"runtime: actor loss {float(loss_a)} vs driver {float(loss_d)}")
    remote_ms, local_ms = [], []
    for i in range(RUNTIME_TIMING_CALLS + 1):
        t0 = time.perf_counter()
        rt.get(a.loss.remote(tok_d, tgt_d), timeout=300.0)
        t1 = time.perf_counter()
        with torch.inference_mode():
            float(gpt2.gpt2_loss(params, tok_d, tgt_d, cfg))
        t2 = time.perf_counter()
        if i:  # the first pair warms up
            remote_ms.append((t1 - t0) * 1e3)
            local_ms.append((t2 - t1) * 1e3)
    del params

    # the lease ends with the process: kill, then the GPU returns
    t0 = time.perf_counter()
    rt.kill(a)
    while rt.available_resources().get("GPU", 0.0) < 1.0:
        check(time.perf_counter() - t0 < GPU_RETURN_BOUND_S,
              f"runtime: the GPU was not back {GPU_RETURN_BOUND_S}s "
              f"after kill()")
        time.sleep(0.01)
    return_s = time.perf_counter() - t0
    check(not _pid_alive(where["pid"]),
          "runtime: the GPU came back before its process exited")

    # the second GPU actor gets the card and serves
    scfg = gpt2.GPT2Config(dtype=torch.float32)
    sparams = gpt2.gpt2_init(scfg, torch.Generator().manual_seed(2),
                             device="cuda")
    ServeActor = rt.remote(num_gpus=1, max_concurrency=8)(RuntimeServeActor)
    t0, t0_boot = time.perf_counter(), boot_clock()
    b = ServeActor.remote(2)
    where_b = rt.get(b.ready.remote(), timeout=300.0)
    serve_start_s = time.perf_counter() - t0
    serve_split = cold_start_split(t0_boot, where_b, boot_clock())
    check(where_b["visible"] == want_visible and where_b["pid"] !=
          where["pid"], f"runtime: second GPU actor {where_b}")
    pgen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, scfg.vocab_size, (n,), generator=pgen)
               .tolist() for n in RUNTIME_SERVE_LENGTHS]
    t0 = time.perf_counter()
    streams = rt.get([b.generate.remote(p, SERVE_NEW) for p in prompts],
                     timeout=600.0)
    serve_wall = time.perf_counter() - t0
    check(rt.get(b.stop.remote(), timeout=60.0),
          "runtime: the actor's engine loop still running")
    want = generated(generate_mod, sparams, scfg, prompts)
    differ = [i for i, (s, g) in enumerate(zip(streams, want)) if s != g]
    check(not differ, f"runtime: streams {differ} from the serving actor "
          f"differ from generate()")
    return {
        "phase": "runtime", "card": card_line(), "cpus": RUNTIME_CPUS,
        "cluster_resources": res, "gpu_visible": where["visible"],
        "host_worker_sees_cuda": host[0],
        "tensors_bit_equal": sorted(tensors),
        "cold_start_s": cold_s, "cold_start_predicted_s": [2, 6],
        "cold_start_split": cold_split,
        "big_mb": RUNTIME_BIG_BYTES >> 20, "put_s": put_s,
        "put_gb_per_s": gb / put_s, "put_legs": put_legs,
        "actor_get_s": get_s, "actor_get_legs": get_legs,
        "actor_get_gb_per_s": gb / get_s,
        "put_plus_get_gb_per_s": gb / (put_s + get_s),
        "put_plus_get_predicted_gb_per_s": [1, 4],
        "actor_back_s": back_s, "actor_back_gb_per_s": gb / back_s,
        "actor_launches": launches, "loss_actor": float(loss_a),
        "loss_driver": float(loss_d), "loss_bit_equal": bit_equal,
        "score_actor_ms_median": statistics.median(remote_ms),
        "score_local_ms_median": statistics.median(local_ms),
        "score_added_ms": statistics.median(remote_ms)
        - statistics.median(local_ms),
        "score_added_predicted_ms": [0.5, 3],
        "score_actor_ms_range": [min(remote_ms), max(remote_ms)],
        "score_local_ms_range": [min(local_ms), max(local_ms)],
        "gpu_return_s": return_s, "gpu_return_bound_s": GPU_RETURN_BOUND_S,
        "serve_actor_start_s": serve_start_s,
        "serve_actor_start_split": serve_split,
        "serve_requests": len(prompts), "serve_new_tokens": SERVE_NEW,
        "serve_wall_s": serve_wall,
        "streams_equal_generate": len(prompts) - len(differ),
        "fresh_interpreter": fresh_interpreter_split(RuntimeGpuActor)}


# ----------------------------------------------------------------- cluster
# The runtime beyond one node on the card: a head without a GPU in this
# process, a node agent (`python -m ray_tpu_torch start --address`) that
# counts the card, a placement group reserving it, GPT-2 small scored
# from a GPU actor placed in the group on the agent's node and through
# a submitted job, then the agent's death and a second agent.

CLUSTER_SYSTEM_CONFIG = {"node_timeout": 3.0, "node_heartbeat": 0.5}
# a written-off worker exits on the conductor's shutdown notice; at the
# latest on its next re-register, every 5 s at the default
# worker_orphan_grace (worker_main.py), plus the RPC
ORPHAN_EXIT_BOUND_S = 5.5
CLUSTER_JOB = """
import sys
import torch
import ray_tpu_torch as rt

rt.init(address="auto")
scorer = rt.get_actor("scorer", namespace="cluster")
gen = torch.Generator().manual_seed(1)
tokens = torch.randint(0, int(sys.argv[1]), (4, 512), generator=gen)
targets = torch.randint(0, int(sys.argv[1]), (4, 512), generator=gen)
print("JOB_LOSS", repr(rt.get(scorer.loss.remote(tokens, targets),
                              timeout=300.0)), flush=True)
rt.shutdown()
"""


class ClusterScorer(RuntimeGpuActor):
    """The cluster phase's GPU actor: RuntimeGpuActor's scoring, where
    it runs, and a line for the driver's log subscription. Tokens may
    come from the host (a job's driver holds no GPU)."""

    def ready(self) -> dict:
        from ray_tpu_torch._private.worker_spawn import ENV_NODE_ID

        return {**_where(self.init_at), "node": os.environ.get(ENV_NODE_ID)}

    def say(self, text: str) -> bool:
        print(text, flush=True)
        return True

    def loss(self, tokens, targets) -> float:
        return super().loss(tokens.cuda(), targets.cuda())

    def cuda_reserved(self) -> int:
        """Bytes this process's caching allocator holds on the card."""
        return torch.cuda.memory_reserved()


def wait_for(pred, bound_s: float, what: str) -> float:
    """Seconds until pred() holds; fails past `bound_s`."""
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 <= bound_s,
              f"cluster: {what() if callable(what) else what} not within "
              f"{bound_s} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def start_agent(rt, session_dir: str) -> tuple:
    """A node agent joined to this cluster, counting the GPUs it sees;
    returns (Popen, node id, seconds from Popen to registered)."""
    from ray_tpu_torch._private.ids import NodeID

    node_id = NodeID().hex()
    host, port = rt._private.worker.global_worker.conductor_address
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RTT_SESSION_DIR=session_dir,
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    log = open(os.path.join(session_dir, f"agent-{node_id[:12]}.log"), "ab")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--address",
         f"{host}:{port}", "--num-cpus", "2", "--node-id", node_id],
        cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    wait_for(lambda: any(n["node_id"] == node_id and n["alive"]
                         for n in rt.nodes()), 120.0,
             "the agent's registration")
    join_s = time.perf_counter() - t0
    check(proc.poll() is None, "cluster: the agent exited")
    return proc, node_id, join_s


def phase_cluster(gpt2) -> None:
    """Head and agent, a placement group, scoring from a GPU actor in it
    and through a job, node death and a second agent (see
    cluster_body). Every process the phase started is ended here, and
    the phase fails if one outlived the cluster's shutdown."""
    import ray_tpu_torch as rt

    torch.cuda.empty_cache()
    info = rt.init(num_cpus=2, resources={"GPU": 0},
                   _system_config=CLUSTER_SYSTEM_CONFIG)
    session_dir = info["session_dir"]
    agents: list = []
    try:
        line = cluster_body(rt, gpt2, session_dir, agents)
    finally:
        end_session(rt, session_dir, "cluster", agents)
    emit(line)


def cluster_body(rt, gpt2, session_dir: str, agents: list) -> dict:
    from ray_tpu_torch import tree
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.memory_monitor import pid_rss
    from ray_tpu_torch._private.worker_spawn import pid_exited
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.util.placement_group import placement_group

    w = worker_mod.global_worker
    want_visible = rt._visible_gpu_ids(1)[0]
    head = rt.cluster_resources()
    check(head.get("GPU") == 0.0, f"cluster: the head counts {head}")

    # 1. the agent joins with the card
    agent, agent_id, join_s = start_agent(rt, session_dir)
    agents.append(agent)
    nodes = [n for n in rt.nodes() if n["alive"]]
    res = rt.cluster_resources()
    check(len(nodes) == 2 and res.get("GPU") == 1.0,
          f"cluster: nodes {nodes}, resources {res}")
    agent_node = next(n for n in nodes if n["node_id"] == agent_id)
    check(agent_node["gpu_ids"] == [want_visible],
          f"cluster: the agent names its GPUs {agent_node['gpu_ids']}")

    # 2. a placement group reserves the card on the agent's node
    t0 = time.perf_counter()
    pg = placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
    check(pg.wait(60.0), "cluster: the placement group never got ready")
    pg_ready_s = time.perf_counter() - t0
    assign = next(p["assignments"] for p in w.conductor.call(
        "list_placement_groups", timeout=30.0) if p["pg_id"] == pg.id)
    avail = rt.available_resources()
    check(assign == [agent_id] and avail.get("GPU") == 0.0
          and avail.get(f"_pg_{pg.id}_GPU") == 1.0,
          f"cluster: group on {assign}, available {avail}")

    # 3. a GPU actor in the group scores on the kernels
    logs, marker = [], f"CLUSTER_LOG_{os.getpid()}"
    got_log = threading.Event()

    def on_logs(batch):
        logs.extend(batch)
        if any(marker in e.get("line", "") for e in batch):
            got_log.set()

    w.subscribe_channel("worker_logs", on_logs)
    Scorer = rt.remote(num_gpus=1, placement_group=pg, name="scorer",
                       namespace="cluster", max_restarts=0)(ClusterScorer)
    t0, t0_boot = time.perf_counter(), boot_clock()
    a = Scorer.remote()
    where = rt.get(a.ready.remote(), timeout=300.0)
    cold_s = time.perf_counter() - t0
    cold_split = cold_start_split(t0_boot, where, boot_clock())
    check(where["node"] == agent_id and where["ppid"] == agent.pid
          and where["visible"] == want_visible and where["count"] == 1,
          f"cluster: the GPU actor {where}, want the agent's node "
          f"{agent_id[:12]}, its child, CUDA_VISIBLE_DEVICES="
          f"{want_visible!r} and one device")
    check(rt.available_resources().get(f"_pg_{pg.id}_GPU") == 0.0,
          "cluster: the actor holds no GPU of the group")
    rss_idle = pid_rss(where["pid"])
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    tgen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (4, 512), generator=tgen)
    tgt = torch.randint(0, cfg.vocab_size, (4, 512), generator=tgen)
    tok_d, tgt_d = tok.cuda(), tgt.cuda()
    with torch.inference_mode():
        loss_d = gpt2.gpt2_loss(params, tok_d, tgt_d, cfg)

    def score_on(actor, label: str) -> dict:
        check(rt.get(actor.load.remote(rt.put(params)), timeout=300.0)
              == ["cuda"], f"cluster: {label}'s weights are not on cuda")
        loss_a, launches, plain = rt.get(actor.score.remote(tok_d, tgt_d),
                                         timeout=300.0)
        hold_launches(f"cluster: {label}'s scoring", launches,
                      {**_NO_LAUNCHES, "flash_fwd": 2 * cfg.num_layers,
                       "ce_fwd": 1}, 1)
        check(plain == 0, f"cluster: {plain} attention calls of {label} "
              "took the plain route")
        bit_equal = bool(loss_a.device.type == "cuda"
                         and torch.equal(loss_a, loss_d))
        check(bit_equal or abs(float(loss_a) - float(loss_d)) <= LOSS_TOL,
              f"cluster: {label}'s loss {float(loss_a)} vs the driver's "
              f"{float(loss_d)}")
        return {"launches": launches, "loss": float(loss_a),
                "bit_equal": bit_equal}

    scored = score_on(a, "the group's actor")
    rss_loaded = pid_rss(where["pid"])
    check(rt.get(a.say.remote(marker), timeout=60.0), "cluster: say")
    log_s = wait_for(got_log.is_set, 10.0, "the actor's line on worker_logs")

    # 4. a job scores the same seeded tokens through the named actor
    script = os.path.join(session_dir, "cluster_job.py")
    with open(script, "w") as f:
        f.write(CLUSTER_JOB)
    here = os.path.dirname(os.path.abspath(__file__))
    client = JobSubmissionClient()
    t0 = time.perf_counter()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} {script} {cfg.vocab_size}",
        runtime_env={"env_vars": {"PYTHONPATH": here,
                                  "RTT_SESSION_DIR": session_dir}})
    status = client.wait_until_finished(job_id, timeout=300.0, poll_s=0.05)
    job_s = time.perf_counter() - t0
    job_log = client.get_job_logs(job_id)
    check(status == "SUCCEEDED", f"cluster: job {status}:\n{job_log[-2000:]}")
    job_loss = re.search(r"JOB_LOSS (\S+)", job_log)
    check(job_loss is not None and (
        float(job_loss.group(1)) == float(loss_d) or
        (not scored["bit_equal"]
         and abs(float(job_loss.group(1)) - float(loss_d)) <= LOSS_TOL)),
        f"cluster: the job's loss {job_loss and job_loss.group(1)} vs the "
        f"driver's {float(loss_d)!r}")

    # 5. the agent dies under its GPU worker. The card must get back at
    # least what the worker's allocator held, the weights included (its
    # CUDA context comes on top), before a second agent may lease it.
    held = rt.get(a.cuda_reserved.remote(), timeout=60.0)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree.tree_leaves(params))
    check(held >= weight_bytes, f"cluster: the GPU worker holds {held} "
          f"bytes on the card, less than the {weight_bytes} of its weights")
    free_loaded = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    agent.kill()
    agent.wait(timeout=30)
    wait_for(lambda: not any(
        n["alive"] for n in rt.nodes() if n["node_id"] == agent_id),
        CLUSTER_SYSTEM_CONFIG["node_timeout"] + 2.0,
        "the dead node's detection")
    detect_s = time.perf_counter() - t0  # from the kill
    res_dead = rt.cluster_resources()
    check(res_dead.get("GPU", 0.0) == 0.0,
          f"cluster: the dead node's GPU still counted: {res_dead}")
    orphan_s = wait_for(lambda: pid_exited(where["pid"]),
                        ORPHAN_EXIT_BOUND_S, "the orphaned GPU worker's exit")
    freed_s = wait_for(
        lambda: torch.cuda.mem_get_info()[0] - free_loaded >= held,
        ORPHAN_EXIT_BOUND_S, "the card taking back the orphan's memory")
    freed = torch.cuda.mem_get_info()[0] - free_loaded
    try:
        rt.get(a.score.remote(tok_d, tgt_d), timeout=60.0)
        check(False, "cluster: a call on the dead node's actor answered")
    except rt.exceptions.ActorDiedError:
        pass

    # only now a second agent: a plain GPU actor gets the card
    agent2, agent2_id, join2_s = start_agent(rt, session_dir)
    agents.append(agent2)
    t0 = time.perf_counter()
    b = rt.remote(num_gpus=1)(ClusterScorer).remote()
    where_b = rt.get(b.ready.remote(), timeout=300.0)
    cold2_s = time.perf_counter() - t0
    check(where_b["node"] == agent2_id and where_b["ppid"] == agent2.pid
          and where_b["visible"] == want_visible,
          f"cluster: the second agent's GPU actor {where_b}")
    rescored = score_on(b, "the second agent's actor")
    del params
    return {
        "phase": "cluster", "card": card_line(),
        "system_config": CLUSTER_SYSTEM_CONFIG,
        "agent_gpu_ids": agent_node["gpu_ids"],
        "agent_join_s": join_s, "agent_join_predicted_s": [6, 9],
        "pg_ready_s": pg_ready_s, "pg_ready_predicted_s": [0, 0.05],
        "cold_start_s": cold_s, "cold_start_predicted_s": [9, 12],
        "cold_start_split": cold_split,
        "actor_launches": scored["launches"], "loss_actor": scored["loss"],
        "loss_driver": float(loss_d), "loss_bit_equal": scored["bit_equal"],
        "worker_log_s": log_s,
        "job_s": job_s, "job_predicted_s": [8, 15],
        "job_loss": job_loss.group(1),
        "detect_s": detect_s, "detect_predicted_s": [3.0, 3.8],
        "orphan_exit_after_detect_s": orphan_s,
        "orphan_exit_predicted_s": [0, 5.5],
        "orphan_exit_bound_s": ORPHAN_EXIT_BOUND_S,
        "orphan_reserved_mb": held / 2 ** 20,
        "card_freed_mb": freed / 2 ** 20,
        "card_freed_predicted_mb": [1024, 2560],
        "card_freed_after_exit_s": freed_s,
        "card_freed_after_exit_predicted_s": [0, 0.1],
        "gpu_worker_rss_idle_mb": rss_idle / 2 ** 20,
        "gpu_worker_rss_loaded_mb": rss_loaded / 2 ** 20,
        "gpu_worker_rss_predicted_mb": [512, 1536],
        "second_agent_join_s": join2_s, "second_cold_start_s": cold2_s,
        "second_loss_bit_equal": rescored["bit_equal"],
        "second_launches": rescored["launches"]}


# ------------------------------------------------------------------ fabric
# The trainer's live weight fabric on the card: GPT-2 small trains in the
# driver (TorchTrainer, spmd), report() publishes every step, and a GPU
# actor's bf16 engine hot-swaps to each version between decode ticks.

FABRIC_NAME = "gpt2"
FABRIC_STEPS = 3
FABRIC_TOKENS = (8, 1024)
FABRIC_SEED = 60
FABRIC_CONFIG = {"weights_keep": 2}
# the request in flight across each swap: prompt tokens, new tokens
FABRIC_LONG = (8, 900)
# the prediction for a version of GPT-2 small bf16 (~0.25 GB) through
# the arena, written before the phase first ran (PERF.md §6)
FABRIC_PREDICTED_S = {"publish": [0.5, 1.5], "fetch": [0.4, 1.2]}
SWAP_BOUND_S = 120.0


class FabricServeActor:
    """The fabric phase's GPU actor: a bf16 GPT-2 small engine built from
    version 1 of the weight set (`WeightSubscriber.fetch(like=)` onto a
    template on this card) and kept on the newest version by a
    `WeightSync`."""

    def __init__(self, name: str):
        from ray_tpu_torch import weights
        from ray_tpu_torch.models import engine, gpt2

        self.init_at = boot_clock()
        _no_tf32()
        self.cfg = gpt2.GPT2Config.small()
        template = gpt2.gpt2_init(self.cfg, torch.Generator().manual_seed(1),
                                  device="cuda")
        self.sub = weights.WeightSubscriber(name)
        t0 = time.perf_counter()
        params = self.sub.fetch(version=1, like=template)
        torch.cuda.synchronize()
        self.first_fetch_s = time.perf_counter() - t0
        del template
        self.engine = engine.ContinuousBatchingEngine(
            params, self.cfg, max_batch=4, params_version=1)
        self.sync = weights.WeightSync(self.engine, name,
                                       consumer="fabric-actor",
                                       subscriber=self.sub,
                                       poll_interval_s=0.05)
        self.long = None
        self.lora = None

    def ready(self) -> dict:
        return {**_where(self.init_at), "first_fetch_s": self.first_fetch_s,
                "first_fetch_bytes": self.sub.last_stats.fetched_bytes}

    def start_long(self, prompt, new: int) -> dict:
        """A request that runs across the next swap; returns once its
        first token is out (it is in flight)."""
        rec = {"version_at_start": self.engine.params_version,
               "t_start": time.time(), "tokens": 0}
        first = threading.Event()

        def run():
            try:
                for _ in self.engine.stream(prompt, new, timeout_s=600.0):
                    rec["tokens"] += 1
                    first.set()
            except Exception as err:  # noqa: BLE001 — reported back
                rec["error"] = repr(err)
            rec["t_end"] = time.time()
            rec["version_at_end"] = self.engine.params_version
            first.set()

        th = threading.Thread(target=run, daemon=True)
        th.start()
        self.long = (th, rec)
        check(first.wait(120.0), "fabric: the long request never started")
        return dict(rec)

    def long_result(self) -> dict:
        th, rec = self.long
        th.join(600.0)
        check(not th.is_alive(), "fabric: the long request never ended")
        swaps = [s for s in self.sync.swaps
                 if rec["t_start"] <= s["applied_at"] <= rec["t_end"]]
        return {**rec, "swaps_during": [s["version"] for s in swaps]}

    def wait_version(self, version: int) -> dict:
        """The status once the engine serves `version` and the sync has
        recorded the swap (it does so just after the engine applies
        it)."""
        t0 = time.perf_counter()
        self.sync.wait_for_swap(version, timeout=SWAP_BOUND_S)
        while not any(x["version"] == version for x in self.sync.swaps):
            check(time.perf_counter() - t0 < SWAP_BOUND_S,
                  f"fabric: the swap to v{version} was never recorded")
            time.sleep(0.005)
        return self.sync.status()

    def generate_all(self, prompts, new: int) -> list:
        out = [None] * len(prompts)

        def run(i):
            out[i] = self.engine.generate(prompts[i], new, timeout_s=600.0)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600.0)
        return out

    def score(self, tokens, targets):
        """gpt2_forward then gpt2_loss on the weights being served,
        counted from 0 in this process."""
        from ray_tpu_torch import kernels
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.ops import attention

        kernels.reset_launches()
        attention.PLAIN_CALLS["attention"] = 0
        params = self.engine.params
        with torch.inference_mode():
            gpt2.gpt2_forward(params, tokens, self.cfg)
            loss = gpt2.gpt2_loss(params, tokens, targets, self.cfg)
        torch.cuda.synchronize()
        return (loss.clone(), dict(kernels.LAUNCHES),
                attention.PLAIN_CALLS["attention"])

    def hashes(self) -> list:
        from ray_tpu_torch import weights

        return weights.leaf_content_hashes(self.engine.params)

    def stats(self) -> dict:
        return {"sync": self.sync.stats(), "status": self.sync.status()}

    def _tenant_streams(self, pool, tenant: str, prompts, new: int) -> list:
        from ray_tpu_torch.models import engine

        eng = engine.ContinuousBatchingEngine(self.engine.params, self.cfg,
                                              max_batch=4, lora_pool=pool)
        try:
            return [eng.generate(p, new, adapter_id=tenant,
                                 timeout_s=600.0) for p in prompts]
        finally:
            eng.stop()

    def lora_streams(self, tenant: str, adapter, prompts, new: int) -> dict:
        """The tenant's streams from a pool paging over the fabric
        (`build_pool(lora=True)`, kept for the re-publish) and from a
        pool over a LocalAdapterSource of `adapter`, on the weights being
        served."""
        from ray_tpu_torch.serve import lora

        if self.lora is None:
            self.lora = lora.build_pool(self.cfg, True, slots=2,
                                        device="cuda")
        fabric = self._tenant_streams(self.lora, tenant, prompts, new)
        local = self._tenant_streams(
            lora.build_pool(self.cfg, {tenant: adapter}, slots=2,
                            device="cuda"), tenant, prompts, new)
        return {"fabric": fabric, "local": local,
                "resident_version": self.lora.resident_version(tenant),
                "stats": self.lora.stats()}

    def wait_dirty(self, tenant: str) -> float:
        t0 = time.perf_counter()
        while not self.lora.source.dirty(tenant):
            check(time.perf_counter() - t0 < 30.0,
                  "fabric: the re-publish never marked the tenant dirty")
            time.sleep(0.01)
        return time.perf_counter() - t0

    def stop(self) -> bool:
        self.sync.stop()
        self.engine.stop()
        if self.lora is not None:
            self.lora.source.close()
        return not self.engine._thread.is_alive()


def end_session(rt, session_dir: str, what: str, procs=()) -> None:
    """Shut the cluster down, wait for the processes the phase started
    itself (`procs`, killed after 15 s), and fail if a process of the
    session outlived it."""
    from ray_tpu_torch._private import isolated

    try:
        rt.shutdown()
    finally:
        for proc in procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
        deadline = time.monotonic() + 10.0
        while isolated.session_processes(session_dir) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        left = isolated.session_processes(session_dir)
        for pid in left:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
    check(not left, f"{what}: processes {left} outlived the cluster")


def phase_fabric(kernels, gpt2, generate_mod) -> None:
    """The trainer publishes, a GPU actor's engine hot-swaps (see
    fabric_body)."""
    import ray_tpu_torch as rt

    torch.cuda.empty_cache()
    info = rt.init(num_cpus=4, _system_config=FABRIC_CONFIG)
    try:
        line = fabric_body(rt, kernels, gpt2, generate_mod)
    finally:
        end_session(rt, info["session_dir"], "fabric")
    emit(line)


def fabric_body(rt, kernels, gpt2, generate_mod) -> dict:
    """`TorchTrainer(mode="spmd")` trains GPT-2 small bf16 on the card
    (TrainStep + adamw, tokens [8, 1024], FABRIC_STEPS steps, each step's
    launches held); every report() publishes the params. A GPU actor
    builds its bf16 engine from version 1 and a WeightSync follows the
    set. Per version: a request started before the swap completes its
    full length, the actor's streams for SERVE_LENGTHS equal the
    driver's generate() on the same params, its gpt2_loss of a fixed
    batch equals the driver's bit for bit (its launches held), and every
    leaf's content hash equals the driver's. Then: version 1 has left the
    registry (weights_keep 2) and its chunks the driver's store; a tenant
    adapter published with publish_adapter pages in over the fabric,
    streams as a local pool of the same adapter, and a re-publish
    hot-swaps it."""
    import shutil
    import tempfile

    from ray_tpu_torch import train, weights
    from ray_tpu_torch._private import refcount
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.serve import lora
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import TrainStep
    from ray_tpu_torch.weights import publisher as pub_mod

    w = worker_mod.global_worker
    cfg = gpt2.GPT2Config.small()
    per_step = train_launches_per_step(kernels, cfg,
                                       FABRIC_TOKENS[0] * FABRIC_TOKENS[1])
    score_launches = {**_NO_LAUNCHES, "flash_fwd": 2 * cfg.num_layers,
                      "ce_fwd": 1}
    batch = train_batch(cfg, *FABRIC_TOKENS, FABRIC_SEED + 1)
    tgen = torch.Generator().manual_seed(FABRIC_SEED + 2)
    tok_d = torch.randint(0, cfg.vocab_size, (4, 512), generator=tgen).cuda()
    tgt_d = torch.randint(0, cfg.vocab_size, (4, 512), generator=tgen).cuda()
    prompts = serve_prompts(cfg)
    long_prompt = torch.randint(0, cfg.vocab_size, (FABRIC_LONG[0],),
                                generator=tgen).tolist()
    Actor = rt.remote(num_gpus=1, max_concurrency=8)(FabricServeActor)
    rec = {"versions": [], "step_launches": []}

    def after_publish(version: int, params, losses) -> None:
        pub = pub_mod.publisher(FABRIC_NAME)
        out = {"version": version, "loss": losses[-1],
               "publish_ms": pub.publish_ms[-1],
               "publish_bytes": pub.published_bytes[-1]}
        if version == 1:
            rec["v1_ids"] = pub.held_object_ids()
            t0, t0_boot = time.perf_counter(), boot_clock()
            rec["actor"] = Actor.remote(FABRIC_NAME)
            where = rt.get(rec["actor"].ready.remote(), timeout=300.0)
            out["actor_start_s"] = time.perf_counter() - t0
            out["actor_start_split"] = cold_start_split(t0_boot, where,
                                                        boot_clock())
            out["fetch_ms"] = where["first_fetch_s"] * 1e3
            out["fetch_bytes"] = where["first_fetch_bytes"]
        a = rec["actor"]
        if version > 1:
            st = rt.get(a.wait_version.remote(version),
                        timeout=SWAP_BOUND_S + 60.0)
            check(st["serving_version"] == version,
                  f"fabric: the actor serves {st['serving_version']}, not "
                  f"{version}")
            swap = next(x for x in st["swaps"] if x["version"] == version)
            # the registry's commit time (the conductor runs in this
            # process: one clock with the actor's)
            commit = next(m["ts"] for m in w.conductor.call(
                "get_weight_versions",
                timeout=30.0)["names"][FABRIC_NAME]["versions"]
                if m["version"] == version)
            # the driver waits for each swap before its next step: the
            # actor notices version v while it serves v - 1
            check(swap["staleness_at_notice"] == 1,
                  f"fabric: v{version} noticed at staleness "
                  f"{swap['staleness_at_notice']}, not 1")
            out.update(fetch_ms=swap["fetch_ms"],
                       fetch_bytes=swap["fetched_bytes"],
                       staleness_at_notice=swap["staleness_at_notice"],
                       apply_ms=swap["apply_ms"],
                       publish_to_applied_s=swap["applied_at"] - commit)
            long = rt.get(a.long_result.remote(), timeout=660.0)
            check("error" not in long and long["tokens"] == FABRIC_LONG[1]
                  and long["version_at_start"] == version - 1,
                  f"fabric: the request in flight across v{version} {long}")
            out["in_flight"] = {k: long[k] for k in (
                "tokens", "version_at_start", "version_at_end",
                "swaps_during")}
            out["in_flight"]["s"] = long["t_end"] - long["t_start"]
        streams = rt.get(a.generate_all.remote(prompts, SERVE_NEW),
                         timeout=600.0)
        with torch.inference_mode():
            want = generated(generate_mod, params, cfg, prompts)
            loss_d = gpt2.gpt2_loss(params, tok_d, tgt_d, cfg)
        differ = [i for i, (x, y) in enumerate(zip(streams, want)) if x != y]
        check(not differ, f"fabric v{version}: streams {differ} of the "
              f"actor differ from the driver's generate()")
        loss_a, launches, plain = rt.get(a.score.remote(tok_d, tgt_d),
                                         timeout=300.0)
        hold_launches(f"fabric v{version}: the actor's scoring", launches,
                      score_launches, 1)
        check(plain == 0, f"fabric v{version}: {plain} plain-route calls")
        check(loss_a.device.type == "cuda" and torch.equal(loss_a, loss_d),
              f"fabric v{version}: the actor's loss {float(loss_a)!r} vs "
              f"the driver's {float(loss_d)!r}")
        hashes = rt.get(a.hashes.remote(), timeout=300.0)
        check(hashes == weights.leaf_content_hashes(params),
              f"fabric v{version}: a fetched leaf's hash differs")
        out.update(streams_equal_generate=len(prompts),
                   actor_launches=launches, loss_actor=float(loss_a),
                   loss_bit_equal=True, leaves_hash_equal=len(hashes))
        if version < FABRIC_STEPS:
            rt.get(a.start_long.remote(long_prompt, FABRIC_LONG[1]),
                   timeout=300.0)
        rec["versions"].append(out)

    def train_fn(config):
        step = TrainStep(lambda p, bt: gpt2.gpt2_loss(
            p, bt["tokens"], bt["targets"], cfg),
            adamw(3e-4, weight_decay=0.1), device="cuda")
        state = step.init_state(gpt2.gpt2_init(
            cfg, torch.Generator().manual_seed(FABRIC_SEED), device="cuda"))
        losses = []
        for s in range(1, FABRIC_STEPS + 1):
            reset_counts(kernels)
            state, m = step(state, batch)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            hold_launches(f"fabric: the driver's step {s}", launches,
                          per_step, 1)
            check_no_plain_route(f"fabric: the driver's step {s}")
            rec["step_launches"].append(launches)
            losses.append(float(m["loss"]))
            train.report({"step": s, "loss": losses[-1]},
                          publish_weights=state["params"],
                          weights_name=FABRIC_NAME)
            config["after_publish"](s, state["params"], losses)

    storage = tempfile.mkdtemp(prefix="fabric-")
    try:
        t0 = time.perf_counter()
        result = train.TorchTrainer(
            train_fn, train_loop_config={"after_publish": after_publish},
            run_config=train.RunConfig(name="fabric",
                                       storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"fabric: the fit failed: "
              f"{result.error!r}")
        a = rec["actor"]
        # weights_keep 2: version 1 left the registry and its chunks the
        # driver's store
        listing = w.conductor.call("get_weight_versions", timeout=30.0)
        kept = [m["version"] for m in
                listing["names"][FABRIC_NAME]["versions"]]
        check(kept == [FABRIC_STEPS - 1, FABRIC_STEPS],
              f"fabric: the registry keeps {kept}")
        v1_ids = rec["v1_ids"]

        def v1_gone():
            refcount.tracker.flush()
            return not any(w.store.contains(o) for o in v1_ids)

        v1_free_s = wait_for(v1_gone, 10.0, "version 1's chunks leaving "
                             "the store")
        # a tenant adapter over the fabric, then its re-publish
        ad1 = lora.make_lora_adapter(cfg, rank=LORA_RANK, seed=71,
                                     scale=LORA_SCALE)
        ad2 = lora.make_lora_adapter(cfg, rank=LORA_RANK, seed=72,
                                     scale=LORA_SCALE)
        check(lora.publish_adapter("t0", ad1) == 1,
              "fabric: publish_adapter's first version")
        first = rt.get(a.lora_streams.remote("t0", ad1, prompts[:2],
                                             SERVE_NEW), timeout=600.0)
        check(first["fabric"] == first["local"]
              and first["resident_version"] == 1
              and first["stats"]["page_in_bytes"] > 0,
              f"fabric: the paged-in tenant {first}")
        check(lora.publish_adapter("t0", ad2) == 2,
              "fabric: publish_adapter's re-publish")
        dirty_s = rt.get(a.wait_dirty.remote("t0"), timeout=60.0)
        second = rt.get(a.lora_streams.remote("t0", ad2, prompts[:2],
                                              SERVE_NEW), timeout=600.0)
        # swaps counted from the first page-in: a version-1 notice that
        # reached the source after it subscribed marks it dirty once
        check(second["fabric"] == second["local"]
              and second["resident_version"] == 2
              and second["stats"]["swaps"]
              == first["stats"]["swaps"] + 1,
              f"fabric: the re-published tenant {second}")
        stats = rt.get(a.stats.remote(), timeout=60.0)
        check(rt.get(a.stop.remote(), timeout=60.0),
              "fabric: the actor's engine loop still running")
        rt.kill(a)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    samples = stats["sync"]["staleness_samples"]
    return {
        "phase": "fabric", "card": card_line(), "model": "gpt2-small",
        "dtype": "bfloat16", "tokens": list(FABRIC_TOKENS),
        "steps": FABRIC_STEPS, "system_config": FABRIC_CONFIG,
        "fit_s": fit_s, "losses": [v["loss"] for v in rec["versions"]],
        "driver_step_launches": rec["step_launches"],
        "versions": rec["versions"],
        "publish_ms": [v["publish_ms"] for v in rec["versions"]],
        "publish_bytes": [v["publish_bytes"] for v in rec["versions"]],
        "fetch_ms": [v["fetch_ms"] for v in rec["versions"]],
        "publish_to_applied_s": [v.get("publish_to_applied_s")
                                 for v in rec["versions"]],
        "predicted_s": FABRIC_PREDICTED_S,
        "swap_count": stats["sync"]["swap_count"],
        "staleness_at_notice": [v.get("staleness_at_notice")
                                for v in rec["versions"]],
        "staleness_samples": {str(k): samples.count(k)
                              for k in sorted(set(samples))},
        "max_staleness": stats["sync"]["max_staleness_versions"],
        "kept_versions": kept, "v1_chunks": len(v1_ids),
        "v1_chunks_freed_s": v1_free_s,
        "lora_tenant_dirty_s": dirty_s,
        "lora_page_in_bytes": first["stats"]["page_in_bytes"],
        "lora_streams_equal_local": 2 * len(first["fabric"])}


DISAGG_TAIL = 16
DISAGG_BATCH = 4
DISAGG_BLOCK = 16
# round B: the failed-over request's new tokens, the token the plan
# kills the GPU actor at, and the router's pull size (so the router holds
# tokens of the dead replica when it dies)
DISAGG_FAILOVER_NEW = 64
DISAGG_KILL_AT = 8
DISAGG_PULL = 4
DISAGG_ARENA = 64 << 20
DISAGG_SEED = 80
# the predictions for these numbers, written before the phase first ran
# (PERF.md §6)
DISAGG_PREDICTED = {"kv_bytes_per_transfer": 20054016,
                    "ttft_ms": [30, 300], "colocated_ttft_ms": [15, 150],
                    "publish_ms": [15, 120], "fetch_ms": [10, 120],
                    "decode_tokens_per_s_ratio": [0.6, 1.6],
                    "actor_cold_start_s": [12, 30],
                    "kill_to_resumed_token_s": [0.05, 2.0],
                    "tier3_export_ms": [1, 50], "tier3_import_ms": [1, 50],
                    # written after the first run, before the split ran
                    "decode_alone_tokens_per_s": {"local": [150, 300],
                                                  "actor": [100, 300],
                                                  # before the third call
                                                  "two_local": [200, 400]}}


def disagg_prompts(cfg, seed: int, n: int = 8) -> list:
    """`n` prompts: one PAGED_SYSTEM-token system prompt, each with a
    distinct DISAGG_TAIL-token tail."""
    gen = torch.Generator().manual_seed(seed)
    system = torch.randint(0, cfg.vocab_size, (PAGED_SYSTEM,), generator=gen)
    return [torch.cat([system, torch.randint(
        0, cfg.vocab_size, (DISAGG_TAIL,), generator=gen)]).tolist()
        for _ in range(n)]


def disagg_decode_actor(rt):
    """The GPU decode replica's actor class: a DecodeServer that reports
    where it runs and on which device its params are. Built here, so it
    is pickled by value with the functions it calls."""
    from ray_tpu_torch.serve.disagg import DecodeServer
    from ray_tpu_torch.tree import tree_device

    class DisaggDecodeActor(DecodeServer):
        def __init__(self, *args, **kwargs):
            self.init_at = boot_clock()
            _no_tf32()
            DecodeServer.__init__(self, *args, **kwargs)

        def where(self) -> dict:
            return {**_where(self.init_at),
                    "param_device": str(tree_device(self.engine.params))}

    return rt.remote(num_gpus=1, max_concurrency=16)(DisaggDecodeActor)


class RecordingPrefill:
    """The driver's PrefillServer as the router sees it, keeping each
    transfer record's outcome, length and reused tokens."""

    def __init__(self, server):
        self.server = server
        self.records = []

    def __getattr__(self, name):
        return getattr(self.server, name)

    def prefill(self, *args, **kwargs):
        rec = self.server.prefill(*args, **kwargs)
        self.records.append({k: rec[k] for k in (
            "plen", "outcome", "reused_tokens", "transfer_id")})
        return rec


def route_in_order(router, prompts, new: int, **kw):
    """Each prompt through `router.generate` on a thread of its own, the
    next one submitted once the one before has its first token (so the
    prefix cache sees them in order). Returns the streams, each TTFT
    (seconds from submit) and the wall seconds."""
    n = len(prompts)
    out, ttft, errors, threads = [None] * n, [None] * n, [], []
    t_start = time.perf_counter()

    def run(i, first):
        t0 = time.perf_counter()

        def on_first():
            ttft[i] = time.perf_counter() - t0
            first.set()

        try:
            out[i] = router.generate(prompts[i], new, on_first_token=on_first,
                                     timeout_s=300.0, **kw)
        except Exception as err:  # noqa: BLE001 — re-raised below
            errors.append(err)
        first.set()

    for i in range(n):
        first = threading.Event()
        th = threading.Thread(target=run, args=(i, first))
        th.start()
        threads.append(th)
        check(first.wait(300.0), f"disagg: request {i} got no first token")
    for th in threads:
        th.join(600.0)
    wall = time.perf_counter() - t_start
    check(not errors, f"disagg: {errors!r}")
    return out, ttft, wall


def quantiles_ms(seconds) -> dict:
    ms = sorted(s * 1e3 for s in seconds)
    return {"median": statistics.median(ms),
            "p90": ms[min(len(ms) - 1, int(round(0.9 * (len(ms) - 1))))],
            "all": ms}


def phase_disagg(kernels, gpt2, generate_mod) -> None:
    """Disaggregated serving across actors (see disagg_body)."""
    import ray_tpu_torch as rt

    torch.cuda.empty_cache()
    info = rt.init(num_cpus=4)
    try:
        line = disagg_body(rt, kernels, gpt2, generate_mod)
    finally:
        end_session(rt, info["session_dir"], "disagg")
    emit(line)


def disagg_body(rt, kernels, gpt2, generate_mod) -> dict:
    """GPT-2 small fp32 from a seed, KV blocks of 16. Round A: a
    PrefillServer here (prefix cache and KV plane on) streams each
    prompt's KV through the chunk fabric to a GPU DecodeServer actor or
    to a DecodeServer here, 8 requests on one system prompt, each stream
    equal to generate(); the same requests with each decode replica alone,
    and through the colocated engine.
    Round B: a fresh GPU decode actor killed by its chaos plan at its
    8th token; the request fails over to the replica here, equal to
    generate(); a DisaggAutoscaler watching the actor_state channel
    replaces the dead actor through its decode TierSpec's factory (a GPU
    DecodeServer actor, which takes the card's lease once it comes back),
    and a request pinned to the replacement equals generate(). Round D:
    the SLO policy over DecodeServers here on the card: a staggered burst
    scales decode from 1 to 2, idle drains it back to 1, every stream
    equal to generate() and nothing dropped. Round C: an
    int8 PrefillServer with a small pool under an evict_storm, its
    streams equal a plain int8 engine's; a second PrefillServer adopts
    the first's published prefix (tier 3); an export / import of that
    prefix between CUDA pools. No kernel launches in this process."""
    from ray_tpu_torch.models import engine as engine_mod
    from ray_tpu_torch.models import kvcache
    from ray_tpu_torch.serve import autoscale, disagg
    from ray_tpu_torch.serve import kvplane as kvp
    from ray_tpu_torch.tree import tree_map
    from ray_tpu_torch.util import state

    w = rt._private.worker.global_worker
    reset_counts(kernels)
    cfg = gpt2.GPT2Config(dtype=torch.float32)
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(2),
                            device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    prompts = disagg_prompts(cfg, DISAGG_SEED)
    with torch.inference_mode():
        want = generated(generate_mod, params, cfg, prompts)
    Actor = disagg_decode_actor(rt)
    depth = disagg.QUEUE_DEPTH
    # retention past the decode tier's admitted bound: 2 replicas x
    # (max_batch + queue depth)
    retain = 2 * 2 * (DISAGG_BATCH + depth)
    rec: dict = {}

    # ---- round A: the cross-process path
    t0, t0_boot = time.perf_counter(), boot_clock()
    actor = Actor.remote(cpu_params, cfg, max_batch=DISAGG_BATCH,
                         device="cuda")
    where = rt.get(actor.where.remote(), timeout=300.0)
    rec["actor_cold_start_s"] = time.perf_counter() - t0
    rec["actor_cold_start_split"] = cold_start_split(t0_boot, where,
                                                     boot_clock())
    check(where["param_device"].startswith("cuda"),
          f"disagg: the GPU actor's params are on {where['param_device']}")
    pf = RecordingPrefill(disagg.PrefillServer(
        params, cfg, kv_block_size=DISAGG_BLOCK, retain=retain))
    local = disagg.DecodeServer(params, cfg, max_batch=DISAGG_BATCH)
    router = disagg.DisaggRouter(decode=[local, actor], prefill=[pf],
                                 affinity_tokens=DISAGG_BLOCK)
    got, ttft, wall = route_in_order(router, prompts, SERVE_NEW)
    differ = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    check(not differ, f"disagg A: streams {differ} differ from generate()")
    wait_for(lambda: pf.stats()["held_transfers"] == 0, 30.0,
             "disagg A: the transfers' acks")
    pst = pf.stats()
    ast = rt.get(actor.stats.remote(), timeout=60.0)
    lst = local.stats()
    kv_bytes = pst["published_bytes"] // pst["published_transfers"]
    check(ast["transfers"] >= 2, f"disagg A: the GPU actor adopted "
          f"{ast['transfers']} transfers")
    check(ast["shm_bytes"] == ast["kv_fetched_bytes"]
          == ast["transfers"] * kv_bytes and ast["rpc_bytes"] == 0,
          f"disagg A: the actor's fetch accounting {ast}")
    check(ast["prefill_programs"] == 0,
          f"disagg A: the actor ran {ast['prefill_programs']} prefills")
    outcomes = [r["outcome"] for r in pf.records]
    check(outcomes[0] == "miss"
          and all(o in ("hit", "partial") for o in outcomes[1:]),
          f"disagg A: prefix outcomes {outcomes}")
    check(pst["reaped_unacked"] == 0 and pst["acked"] == len(prompts),
          f"disagg A: retention {pst}")
    check(pst["prefix_cache"]["evictions"] == 0
          and pf.kvplane_stats()["spills"] == 0,
          "disagg A: the fp32 pool evicted (it must hold the round)")
    fetch_ms = rt.get(actor.fetch_times.remote(), timeout=60.0)
    publish_ms = pf.publish_times()
    # where the decode time goes: the same requests (prefix hits now)
    # with each decode replica alone, the other process idle, and with two
    # decode replicas in this process (one CUDA context on the card)
    alone = {}
    local2 = disagg.DecodeServer(params, cfg, max_batch=DISAGG_BATCH)
    for name, tier in (("local", [local]), ("actor", [actor]),
                       ("two_local", [local, local2])):
        r = disagg.DisaggRouter(decode=tier, prefill=[pf],
                                affinity_tokens=DISAGG_BLOCK)
        agot, attft, awall = route_in_order(r, prompts, SERVE_NEW)
        check(agot == want, f"disagg A: the {name} decode replica's "
              f"streams differ from generate()")
        alone[name] = {"decode_tokens_per_s": len(prompts) * SERVE_NEW
                       / awall, "ttft_ms": quantiles_ms(attft)}
    local2.stop()
    wait_for(lambda: pf.stats()["held_transfers"] == 0, 30.0,
             "disagg A: the transfers' acks")
    # the same requests through the colocated engine
    eng = engine_mod.ContinuousBatchingEngine(
        params, cfg, max_batch=DISAGG_BATCH, kv_block_size=DISAGG_BLOCK)
    try:
        colo = disagg.DisaggRouter(colocated=eng)
        cgot, cttft, cwall = route_in_order(colo, prompts, SERVE_NEW)
    finally:
        eng.stop()
    check(cgot == want, "disagg A: the colocated streams differ from "
          "generate()")
    rt.get(actor.stop.remote(), timeout=60.0)
    rt.kill(actor)
    rec["A"] = {
        "requests": len(prompts), "prompt_tokens": len(prompts[0]),
        "new_tokens": SERVE_NEW, "streams_equal_generate": len(prompts),
        "ttft_ms": quantiles_ms(ttft), "colocated_ttft_ms":
            quantiles_ms(cttft),
        "kv_bytes_per_transfer": kv_bytes,
        "publish_ms": quantiles_ms([x / 1e3 for x in publish_ms]),
        "actor_fetch_ms": quantiles_ms([x / 1e3 for x in fetch_ms]),
        "local_fetch_ms": quantiles_ms(
            [x / 1e3 for x in local.fetch_times()] or [0.0]),
        "decode_tokens_per_s": len(prompts) * SERVE_NEW / wall,
        "colocated_decode_tokens_per_s": len(prompts) * SERVE_NEW / cwall,
        "decode_alone": alone,
        "actor_transfers": ast["transfers"],
        "local_transfers": lst["transfers"],
        "actor_shm_bytes": ast["shm_bytes"],
        "actor_rpc_bytes": ast["rpc_bytes"],
        "local_chunks_local": lst["chunks_local"],
        "actor_prefill_programs": ast["prefill_programs"],
        "outcomes": outcomes, "reaped_unacked": pst["reaped_unacked"],
        "retain": retain, "router": {k: router.stats()[k] for k in (
            "dispatched", "completed", "shed", "max_pending",
            "shm_affinity_hits", "directory_hits", "directory_misses")}}

    # ---- round B: a decode actor killed mid-stream
    plan = [{"action": "kill_replica", "role": "decode",
             "at": f"token:{DISAGG_KILL_AT}", "replica": 0}]
    actor_b = Actor.remote(cpu_params, cfg, max_batch=DISAGG_BATCH,
                           chaos=plan, device="cuda")
    where_b = rt.get(actor_b.where.remote(), timeout=300.0)
    # ties of the free-slot refinement go to the last replica: actor_b
    router_b = disagg.DisaggRouter(decode=[local, actor_b], prefill=[pf],
                                   affinity_tokens=DISAGG_BLOCK,
                                   stream_chunk_tokens=DISAGG_PULL)
    rid_b = router_b.tier_replicas("decode")[-1]["rid"]
    heal: dict = {}

    def decode_factory():
        """The healer's replacement: a GPU decode actor without a chaos
        plan, returned once it runs (it waits for the card's lease)."""
        t0, t0_boot = time.perf_counter(), boot_clock()
        a = Actor.remote(cpu_params, cfg, max_batch=DISAGG_BATCH,
                         device="cuda")
        where = rt.get(a.where.remote(), timeout=300.0)
        heal.update(actor=a, where=where, ready_ts=time.time(),
                    cold_start_s=time.perf_counter() - t0,
                    cold_start_split=cold_start_split(t0_boot, where,
                                                      boot_clock()))
        return a

    hold = dict(up_delay_s=3600.0, down_delay_s=3600.0)
    healer = autoscale.DisaggAutoscaler(
        router_b, prefill=autoscale.TierSpec(fixed_tier, min_replicas=1,
                                             max_replicas=1, **hold),
        decode=autoscale.TierSpec(decode_factory, min_replicas=1,
                                  max_replicas=2, **hold),
        interval_s=3600.0, drain_grace_s=5.0).watch()
    prompt = prompts[0]
    with torch.inference_mode():
        want_b = generate_mod.generate(
            params, cfg, [prompt],
            max_new_tokens=DISAGG_FAILOVER_NEW)[0].tolist()
    chunks_at = []
    n_records = len(pf.records)
    got_b = router_b.generate(
        prompt, DISAGG_FAILOVER_NEW, timeout_s=300.0,
        on_tokens=lambda toks: chunks_at.append((time.time(), len(toks))))
    check(got_b == want_b, "disagg B: the failed-over stream differs from "
          "generate()")
    bst = router_b.stats()
    check(bst["failovers"] == {"prefill": 0, "decode": 1}
          and bst["failover_requests"] == 1 and bst["shed"] == 0,
          f"disagg B: router {bst}")
    check(rid_b not in [r["rid"] for r in router_b.tier_replicas("decode")],
          "disagg B: the dead actor is still routed")
    replays = pf.records[n_records:]
    check(len(replays) == 2 and replays[1]["reused_tokens"] > 0
          and replays[1]["plen"] > len(prompt),
          f"disagg B: the replay's prefill {replays}")
    router_b.publish_servefault(force=True)
    wait_for(lambda: state.servefault_status()["totals"]["removed_dead"]
             ["decode"] == 1, 10.0, "disagg B: servefault_status")
    sft = state.servefault_status()["totals"]
    events = w.conductor.call("get_servefault_events", timeout=30.0)
    kill = [e for e in events if e.get("kind") == "chaos"]
    fail = [e for e in events if e.get("kind") == "failover"]
    check(len(kill) == 1 and len(fail) == 1
          and any(n in fail[0]["detail"] for n in (
              "ActorDiedError", "ActorError", "WorkerCrashedError")),
          f"disagg B: events {kill} {fail}")
    resumed = [t for t, _ in chunks_at if t > kill[0]["ts"]]
    check(resumed, "disagg B: no token after the kill")
    info = w.conductor.call("get_actor_info", actor_b.actor_id, timeout=30.0)
    check(info["state"] == "DEAD", f"disagg B: the actor is {info['state']}")
    # the healer's replacement leases the card once the dead actor's
    # lease is back, and serves a request pinned to it
    wait_for(lambda: healer.servefault_stats()["replacements"]["decode"]
             >= 1, 300.0, "disagg B: the healer's replacement")
    healed = healer.servefault_stats()
    healer.stop()
    hold_heal("disagg B", healed, router_b.stats())
    replacement = heal["actor"]
    check(heal["where"]["pid"] != where_b["pid"],
          "disagg B: the replacement runs in the dead actor's process")
    router_r = disagg.DisaggRouter(decode=[replacement], prefill=[pf],
                                   affinity_tokens=DISAGG_BLOCK,
                                   stream_chunk_tokens=DISAGG_PULL)
    got_r = router_r.generate(prompt, DISAGG_FAILOVER_NEW, timeout_s=300.0)
    hold_stream("disagg B: the replacement", got_r, want_b)
    rst = rt.get(replacement.stats.remote(), timeout=60.0)
    check(rst["transfers"] == 1 and rst["prefill_programs"] == 0,
          f"disagg B: the replacement's stats {rst}")
    aev = {e["kind"]: e for e in w.conductor.call(
        "get_autoscale_events", timeout=30.0)
        if e.get("autoscaler") == healer.autoscaler_id}
    rt.get(replacement.stop.remote(), timeout=60.0)
    rt.kill(replacement)
    lease_s = heal["ready_ts"] - kill[0]["ts"]
    rec["B"] = {
        "new_tokens": DISAGG_FAILOVER_NEW, "kill_at_token": DISAGG_KILL_AT,
        "pull_tokens": DISAGG_PULL, "stream_equal_generate": True,
        "failovers": bst["failovers"], "replay": replays[1],
        "tokens_before_kill": sum(n for t, n in chunks_at
                                  if t <= kill[0]["ts"]),
        "kill_to_resumed_token_s": resumed[0] - kill[0]["ts"],
        "failover_detail": fail[0]["detail"][:160],
        "recovery_ms": router_b.servefault_stats()[
            "recent_failover_recovery_ms"],
        "servefault_totals": {k: sft[k] for k in (
            "failovers", "failover_requests", "removed_dead")},
        "lease_after_death_s": lease_s, "lease_pid": heal["where"]["pid"],
        "healer": {k: healed[k] for k in (
            "deaths", "replacements", "replacements_blocked",
            "breaker_trips")},
        "death_to_replacement_s": aev["replace"]["ts"]
        - aev["replica_death"]["ts"],
        "replacement_cold_start_s": heal["cold_start_s"],
        "replacement_cold_start_split": heal["cold_start_split"],
        "replacement_stream_equal_generate": True}

    # ---- round D: the SLO policy scales decode on the card
    rec["D"] = autoscale_round(autoscale, disagg, generate_mod, params,
                               cfg, pf, w)

    # ---- round C: the KV plane under pressure, int8
    cprompts = disagg_prompts(cfg, DISAGG_SEED + 1, 4)
    cprompts = cprompts + cprompts
    storm = [{"action": "evict_storm", "role": "prefill", "blocks": 128,
              "at": "request:5"}]
    pool = 2 * (-(-cfg.max_seq_len // DISAGG_BLOCK))  # 2 windows
    c1 = disagg.PrefillServer(params, cfg, kv_block_size=DISAGG_BLOCK,
                              kv_pool_blocks=pool, kv_int8=True,
                              kvplane_arena_bytes=DISAGG_ARENA,
                              retain=retain, chaos=storm)
    router_c = disagg.DisaggRouter(decode=[local], prefill=[c1],
                                   affinity_tokens=DISAGG_BLOCK)
    plain = engine_mod.ContinuousBatchingEngine(
        params, cfg, max_batch=DISAGG_BATCH, kv_block_size=DISAGG_BLOCK,
        kv_pool_blocks=pool, kv_int8=True)
    try:
        want_c = [plain.generate(p, SERVE_NEW, timeout_s=300.0)
                  for p in cprompts]
    finally:
        plain.stop()
    got_c = [router_c.generate(p, SERVE_NEW, timeout_s=300.0)
             for p in cprompts]
    differ = [i for i, (x, y) in enumerate(zip(got_c, want_c)) if x != y]
    check(not differ, f"disagg C: streams {differ} differ from the plain "
          f"int8 engine's")
    kst = c1.kvplane_stats()
    check(kst["evict_storms"] == 1 and kst["spills"] > 0
          and kst["tier2_hits"] > 0 and kst["tier3_publishes"] > 0,
          f"disagg C: the KV plane {kst}")
    c2 = disagg.PrefillServer(params, cfg, kv_block_size=DISAGG_BLOCK,
                              kv_pool_blocks=pool, kv_int8=True,
                              retain=retain)
    entry = kvp.directory_lookup(w, None, cprompts[0], DISAGG_BLOCK)
    check(entry is not None and entry["holder"] == c1.server_id,
          f"disagg C: the directory holds {entry}")
    rec_c2 = c2.prefill(cprompts[0], None, entry)
    c2st = c2.kvplane_stats()
    check(c2st["tier3_reused_tokens"] > 0 and rec_c2["reused_tokens"] > 0,
          f"disagg C: tier 3 {c2st}")
    got_c2 = local.decode_from(rec_c2, SERVE_NEW, timeout_s=300.0)
    c2.ack(rec_c2["transfer_id"])
    check(got_c2 == got_c[4], "disagg C: the tier-3 adopter's stream "
          "differs from the holder's")
    with torch.inference_mode():
        t0 = time.perf_counter()
        packed, n_tok, digest = c1.kv_cache.export_prefix(cprompts[0])
        export_ms = (time.perf_counter() - t0) * 1e3
        fresh = kvcache.PagedKVCache(cfg, block_size=DISAGG_BLOCK,
                                     num_blocks=64, int8=True)
        t0 = time.perf_counter()
        adopted = fresh.import_prefix(cprompts[0], packed)
        torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t0) * 1e3
        again = fresh.export_prefix(cprompts[0])
    check(adopted == n_tok // DISAGG_BLOCK and again[2] == digest
          and all(np.array_equal(again[0][f], packed[f])
                  for f in ("qk", "qv", "sk", "sv", "tokens")),
          "disagg C: export / import between CUDA pools changed bytes")
    local.stop()
    check_no_kernel(kernels, "the disaggregated serving path")
    rec["C"] = {
        "pool_blocks": pool, "arena_bytes": DISAGG_ARENA,
        "requests": len(cprompts), "streams_equal_plain_int8": len(cprompts),
        "storm_evicted_blocks": kst["storm_evicted_blocks"],
        "spills": kst["spills"], "tier2_hits": kst["tier2_hits"],
        "tier2_reused_tokens": kst["tier2_reused_tokens"],
        "tier3_publishes": kst["tier3_publishes"],
        "tier3_reused_tokens": c2st["tier3_reused_tokens"],
        "tier3_fetched_bytes": c2st["tier3_fetched_bytes"],
        "prefix_blocks": adopted, "prefix_bytes": int(sum(
            packed[f].nbytes for f in ("qk", "qv", "sk", "sv"))),
        "tier3_export_ms": export_ms, "tier3_import_ms": import_ms}
    return {"phase": "disagg", "card": card_line(), "model": "gpt2-small",
            "dtype": "float32", "kv_block_size": DISAGG_BLOCK,
            "predicted": DISAGG_PREDICTED, **rec}


def fixed_tier():
    """The factory of a tier the loop must not scale."""
    raise RuntimeError("this tier is fixed")


def hold_heal(what: str, healer: dict, router: dict) -> None:
    """The self-healer saw exactly the one decode death and replaced it
    once, no breaker tripped and the router shed nothing."""
    check(healer["deaths"] == {"prefill": 0, "decode": 1}
          and healer["replacements"] == {"prefill": 0, "decode": 1}
          and healer["replacements_blocked"] == 0
          and healer["breaker_trips"] == 0 and router["shed"] == 0,
          f"{what}: healer {healer}, router shed {router['shed']}")


def hold_stream(what: str, got, want) -> None:
    """A stream equal to generate()'s, token for token."""
    if got != want:
        at = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                  min(len(got), len(want)))
        check(False, f"{what}: the stream differs from generate() at token "
              f"{at} ({len(got)} vs {len(want)} tokens)")


# round D of the disagg phase: a burst of AUTOSCALE_BURST requests, one
# every AUTOSCALE_GAP_S, each paced by the router at AUTOSCALE_SLEEP_S a
# token, against one decode replica of DISAGG_BATCH slots; the policy's
# delays and windows are short so the round takes seconds
AUTOSCALE_BURST = 8
AUTOSCALE_GAP_S = 0.4
AUTOSCALE_SLEEP_S = 0.05
AUTOSCALE_POLICY = {"up_delay_s": 1.0, "down_delay_s": 2.0,
                    "cooldown_s": 1.0}
AUTOSCALE_WINDOW_S = 2.0
AUTOSCALE_INTERVAL_S = 0.25
# the predictions, written before the round first ran (PERF.md section 6)
AUTOSCALE_PREDICTED = {"scale_up_after_burst_start_s": [1.5, 4.0],
                       "scale_down_after_last_stream_s": [2.5, 8.0],
                       "death_to_replacement_s": [10, 30],
                       "replacement_cold_start_s": [10, 30],
                       "kill_to_resumed_token_s": [0.05, 2.0]}


def autoscale_round(autoscale, disagg, generate_mod, params, cfg, pf,
                    w) -> dict:
    """The SLO policy on the card (DisaggAutoscaler.start(), its tick
    every AUTOSCALE_INTERVAL_S): decode replicas are DecodeServers in this
    process (one card, one lease), the prefill tier is the round's
    PrefillServer, held at one. The burst takes decode from 1 to 2
    replicas, idle drains it back to 1: streams equal generate(), nothing
    shed, one scale-up, one drain completed."""
    made = []

    def local_factory():
        d = disagg.DecodeServer(params, cfg, max_batch=DISAGG_BATCH)
        made.append(d)
        return d

    router = disagg.DisaggRouter(decode=[local_factory()], prefill=[pf],
                                 affinity_tokens=DISAGG_BLOCK,
                                 window_s=AUTOSCALE_WINDOW_S)
    prompts = disagg_prompts(cfg, DISAGG_SEED + 2, AUTOSCALE_BURST)
    with torch.inference_mode():
        want = generated(generate_mod, params, cfg, prompts)
    scaler = autoscale.DisaggAutoscaler(
        router, prefill=autoscale.TierSpec(fixed_tier, min_replicas=1,
                                           max_replicas=1),
        decode=autoscale.TierSpec(local_factory, min_replicas=1,
                                  max_replicas=2, **AUTOSCALE_POLICY),
        interval_s=AUTOSCALE_INTERVAL_S, drain_grace_s=30.0,
        window_s=AUTOSCALE_WINDOW_S)
    got, errors = [None] * len(prompts), []
    t_start = time.time()

    def run(i):
        try:
            got[i] = router.generate(prompts[i], SERVE_NEW, timeout_s=300.0,
                                     token_sleep_s=AUTOSCALE_SLEEP_S)
        except Exception as err:  # noqa: BLE001 — re-raised below
            errors.append(err)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    scaler.start()
    try:
        for th in threads:
            th.start()
            time.sleep(AUTOSCALE_GAP_S)
        for th in threads:
            th.join(600.0)
        t_done = time.time()
        wait_for(lambda: scaler.status()["drains_completed"] >= 1
                 and scaler.status()["decode_replicas"] == 1, 120.0,
                 "disagg D: the idle drain")
    finally:
        scaler.stop()
        for d in made:
            d.stop()
    check(not errors, f"disagg D: {errors!r}")
    for i, (x, y) in enumerate(zip(got, want)):
        hold_stream(f"disagg D: request {i}", x, y)
    st, rs = scaler.status(), router.stats()
    check(st["scale_ups"] == {"prefill": 0, "decode": 1}
          and st["scale_downs"] == {"prefill": 0, "decode": 1}
          and st["drains_completed"] == 1 and st["drains_forced"] == 0,
          f"disagg D: the loop {st}")
    check(rs["shed"] == 0 and rs["completed"] == rs["dispatched"]
          == len(prompts), f"disagg D: router {rs}")
    events = [e for e in w.conductor.call("get_autoscale_events",
                                          timeout=30.0)
              if e.get("autoscaler") == scaler.autoscaler_id]
    return {"requests": len(prompts), "gap_s": AUTOSCALE_GAP_S,
            "token_sleep_s": AUTOSCALE_SLEEP_S, "new_tokens": SERVE_NEW,
            "policy": AUTOSCALE_POLICY, "window_s": AUTOSCALE_WINDOW_S,
            "interval_s": AUTOSCALE_INTERVAL_S,
            "streams_equal_generate": len(prompts), "shed": rs["shed"],
            "decisions": [{"kind": e["kind"], "tier": e.get("tier"),
                           "at_s": e["ts"] - t_start,
                           "reason": e.get("reason")} for e in events],
            "last_stream_at_s": t_done - t_start,
            "transfers": [d.stats()["transfers"] for d in made],
            "replica_seconds": st["replica_seconds"],
            "predicted": AUTOSCALE_PREDICTED}


ONLINE_NAME = "online"
ONLINE_CONFIG = {"num_samplers": 1, "num_steps": 10, "batch_size": 8,
                 "publish_every": 2, "max_prompt_len": 64,
                 "max_new_tokens": 64}
ONLINE_LAUNCHES_PER_STEP = {**_NO_LAUNCHES, "flash_fwd": 12,
                            "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
# the sampler's greedy stream of this prompt on its last version is held
# against generate() in the driver
ONLINE_PROBE = [(7919 * i) % 50257 for i in range(1, 33)]
ONLINE_PROBE_NEW = 32
ONLINE_TIMING_STEPS = 5
ONLINE_LORA_STEPS = 4
ONLINE_LORA_TENANT = "tenant-0"
ONLINE_SEED = 90
# the predictions, written before the phase first ran (PERF.md section 6)
ONLINE_PREDICTED = {"learner_step_ms": [20, 60],
                    "learner_tokens_per_s": [17000, 51000],
                    "rollouts_per_s": [0.8, 2.0], "fit_s": [45, 110],
                    "delta_bytes": [245000000, 247434240],
                    "full_bytes": 249007104,
                    "publish_ms": [400, 1100],
                    "commit_to_applied_s": [0.3, 1.5],
                    "sampler_cold_start_s": [12, 30],
                    "lora_step_launches": {"flash_fwd": 12,
                                           "flash_bwd_dq": 12,
                                           "flash_bwd_dkv": 12}}


def online_sampler_class():
    """The online phase's sampler actor: a RolloutSampler that reports
    where it runs and, at stop(), its greedy stream of ONLINE_PROBE on the
    newest version. Built here, so it is pickled by value."""
    from ray_tpu_torch.online import RolloutSampler

    class OnlineSampler(RolloutSampler):
        def __init__(self, *args, **kwargs):
            self.init_at = boot_clock()
            _no_tf32()
            RolloutSampler.__init__(self, *args, **kwargs)
            self.where = {**_where(self.init_at), "ready_at": boot_clock()}

        def stop(self) -> dict:
            # the rollout loop ends, the engine catches up with the
            # newest version, then answers the probe
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=60.0)
            latest = self.sync.status()["latest_version"]
            self.sync.wait_for_swap(latest, timeout=120.0)
            probe = self.engine.generate(ONLINE_PROBE, ONLINE_PROBE_NEW,
                                         timeout_s=300.0)
            version = self.engine.params_version
            swaps = list(self.sync.swaps)
            return {**RolloutSampler.stop(self), "probe_stream": probe,
                    "probe_version": version, "swaps": swaps,
                    "where": self.where}

    return OnlineSampler


def phase_online(kernels, gpt2, generate_mod) -> None:
    """The online learning loop on the card (see online_body)."""
    import ray_tpu_torch as rt

    torch.cuda.empty_cache()
    info = rt.init(num_cpus=4)
    try:
        line = online_body(rt, kernels, gpt2, generate_mod)
    finally:
        end_session(rt, info["session_dir"], "online")
    emit(line)


def online_body(rt, kernels, gpt2, generate_mod) -> dict:
    """`OnlineTrainer` on GPT-2 small bf16: the learner in this process on
    the card (TrainStep, frozen_adam, the distillation loss on [8, 127]),
    one RolloutSampler GPU actor on the card's lease, ONLINE_CONFIG.
    Held: no error, 10 finite losses, 80 rollouts ingested, the sampler's
    staleness <= 1 with a swap and no rpc bytes, every delta version
    smaller than whole, `wpe` bit-equal in every version, the learner's
    launches exactly ONLINE_LAUNCHES_PER_STEP a step (no CE kernel, no
    plain route), and the sampler's greedy stream on its last version
    equal to generate() on that version here. Then a TenantLoraTrainer
    on GPT-2 small bf16 takes ONLINE_LORA_STEPS steps (its launches held
    the same way) and publishes under lora/<tenant>; an engine whose
    pool reads the fabric pages the adapter in, and its tenant stream
    (fp32 copy of the base) equals generate() on the merged params."""
    import shutil
    import tempfile

    from ray_tpu_torch import weights
    from ray_tpu_torch.models import engine as engine_mod
    from ray_tpu_torch.online import (OnlineConfig, OnlineTrainer,
                                      TenantLoraTrainer)
    from ray_tpu_torch.online.loop import _collate, _distill_loss_fn
    from ray_tpu_torch.serve import lora
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.train.optim import frozen_adam
    from ray_tpu_torch.train.step import TrainStep
    from ray_tpu_torch.tree import tree_map
    from ray_tpu_torch.weights import publisher as pub_mod

    w = rt._private.worker.global_worker
    cfg = gpt2.GPT2Config.small()
    oc = OnlineConfig(weights_name=ONLINE_NAME, seed=ONLINE_SEED,
                      **ONLINE_CONFIG)
    steps = oc.num_steps
    tmp = tempfile.mkdtemp(prefix="online-")
    out: dict = {}
    try:
        trainer = OnlineTrainer(
            cfg, config=oc, run_config=RunConfig(name="online",
                                                 storage_path=tmp),
            device="cuda", sampler_device="cuda",
            sampler_class=online_sampler_class())
        reset_counts(kernels)
        t0, t0_boot = time.perf_counter(), boot_clock()
        res = trainer.fit()
        fit_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(res.error is None, f"online: the learner failed: {res.error!r}")
    losses = [m["loss"] for m in res.metrics_history if "loss" in m]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"online: losses {losses}")
    check(res.metrics_history[-1]["ingested_rollouts"]
          == steps * oc.batch_size,
          f"online: ingested {res.metrics_history[-1]}")
    hold_launches("online: the learner", launches, ONLINE_LAUNCHES_PER_STEP,
                  steps)
    check_no_plain_route("the online learner")
    check(len(res.sampler_stats) == 1, f"online: {res.sampler_stats}")
    smp = res.sampler_stats[0]
    check(smp["run_error"] is None and smp["max_staleness_versions"] is not
          None and smp["max_staleness_versions"] <= 1
          and smp["swap_count"] >= 1 and smp["rpc_bytes"] == 0,
          f"online: the sampler {smp}")
    versions = res.weight_versions["names"][ONLINE_NAME]["versions"]
    deltas = [v for v in versions if v["delta"]]
    check(deltas and all(0 < v["delta_bytes"] < v["total_bytes"]
                         for v in deltas), f"online: versions {versions}")
    sub = weights.WeightSubscriber(ONLINE_NAME)
    kept = [v["version"] for v in versions]
    wpe = [torch.as_tensor(sub.fetch(version=v)["wpe"]) for v in kept]
    check(all(torch.equal(x, wpe[0]) for x in wpe),
          f"online: wpe moved across versions {kept}")
    check(smp["probe_version"] == max(kept),
          f"online: the sampler serves v{smp['probe_version']}, the last "
          f"publish is v{max(kept)}")
    template = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(1),
                              device="cuda")
    last = sub.fetch(version=max(kept), like=template)
    sub.close()
    with torch.inference_mode():
        want = generate_mod.generate(last, cfg, [ONLINE_PROBE],
                                     max_new_tokens=ONLINE_PROBE_NEW)[0]
    hold_stream("online: the sampler's probe", smp["probe_stream"],
                want.tolist())
    commit = {m["version"]: m["ts"] for m in versions}
    applied = [s["applied_at"] - commit[s["version"]]
               for s in smp["swaps"] if s["version"] in commit]
    pub = pub_mod.publisher(ONLINE_NAME)
    # the learner's step alone, timed by CUDA events on the phase's shape
    rng = np.random.default_rng(ONLINE_SEED)
    rollouts = [{"prompt": rng.integers(1, cfg.vocab_size,
                                        oc.max_prompt_len).astype(np.int32),
                 "completion": rng.integers(
                     1, cfg.vocab_size, oc.max_new_tokens).astype(np.int32),
                 "weights_version": 1} for _ in range(oc.batch_size)]
    batch = _collate(rollouts, oc.max_prompt_len + oc.max_new_tokens)
    batch.pop("versions")
    step = TrainStep(_distill_loss_fn(cfg),
                     frozen_adam(oc.learning_rate, oc.frozen_leaves),
                     device="cuda")
    state = step.init_state(last)
    step_ms = []
    for i in range(ONLINE_TIMING_STEPS + 1):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        state, _ = step(state, batch)
        b.record()
        torch.cuda.synchronize()
        if i:
            step_ms.append(a.elapsed_time(b))
    del state, last, template
    tokens = batch["tokens"].numel()
    med = statistics.median(step_ms)
    where = smp["where"]
    out.update(
        model="gpt2-small", dtype="bfloat16", config=ONLINE_CONFIG,
        learner_tokens=list(batch["tokens"].shape), losses=losses,
        learner_launches=launches, launches_per_step=ONLINE_LAUNCHES_PER_STEP,
        learner_step_ms={"median": med, "all": step_ms},
        learner_tokens_per_s=tokens / med * 1e3,
        fit_s=fit_s, rollouts=smp["rollouts"],
        rollouts_per_s=smp["rollouts"] / fit_s,
        rollout_tokens=smp["rollout_tokens"],
        sampler={k: smp[k] for k in (
            "max_staleness_versions", "swap_count", "rpc_bytes",
            "shm_bytes", "prefetch_bytes", "backpressure_waits")},
        versions=[{k: v[k] for k in ("version", "delta", "delta_bytes",
                                     "total_bytes")} for v in versions],
        publish_ms=list(pub.publish_ms),
        publish_bytes=list(pub.published_bytes),
        commit_to_applied_s=applied,
        sampler_cold_start_s=where["ready_at"] - t0_boot,
        sampler_cold_start_split=cold_start_split(t0_boot, where,
                                                  where["ready_at"]),
        wpe_equal_versions=kept, probe_version=smp["probe_version"],
        probe_equal_generate=True)
    # ---- per-tenant LoRA on the same model
    base = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(ONLINE_SEED),
                          device="cuda")
    lt = TenantLoraTrainer(base, cfg, ONLINE_LORA_TENANT, rank=8, scale=2.0,
                           learning_rate=1e-2, publish_every=2,
                           seed=ONLINE_SEED)
    gen = np.random.default_rng(ONLINE_SEED + 1)
    lbatches = [gen.integers(0, cfg.vocab_size, (oc.batch_size, 128))
                for _ in range(ONLINE_LORA_STEPS)]
    reset_counts(kernels)
    t0 = time.perf_counter()
    lres = lt.fit(lbatches, num_steps=ONLINE_LORA_STEPS)
    lora_s = time.perf_counter() - t0
    llaunches = dict(kernels.LAUNCHES)
    hold_launches("online: the LoRA trainer", llaunches,
                  ONLINE_LAUNCHES_PER_STEP, ONLINE_LORA_STEPS)
    check_no_plain_route("the online LoRA trainer")
    check(lres["published_versions"] == [1, 2]
          and all(np.isfinite(lres["losses"])), f"online LoRA: {lres}")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    base32 = tree_map(lambda t: t.float(), base)
    del base
    pool = lora.build_pool(cfg32, True, slots=2, device="cuda")
    eng = engine_mod.ContinuousBatchingEngine(base32, cfg32, max_batch=2,
                                              lora_pool=pool)
    try:
        tenant = eng.generate(ONLINE_PROBE, ONLINE_PROBE_NEW,
                              timeout_s=300.0, adapter_id=ONLINE_LORA_TENANT)
        resident = pool.resident_version(ONLINE_LORA_TENANT)
        pstats = pool.stats()
    finally:
        eng.stop()
        pool.source.close()
    check(resident == 2, f"online LoRA: the pool holds v{resident}")
    ad = lt.adapter()
    merged = generate_mod.merge_lora_params(base32, cfg32, {
        "scale": float(ad["scale"]),
        "targets": {n: {k: torch.from_numpy(v).cuda() for k, v in ab.items()}
                    for n, ab in ad["targets"].items()}})
    with torch.inference_mode():
        want_t = generate_mod.generate(merged, cfg32, [ONLINE_PROBE],
                                       max_new_tokens=ONLINE_PROBE_NEW)[0]
    hold_stream("online LoRA: the tenant stream", tenant, want_t.tolist())
    out["lora"] = {"tenant": ONLINE_LORA_TENANT, "rank": 8, "scale": 2.0,
                   "steps": ONLINE_LORA_STEPS,
                   "tokens": [oc.batch_size, 127], "losses": lres["losses"],
                   "launches": llaunches, "fit_s": lora_s,
                   "published_versions": lres["published_versions"],
                   "page_in_bytes": pstats["page_in_bytes"],
                   "tenant_stream_equal_generate": True}
    return {"phase": "online", "card": card_line(),
            "predicted": ONLINE_PREDICTED, **out}


PIPELINE_NAME = "llama-pipeline"
PIPELINE_B_NAME = "llama-pipeline-b"
PIPELINE_TOKENS = (8, 1024)
PIPELINE_M = 4
PIPELINE_STEPS = 4
PIPELINE_B_STEPS = 2
PIPELINE_LR = 1e-3
PIPELINE_SEED = 95
PIPELINE_DEVICES = ["cpu", "cuda"]
# the GPU stage's launches a step: its loss-and-grad recomputes the
# forward of each microbatch, 12 layers x M 4
PIPELINE_LAUNCHES_PER_STEP = {**_NO_LAUNCHES, "flash_fwd": 48,
                              "flash_bwd_fused": 48}
# step 0 precedes any update: the pipeline's loss is the dense one
PIPELINE_FIRST_LOSS_TOL = 1e-4
PIPELINE_KILL_BOUND_S = 25.0
PIPELINE_LEASE_BOUND_S = 60.0
# the predictions, written before the phase first ran (PERF.md section 6)
PIPELINE_PREDICTED = {"stage_step_ms": [200, 700],
                      "pipeline_tokens_per_s": [11700, 41000],
                      "dense_step_ms": [80, 200],
                      "dense_tokens_per_s": [41000, 102400],
                      "bubble_fraction": [0.15, 0.8],
                      "activation_bytes_per_step": 25165824,
                      "gpu_stage_cold_start_s": [12, 35],
                      "kill_to_raise_s": [0.05, 3.0],
                      "lease_back_s": [12, 40],
                      "phase_s": [80, 180]}


def pipeline_stage0(params, tokens):
    """Stage 0 of the Llama pipeline: the embedding lookup."""
    return params["tok_emb"][tokens]


def pipeline_stage1(params, x):
    """Stage 1: Llama small's 12 blocks, norm_f and the LM head (fp32
    logits), as `llama_forward` runs them after the embedding."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.layers import fp32_logits, rms_norm

    cfg = llama.LlamaConfig.small()
    cos, sin = llama._rope(cfg, x.device)
    for p in params["blocks"]:
        x = llama.llama_block(x, p, cos, sin, cfg)
    return fp32_logits(rms_norm(x, params["norm_f"]["scale"]),
                       params["lm_head"])


def pipeline_loss(logits, targets):
    """`llama_loss`'s tail: the padded vocabulary masked, log-softmax,
    the mean next-token cross-entropy over the microbatch."""
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.small()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def pipeline_data(step):
    """Step `step`'s tokens [8, 1024] and next tokens, from the phase's
    own seed."""
    from ray_tpu_torch.models import llama

    b, t = PIPELINE_TOKENS
    seq = np.random.default_rng(PIPELINE_SEED + step).integers(
        0, llama.LlamaConfig.small().vocab_size, (b, t + 1))
    return seq[:, :-1], seq[:, 1:]


def pipeline_slow_data(step):
    time.sleep(0.05)
    return pipeline_data(step)


def pipeline_stage_class():
    """The stages' actor class: a StageActor that turns TF32 off, records
    where and when it became ready, and counts its own process's kernel
    launches and plain-route attention calls from 0 over each run. Built
    here, so it is pickled by value."""
    from ray_tpu_torch.mpmd.stage import StageActor

    class PipelineStage(StageActor):
        def __init__(self, *args, **kwargs):
            self.init_at = boot_clock()
            _no_tf32()
            StageActor.__init__(self, *args, **kwargs)
            self.where = None

        def setup(self, *args, **kwargs):
            out = StageActor.setup(self, *args, **kwargs)
            if self.device == "cuda":
                torch.cuda.synchronize()
                self.where = {**_where(self.init_at),
                              "ready_at": boot_clock()}
            else:
                self.where = {"pid": os.getpid(), "ready_at": boot_clock()}
            return out

        def run_steps(self, *args, **kwargs):
            from ray_tpu_torch import kernels
            from ray_tpu_torch.ops import attention

            kernels.reset_launches()
            attention.PLAIN_CALLS["attention"] = 0
            out = StageActor.run_steps(self, *args, **kwargs)
            out.update(launches=dict(kernels.LAUNCHES),
                       plain_calls=attention.PLAIN_CALLS["attention"],
                       where=self.where)
            return out

    return PipelineStage


def pipeline_params():
    """Llama small bf16 from the phase's seed on the CPU, split by stage:
    the embedding; the blocks, norm_f and the untied lm_head."""
    from ray_tpu_torch.models import llama

    params = llama.llama_init(llama.LlamaConfig.small(),
                              torch.Generator().manual_seed(PIPELINE_SEED),
                              device="cpu")
    return params, [{"tok_emb": params["tok_emb"]},
                    {"blocks": params["blocks"], "norm_f": params["norm_f"],
                     "lm_head": params["lm_head"]}]


def pipeline_dense_reference(params, steps: int) -> dict:
    """The dense reference on the card: the same params, the same
    microbatch split, `llama_loss` per microbatch, gradients summed (in
    their dtype) and divided by M, the same adamw; each step timed
    between CUDA events."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.tree import tree_leaves, tree_map

    cfg = llama.LlamaConfig.small()
    ref = tree_map(lambda t: t.to("cuda", copy=True).requires_grad_(True),
                   params)
    leaves = tree_leaves(ref)
    opt = adamw(PIPELINE_LR)
    state = opt.init(ref)
    losses, step_ms = [], []
    for step in range(steps):
        x, t = pipeline_data(step)
        xs = torch.from_numpy(x).cuda().reshape(PIPELINE_M, -1, x.shape[1])
        ts = torch.from_numpy(t).cuda().reshape(PIPELINE_M, -1, t.shape[1])
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        acc, mb_losses = None, []
        for i in range(PIPELINE_M):
            loss = llama.llama_loss(ref, xs[i], ts[i], cfg)
            grads = torch.autograd.grad(loss, leaves)
            mb_losses.append(loss.detach())
            acc = list(grads) if acc is None else \
                [u + v for u, v in zip(acc, grads)]
        opt.update_([g / float(PIPELINE_M) for g in acc], state, ref)
        b.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(np.mean([float(v) for v in mb_losses])))
    del ref, leaves, state, acc, grads
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms}


def hold_pipeline_losses(what: str, losses: list, want: list) -> None:
    """Step 0 within PIPELINE_FIRST_LOSS_TOL of the dense reference's
    (no update yet), every later step within MESH_LOSS_TOL (the fused
    backward's atomics vary run to run)."""
    check(len(losses) == len(want) and all(np.isfinite(losses)),
          f"{what}: losses {losses}")
    errs = [abs(a - b) for a, b in zip(losses, want)]
    check(errs[0] <= PIPELINE_FIRST_LOSS_TOL
          and all(e <= MESH_LOSS_TOL["llama-small"] for e in errs[1:]),
          f"{what}: losses {losses} against the dense reference's {want}")


def hold_pipeline_stages(what: str, stages: list, steps: int) -> dict:
    """The GPU stage launched exactly PIPELINE_LAUNCHES_PER_STEP a step
    and no attention call took the plain route; the CPU stage launched
    nothing. Returns the GPU stage's launches."""
    check([s["where"] is not None for s in stages] == [True, True]
          and stages[1]["where"].get("device") is not None,
          f"{what}: stage placement {[s['where'] for s in stages]}")
    hold_launches(f"{what}: the GPU stage", stages[1]["launches"],
                  PIPELINE_LAUNCHES_PER_STEP, steps)
    check(not any(stages[0]["launches"].values()),
          f"{what}: the CPU stage launched {stages[0]['launches']}")
    check(stages[1]["plain_calls"] == 0 and stages[0]["plain_calls"] == 0,
          f"{what}: plain-route calls "
          f"{[s['plain_calls'] for s in stages]}")
    return stages[1]["launches"]


def phase_pipeline() -> None:
    """MPMD pipelines on the card (see pipeline_body)."""
    import ray_tpu_torch as rt

    torch.cuda.empty_cache()
    info = rt.init(num_cpus=4)
    try:
        line = pipeline_body(rt)
    finally:
        end_session(rt, info["session_dir"], "pipeline")
    emit(line)


def pipeline_body(rt) -> dict:
    """Llama small bf16, full width, as a two-stage pipeline: stage 0 (the
    embedding) on a CPU actor, stage 1 (the blocks, norm_f, lm_head and
    the loss) on a GPU actor holding the card's lease. Round A: a
    `PipelineTrainer`, 1F1B, [8, 1024] in M 4 microbatches, adamw(1e-3),
    4 steps, against the dense reference run here first; held: the
    losses, the registry (formed, slices {0, 1}, bubble estimate 0.2,
    4 steps a stage, prefetch hits), the activation bytes, the GPU
    stage's launches (48 + 48 a step, nothing else, no plain route), the
    merged timeline's step markers and pipeline lane. Round B: a
    `PipelineConductor`, GPipe, 2 steps, held the same way; then a long
    run whose stage 0 is killed 1 s in: the run raises within
    PIPELINE_KILL_BOUND_S, a stage_death event, both actors dead. Round
    C: a PipelineTrainer under round B's name takes a step on the card's
    lease within PIPELINE_LEASE_BOUND_S of round B's close."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.mpmd import PipelineConductor
    from ray_tpu_torch.observability.timeline import merged_timeline
    from ray_tpu_torch.train import PipelineTrainer, RunConfig
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.util import state

    w = rt._private.worker.global_worker
    b, t = PIPELINE_TOKENS
    tokens = b * t
    params, split = pipeline_params()
    dense = pipeline_dense_reference(params, PIPELINE_STEPS)
    del params
    stage_cls = pipeline_stage_class()
    fns = [pipeline_stage0, pipeline_stage1]
    # bf16 activations forward and their gradients back, per microbatch
    d_model = llama.LlamaConfig.small().d_model
    per_step_bytes = 2 * PIPELINE_M * (b // PIPELINE_M) * t * d_model * 2

    # ---- round A: PipelineTrainer, 1F1B
    trainer = PipelineTrainer(
        fns, split, pipeline_loss, adamw(PIPELINE_LR),
        data_fn=pipeline_data, num_microbatches=PIPELINE_M,
        num_steps=PIPELINE_STEPS, schedule="1f1b",
        run_config=RunConfig(name=PIPELINE_NAME), device=PIPELINE_DEVICES,
        stage_class=stage_cls)
    t0_boot, t0 = boot_clock(), time.perf_counter()
    res = trainer.fit()
    fit_s = time.perf_counter() - t0
    check(res.error is None, f"pipeline: round A failed: {res.error!r}")
    losses = [m["loss"] for m in res.metrics_history]
    hold_pipeline_losses("pipeline round A", losses, dense["losses"])
    stages = trainer.stages
    launches = hold_pipeline_stages("pipeline round A", stages,
                                    PIPELINE_STEPS)
    rec = state.pipeline_status(PIPELINE_NAME)["pipelines"][PIPELINE_NAME]
    check(rec["formed"] and {v["slice_id"] for v in rec["stages"].values()}
          == {0, 1} and abs(rec["bubble_estimate"] - 0.2) < 1e-12,
          f"pipeline: the registry {rec}")
    check(set(rec["stats"]) == {0, 1} and all(
        s["steps"] == PIPELINE_STEPS for s in rec["stats"].values())
        and sum(s["prefetch_hits"] for s in rec["stats"].values()) > 0,
        f"pipeline: the stages' stats {rec['stats']}")
    check(rec["totals"]["activation_bytes"]
          == PIPELINE_STEPS * per_step_bytes,
          f"pipeline: activation bytes {rec['totals']} against "
          f"{per_step_bytes} a step")
    run_id = rec["run_id"]
    marks: list = []
    lanes: set = set()

    def timeline_in():
        trace = merged_timeline()
        marks[:] = [e for e in trace if e.get("cat") == "train_step"
                    and e.get("ph") == "X"
                    and e.get("pid") == f"train:{run_id}"]
        lanes.clear()
        lanes.update(e["tid"] for e in trace if e.get("cat") == "pipeline"
                     and e["args"].get("pipeline") == PIPELINE_NAME)
        return len(marks) >= 2 * PIPELINE_STEPS and \
            {"stage 0", "stage 1"} <= lanes

    wait_for(timeline_in, 15.0, "pipeline: the timeline's markers")
    check(len(marks) == 2 * PIPELINE_STEPS
          and {e["tid"] for e in marks} == {"rank 0", "rank 1"}
          and any(e["args"].get("bubble_wait_ms", 0) > 0 for e in marks),
          f"pipeline: step markers {[e['args'] for e in marks]}")
    by_rank = {r: sorted((e for e in marks if e["tid"] == f"rank {r}"),
                         key=lambda e: e["ts"]) for r in (0, 1)}
    step_ms = {r: [e["args"]["total_ms"] for e in by_rank[r]]
               for r in (0, 1)}
    bubble = {r: [e["args"]["bubble_wait_ms"] / e["args"]["total_ms"]
                  for e in by_rank[r]] for r in (0, 1)}
    med = {r: statistics.median(step_ms[r][1:]) for r in (0, 1)}
    pipe_ms = max(med.values())
    gpu_where = stages[1]["where"]

    # ---- round B: PipelineConductor, GPipe, then stage 0 killed
    pipe = PipelineConductor(
        PIPELINE_B_NAME, fns, split, adamw(PIPELINE_LR), pipeline_loss,
        num_microbatches=PIPELINE_M, schedule="gpipe",
        device=PIPELINE_DEVICES, stage_class=stage_cls)
    outcome: dict = {}
    try:
        pipe.form()
        out_b = pipe.run(PIPELINE_B_STEPS, pipeline_data)
        hold_pipeline_losses("pipeline round B", out_b["losses"],
                             dense["losses"][:PIPELINE_B_STEPS])
        launches_b = hold_pipeline_stages("pipeline round B",
                                          out_b["stages"], PIPELINE_B_STEPS)
        run_b = pipe.run_id
        actors = [a.actor_id for a in pipe._actors]

        def drive():
            t_start = time.monotonic()
            try:
                pipe.run(500, pipeline_slow_data, recv_timeout=120.0)
                outcome["error"] = None
            except Exception as e:  # noqa: BLE001 — the expected outcome
                outcome["error"] = e
            outcome["raised_at"] = time.monotonic()

        runner = threading.Thread(target=drive, daemon=True)
        runner.start()
        time.sleep(1.0)
        killed_at = time.monotonic()
        rt.kill(pipe._actors[0])
        runner.join(timeout=PIPELINE_KILL_BOUND_S + 5.0)
        check(not runner.is_alive() and outcome.get("error") is not None,
              f"pipeline: the run did not raise after stage 0's kill "
              f"({outcome})")
        kill_to_raise = outcome["raised_at"] - killed_at
        check(kill_to_raise <= PIPELINE_KILL_BOUND_S,
              f"pipeline: raised {kill_to_raise:.1f} s after the kill")
        states: list = []

        def both_dead():
            states[:] = [w.conductor.call("get_actor_info", a,
                                          timeout=10.0)["state"]
                         for a in actors]
            return states == ["DEAD", "DEAD"]

        wait_for(both_dead, 15.0,
                 lambda: f"pipeline: both stages dead (states {states})")
        events = w.conductor.call("get_pipeline_events", 1000, timeout=10.0)
        check(any(e.get("kind") == "stage_death"
                  and e.get("pipeline") == PIPELINE_B_NAME for e in events),
              "pipeline: no stage_death event")
    finally:
        pipe.close()
    closed_at = boot_clock()

    # ---- round C: the lease comes back to a new pipeline of that name
    trainer_c = PipelineTrainer(
        fns, split, pipeline_loss, adamw(PIPELINE_LR),
        data_fn=pipeline_data, num_microbatches=PIPELINE_M, num_steps=1,
        schedule="1f1b", run_config=RunConfig(name=PIPELINE_B_NAME),
        device=PIPELINE_DEVICES, stage_class=stage_cls)
    res_c = trainer_c.fit()
    check(res_c.error is None and len(res_c.metrics_history) == 1
          and np.isfinite(res_c.metrics_history[0]["loss"]),
          f"pipeline: round C {res_c.error!r} {res_c.metrics_history}")
    lease_back = trainer_c.stages[1]["where"]["ready_at"] - closed_at
    check(lease_back <= PIPELINE_LEASE_BOUND_S,
          f"pipeline: the GPU stage was ready {lease_back:.1f} s after "
          "round B's close")
    rec_c = state.pipeline_status(PIPELINE_B_NAME)["pipelines"][
        PIPELINE_B_NAME]
    check(rec_c["formed"] and rec_c["run_id"] != run_b,
          f"pipeline: round C's registry {rec_c['run_id']} vs {run_b}")
    dense_ms = statistics.median(dense["step_ms"][1:])
    stats = rec["stats"]
    return {
        "phase": "pipeline", "card": card_line(), "model": "llama-small",
        "dtype": "bfloat16", "tokens": list(PIPELINE_TOKENS),
        "microbatches": PIPELINE_M, "devices": PIPELINE_DEVICES,
        "predicted": PIPELINE_PREDICTED,
        "round_a": {
            "schedule": "1f1b", "losses": losses,
            "dense_losses": dense["losses"],
            "loss_errs": [abs(a - b) for a, b in zip(losses,
                                                      dense["losses"])],
            "launches": launches,
            "launches_per_step": PIPELINE_LAUNCHES_PER_STEP,
            "plain_calls": stages[1]["plain_calls"],
            "stage_step_ms": {f"stage {r}": step_ms[r] for r in (0, 1)},
            "stage_step_ms_median": {f"stage {r}": med[r] for r in (0, 1)},
            "stage_bubble_by_step": {f"stage {r}": bubble[r]
                                     for r in (0, 1)},
            "stage_bubble_fraction": {
                f"stage {s}": stats[s]["bubble_fraction"] for s in (0, 1)},
            "bubble_estimate": rec["bubble_estimate"],
            "activation_bytes_per_step":
                rec["totals"]["activation_bytes"] / PIPELINE_STEPS,
            "channel_wait_s": {f"stage {s}": stats[s]["channel_wait_s"]
                               for s in (0, 1)},
            "prefetch_hits": {f"stage {s}": stats[s]["prefetch_hits"]
                              for s in (0, 1)},
            "pipeline_step_ms": pipe_ms,
            "pipeline_tokens_per_s": tokens / pipe_ms * 1e3,
            "dense_step_ms": dense["step_ms"],
            "dense_step_ms_median": dense_ms,
            "dense_tokens_per_s": tokens / dense_ms * 1e3,
            "fit_s": fit_s,
            "gpu_stage_cold_start_s": gpu_where["ready_at"] - t0_boot,
            "gpu_stage_cold_start_split": cold_start_split(
                t0_boot, gpu_where, gpu_where["ready_at"]),
        },
        "round_b": {"schedule": "gpipe", "losses": out_b["losses"],
                    "launches": launches_b,
                    "kill_to_raise_s": kill_to_raise,
                    "error": type(outcome["error"]).__name__},
        "round_c": {"loss": res_c.metrics_history[0]["loss"],
                    "close_to_gpu_stage_ready_s": lease_back,
                    "run_id": rec_c["run_id"]},
    }


def phase_train_gang() -> None:
    """`TorchTrainer(mode="workers", num_workers=2, use_gpu=False,
    resources_per_worker={"CPU": 1})` on the card machine's CPUs: GPT-2
    tiny (fp32, 2 heads) on a 2-rank gloo gang, 4 steps of the mesh TrainStep
    (dp 2), each loss against the one-process step's within
    fabric_checks.GANG_LOSS_TOL (both fp32 on the CPU); a second
    fit, at the same time, whose chaos plan kills rank 1 at step 2
    restarts from pending/ and ends on the uninterrupted run's last
    loss. One card: a gang of GPU ranks (one card each) cannot form
    here."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import fabric_checks as fc
    from ray_tpu_torch.util import state

    info = rt.init(num_cpus=4)
    try:
        # the two fits run at once, a gang of 2 CPUs each
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(2) as pool:
            full_fut = pool.submit(fc.gpt2_gang_fit)
            chaos_fut = pool.submit(fc.gpt2_gang_fit, json.dumps(
                [{"action": "kill", "rank": 1, "at_step": 2}]))
            ref = fc.gpt2_reference_losses()
            full = full_fut.result()
            fit_s = time.perf_counter() - t0
            chaos = chaos_fut.result()
            chaos_s = time.perf_counter() - t0
        tol = fc.GANG_LOSS_TOL
        errs = [abs(x - y) for x, y in zip(full["losses"], ref)]
        check(full["steps"] == list(range(1, fc.GANG_STEPS + 1))
              and max(errs) <= tol
              and all(len(set(r)) == 1 for r in full["rank_losses"]),
              f"train_gang: losses {full} vs the one-process step's {ref}")
        check(chaos["steps"] == list(range(3, fc.GANG_STEPS + 1))
              and chaos["losses"][-1] == full["losses"][-1],
              f"train_gang: the restarted fit {chaos} vs {full}")
        counters = state.resilience_status()["counters"]
        check(counters.get("restart", 0) == 1
              and counters.get("recovery", 0) == 1,
              f"train_gang: resilience counters {counters}")
    finally:
        end_session(rt, info["session_dir"], "train_gang")
    emit({"phase": "train_gang", "model": "gpt2-tiny", "dtype": "float32",
          "ranks": 2, "backend": "gloo", "device": "cpu",
          "gpu_ranks": "not formed: one card here, a GPU rank needs a card "
                       "of its own",
          "steps": fc.GANG_STEPS, "tokens": list(fc.GANG_BATCH),
          "losses": full["losses"], "reference_losses": ref,
          "max_loss_err": max(errs), "tol": tol, "fit_s": fit_s,
          "restarted_steps": chaos["steps"],
          "restarted_losses": chaos["losses"], "chaos_fit_s": chaos_s,
          "resilience_counters": counters})


# --------------------------------------------------------- runtime surface
# How a user ships code to the workers, reaches the cluster from outside
# it and sees what it did: a GPU actor in a runtime_env scoring GPT-2
# small on the kernels, spans across the call, the actor's CUPTI profile,
# its metric and the state API, a ray:// client, the microbenchmark.

SURFACE_NAME = "surface-scorer"
SURFACE_SEED = 97
SURFACE_PROFILE_S = 3.0
SURFACE_CLIENT_CALLS = 10
SURFACE_PERF_SCALE = 0.05
SURFACE_SPAN_BOUND_S = 15.0
# written into PERF.md before the first run on the card
SURFACE_PREDICTED = {"cold_start_s": [10, 20],
                     "profile_scores": [60, 130],
                     "profile_flash_fwd_launches": [1440, 3120],
                     "profile_ce_fwd_launches": [60, 130],
                     "client_call_ms_median": [12, 25]}
SURFACE_KERNELS = {"flash_fwd": "flash_fwd_kernel", "ce_fwd": "ce_fwd_kernel"}

SURFACE_CLIENT = """
import json, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch._private.serialization import GpuLeaseRequiredError

t0 = time.perf_counter()
info = rt.init(address="ray://" + sys.argv[1])
connect_s = time.perf_counter() - t0
h = rt.get_actor(sys.argv[2])
seed, calls = int(sys.argv[3]), int(sys.argv[4])
losses, ms = [], []
for i in range(calls + 1):
    t0 = time.perf_counter()
    losses.append(rt.get(h.loss_of.remote(seed), timeout=300.0))
    if i:  # the first call warms up
        ms.append((time.perf_counter() - t0) * 1e3)
ref = h.cuda_loss_of.remote(seed)
try:
    rt.get(ref, timeout=300.0)
    refused = "loaded"
except GpuLeaseRequiredError as err:
    refused = str(err)
rt.shutdown()
print(json.dumps({"client": info.get("client"), "connect_s": connect_s,
                  "losses": losses, "ms": ms, "refused": refused,
                  "ref": ref.id}))
"""


def surface_tokens(seed: int) -> tuple:
    """GPT-2 small's [4, 512] tokens and targets from `seed`, on the CPU
    (the driver, the actor and a client make the same ones)."""
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, 50257, (4, 512), generator=gen)
    return tok, torch.randint(0, 50257, (4, 512), generator=gen)


class SurfaceActor(RuntimeGpuActor):
    """A GPU actor whose runtime_env stages a working directory and a
    package and sets a variable; it scores as RuntimeGpuActor does and
    counts its scores in a metric."""

    def __init__(self):
        super().__init__()
        from ray_tpu_torch.util import metrics

        self.scores = metrics.Counter(
            "surface_scores_total", "GPT-2 small scores in the actor")
        self.count = 0

    def staged(self) -> dict:
        """What the runtime_env gave this process."""
        import surface_helper  # the working_dir's module
        import surface_pkg  # the py_modules' package

        with open("surface_data.txt") as f:
            data = f.read()
        return {"var": os.environ.get("RTT_SURFACE_VAR"),
                "helper": surface_helper.VALUE, "pkg": surface_pkg.VALUE,
                "data": data, "cwd": os.getcwd(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def score(self, tokens, targets):
        out = super().score(tokens, targets)
        self.scores.inc()
        self.count += 1
        return out

    def cuda_loss_of(self, seed: int):
        tok, tgt = surface_tokens(seed)
        from ray_tpu_torch.models import gpt2

        with torch.inference_mode():
            return gpt2.gpt2_loss(self.params, tok.cuda(), tgt.cuda(),
                                  gpt2.GPT2Config.small()).clone()

    def loss_of(self, seed: int) -> float:
        return float(self.cuda_loss_of(seed))

    def flush_metrics(self) -> int:
        from ray_tpu_torch.util import metrics

        metrics.flush()
        return self.count


def surface_kernels(trace_dir: str) -> dict:
    """Each port kernel's GPU kernel events in a profile: count and
    summed device time (ms), by CUPTI's kernel names."""
    from ray_tpu_torch.util import profiling

    files = profiling.trace_files(trace_dir)
    check(len(files) == 1, f"runtime_surface: profile files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("cat") == "kernel"]
    check(gpu, "runtime_surface: the profile holds no GPU kernel event "
          "(no CUPTI trace)")
    busy = sum(e.get("dur", 0.0) for e in gpu) / 1e3
    span = (max(e["ts"] + e.get("dur", 0.0) for e in gpu)
            - min(e["ts"] for e in gpu)) / 1e3
    by_name: dict = {}
    for e in gpu:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0)
    out = {"gpu_kernel_events": len(gpu), "gpu_busy_ms": busy,
           "kernel_span_ms": span, "busy_share": busy / span,
           "top_kernels_ms": {n[:80]: d / 1e3 for n, d in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:6]}}
    for name, symbol in SURFACE_KERNELS.items():
        mine = [e for e in gpu if symbol in e.get("name", "")]
        out[name] = {"count": len(mine),
                     "device_ms": sum(e.get("dur", 0.0) for e in mine) / 1e3}
    return out


def phase_runtime_surface(gpt2) -> None:
    """See surface_body; then the control-plane microbenchmark on this
    machine's CPUs."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import perf
    from ray_tpu_torch.util import tracing

    torch.cuda.empty_cache()
    stage = tempfile.mkdtemp(prefix="surface-")
    info = rt.init(num_cpus=4)
    try:
        tracing.enable()
        line = surface_body(rt, gpt2, stage)
    finally:
        tracing._enabled = False
        os.environ.pop(tracing.ENV_TRACING, None)
        end_session(rt, info["session_dir"], "runtime_surface")
        import shutil

        shutil.rmtree(stage, ignore_errors=True)
    emit(line)
    t0 = time.perf_counter()
    sink = perf.run(scale=SURFACE_PERF_SCALE)
    rates = {r["name"]: {k: v for k, v in r.items()
                         if k.endswith(("_per_s", "p50_ms"))}
             for r in sink}
    check(all(v > 0 for r in rates.values() for v in r.values()),
          f"runtime_surface: microbenchmark rates {rates}")
    emit({"phase": "runtime_surface_perf", "card": card_line(),
          "host_cpus": os.cpu_count(), "scale": SURFACE_PERF_SCALE,
          "seconds": time.perf_counter() - t0, "rates": rates,
          "note": "host numbers of the machine that holds the card"})


def surface_body(rt, gpt2, stage: str) -> dict:
    """A named GPU actor in a runtime_env (env_vars, working_dir,
    py_modules) scores GPT-2 small on the kernels, bit-equal to this
    driver; a driver span parents its span; profile_actor takes its
    CUPTI trace while it scores in a loop; its metric and calls show in
    the state API; a ray:// client in a subprocess finds it by name,
    gets the same loss and is refused a CUDA tensor."""
    from ray_tpu_torch.client import ClientProxy
    from ray_tpu_torch.util import profiling, state, tracing

    wd, mods = os.path.join(stage, "wd"), os.path.join(stage, "mods")
    os.makedirs(os.path.join(mods, "surface_pkg"))
    os.makedirs(wd)
    with open(os.path.join(wd, "surface_helper.py"), "w") as f:
        f.write("VALUE = 'working-dir'\n")
    with open(os.path.join(wd, "surface_data.txt"), "w") as f:
        f.write("staged")
    with open(os.path.join(mods, "surface_pkg", "__init__.py"), "w") as f:
        f.write("VALUE = 'py-module'\n")
    env = {"env_vars": {"RTT_SURFACE_VAR": "on"}, "working_dir": wd,
           "py_modules": [mods]}
    Actor = rt.remote(num_gpus=1)(SurfaceActor)
    try:
        Actor.options(runtime_env={"env_vars": {
            "CUDA_VISIBLE_DEVICES": "0"}}).remote()
        refused_visible = False
    except ValueError as e:
        refused_visible = "CUDA_VISIBLE_DEVICES" in str(e)
    check(refused_visible, "runtime_surface: env_vars with "
          "CUDA_VISIBLE_DEVICES were not refused")
    t0, t0_boot = time.perf_counter(), boot_clock()
    a = Actor.options(name=SURFACE_NAME, runtime_env=env).remote()
    where = rt.get(a.ready.remote(), timeout=300.0)
    cold_s = time.perf_counter() - t0
    cold_split = cold_start_split(t0_boot, where, boot_clock())
    staged = rt.get(a.staged.remote(), timeout=60.0)
    check(staged["var"] == "on" and staged["helper"] == "working-dir"
          and staged["pkg"] == "py-module" and staged["data"] == "staged"
          and os.path.join("runtime_env", "") in staged["cwd"]
          and staged["visible"] == rt._visible_gpu_ids(1)[0],
          f"runtime_surface: the actor's runtime_env {staged}")

    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    check(rt.get(a.load.remote(rt.put(params)), timeout=300.0) == ["cuda"],
          "runtime_surface: the actor's weights are not all on cuda")
    tok, tgt = surface_tokens(SURFACE_SEED)
    tok_d, tgt_d = tok.cuda(), tgt.cuda()
    with torch.inference_mode():
        loss_d = gpt2.gpt2_loss(params, tok_d, tgt_d, cfg)
    del params
    with tracing.span("surface-driver") as root:
        loss_a, launches, plain = rt.get(a.score.remote(tok_d, tgt_d),
                                         timeout=300.0)
    hold_launches("runtime_surface: the actor's scoring", launches,
                  {**_NO_LAUNCHES, "flash_fwd": 2 * cfg.num_layers,
                   "ce_fwd": 1}, 1)
    check(plain == 0, f"runtime_surface: {plain} plain attention calls")
    check(loss_a.device.type == "cuda" and torch.equal(loss_a, loss_d),
          f"runtime_surface: actor loss {float(loss_a)} vs driver "
          f"{float(loss_d)}, not bit-equal")

    # spans: the actor's under the driver's submit span, under its root
    want = f"actor:{SurfaceActor.__name__}.score"
    chain: dict = {}

    def spans_in() -> bool:
        w = rt._private.worker.global_worker
        w._flush_task_events()
        spans = w.conductor.call("get_spans", timeout=30.0)
        chain["submit"] = [sp for sp in spans
                           if sp["parent_id"] == root.span_id]
        chain["actor"] = [sp for sp in spans if sp["name"] == want
                          and sp["trace_id"] == root.trace_id
                          and sp["parent_id"] in {
                              x["span_id"] for x in chain["submit"]}]
        return bool(chain["actor"])

    span_s = wait_for(spans_in, SURFACE_SPAN_BOUND_S,
                      f"the actor's span {want}")
    check(len(chain["submit"]) == 1 and len(chain["actor"]) == 1
          and chain["submit"][0]["name"] == f"submit:{a.actor_id[:8]}.score"
          and chain["actor"][0]["pid"] == where["pid"],
          f"runtime_surface: span chain {chain}")
    lane = [e for e in state.timeline(merged=True)
            if e.get("cat") == "span" and e["name"] == want
            and e["tid"] == root.trace_id[:8]]
    check(len(lane) == 1, f"runtime_surface: timeline span lane {lane}")

    # the device profile while the actor scores in a loop
    stop, scored = threading.Event(), []

    def loop():
        while not stop.is_set():
            rt.get(a.score.remote(tok_d, tgt_d), timeout=300.0)
            scored.append(time.perf_counter())

    looper = threading.Thread(target=loop, daemon=True)
    looper.start()
    try:
        wait_for(lambda: len(scored) >= 3, 60.0, "the scoring loop")
        t_start = time.perf_counter()
        trace_dir = profiling.profile_actor(a, seconds=SURFACE_PROFILE_S,
                                            tag="surface")
        t_end = time.perf_counter()
    finally:
        stop.set()
        looper.join(timeout=300.0)
    check(not looper.is_alive(), "runtime_surface: the scoring loop hangs")
    window = surface_kernels(trace_dir)
    for name in SURFACE_KERNELS:
        check(window[name]["count"] > 0,
              f"runtime_surface: no {name} kernel in the actor's CUPTI "
              f"trace {window}")
    # one ce_fwd a score: the scores the trace holds
    window["scores_in_trace"] = window["ce_fwd"]["count"]
    emit({"phase": "runtime_surface_profile", "card": card_line(),
          "seconds": SURFACE_PROFILE_S, "profile_call_s": t_end - t_start,
          "kernels": window,
          "predicted": {k: v for k, v in SURFACE_PREDICTED.items()
                        if k.startswith("profile_")}})

    # the device memory snapshot, in this process (a pickle, where the
    # JAX package writes pprof)
    import pickle

    profiling.record_memory_history()
    try:
        held = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        snap_path = profiling.save_device_memory_profile(
            os.path.join(stage, "memory.pickle"))
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    with open(snap_path, "rb") as f:
        snap = pickle.load(f)
    snap_bytes = sum(s.get("total_size", 0) for s in snap["segments"])
    check(snap_bytes >= held.numel() and any(
        b.get("frames") for s in snap["segments"] for b in s["blocks"]),
        "runtime_surface: the memory snapshot holds no recorded block")
    del held

    # the actor's metric and its calls in the state API
    count = rt.get(a.flush_metrics.remote(), timeout=60.0)
    series = f"surface_scores_total{{WorkerId="
    wait_for(lambda: any(
        ln.startswith(series) and ln.endswith(f" {float(count)}")
        for ln in state.prometheus_metrics().splitlines()), 15.0,
        f"the actor's counter at {count}")
    actors = [r for r in state.list_actors() if r.get("name") == SURFACE_NAME]
    calls = f"{a.actor_id[:8]}.score"
    summary = state.summarize_tasks()
    tasks = state.list_tasks(name=calls)
    rpc = state.rpc_stats()
    check(len(actors) == 1 and actors[0].get("state") == "ALIVE"
          and summary.get(calls, {}).get("count", 0) >= count
          and len(tasks) >= count
          and {"create_actor", "report_spans", "report_metrics"} <= set(rpc),
          f"runtime_surface: state {actors} {summary.get(calls)} "
          f"{len(tasks)} tasks, rpc {sorted(rpc)}")

    # a ray:// client in a subprocess, through a proxy here
    proxy = ClientProxy(host="127.0.0.1", port=0)
    try:
        host, port = proxy.address
        cenv = dict(os.environ)
        here = os.path.dirname(os.path.abspath(__file__))
        cenv["PYTHONPATH"] = os.pathsep.join(
            [here] + ([cenv["PYTHONPATH"]] if cenv.get("PYTHONPATH")
                      else []))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", SURFACE_CLIENT, f"{host}:{port}",
             SURFACE_NAME, str(SURFACE_SEED), str(SURFACE_CLIENT_CALLS)],
            capture_output=True, text=True, timeout=600, env=cenv)
        client_s = time.perf_counter() - t0
    finally:
        proxy.stop()
    check(out.returncode == 0, f"runtime_surface: the client exited "
          f"{out.returncode}: {out.stdout[-2000:]} {out.stderr[-4000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    check(got["client"] is True
          and all(x == float(loss_d) for x in got["losses"]),
          f"runtime_surface: client losses {got['losses']} vs the "
          f"driver's {float(loss_d)}")
    check(got["ref"] in got["refused"] and "no GPU lease" in got["refused"],
          f"runtime_surface: the client's CUDA get said {got['refused']!r}")
    return {
        "phase": "runtime_surface", "card": card_line(),
        "model": "gpt2-small", "dtype": "bfloat16", "tokens": [4, 512],
        "runtime_env": sorted(env), "cuda_visible_devices_refused": True,
        "cold_start_s": cold_s, "cold_start_split": cold_split,
        "actor_launches": launches, "loss_actor": float(loss_a),
        "loss_driver": float(loss_d), "loss_bit_equal": True,
        "span_wait_s": span_s, "memory_snapshot_segment_bytes": snap_bytes,
        "span_chain": ["surface-driver", chain["submit"][0]["name"], want],
        "metric_scores": count, "summarize_count": summary[calls]["count"],
        "client_connect_s": got["connect_s"],
        "client_call_ms_median": statistics.median(got["ms"]),
        "client_call_ms_range": [min(got["ms"]), max(got["ms"])],
        "client_process_s": client_s, "client_loss_bit_equal": True,
        "client_cuda_get": "GpuLeaseRequiredError",
        "predicted": SURFACE_PREDICTED}


def check_no_kernel(kernels, path: str) -> dict:
    """Fails if `path` launched a kernel or an attention call took the
    plain route since reset_counts(): the cached prefill and decode attend
    in plain PyTorch, as the JAX package's do with einsums."""
    launches = dict(kernels.LAUNCHES)
    check(not any(launches.values()), f"{path} launched {launches}")
    check_no_plain_route(path)
    return launches


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
    from ray_tpu_torch.models import gpt2, kvcache, llama
    from ray_tpu_torch.models import moe_transformer as moe
    from ray_tpu_torch.ops import attention, fused_ce
    from ray_tpu_torch.ops import moe as moe_ops
    from ray_tpu_torch.serve import lora as lora_mod

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
        phase_kv_ops(kvcache)
        rows = [phase_flash(kernels, attention, gen),
                phase_ce(kernels, fused_ce, gen)]
        # the GPT-2 scoring and serving path: every count from 0, read
        # after both entry points
        reset_counts(kernels)
        params, cpu_params, cfg, tok_d, tgt_d = phase_score(kernels, gpt2,
                                                            tree)
        scfg = gpt2.GPT2Config(dtype=torch.float32)
        sparams = gpt2.gpt2_init(scfg, torch.Generator().manual_seed(2),
                                 device="cuda")
        distinct = phase_serve_fp32("gpt2-small", scfg, sparams, engine_mod,
                                    generate_mod)
        phase_serve_bf16("gpt2-small", gpt2.gpt2_forward, engine_mod,
                         generate_mod, params, cpu_params, cfg)
        launches = dict(kernels.LAUNCHES)
        for name in ("flash_fwd", "ce_fwd"):
            check(launches[name] > 0,
                  f"{name} never launched on the scoring path")
        check_no_plain_route("the GPT-2 scoring and serving path")
        phase_score_timing("gpt2-small", gpt2.gpt2_forward, gpt2.gpt2_loss,
                           params, cfg, tok_d, tgt_d)
        # the GPT-2 paged serving path, counted from 0: plain PyTorch on
        # the card, as the JAX package's cached path has no kernel
        reset_counts(kernels)
        paged = phase_serve_paged("gpt2-small", scfg, sparams, engine_mod,
                                  generate_mod, kvcache, tree, distinct)
        phase_serve_paged_int8(cfg, params, engine_mod, generate_mod,
                               kvcache)
        check_no_kernel(kernels, "the GPT-2 paged serving path")
        # speculation, LoRA and adoption, counted from 0: no kernel
        reset_counts(kernels)
        phase_serve_spec("gpt2-small", scfg, sparams, engine_mod,
                         generate_mod, paged)
        phase_serve_lora("gpt2-small", scfg, sparams, engine_mod, lora_mod,
                         generate_mod, distinct)
        phase_serve_adopt(scfg, sparams, engine_mod, kvcache, paged)
        check_no_kernel(kernels, "the GPT-2 speculation, LoRA and adoption "
                        "paths")
        del params, cpu_params, sparams
        # the Llama scoring and serving path, counted from 0 the same way
        reset_counts(kernels)
        params, cpu_params, cfg, tok_d, tgt_d = phase_llama_score(
            kernels, llama, tree)
        lcfg = llama.LlamaConfig(dtype=torch.float32)
        lparams = llama.llama_init(lcfg, torch.Generator().manual_seed(12),
                                   device="cuda")
        distinct = phase_serve_fp32("llama-small", lcfg, lparams,
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
        reset_counts(kernels)
        paged = phase_serve_paged("llama-small", lcfg, lparams, engine_mod,
                                  generate_mod, kvcache, tree, distinct)
        check_no_kernel(kernels, "the Llama paged serving path")
        reset_counts(kernels)
        phase_serve_spec("llama-small", lcfg, lparams, engine_mod,
                         generate_mod, paged)
        phase_serve_lora("llama-small", lcfg, lparams, engine_mod, lora_mod,
                         generate_mod, distinct)
        check_no_kernel(kernels, "the Llama speculation and LoRA paths")
        del lparams
    # training needs autograd, so it runs outside inference mode and on
    # parameters of its own
    rows += phase_flash_bwd(kernels, attention, gen)
    phase_dq_seeds(kernels, attention)
    rows += phase_ce_bwd(kernels, fused_ce, gen)
    fused_row = phase_flash_bwd_fused(kernels, attention, gen)
    phase_train_check(gpt2, tree)
    phase_llama_train_check(kernels, llama, tree)
    phase_moe_train_check(kernels, moe, moe_ops, tree)
    phase_plain_route(kernels, attention, gpt2, llama, tree)
    # the training paths, each counted from 0: GPT-2's reaches seven of
    # the kernels, Llama's the single-pass backward
    launches, gpt2_line = phase_train(kernels, gpt2)
    for row in rows:
        row["launches"] = launches[row["name"]]
    launches, llama_line = phase_llama_train(kernels, llama)
    fused_row["launches"] = launches["flash_bwd_fused"]
    rows.insert(4, fused_row)
    # the MoE step: the two-pass attention kernels at head_dim 128
    _, moe_line = phase_moe_train(kernels, moe, moe_ops)
    # the mesh form of the same steps, counted from 0 the same way
    phase_mesh_train(kernels, gpt2, llama, moe,
                     {"gpt2-small": gpt2_line, "llama-small": llama_line,
                      "mixtral-8x7b-2l": moe_line})
    # ring and Ulysses attention, all_to_all, counted from 0
    phase_seq_parallel(kernels, attention)
    # checkpoints and the trainer's fit loop, each leg counted from 0
    phase_trainer_resume(kernels, gpt2, llama)
    # the actor runtime: GPU actors score (the kernels counted in the
    # actor's process from 0) and serve
    phase_runtime(gpt2, generate_mod)
    # the runtime beyond one node: a GPU actor on an agent's node, in a
    # placement group, scores (its kernels counted in its process from 0)
    phase_cluster(gpt2)
    # the live weight fabric: the driver trains and publishes, a GPU
    # actor's engine hot-swaps (the driver's step counted from 0 each
    # step, the actor's scoring in its process)
    phase_fabric(kernels, gpt2, generate_mod)
    # disaggregated serving across actors and the KV plane: prefill here,
    # decode in a GPU actor, a failover healed through the autoscaler,
    # the SLO policy, the tiers under pressure (no kernel launches in this
    # process)
    phase_disagg(kernels, gpt2, generate_mod)
    # the online learning loop: the learner here on the flash kernels (its
    # launches counted from 0), a GPU sampler actor, then per-tenant LoRA
    phase_online(kernels, gpt2, generate_mod)
    # MPMD pipelines: Llama small's stage 1 in a GPU actor on the flash
    # kernels (its launches counted in its process from 0), stage 0 on a
    # CPU actor; a stage killed mid-run; the lease back to a new pipeline
    phase_pipeline()
    # the trainer's worker gang on the machine's CPUs, with a chaos kill
    phase_train_gang()
    # the runtime's user surface: a GPU actor in a runtime_env scoring on
    # the kernels (its launches counted in its process from 0), spans, its
    # CUPTI profile, metrics, the state API, a ray:// client, the
    # control-plane microbenchmark
    phase_runtime_surface(gpt2)
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
