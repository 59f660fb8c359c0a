"""Where the time goes on the card: torch.profiler over the port's
scoring entry points, one serving decode tick (fp32 and bf16) and one
training step (`TrainStep` + `adamw`, bf16, tokens [8, 1024]) of GPT-2
small, and one training step of Llama small (tokens [4, 2048], the
single-pass attention backward).

    python -m ray_tpu_torch.profile_score

Prints one JSON line per window: host wall time per call, device busy
time per call (the sum of the kernels' own durations from CUPTI), the
device's idle share (1 - busy / wall), the kernels taking the most
device time with their launch counts, and the port's own kernels
(`csrc/`) with theirs. Needs one CUDA device.
"""
from __future__ import annotations

import json
import re
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .kernels import build
from .models import gpt2, llama
from .models.engine import _tick
from .train.optim import adamw
from .train.step import TrainStep


def _window(name: str, fn, calls: int = 3, top: int = 10) -> dict:
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    per_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            slot = per_kernel[ev.name]
            slot[0] += ev.time_range.elapsed_us() / 1e3 / calls
            slot[1] += 1
    if not per_kernel:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(ms for ms, _ in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    port = [(k, v) for k, v in ranked if _PORT_KERNEL.search(k)]
    ranked = ranked[:top]
    return {"window": name, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "launches_per_call": sum(n for _, n in per_kernel.values())
            / calls,
            "top": [{"kernel": k[:80], "ms": ms, "share": ms / busy,
                     "launches": n / calls} for k, (ms, n) in ranked],
            "port_kernels": [{"kernel": _port_name(k), "ms": ms,
                              "launches": n / calls}
                             for k, (ms, n) in port]}


# the port's kernels (csrc/*.cu), each at file scope in an anonymous
# namespace; PyTorch's own anonymous-namespace kernels sit under at:: or
# carry other names
_PORT_KERNEL = re.compile(
    r"(?:^|\s)\(anonymous namespace\)::(?:flash_|ce_|gemm_kernel<)")


def _port_name(kernel: str) -> str:
    """A port kernel's name and template arguments from its demangled
    signature: `flash_fwd_kernel<64>`, `gemm_kernel<Tile<...>, DxEpi>`."""
    name = kernel.split("(anonymous namespace)::", 1)[1].replace(
        "(anonymous namespace)::", "")
    cut = name.find(">(")
    return name[:cut + 1] if cut >= 0 else name.split("(", 1)[0]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_score needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    cfg = gpt2.GPT2Config.small()
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen).cuda()
    targets = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen).cuda()
    scfg = gpt2.GPT2Config(dtype=torch.float32)
    sparams = gpt2.gpt2_init(scfg, torch.Generator().manual_seed(2),
                             device="cuda")
    cache = gpt2.gpt2_init_kv_cache(scfg, 4, device="cuda")
    bf16_cache = gpt2.gpt2_init_kv_cache(cfg, 4, device="cuda")
    tok = torch.randint(0, scfg.vocab_size, (4,), generator=gen).cuda()
    pos = torch.tensor([8, 40, 77, 120], device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    with torch.inference_mode():
        for name, fn in [
                ("gpt2_forward bf16 [4, 512]",
                 lambda: gpt2.gpt2_forward(params, tokens, cfg)),
                ("gpt2_loss bf16 [4, 512]",
                 lambda: gpt2.gpt2_loss(params, tokens, targets, cfg)),
                ("engine decode tick fp32, 4 slots",
                 lambda: _tick(sparams, scfg, cache, tok, pos)),
                ("engine decode tick bf16, 4 slots",
                 lambda: _tick(params, cfg, bf16_cache, tok, pos))]:
            print(json.dumps(_window(name, fn)), flush=True)
    # training needs autograd: outside inference mode, on its own weights
    del params, sparams, cache, bf16_cache
    step = TrainStep(
        lambda p, b: gpt2.gpt2_loss(p, b["tokens"], b["targets"], cfg),
        adamw(3e-4, weight_decay=0.1))
    state = step.init_state(gpt2.gpt2_init(
        cfg, torch.Generator().manual_seed(6), device="cuda"))
    seq = torch.randint(0, cfg.vocab_size, (8, 1025), generator=gen)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    print(json.dumps(_window("train step bf16 [8, 1024]",
                             lambda: step(state, batch))), flush=True)
    del step, state
    lcfg = llama.LlamaConfig.small()
    step = TrainStep(
        lambda p, b: llama.llama_loss(p, b["tokens"], b["targets"], lcfg),
        adamw(3e-4, weight_decay=0.1))
    state = step.init_state(llama.llama_init(
        lcfg, torch.Generator().manual_seed(16), device="cuda"))
    seq = torch.randint(0, lcfg.vocab_size, (4, 2049), generator=gen)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    print(json.dumps(_window("llama train step bf16 [4, 2048], fused backward",
                             lambda: step(state, batch))), flush=True)


if __name__ == "__main__":
    main()
