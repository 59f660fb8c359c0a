"""The gates `chip_smoke.py` holds the flash kernels by, checked on the
CPU. Backward (`hold_grads`): gradients rounded as the kernels round them
(bf16 P and dS operands, bf16 outputs) pass, and a kernel that is wrong in
most rows, drops one kv tile, adds one 128-key tile's dQ partial twice or
leaves half of a 128-key tile's dK or dV unwritten fails, at a causal
length where most gradient values are far below the largest. Forward
(`hold_forward`): O rounded as the kernel rounds it (bf16 P operand, bf16
output) passes at causal T 2048, and O 5 % high in the later half of the
rows or of the columns, one 64-row q tile unwritten, one kv tile's P V
missing, or an LSE without one kv tile fails. The CE forward
(`hold_ce_forward`, CE_FWD_TOL): the logits summed in 64-deep k-chunks as
the kernel sums them pass at GPT-2's vocabulary, and a sum-exp without
the ragged last vocab tile or without one 64-column slice, or a tile
without one d chunk, fails; the bound it replaced passed the first two.
And the parse of nvcc's output that puts ptxas's warnings in the build
line."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops import attention, fused_ce


def _grads(t: int = 1024, h: int = 2, d: int = 64, parts: bool = False):
    """(reference fp32 dQ, dK, dV, and the kernels' rounding of them) for
    causal attention from a seed, layout [B, H, T, D]; with `parts` also
    the rounded dS, K and the scale that make dQ."""
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(1, h, t, d, generator=gen).to(bf).float()
                   for _ in range(4))
    scale = d ** -0.5
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(
        ~torch.ones(t, t, dtype=torch.bool).tril(), -float("inf"))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = (p @ v).to(bf).float()
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    ref = (ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
           p.transpose(-1, -2) @ do)
    pb, dsb = p.to(bf).float(), ds.to(bf).float()
    kern = ((dsb @ k * scale).to(bf), (dsb.transpose(-1, -2) @ q * scale
                                       ).to(bf),
            (pb.transpose(-1, -2) @ do).to(bf))
    if parts:
        return ref, kern, (dsb, k, scale)
    return ref, kern


def test_grad_gates_pass_kernel_rounding():
    ref, kern = _grads()
    held = chip_smoke.hold_grads("emulated kernels", kern, ref)
    for n in ("dq", "dk", "dv"):
        # most values are far below the largest: a bare atol near the
        # typical value would not see a wrong row
        assert held[f"{n}_ref_median_abs"] < 0.05 * held[f"{n}_ref_max_abs"]
        assert held[f"{n}_rel_norm_err"] < chip_smoke.GRAD_NORM_TOL / 2


_FAULTS = [("scale", "dq"), ("dropped_tile", "dq"), ("dq_partial_twice", "dq"),
           ("dkv_half_tile_dk", "dk"), ("dkv_half_tile_dv", "dv"),
           ("dkv_half_tile_both", "dk")]


@pytest.mark.parametrize("fault, grad", _FAULTS, ids=[f for f, _ in _FAULTS])
def test_grad_gates_refuse_a_wrong_kernel(fault, grad):
    ref, kern, (ds, k, scale) = _grads(parts=True)
    dq, dk, dv = (g.clone() for g in kern)
    if fault == "scale":     # 5 % off everywhere
        dq = dq * 1.05
    elif fault == "dropped_tile":  # one 64-query tile's dQ never written
        dq[:, :, 900:964] = 0
    elif fault == "dq_partial_twice":
        # the dQ partial of the 128-key tile at keys 512-639 added a second
        # time, as two warpgroups that each add the whole partial would
        tile = slice(512, 640)
        dq = (dq.float() + ds[..., tile] @ k[:, :, tile] * scale).to(dq.dtype)
    else:                    # keys 576-639, the second warpgroup's 64 keys
        # of the 128-key tile at 512, left unwritten (zero here)
        if fault in ("dkv_half_tile_dk", "dkv_half_tile_both"):
            dk[:, :, 576:640] = 0
        if fault in ("dkv_half_tile_dv", "dkv_half_tile_both"):
            dv[:, :, 576:640] = 0
    with pytest.raises(AssertionError, match=grad):
        chip_smoke.hold_grads(fault, (dq, dk, dv), ref)


def test_plain_backward_matches_the_emulation_reference():
    """`_grads`' reference is the port's plain backward's function."""
    ref, _ = _grads(t=256)
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(1, 2, 256, 64, generator=gen).to(bf).float()
                   .transpose(1, 2) for _ in range(4))
    o, lse = attention._flash_fwd(q, k, v, True, 64 ** -0.5)
    o = o.to(bf).float()
    got = attention._flash_bwd_reference(q, k, v, o, lse, do, True,
                                         64 ** -0.5)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.transpose(1, 2), r, atol=1e-5,
                                   rtol=1e-4)


def _forward(t: int = 2048, h: int = 2, d: int = 64):
    """(reference fp32 O [1, H, T, D] and LSE [H, T], the kernel's rounding
    of O, and the fp32 P and V) for causal attention from a seed."""
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q, k, v = (torch.randn(1, h, t, d, generator=gen).to(bf).float()
               for _ in range(3))
    s = (q @ k.transpose(-1, -2) * d ** -0.5).masked_fill(
        ~torch.ones(t, t, dtype=torch.bool).tril(), -float("inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    kern = (p.to(bf).float() @ v).to(bf)
    return p @ v, lse[0], kern, (s, p, v)


def test_forward_gate_passes_kernel_rounding():
    ref_o, ref_lse, kern, _ = _forward()
    held = chip_smoke.hold_forward("emulated kernel", kern, ref_lse, ref_o,
                                   ref_lse)
    # most values are far below the largest: an atol near the typical
    # value would not see a wrong row
    assert held["ref_median_abs"] < 0.05 * held["ref_max_abs"]
    assert held["rel_norm_err"] < chip_smoke.GRAD_NORM_TOL / 2


_FWD_FAULTS = [("late_rows_5pct", "o"), ("late_cols_5pct", "o"),
               ("unwritten_q_tile", "o"), ("missing_kv_tile", "o"),
               ("lse_missing_kv_tile", "lse")]


@pytest.mark.parametrize("fault, out", _FWD_FAULTS,
                         ids=[f for f, _ in _FWD_FAULTS])
def test_forward_gate_refuses_a_wrong_kernel(fault, out):
    ref_o, ref_lse, kern, (s, p, v) = _forward()
    o, lse = kern.clone(), ref_lse.clone()
    tile = slice(512, 576)  # one 64-key kv tile
    if fault == "late_rows_5pct":    # queries in the second half of T
        o[:, :, o.shape[2] // 2:] *= 1.05
    elif fault == "late_cols_5pct":  # the second half of head_dim
        o[..., o.shape[3] // 2:] *= 1.05
    elif fault == "unwritten_q_tile":
        o[:, :, 900:964] = 0
    elif fault == "missing_kv_tile":  # its P V never added, LSE right
        p = p.clone()
        p[..., tile] = 0
        o = (p.to(torch.bfloat16).float() @ v).to(torch.bfloat16)
    else:                             # its keys left out of the LSE
        s = s.clone()
        s[..., tile] = -float("inf")
        lse = torch.logsumexp(s, -1)[0]
    with pytest.raises(AssertionError, match=f" {out}: "):
        chip_smoke.hold_forward(fault, o, lse, ref_o, ref_lse)


def test_forward_gate_old_allclose_misses_late_rows():
    """The fault the forward gate was tightened for: O 5 % high in the
    later half of the rows passes the bf16 allclose that held the forward
    before, and fails `hold_forward` by its relative norm alone."""
    ref_o, ref_lse, kern, _ = _forward()
    o = kern.float()
    o[:, :, o.shape[2] // 2:] *= 1.05
    assert torch.allclose(o, ref_o, atol=chip_smoke.BF16_TOL,
                          rtol=chip_smoke.BF16_TOL)
    assert torch.allclose(o, ref_o, rtol=chip_smoke.GRAD_TOL,
                          atol=chip_smoke.GRAD_ATOL_FRAC
                          * float(ref_o.abs().max()))
    assert chip_smoke.norm_err(o, ref_o) > chip_smoke.GRAD_NORM_TOL


# chip_smoke.py's bound for ce_fwd's loss and LSE before CE_FWD_TOL
_OLD_CE_TOL = 2e-3
_CE_FAULTS = ["ragged_tail", "column_slice", "d_chunk"]


def _ce_forward(fault: str = ""):
    """(the kernel's loss and LSE as emulated, the plain forward's) at
    GPT-2's vocabulary (V 50304, 50257 live, so the last 256-column tile
    holds 81 live columns) and d 128, x ~ N(0, 1) and w ~ 0.02 N(0, 1) in
    bf16 as phase_ce makes them. The emulation sums the logits in k-chunks
    of 64 in fp32, as the kernel's ring does. `fault`: the sum-exp without
    the ragged last tile, or without one 64-column slice of a tile; or one
    tile's logits without one d chunk (the tile holding row 0's target:
    a dropped d chunk shows only in the loss of rows whose target lies
    in that tile)."""
    rng = np.random.default_rng(0)
    n, d, v, vocab = 256, 128, 50304, 50257
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)
                         ).to(bf)
    w = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32)
                         * 0.02).to(bf)
    t = torch.from_numpy(rng.integers(0, vocab, size=n))
    logits = torch.zeros(n, v)
    for k in range(0, d, 64):
        chunk = x[:, k:k + 64].float() @ w[:, k:k + 64].float().T
        if fault == "d_chunk" and k == 64:
            tile = int(t[0]) // 256 * 256
            chunk[:, tile:tile + 256] = 0
        logits += chunk
    logits[:, vocab:] = -float("inf")
    tgt = logits.gather(1, t[:, None])[:, 0]
    if fault == "ragged_tail":
        logits[:, v // 256 * 256:] = -float("inf")
    elif fault == "column_slice":
        logits[:, 100 * 256 + 64:100 * 256 + 128] = -float("inf")
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - tgt, lse), fused_ce._ce_reference(x, w, t, vocab)


def test_ce_forward_gate_passes_kernel_summation():
    (loss, lse), (ref_loss, ref_lse) = _ce_forward()
    held = chip_smoke.hold_ce_forward("emulated kernel", loss, lse,
                                      ref_loss, ref_lse)
    assert max(held.values()) < chip_smoke.CE_FWD_TOL / 10


@pytest.mark.parametrize("fault", _CE_FAULTS)
def test_ce_forward_gate_refuses_a_wrong_kernel(fault):
    (loss, lse), ref = _ce_forward(fault)
    with pytest.raises(AssertionError, match="loss err"):
        chip_smoke.hold_ce_forward(fault, loss, lse, *ref)


@pytest.mark.parametrize("fault", _CE_FAULTS[:2])
def test_ce_forward_old_bound_passed_dropped_columns(fault):
    """The faults the CE forward's bound was tightened for: a sum-exp
    without the ragged last tile or one 64-column slice moves every
    row's LSE by less than the old bound of 2e-3."""
    (loss, lse), (ref_loss, ref_lse) = _ce_forward(fault)
    lse_err = chip_smoke.max_err(lse, ref_lse)
    assert chip_smoke.CE_FWD_TOL < lse_err <= _OLD_CE_TOL
    assert chip_smoke.max_err(loss, ref_loss) <= _OLD_CE_TOL


# nvcc -Xptxas -v output as an H100 build printed it for a flash_fwd
# variant whose wgmma sat in a branch that differed between warpgroups
_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__12db9c2d_12_\
flash_fwd_cu_48fe48b516flash_fwd_kernelILi64EEEvNS_7FwdMapsEP13__nv_bfloat16\
Pfiiiif' for 'sm_90a'
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to program dependence on compiler-inserted \
WG.AR in divergent path in the function '_ZN45_GLOBAL__N__12db9c2d_12_\
flash_fwd_cu_48fe48b516flash_fwd_kernelILi128EEEvNS_7FwdMapsEP13__nv_\
bfloat16Pfiiiif'
ptxas info    : Function properties for _ZN45_GLOBAL__N__12db9c2d_12_\
flash_fwd_cu_48fe48b516flash_fwd_kernelILi64EEEvNS_7FwdMapsEP13__nv_\
bfloat16Pfiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers
"""


def test_ptxas_warnings_are_parsed_per_kernel():
    """The serialization note is put under the kernel it names, not the
    entry compiled last; register and spill lines are no warnings, and
    stay in the register lines."""
    got = chip_smoke.ptxas_warnings(_PTXAS_LOG)
    assert list(got) == ["flash_fwd_kernel<128>"]
    assert len(got["flash_fwd_kernel<128>"]) == 1
    assert got["flash_fwd_kernel<128>"][0].startswith(
        "ptxas info    : (C7520) Potential Performance Loss: wgmma")
    assert chip_smoke.ptxas_warnings("ptxas info    : Used 106 registers"
                                     ", used 1 barriers") == {}
    lines = chip_smoke.ptxas_lines(_PTXAS_LOG)
    assert "flash_fwd_kernel<64>: ptxas info    : Used 106 registers, " \
        "used 1 barriers" in lines
