"""The gates `chip_smoke.py` holds the flash kernels by, checked on the
CPU. Backward (`hold_grads`): gradients rounded as the kernels round them
(bf16 P and dS operands, bf16 outputs) pass, and a kernel that is wrong in
most rows, drops one kv tile, adds one 128-key tile's dQ partial twice or
leaves half of a 128-key tile's dK or dV unwritten fails, at a causal
length where most gradient values are far below the largest. Forward
(`hold_forward`): O rounded as the kernel rounds it (bf16 P operand, bf16
output) passes at causal T 2048, and O 5 % high in the later half of the
rows or of the columns, one 64-row q tile unwritten, one kv tile's P V
missing, or an LSE without one kv tile fails."""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops import attention


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
