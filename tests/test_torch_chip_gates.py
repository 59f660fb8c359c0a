"""The gates `chip_smoke.py` holds the flash backward kernels by, checked
on the CPU: gradients rounded as the kernels round them (bf16 P and dS
operands, bf16 outputs) pass, and a kernel that is wrong in most rows,
drops one kv tile, adds one 128-key tile's dQ partial twice or leaves half
of a 128-key tile's dK or dV unwritten fails, at a causal length where
most gradient values are far below the largest."""
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
