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
line. The MoE and sequence-parallel gates: `hold_routing` refuses a
routing that drops a token it should keep, `hold_output` refuses a ring
that skips a block (the port's `ring_attention` over 4 emulated ranks),
`hold_launches` refuses a launch count off by one either way, and
`RoutingTape` makes a replayed pass take the recorded experts. The
serving control loop's and the online loop's gates: `hold_heal` refuses
a replacement or death count off by one, a breaker trip or a shed;
`hold_stream` refuses a stream one token off; the online learner's
launch gate refuses a flash count off by one and any CE launch."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops import attention, fused_ce
from ray_tpu_torch.ops import moe as moe_ops
from ray_tpu_torch.ops import ring_attention as ring_mod


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


def test_ptxas_gate_refuses_a_warning_of_any_kernel():
    """The build phase's gate covers every kernel, not only ce_fwd: a
    captured serialization note of flash_fwd, or a spill of the dK/dV
    loop, fails the build; register lines alone pass."""
    with pytest.raises(AssertionError, match=r"flash_fwd_kernel<128>: .*C7520"):
        chip_smoke.gate_ptxas({"flash_fwd": _PTXAS_LOG})
    spill = _PTXAS_LOG.replace("(C7520)", "(C0000)").replace(
        "Potential Performance Loss", "info").replace(
        "0 bytes spill stores", "16 bytes spill stores").replace(
        "flash_fwd_kernelILi64EE", "flash_bwd_kv_kernelILi64ELb1EE")
    clean = "\n".join(ln for ln in spill.splitlines()
                      if "C0000" not in ln and "WG.AR" not in ln)
    with pytest.raises(AssertionError, match=r"flash_bwd_kv_kernel<64, "
                       r"fused>: .*16 bytes spill"):
        chip_smoke.gate_ptxas({"flash_bwd": clean})
    ok = clean.replace("16 bytes spill", "0 bytes spill")
    ptxas, warnings = chip_smoke.gate_ptxas({"flash_bwd": ok})
    assert warnings == {} and len(ptxas) == 2


def test_dq_sweep_reference_and_emulation():
    """`dq_reference_and_emulation`, which the dq_seeds phase holds
    flash_bwd_dq against: its reference is the plain backward's dQ bit for
    bit, its emulation the kernel rounding `_grads` emulates, and its
    float64-summed emulation in the kernel's exp2 form lies far closer to
    the emulation than either to the reference. `hold_dq_rounding` passes
    either emulation and refuses a 5 % scale or a dropped tile; the
    allowance `allowance_used` reports exceeds 1 exactly where hold_grads'
    allclose fails."""
    ref, kern, _ = _grads(t=256, parts=True)
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(1, 2, 256, 64, generator=gen).to(bf)
                   .transpose(1, 2) for _ in range(4))
    scale = 64 ** -0.5
    o, lse = attention._flash_fwd(q, k, v, True, scale)
    o = o.to(bf)
    got_ref, emu, exact = chip_smoke.dq_reference_and_emulation(
        attention, q, k, v, o, lse, do, scale)
    plain = attention._flash_bwd_reference(q, k, v, o, lse, do, True, scale)
    assert torch.equal(got_ref, plain[0])
    torch.testing.assert_close(emu.transpose(1, 2).float(), kern[0].float(),
                               atol=2 ** -6, rtol=2 ** -7)
    floor = chip_smoke.norm_err(emu, exact)
    assert floor < chip_smoke.norm_err(emu, got_ref) / 10
    for dq in (emu, exact):
        chip_smoke.hold_dq_rounding("emulation", dq, emu, exact)
    faults = {"scale": exact.float() * 1.05, "tile": exact.clone()}
    faults["tile"][:, 128:192] = 0
    for name, dq in faults.items():
        with pytest.raises(AssertionError, match="emulation of its round"):
            chip_smoke.hold_dq_rounding(name, dq, emu, exact)
    assert chip_smoke.allowance_used(emu, got_ref) < 1
    chip_smoke.hold_grads("emulated dq", (emu, plain[1], plain[2]), plain)
    wrong = emu.float() * 1.05
    assert chip_smoke.allowance_used(wrong, got_ref) > 1
    with pytest.raises(AssertionError, match="dq"):
        chip_smoke.hold_grads("5 % dq", (wrong, plain[1], plain[2]), plain)


# --------------------------------------------- MoE and sequence parallel

def _routing(capacity_cut: int = 0):
    """The routing of fixed random logits [256, 8] leaning to expert 0,
    top 2, at capacity factor 1.25, with the capacity cut by
    `capacity_cut` slots (the tokens in the cut slots dropped though they
    fit)."""
    logits = torch.randn(256, 8, generator=torch.Generator().manual_seed(1))
    logits[:, 0] += 1.0
    cap = moe_ops.capacity_of(256, 2, 1.25, 8)
    d, c = moe_ops._top_k_routing(logits, 2, 8, cap - capacity_cut)
    return torch.nn.functional.pad(d, (0, capacity_cut)), \
        torch.nn.functional.pad(c, (0, capacity_cut))


def test_routing_gate_refuses_a_dropped_token():
    ref = _routing()
    held = chip_smoke.hold_routing("same routing", _routing(), ref)
    assert held["dispatch_entries_differing"] == 0
    assert held["kept_choices_per_token"] < 2  # the capacity binds
    one = (ref[0].clone(), ref[1].clone())
    t, e, c = ref[0].nonzero()[0].tolist()
    one[0][t, e, c] = 0
    one[1][t, e, c] = 0
    for fault in (_routing(capacity_cut=1), one):
        with pytest.raises(AssertionError, match="dispatch entries differ"):
            chip_smoke.hold_routing("drops a token", fault, ref)


def _ring(monkeypatch, skip: bool = False, sp: int = 4):
    """ring_attention on each of `sp` emulated ranks of a causal bf16
    sequence [1, 1024, 2, 64] split on T, with a ppermute that hands each
    rank the block of the rank before it (with `skip`, the one before
    that: a ring that skips a block); the joined output and the fp32
    mha_reference of the whole sequence."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 1024, 2, 64, generator=gen).bfloat16()
               for _ in range(3))
    qs, ks, vs = (x.chunk(sp, dim=1) for x in (q, k, v))
    rank = {"r": 0}

    def ppermute(x, axis_name, perm):
        blocks = ks if any(x is b for b in ks) else vs
        j = next(i for i, b in enumerate(blocks) if b is x)
        return blocks[(j - 1 - int(skip)) % sp]

    monkeypatch.setattr(ring_mod, "axis_size", lambda name: sp)
    monkeypatch.setattr(ring_mod, "axis_index", lambda name: rank["r"])
    monkeypatch.setattr(ring_mod, "ppermute", ppermute)
    outs = []
    for r in range(sp):
        rank["r"] = r
        outs.append(ring_mod.ring_attention(qs[r], ks[r], vs[r], "sp"))
    ref = attention.mha_reference(q.float(), k.float(), v.float(), True)
    return torch.cat(outs, dim=1), ref


def test_ring_gate_refuses_a_skipped_block(monkeypatch):
    out, ref = _ring(monkeypatch)
    held = chip_smoke.hold_output("emulated ring", out, ref)
    assert held["rel_norm_err"] < chip_smoke.GRAD_NORM_TOL / 2
    bad, ref = _ring(monkeypatch, skip=True)
    with pytest.raises(AssertionError, match="relative norm error"):
        chip_smoke.hold_output("ring skipping a block", bad, ref)


def test_launch_gate_refuses_a_count_off_by_one():
    per_step = chip_smoke.MOE_LAUNCHES_PER_STEP
    steps = chip_smoke.TRAIN_STEPS + 1
    exact = {k: n * steps for k, n in per_step.items()}
    chip_smoke.hold_launches("moe_train", exact, per_step, steps)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ce_fwd"):
        for off in (-1, 1):
            if exact[name] + off < 0:
                continue
            with pytest.raises(AssertionError, match="launches"):
                chip_smoke.hold_launches(
                    "moe_train", {**exact, name: exact[name] + off},
                    per_step, steps)


def test_routing_tape_replays_the_recorded_experts():
    """A pass under replay() routes as the recorded pass did, also where
    its own probabilities would choose another expert, and takes its own
    probabilities' values there (so the gate gets their gradient)."""
    tape = chip_smoke.RoutingTape(moe_ops)
    a = torch.tensor([[0.5, 0.3, 0.2], [0.1, 0.2, 0.7]])
    b = torch.tensor([[0.3, 0.5, 0.2], [0.1, 0.2, 0.7]])
    with tape.record():
        moe_ops.top_k_stable(a, 1)
    with tape.replay():
        vals, idx = moe_ops.top_k_stable(b, 1)
    assert idx.tolist() == [[0], [2]]
    assert torch.equal(vals, b.gather(-1, idx))
    assert moe_ops.top_k_stable(b, 1)[1].tolist() == [[1], [2]]


def _healed(**over):
    st = {"deaths": {"prefill": 0, "decode": 1},
          "replacements": {"prefill": 0, "decode": 1},
          "replacements_blocked": 0, "breaker_trips": 0}
    st.update(over)
    return st


@pytest.mark.parametrize("fault", [
    {"replacements": {"prefill": 0, "decode": 0}},
    {"replacements": {"prefill": 0, "decode": 2}},
    {"deaths": {"prefill": 0, "decode": 2}},
    {"breaker_trips": 1}, {"replacements_blocked": 1}, "shed"])
def test_heal_gate_refuses_a_count_off_by_one(fault):
    """`hold_heal` (the disagg phase's self-healer): one decode death
    replaced once passes; a replacement or death count off by one, a
    breaker trip, a blocked replacement or a shed request fails."""
    chip_smoke.hold_heal("disagg B", _healed(), {"shed": 0})
    healer, router = _healed(), {"shed": 0}
    if fault == "shed":
        router["shed"] = 1
    else:
        healer = _healed(**fault)
    with pytest.raises(AssertionError, match="healer"):
        chip_smoke.hold_heal("disagg B", healer, router)


@pytest.mark.parametrize("at", [0, 17, 63])
def test_stream_gate_refuses_one_token_off(at):
    """`hold_stream`: equal streams pass; one token changed, or one token
    short, fails and names the first differing index."""
    want = list(range(100, 164))
    chip_smoke.hold_stream("online", list(want), want)
    bad = list(want)
    bad[at] += 1
    with pytest.raises(AssertionError, match=f"at token {at} "):
        chip_smoke.hold_stream("online", bad, want)
    with pytest.raises(AssertionError, match="at token 63 "):
        chip_smoke.hold_stream("online", want[:-1], want)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv", "ce_fwd", "ce_probs",
                                  "ce_dx", "ce_dw"])
def test_online_launch_gate_refuses_off_by_one_and_ce(name):
    """The online learner's and the LoRA trainer's launch gate: exactly 12
    of each flash kernel a step pass; one flash launch more or fewer, or
    any CE kernel launch on the learner, fails."""
    per_step = chip_smoke.ONLINE_LAUNCHES_PER_STEP
    steps = chip_smoke.ONLINE_CONFIG["num_steps"]
    exact = {k: n * steps for k, n in per_step.items()}
    assert exact["flash_fwd"] == exact["flash_bwd_dq"] \
        == exact["flash_bwd_dkv"] == 12 * steps
    assert not any(exact[k] for k in ("ce_fwd", "ce_probs", "ce_dx",
                                      "ce_dw"))
    chip_smoke.hold_launches("online", exact, per_step, steps)
    for off in (-1, 1):
        if exact[name] + off < 0:
            continue
        with pytest.raises(AssertionError, match="launches"):
            chip_smoke.hold_launches("online", {**exact,
                                                name: exact[name] + off},
                                     per_step, steps)
