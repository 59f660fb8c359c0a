"""The MPMD pipeline's, the collective actors' and the flight recorder's
checks that need a cluster, run by `isolated.run_checks` in a driver
process of their own, as `fabric_checks.py`'s are
(tests/test_torch_mpmd.py, tests/test_torch_collective.py and
tests/test_torch_flight_recorder.py make each one a test case).

Each is a twin of a case of the JAX package's tests/test_mpmd.py,
tests/test_collective.py or tests/test_observability.py, named after
it. The stage functions, data functions and actor classes live here
because a worker imports what a check pickles by reference, and the
test modules import JAX. A check that returns a value has it as JSON in
its outcome (arrays as base64 `.npz`, see `pack`); the tests hold those
values against the JAX package's.

This module imports no torch at the top: the fork template must not.
"""
from __future__ import annotations

import base64
import functools
import io
import threading
import time

import numpy as np

import ray_tpu_torch as rt

from .cluster_checks import _conductor, _wait_until

# ------------------------------------------------ the JAX test's MLP twin
# tests/test_mpmd.py: two stages, sgd(LR), M microbatches, STEPS steps

D = 8
LR = 0.05
M = 4
STEPS = 4


def mlp_stage0(params, x):
    import torch

    return torch.tanh(x @ params["w"] + params["b"])


def mlp_stage1(params, h):
    return h @ params["w"] + params["b"]


def mse_loss(y, t):
    import torch

    return torch.mean((y - t) ** 2)


def mlp_params():
    """tests/test_mpmd.py `_params()` as numpy arrays (same generator,
    same float32 casts)."""
    rng = np.random.default_rng(0)
    p0 = {"w": (rng.standard_normal((D, D)) * 0.1).astype(np.float32),
          "b": np.zeros((D,), np.float32)}
    p1 = {"w": (rng.standard_normal((D, 1)) * 0.1).astype(np.float32),
          "b": np.zeros((1,), np.float32)}
    return p0, p1


def mlp_data(step):
    """tests/test_mpmd.py `_data(step)`."""
    r = np.random.default_rng(100 + step)
    x = r.standard_normal((8, D)).astype(np.float32)
    t = np.sum(x, axis=1, keepdims=True).astype(np.float32)
    return x, t


def slow_mlp_data(step):
    time.sleep(0.05)
    return mlp_data(step)


def pack(tree) -> dict:
    """A tree's leaves (JAX's leaf order) as a JSON-safe base64 `.npz`,
    with the dtype names (bf16 leaves travel as float32 values)."""
    import torch

    from ..tree import tree_flatten

    leaves, _ = tree_flatten(tree)
    arrs = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().cpu().numpy()
        arrs.append(np.asarray(leaf))
    buf = io.BytesIO()
    np.savez(buf, *arrs)
    return {"npz": base64.b64encode(buf.getvalue()).decode()}


def unpack(packed: dict) -> list:
    """The leaves `pack` wrote, in order."""
    data = np.load(io.BytesIO(base64.b64decode(packed["npz"])))
    return [data[f"arr_{i}"] for i in range(len(data.files))]


def _markers(pred, want: int, timeout: float = 15.0) -> list:
    """The merged timeline's events matching `pred`, once there are at
    least `want` (step records and stage reports are pushed, so they
    land a moment after the run returns)."""
    from ..observability.timeline import merged_timeline

    found: list = []

    def enough():
        found[:] = [e for e in merged_timeline() if pred(e)]
        return len(found) >= want

    _wait_until(enough, timeout,
                lambda: f"{len(found)} of {want} timeline markers")
    return found


# ----------------------------------------- chunked transfer (util.chunks)

def _pull_chunks(desc):
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util import chunks as ch

    me = worker_mod.global_worker
    fetcher = ch.ChunkFetcher(me)
    out = ch.fetch_tree(me, desc, fetcher)
    # fetch AGAIN through the same fetcher: the cache must prevent a
    # second trip over the object plane
    ch.fetch_tree(me, desc, fetcher)
    return {"fetched": fetcher.chunks_fetched,
            "local": fetcher.chunks_local,
            "bytes": fetcher.fetched_bytes,
            "a_sum": float(out["a"].sum()),
            "b_shape": list(out["b"].shape)}


def mpmd_chunk_tree_roundtrip_local():
    """put_tree / fetch_tree: values (a 0-d leaf and a non-contiguous one
    among them) round-trip exactly; same-process fetches are all local;
    the descriptor is metadata only."""
    from ..util import chunks
    from .worker import global_worker as w

    base = np.arange(48, dtype=np.float32).reshape(6, 8)
    tree = {"mat": base, "t": base.T,  # .T is not C-contiguous
            "scalar": np.float32(7.5), "zero_d": np.array(3.25)}
    assert not base.T.flags.c_contiguous
    refs, desc = chunks.put_tree(w, tree)
    assert len(refs) == len(desc["leaves"]) == 4
    assert desc["total_bytes"] == sum(e["nbytes"] for e in desc["leaves"])
    for e in desc["leaves"]:  # metadata only, no payload
        assert set(e) >= {"object_id", "locator", "nbytes", "shape",
                          "dtype"}, e
    fetcher = chunks.ChunkFetcher(w)
    out = chunks.fetch_tree(w, desc, fetcher)
    np.testing.assert_array_equal(out["mat"], tree["mat"])
    np.testing.assert_array_equal(out["t"], base.T)
    assert out["zero_d"].shape == ()  # 0-d stayed 0-d
    assert float(out["scalar"]) == 7.5
    assert fetcher.chunks_local == 4 and fetcher.chunks_fetched == 0
    assert fetcher.fetched_bytes == 0


def mpmd_chunk_tree_fetch_is_point_to_point():
    """A remote process fetches each chunk exactly once, straight from
    the owner: fetched bytes == payload bytes."""
    from ..util import chunks
    from .worker import global_worker as w

    tree = {"a": np.arange(1024, dtype=np.float32),
            "b": np.ones((32, 8), np.int32)}
    refs, desc = chunks.put_tree(w, tree)
    res = rt.get(rt.remote(_pull_chunks).remote(desc), timeout=60.0)
    assert res["fetched"] == 2 and res["bytes"] == desc["total_bytes"], res
    assert res["a_sum"] == float(np.arange(1024, dtype=np.float32).sum())
    assert res["b_shape"] == [32, 8]
    del refs  # the driver's refs were the chunks' lifetime


# ------------------------------------------------------------- channels

def _open(name: str, **spec) -> None:
    _conductor().call("pipeline_open", name, {"num_stages": 2, **spec},
                      timeout=10.0)


def mpmd_channel_roundtrip_and_retention():
    """send / recv: exact round trip, the mailbox drained on take, recv
    bytes == sent bytes, the sender's retention window bounded at two
    steps, and drain as the sender-side close barrier."""
    from ..mpmd.channels import ActivationChannel
    from ..util import state

    _open("chan-test")
    tx = ActivationChannel("chan-test", 0, 1)
    rx = ActivationChannel("chan-test", 0, 1, stage=1)
    try:
        payload = {"h": np.random.default_rng(0).standard_normal(
            (4, 16)).astype(np.float32), "mask": np.ones(4, np.int32)}
        sent = tx.send(0, 2, "act", payload)
        got = rx.recv(0, 2, "act", timeout=10.0)
        np.testing.assert_array_equal(got["h"], payload["h"])
        np.testing.assert_array_equal(got["mask"], payload["mask"])
        assert rx.stats.recv_bytes == sent == tx.stats.sent_bytes
        assert rx.stats.max_fetch_bytes <= payload["h"].nbytes
        assert state.pipeline_status()["mailbox_depth"] == 0
        try:  # a second take of the same key blocks (single delivery)
            rx.recv(0, 2, "act", timeout=0.3)
            raise AssertionError("a slot was delivered twice")
        except TimeoutError:
            pass
        for step in range(4):
            tx.send(step, 0, "act", {"h": np.zeros(2, np.float32)})
        assert {s for s, _mb, _k in tx.held_slots()} <= {2, 3}
        assert tx.drain(timeout=0.3) is False
        rx.recv(2, 0, "act", timeout=5.0)
        rx.recv(3, 0, "act", timeout=5.0)
        assert tx.drain(timeout=5.0) is True
    finally:
        tx.close()
        rx.close()


def mpmd_channel_prefetch_overlaps_and_keeps_accounting():
    """prefetch pulls the next microbatch's chunks in the background: the
    consuming recv is served from it (prefetch_hits), payloads stay
    exact, recv bytes == sent bytes."""
    from ..mpmd.channels import ActivationChannel

    _open("chan-prefetch")
    tx = ActivationChannel("chan-prefetch", 0, 1)
    rx = ActivationChannel("chan-prefetch", 0, 1, stage=1)
    try:
        rng = np.random.default_rng(1)
        payloads = [{"h": rng.standard_normal((8, 16)).astype(
            np.float32)} for _ in range(3)]
        sent = 0
        # prefetch BEFORE the send exists: the background poll waits
        rx.prefetch(0, 0, "act", timeout=10.0)
        for mb, p in enumerate(payloads):
            sent += tx.send(0, mb, "act", p)
        rx.prefetch(0, 1, "act", timeout=10.0)
        rx.prefetch(0, 2, "act", timeout=10.0)
        for mb, p in enumerate(payloads):
            got = rx.recv(0, mb, "act", timeout=10.0)
            np.testing.assert_array_equal(got["h"], p["h"])
        assert rx.stats.prefetch_hits == 3
        assert rx.stats.recv_msgs == 3
        assert rx.stats.recv_bytes == sent == tx.stats.sent_bytes
        try:
            rx.recv(0, 0, "act", timeout=0.3)
            raise AssertionError("a prefetched slot was delivered twice")
        except TimeoutError:
            pass
        assert tx.drain(timeout=5.0) is True
    finally:
        tx.close()
        rx.close()


def mpmd_channel_generations_do_not_cross():
    """A closed pipeline's stage cannot send, and run_id scopes channel
    keys, so an old generation's payload never reaches a reopened
    pipeline's recv; registrations are fenced the same way."""
    from ..mpmd.channels import ActivationChannel

    c = _conductor()
    for bad in ("a/ch/b", "a/ch"):
        res = c.call("pipeline_open", bad, {"num_stages": 2}, timeout=10.0)
        assert "/ch" in (res.get("error") or ""), res
    _open("gen", run_id="r1")
    old_tx = ActivationChannel("gen", 0, 1, run_id="r1")
    try:
        old_tx.send(0, 0, "act", {"h": np.ones(4, np.float32)})
        _open("gen", run_id="r2")
        new_rx = ActivationChannel("gen", 0, 1, stage=1, run_id="r2")
        try:
            try:
                new_rx.recv(0, 0, "act", timeout=0.3)
                raise AssertionError("an old generation's payload "
                                     "crossed")
            except TimeoutError:
                pass
        finally:
            new_rx.close()
        res = c.call("pipeline_register_stage", "gen", 0,
                     {"run_id": "r1"}, timeout=10.0)
        assert "generation" in (res.get("error") or ""), res
        res = c.call("pipeline_register_stage", "gen", 0,
                     {"run_id": "r2"}, timeout=10.0)
        assert res.get("error") is None, res
        c.call("pipeline_close", "gen", timeout=10.0)
        try:
            old_tx.send(1, 0, "act", {"h": np.ones(4, np.float32)})
            raise AssertionError("a closed pipeline took a send")
        except RuntimeError as e:
            assert "not open" in str(e), e
    finally:
        old_tx.close()


def bit_trees():
    """The trees the bit check sends: a bf16 tree and an fp32 tree, each
    with a 0-d leaf, a non-contiguous leaf and special values."""
    import torch

    g = torch.Generator().manual_seed(5)
    special = torch.tensor([-0.0, float("nan"), float("inf"),
                            float("-inf"), 1e-45, -3.4e38])
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        mat = torch.randn(6, 8, generator=g).to(dtype)
        out.append({"mat": mat, "t": mat.T,
                    "zero_d": torch.tensor(3.25, dtype=dtype),
                    "special": special.to(dtype),
                    "nested": [torch.randn(3, generator=g).to(dtype)]})
    return out


class ChannelSender:
    """Sends `bit_trees()` from its own process, as microbatches 0 and 1
    of step 0, and waits for the receiver to take them."""

    def send(self, name: str) -> bool:
        from ray_tpu_torch.mpmd.channels import ActivationChannel

        ch = ActivationChannel(name, 0, 1)
        try:
            for mb, tree in enumerate(bit_trees()):
                ch.send(0, mb, "act", tree)
            return ch.drain(timeout=30.0)
        finally:
            ch.close()


def mpmd_channel_keeps_bits():
    """A bf16 tree and an fp32 tree (0-d, non-contiguous and special
    leaves) go from an actor through one ActivationChannel to this
    process: every leaf comes back bit-equal, in its dtype and shape, on
    the receiver's device."""
    import torch

    from ..mpmd.channels import ActivationChannel
    from ..tree import tree_flatten

    _open("chan-bits")
    rx = ActivationChannel("chan-bits", 0, 1, stage=1, device="cpu")
    sender = rt.remote(ChannelSender).remote()
    try:
        done = sender.send.remote("chan-bits")
        got = [rx.recv(0, mb, "act", timeout=60.0) for mb in range(2)]
        assert rt.get(done, timeout=60.0) is True
    finally:
        rx.close()
        rt.kill(sender)
    for tree_got, tree_want in zip(got, bit_trees()):
        g, gs = tree_flatten(tree_got)
        w, ws = tree_flatten(tree_want)
        assert gs == ws, (gs, ws)
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
            bits = torch.int16 if b.dtype == torch.bfloat16 \
                else torch.int32
            assert torch.equal(a.contiguous().view(bits),
                               b.contiguous().view(bits)), (a, b)


# ------------------------------------------------------ pipelines, MLP

def mpmd_two_stage_pipeline_matches_dense_reference():
    """A 2-stage pipeline on two virtual slices (1F1B, sgd) on CPU
    stages; returns its losses for the test to hold against the JAX
    dense reference. Held here: the registry (formed, slice ids {0, 1},
    the bubble estimate, per-stage stats, prefetch hits), the merged
    timeline's 2 x STEPS step markers with bubble_wait_ms and its
    pipeline lane, and the stages' metric snapshots (the JAX test's
    Prometheus legs): the send byte counters cover the totals."""
    from ..mpmd.schedule import bubble_fraction
    from ..train import PipelineTrainer, RunConfig, ScalingConfig
    from ..train.optim import sgd
    from ..util import state

    p0, p1 = mlp_params()
    trainer = PipelineTrainer(
        [mlp_stage0, mlp_stage1], [p0, p1], mse_loss, sgd(LR),
        data_fn=mlp_data, num_microbatches=M, num_steps=STEPS,
        schedule="1f1b", scaling_config=ScalingConfig(num_stages=2),
        run_config=RunConfig(name="parity"), num_slices=2, device="cpu")
    result = trainer.fit()
    assert result.error is None, result.error
    losses = [m["loss"] for m in result.metrics_history]
    assert len(losses) == STEPS, losses

    rec = state.pipeline_status("parity")["pipelines"]["parity"]
    assert rec["formed"] and rec["num_stages"] == 2
    assert {v["slice_id"] for v in rec["stages"].values()} == {0, 1}
    assert rec["schedule"] == "1f1b"
    assert abs(rec["bubble_estimate"]
               - bubble_fraction("1f1b", 2, M)) < 1e-12
    assert set(rec["stats"]) == {0, 1}, rec["stats"].keys()
    for s in rec["stats"].values():
        assert s["steps"] == STEPS
        assert 0.0 <= s["bubble_fraction"] <= 1.0
    assert rec["totals"]["activation_bytes"] > 0
    assert sum(s.get("prefetch_hits", 0)
               for s in rec["stats"].values()) > 0

    run_id = rec["run_id"]
    steps = _markers(lambda e: e.get("cat") == "train_step"
                     and e.get("ph") == "X"
                     and e.get("pid") == f"train:{run_id}", 2 * STEPS)
    assert len(steps) == 2 * STEPS, len(steps)
    assert {e["tid"] for e in steps} == {"rank 0", "rank 1"}
    assert any(e["args"].get("bubble_wait_ms", 0) > 0 for e in steps)
    lanes = {e["tid"] for e in _markers(
        lambda e: e.get("cat") == "pipeline"
        and e["args"].get("pipeline") == "parity"
        and e["args"].get("kind") == "stage_report", 2)}
    assert {"stage 0", "stage 1"} <= lanes, lanes

    sent = 0.0
    for s in rec["stats"].values():
        snap = s["metrics"]
        assert any("pipeline=parity" in k for k in
                   snap["ray_tpu_pipeline_bubble_fraction"])
        sent += sum(v for k, v in
                    snap["ray_tpu_pipeline_activations_bytes_total"].items()
                    if "direction=send" in k and "pipeline=parity" in k)
    assert sent >= rec["totals"]["activation_bytes"], sent
    return {"losses": losses, "run_id": run_id,
            "bubble_fraction": result.metrics["bubble_fraction"]}


def mpmd_all_surfaces_report_consistent_numbers():
    """pipeline_status() and the timeline's stage_report markers report
    the same per-stage numbers as the run's own summaries (GPipe, 2
    steps); the registry's events hold open / formed / stage_report /
    closed. Returns the stages' params after the run
    (`stage_params_snapshot`) for the test to hold against JAX's."""
    from ..mpmd import PipelineConductor
    from ..train.optim import sgd
    from ..util import state

    p0, p1 = mlp_params()
    pipe = PipelineConductor("surfaces", [mlp_stage0, mlp_stage1],
                             [p0, p1], sgd(LR), mse_loss,
                             num_microbatches=M, schedule="gpipe",
                             device="cpu")
    try:
        pipe.form()
        out = pipe.run(2, mlp_data)
        params = pipe.stage_params_snapshot()
    finally:
        pipe.close()
    local = {s["stage"]: s for s in out["stages"]}
    st = state.pipeline_status()["pipelines"]["surfaces"]
    for s, mine in local.items():
        reg = st["stats"][s]
        assert reg["steps"] == mine["steps"] == 2
        assert reg["sent_bytes"] == mine["sent_bytes"]
        assert reg["recv_bytes"] == mine["recv_bytes"]
        assert abs(reg["bubble_fraction"] - mine["bubble_fraction"]) \
            < 1e-9
    assert st["totals"]["activation_bytes"] == sum(
        m["sent_bytes"] for m in local.values())
    kinds = {e["kind"] for e in _conductor().call(
        "get_pipeline_events", 1000, timeout=10.0)
        if e.get("pipeline") == "surfaces"}
    assert {"open", "formed", "stage_report", "closed"} <= kinds, kinds
    reports = {e["args"]["stage"]: e["args"] for e in _markers(
        lambda e: e.get("cat") == "pipeline"
        and e["args"].get("kind") == "stage_report"
        and e["args"].get("pipeline") == "surfaces", 2)}
    assert set(reports) == {0, 1}
    for s, mine in local.items():
        assert reports[s]["sent_bytes"] == mine["sent_bytes"]
        assert abs(reports[s]["bubble_fraction"]
                   - mine["bubble_fraction"]) <= 1e-6
    # Prometheus: each stage pushed its registry with its report
    from .telemetry_checks import prom_total, prometheus_when

    sent = sum(m["sent_bytes"] for m in local.values())
    prom = prometheus_when(
        lambda t: prom_total(t, "ray_tpu_pipeline_activations_bytes_total",
                             pipeline="surfaces", direction="send")
        >= sent, what="the stages' pipeline series")
    for s, mine in local.items():
        assert abs(prom_total(prom, "ray_tpu_pipeline_bubble_fraction",
                              pipeline="surfaces", stage=s)
                   - mine["last_bubble_fraction"]) <= 1e-6, s
    # the CLI and the dashboard (JSON stage keys are strings)
    from .dashboard_checks import cli_json, cli_text, dashboard_json

    cli_rec = cli_json("pipeline")["pipelines"]["surfaces"]
    for s, mine in local.items():
        assert cli_rec["stats"][str(s)]["sent_bytes"] == mine["sent_bytes"]
    assert cli_rec["totals"]["activation_bytes"] == sent
    text = cli_text("pipeline", "--events", "5")
    assert "surfaces" in text and "schedule=gpipe" in text, text
    dash = dashboard_json("/api/pipeline")["pipelines"]["surfaces"]
    for s, mine in local.items():
        assert dash["stats"][str(s)]["recv_bytes"] == mine["recv_bytes"]
    kinds = {e["kind"] for e in dashboard_json("/api/pipeline")["events"]
             if e.get("pipeline") == "surfaces"}
    assert {"open", "formed", "stage_report", "closed"} <= kinds, kinds
    return {"losses": out["losses"], "params": [pack(p) for p in params]}


def mpmd_stage_death_fails_pipeline_fast():
    """Killing one stage mid-run kills the survivors and the driver's
    run raises well before any channel timeout; a stage_death event is
    recorded."""
    from ..mpmd import PipelineConductor
    from ..train.optim import sgd

    p0, p1 = mlp_params()
    pipe = PipelineConductor("doomed", [mlp_stage0, mlp_stage1], [p0, p1],
                             sgd(LR), mse_loss, num_microbatches=M,
                             schedule="1f1b", device="cpu")
    result: dict = {}

    def drive():
        t0 = time.monotonic()
        try:
            pipe.run(500, slow_mlp_data, recv_timeout=120.0)
            result["error"] = None
        except Exception as e:  # noqa: BLE001 — the expected outcome
            result["error"] = e
        result["elapsed"] = time.monotonic() - t0

    try:
        pipe.form()
        t = threading.Thread(target=drive)
        t.start()
        time.sleep(1.0)  # let the schedule get going
        rt.kill(pipe._actors[0])
        t.join(timeout=30.0)
        assert not t.is_alive(), "run() did not fail fast"
        assert result["error"] is not None
        assert result["elapsed"] < 25.0, result["elapsed"]
        events = _conductor().call("get_pipeline_events", 1000,
                                   timeout=10.0)
        assert any(e.get("kind") == "stage_death"
                   and e.get("pipeline") == "doomed" for e in events)
    finally:
        pipe.close()
    return {"elapsed_s": result["elapsed"],
            "error": type(result["error"]).__name__}


def mpmd_pipeline_validates_microbatches():
    """The port's SPMD pipeline (`parallel.make_pipeline_fn`) on a dp 2,
    pp 4 mesh refuses 3 microbatches of a per-shard batch of 8 at call
    time, naming the global batch and the mesh axes: the check fires
    before any collective, so an 8-rank mesh over a fake process group
    in this one process suffices."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..parallel import (MeshConfig, make_mesh, make_pipeline_fn,
                            stack_stage_params)

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        mesh = make_mesh(MeshConfig(dp=2, pp=4), device="cpu")
        stacked = stack_stage_params(
            [(torch.zeros(8, 8), torch.zeros(8)) for _ in range(4)])
        pipe = make_pipeline_fn(lambda p, x: torch.tanh(x @ p[0] + p[1]),
                                mesh, num_microbatches=3)
        try:
            pipe(stacked, torch.zeros(16, 8))  # local batch 8, not / 3
        except ValueError as e:
            return {"message": str(e)}
        raise AssertionError("3 microbatches of 8 rows were taken")
    finally:
        dist.destroy_process_group()


# --------------------------------------------- pipelines, Llama tiny fp32

LLAMA_SEED = 7
LLAMA_TOKENS = (8, 32)
LLAMA_STEPS = 3
LLAMA_LR = 1e-3


def tiny_llama():
    """(config, params): Llama tiny in fp32 from a torch seed, on the
    CPU."""
    import dataclasses

    import torch

    from ..models.llama import LlamaConfig, llama_init

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    return cfg, llama_init(cfg, torch.Generator().manual_seed(LLAMA_SEED),
                           device="cpu")


def llama_split(params):
    """Stage 0: the embedding and block 0; stage 1: the other blocks,
    norm_f and lm_head."""
    return ({"tok_emb": params["tok_emb"], "blocks": params["blocks"][:1]},
            {"blocks": params["blocks"][1:], "norm_f": params["norm_f"],
             "lm_head": params["lm_head"]})


def _blocks(x, blocks, config):
    from ..models.llama import _rope, llama_block

    cos, sin = _rope(config, x.device)
    for p in blocks:
        x = llama_block(x, p, cos, sin, config)
    return x


def llama_stage0(params, tokens, config):
    return _blocks(params["tok_emb"][tokens], params["blocks"], config)


def llama_stage1(params, x, config):
    from ..ops.layers import fp32_logits, rms_norm

    x = rms_norm(_blocks(x, params["blocks"], config),
                 params["norm_f"]["scale"])
    return fp32_logits(x, params["lm_head"])


def llama_tail_loss(logits, targets, config):
    """`llama_loss`'s tail: the vocabulary padding masked, log-softmax,
    mean next-token cross-entropy over the microbatch."""
    import torch

    if config.padded_vocab != config.vocab_size:
        logits[..., config.vocab_size:] = -1e30
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def llama_data(step):
    """Tokens [8, 33] from a seed of the step: (inputs, next tokens)."""
    b, t = LLAMA_TOKENS
    seq = np.random.default_rng(200 + step).integers(0, 512, (b, t + 1))
    return seq[:, :-1], seq[:, 1:]


def _snapshot_stage():
    """`SnapshotStage`: a StageActor whose run_steps summary carries the
    stage's final params (host copies, packed). Built on first use and
    kept as this module's attribute, so it pickles by reference."""
    cls = globals().get("SnapshotStage")
    if cls is None:
        from ..mpmd.stage import StageActor

        class SnapshotStage(StageActor):
            def run_steps(self, *args, **kwargs):
                out = StageActor.run_steps(self, *args, **kwargs)
                out["final_params"] = pack(self.get_params())
                return out

        SnapshotStage.__qualname__ = "SnapshotStage"
        globals()["SnapshotStage"] = cls = SnapshotStage
    return cls


def _llama_pipeline(schedule: str) -> dict:
    from ..train import PipelineTrainer, RunConfig
    from ..train.optim import adamw

    cfg, params = tiny_llama()
    trainer = PipelineTrainer(
        [functools.partial(llama_stage0, config=cfg),
         functools.partial(llama_stage1, config=cfg)],
        list(llama_split(params)),
        functools.partial(llama_tail_loss, config=cfg), adamw(LLAMA_LR),
        data_fn=llama_data, num_microbatches=M, num_steps=LLAMA_STEPS,
        schedule=schedule, run_config=RunConfig(name=f"llama-{schedule}"),
        device="cpu", stage_class=_snapshot_stage())
    result = trainer.fit()
    assert result.error is None, result.error
    return {"losses": [m["loss"] for m in result.metrics_history],
            "params": [s["final_params"] for s in trainer.stages]}


def mpmd_llama_pipeline_1f1b():
    """Llama tiny fp32 as a two-stage PipelineTrainer (1F1B, adamw(1e-3),
    M 4, 3 steps) on CPU stages: losses and each stage's final params."""
    return _llama_pipeline("1f1b")


def mpmd_llama_pipeline_gpipe():
    """As mpmd_llama_pipeline_1f1b, under GPipe."""
    return _llama_pipeline("gpipe")


# -------------------------------------------------- collective actors

class ColRank:
    """tests/test_collective.py's `Rank` actor."""

    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def setup(self, group="g"):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(self.world, self.rank, group_name="g")
        return self.rank

    def do_allreduce(self):
        from ray_tpu_torch.util import collective as col

        x = np.full((4,), float(self.rank + 1), dtype=np.float32)
        return col.allreduce(x, group_name="g")

    def do_broadcast(self):
        from ray_tpu_torch.util import collective as col

        x = (np.arange(3, dtype=np.float32) if self.rank == 0
             else np.zeros(3, dtype=np.float32))
        return col.broadcast(x, src_rank=0, group_name="g")

    def do_allgather(self):
        from ray_tpu_torch.util import collective as col

        return col.allgather(np.array([self.rank], np.int64),
                             group_name="g")

    def do_reducescatter(self):
        from ray_tpu_torch.util import collective as col

        x = np.arange(4, dtype=np.float32) + self.rank
        return col.reducescatter(x, group_name="g")

    def do_sendrecv(self):
        from ray_tpu_torch.util import collective as col

        if self.rank == 0:
            col.send(np.array([42.0]), dst_rank=1, group_name="g")
            return None
        out = np.zeros(1)
        col.recv(out, src_rank=0, group_name="g")
        return out

    def do_barrier(self):
        from ray_tpu_torch.util import collective as col

        col.barrier(group_name="g")
        return True

    def info(self):
        from ray_tpu_torch.util import collective as col

        return {"initialized": col.is_group_initialized("g"),
                "rank": col.get_rank("g"),
                "size": col.get_collective_group_size("g")}

    def destroy(self):
        from ray_tpu_torch.util import collective as col

        col.destroy_collective_group("g")
        return col.is_group_initialized("g")


def _group2(declarative: bool = False):
    actors = [rt.remote(ColRank).remote(r, 2) for r in range(2)]
    if declarative:
        from ..util import collective as col

        col.create_collective_group(actors, 2, [0, 1], group_name="g")
    else:
        rt.get([a.setup.remote() for a in actors], timeout=60.0)
    return actors


def _call(actors, method: str) -> list:
    return rt.get([getattr(a, method).remote() for a in actors],
                  timeout=120.0)


def _lists(values) -> list:
    return [None if v is None else np.asarray(v).tolist() for v in values]


def collective_allreduce():
    return {"allreduce": _lists(_call(_group2(), "do_allreduce"))}


def collective_broadcast_allgather():
    actors = _group2()
    return {"broadcast": _lists(_call(actors, "do_broadcast")),
            "allgather": [[np.asarray(x).tolist() for x in r]
                          for r in _call(actors, "do_allgather")]}


def collective_reducescatter_sendrecv_barrier():
    actors = _group2()
    return {"reducescatter": _lists(_call(actors, "do_reducescatter")),
            "sendrecv": _lists(_call(actors, "do_sendrecv")),
            "barrier": _call(actors, "do_barrier")}


def collective_declarative_create_group():
    """create_collective_group on actors of a class with no init method
    of its own: the worker's __ray_tpu_col_init__ hook inits each."""
    actors = _group2(declarative=True)
    return {"allreduce": _lists(_call(actors, "do_allreduce")),
            "info": _call(actors, "info")}


def collective_destroy_leaves_only_final_barrier():
    """After some ops, both ranks destroy the group at once: each is
    uninitialized after, and of the group's keys only the final
    barrier's markers (one per rank) are left."""
    actors = _group2()
    for method in ("do_allreduce", "do_broadcast", "do_allgather",
                   "do_sendrecv", "do_barrier"):
        _call(actors, method)
    assert _call(actors, "destroy") == [False, False]
    keys = sorted(k.decode() for k in _conductor().call(
        "kv_keys", b"col/g/", "collective", timeout=10.0))
    return {"keys": keys}


# ----------------------------------------------------- flight recorder

def flight_straggler_gang():
    """Four ranks report ten steps each through report_train_steps, rank
    3 at 2.5x the others: train_progress flags it."""
    from ..util import state

    for rank in range(4):
        ms = 250.0 if rank == 3 else 100.0
        _conductor().call(
            "report_train_steps", "straggler-run", rank,
            [{"step": s, "rank": rank, "total_ms": ms,
              "device_step_ms": ms, "t_start": time.time(),
              "t_end": time.time() + ms / 1e3} for s in range(10)],
            timeout=10.0)
    run = state.train_progress("straggler-run")["straggler-run"]
    assert run["world"] == 4, run
    assert run["stragglers"] == [3], run
    assert run["last_step_skew"]["max_over_median"] > 2.0, run
    return {"stragglers": run["stragglers"],
            "max_over_median": run["last_step_skew"]["max_over_median"]}


def _gpt2_train_fn(cfg):
    """Three TrainSteps of GPT-2 tiny fp32 on the CPU, one report each."""
    import dataclasses

    import torch

    from ..models.gpt2 import GPT2Config, gpt2_init, gpt2_loss
    from ..train import report
    from ..train.optim import adamw
    from ..train.step import TrainStep

    mcfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    step = TrainStep(lambda p, b: gpt2_loss(p, b["tokens"], b["targets"],
                                            mcfg), adamw(1e-3),
                     device="cpu")
    state = step.init_state(gpt2_init(mcfg, device="cpu"))
    gen = torch.Generator().manual_seed(3)
    for i in range(3):
        seq = torch.randint(0, mcfg.vocab_size, (2, 33), generator=gen)
        state, metrics = step(state, {"tokens": seq[:, :-1],
                                      "targets": seq[:, 1:]})
        report({"loss": float(metrics["loss"]), "step": i})


def flight_spmd_trainer_records():
    """A TorchTrainer (spmd) run's 3 step records reach the conductor:
    train_progress counts 3 steps for rank 0, and the merged timeline has
    3 step markers under train:<run_id>, tid "rank 0", carrying
    device_step_ms."""
    import shutil
    import tempfile

    from ..train import RunConfig, TorchTrainer
    from ..util import state

    tmp = tempfile.mkdtemp()
    try:
        result = TorchTrainer(_gpt2_train_fn, run_config=RunConfig(
            name="obs-accept", storage_path=tmp)).fit()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert result.error is None, result.error
    assert len(result.metrics_history) == 3
    progress: dict = {}

    def buffered():
        progress.clear()
        progress.update({k: v for k, v in state.train_progress().items()
                         if k.startswith("obs-accept/")})
        return bool(progress) and \
            list(progress.values())[0]["steps_buffered"] >= 3

    _wait_until(buffered, 10.0, lambda: f"progress {progress}")
    (run_id, run), = progress.items()
    assert run["per_rank"][0]["steps"] == 3, run
    marks = _markers(lambda e: e.get("cat") == "train_step"
                     and e.get("ph") == "X"
                     and e.get("pid") == f"train:{run_id}", 3)
    assert {e["tid"] for e in marks} == {"rank 0"}
    assert all(e["args"]["device_step_ms"] > 0 for e in marks), marks
    return {"run_id": run_id, "steps": run["per_rank"][0]["steps"],
            "device_step_ms": [e["args"]["device_step_ms"]
                               for e in marks]}


def __getattr__(name):
    # a worker unpickling SnapshotStage by reference builds it here: this
    # module must not import torch at the top
    if name == "SnapshotStage":
        return _snapshot_stage()
    raise AttributeError(name)
