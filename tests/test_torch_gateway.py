"""Twins of tests/test_gateway.py for the port's HTTP front door
(ray_tpu_torch/serve/gateway.py + serve/qos.py), on the CPU, with Llama
tiny fp32 carried over from JAX by `from_jax_params`.

Everything drives the gateway the way a client does: raw
``http.client`` connections against the bound port, SSE frames parsed off
the wire. The invariants are the JAX test's: protocol errors come back as
OpenAI error bodies with the right status; the concatenated SSE deltas
are exactly the non-streaming body and both equal the engine's
``generate()``; a preempted batch stream resumes and still finishes
equal to an uninterrupted run; a client that vanishes frees its decode
slot (router shed cause ``disconnect``, engine cancel ``disconnect``,
gateway 499). The preemption twin sends its interactive request once the
batch stream's first SSE frame has been read, not after a sleep.

Parity cases hold the port against the JAX package on the same seeded
inputs: `TokenBucket` and `QosGate` under the same random admit /
release / clock sequences, `ByteCodec`, `_sse_frame` and `shed_outcome`,
a JAX `GatewayServer` (aiohttp) and a port one given one script of
requests (statuses, header names, JSON bodies and SSE frames once `id`
and `created` are out), and `generate(cancel_event=)` set after k tokens
on both routers, colocated and disaggregated.

The cluster case (`test_state_api_sees_gateway_telemetry`) is a check of
`_private/telemetry_checks.py` in a driver process of its own
(`isolated.run_checks`).
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import random
import socket
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import llama_init as jllama_init
from ray_tpu.serve import disagg as jdisagg
from ray_tpu.serve import gateway as jgateway
from ray_tpu.serve import qos as jqos
from ray_tpu_torch._private import isolated
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.serve import disagg as tdisagg
from ray_tpu_torch.serve import gateway as tgateway
from ray_tpu_torch.serve import qos as tqos
from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                        PrefillServer)
from ray_tpu_torch.serve.gateway import GatewayServer
from ray_tpu_torch.serve.handle import RequestShedError
from ray_tpu_torch.serve.qos import QosGate, TenantPolicy, TokenBucket

pytestmark = pytest.mark.gateway

# max_seq_len well past tiny()'s 128: the preemption case needs a batch
# decode long enough that an interactive arrival lands while the engine is
# still producing
JCFG = dataclasses.replace(JLlamaConfig.tiny(), dtype=jnp.float32,
                           max_seq_len=1024)
CFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32,
                          max_seq_len=1024)
BS = 4

CHECKS = {"gateway_state_api_sees_gateway_telemetry": {
    "num_cpus": 4, "_system_config": {"log_to_driver": 0}}}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=240.0)


@pytest.fixture(scope="module")
def models():
    jp = jllama_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def stack(model):
    """One engine + router + gateway shared by the protocol cases.
    Counters accumulate across cases: assertions use deltas."""
    engine = ContinuousBatchingEngine(model, CFG, max_batch=2)
    router = DisaggRouter(colocated=engine, max_queue_depth=8)
    qos = QosGate(
        api_keys={"sk-alpha": "alpha", "sk-blocked": "blocked"},
        policies={"blocked": TenantPolicy(rate_rps=0.0, burst=0.0)},
        router=router)
    gw = GatewayServer(router, model="tiny", vocab_size=CFG.vocab_size,
                       qos=qos, max_tokens_cap=800)
    host, port = gw.ready()
    yield SimpleNamespace(engine=engine, router=router, gw=gw, host=host,
                          port=port)
    gw.stop()
    engine.stop()


def _post(host, port, path, body=None, headers=None, raw=None,
          timeout=60.0, conn=None):
    conn = conn or http.client.HTTPConnection(host, port, timeout=timeout)
    payload = raw if raw is not None else json.dumps(body)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    conn.request("POST", path, payload, hdrs)
    return conn, conn.getresponse()


def _drain_sse(resp, stop_after=None):
    """Parse SSE frames off the socket: (chunks, saw_done). `stop_after`
    stops after N content frames (the disconnect cases walk away)."""
    chunks = []
    saw_done = False
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        payload = line[len(b"data: "):]
        if payload == b"[DONE]":
            saw_done = True
            break
        chunks.append(json.loads(payload))
        if stop_after is not None and len(chunks) >= stop_after:
            break
    return chunks, saw_done


def _oracle_text(engine, prompt, n):
    return " ".join(str(int(t)) for t in engine.generate(prompt, n))


def _wait(pred, bound_s=15.0):
    deadline = time.time() + bound_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# ------------------------------------------------------ protocol errors


def test_malformed_json_is_openai_400(stack):
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       raw=b"{this is not json")
    assert resp.status == 400
    err = json.loads(resp.read())["error"]
    assert err["type"] == "invalid_request_error"
    assert err["code"] == "invalid_json"
    assert err["message"]
    conn.close()


def test_unknown_model_is_404(stack):
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "gpt-nope", "prompt": [1, 2]})
    assert resp.status == 404
    err = json.loads(resp.read())["error"]
    assert err["code"] == "model_not_found"
    conn.close()


def test_bad_prompt_is_400(stack):
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": {"no": 1}})
    assert resp.status == 400
    assert json.loads(resp.read())["error"]["type"] == \
        "invalid_request_error"
    conn.close()


def test_unknown_api_key_is_401(stack):
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": [1, 2]},
                       headers={"Authorization": "Bearer sk-wrong"})
    assert resp.status == 401
    err = json.loads(resp.read())["error"]
    assert err["type"] == "authentication_error"
    assert err["code"] == "invalid_api_key"
    conn.close()


def test_zero_rate_tenant_is_429_with_retry_after(stack):
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": [1, 2]},
                       headers={"Authorization": "Bearer sk-blocked"})
    assert resp.status == 429
    assert int(resp.headers["Retry-After"]) >= 1
    assert resp.headers["X-Shed-Cause"] == "rate_limit"
    err = json.loads(resp.read())["error"]
    assert err["type"] == "rate_limit_error"
    conn.close()
    # the same shed with stream=true is still a real 429 status line,
    # not a 200 that turns into an error frame
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": [1, 2],
                             "stream": True},
                       headers={"Authorization": "Bearer sk-blocked"})
    assert resp.status == 429
    assert resp.headers["X-Shed-Cause"] == "rate_limit"
    conn.close()
    assert stack.gw.stats()["rate_limited"] >= 2


# ------------------------------------------------- parity vs the oracle


def test_stream_and_nonstream_match_engine_oracle(stack):
    prompt, n = [1, 2, 3, 4, 5], 32
    expected = _oracle_text(stack.engine, prompt, n)

    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": prompt,
                             "max_tokens": n})
    assert resp.status == 200
    body = json.loads(resp.read())
    assert body["object"] == "text_completion"
    assert body["choices"][0]["text"] == expected
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == n

    # the stream rides the same keep-alive connection
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": prompt,
                             "max_tokens": n, "stream": True}, conn=conn)
    assert resp.status == 200
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    chunks, saw_done = _drain_sse(resp)
    conn.close()
    assert saw_done
    assert chunks[0]["id"].startswith("cmpl-")
    streamed = "".join(c["choices"][0]["text"] for c in chunks)
    assert streamed == expected
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


def test_chat_stream_matches_chat_nonstream(stack):
    body = {"model": "tiny", "max_tokens": 24,
            "messages": [{"role": "user", "content": "hello there"}]}
    conn, resp = _post(stack.host, stack.port, "/v1/chat/completions",
                       body=body)
    assert resp.status == 200
    out = json.loads(resp.read())
    assert out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant"
    conn.close()

    conn, resp = _post(stack.host, stack.port, "/v1/chat/completions",
                       body=dict(body, stream=True))
    assert resp.status == 200
    chunks, saw_done = _drain_sse(resp)
    conn.close()
    assert saw_done
    assert chunks[0]["object"] == "chat.completion.chunk"
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    streamed = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
    assert streamed == msg["content"]


# ------------------------------------------- preemption bit-identity


def test_preempted_batch_stream_is_bit_identical(model):
    """An interactive arrival on a full tier preempts a batch slot; the
    preempted stream replays with its history and still delivers EXACTLY
    the uninterrupted greedy decode."""
    engine = ContinuousBatchingEngine(model, CFG, max_batch=1)
    router = DisaggRouter(colocated=engine, max_queue_depth=0)
    gw = GatewayServer(router, model="tiny", vocab_size=CFG.vocab_size,
                       qos=QosGate(router=router), max_tokens_cap=800)
    host, port = gw.ready()
    try:
        prompt, n = [7, 8, 9], 600
        expected = _oracle_text(engine, prompt, n)
        out = {}
        first = threading.Event()

        def batch_client():
            conn, resp = _post(host, port, "/v1/completions",
                               body={"model": "tiny", "prompt": prompt,
                                     "max_tokens": n, "stream": True,
                                     "priority": "batch"},
                               timeout=180.0)
            head, _ = _drain_sse(resp, stop_after=1)
            first.set()
            chunks, saw_done = _drain_sse(resp)
            out["batch"] = ("".join(c["choices"][0]["text"]
                                    for c in head + chunks), saw_done,
                            resp.status)
            conn.close()

        th = threading.Thread(target=batch_client, daemon=True)
        th.start()
        # the batch stream is producing and holds the one slot: the
        # interactive arrival must preempt
        assert first.wait(60.0)
        conn, resp = _post(host, port, "/v1/completions",
                           body={"model": "tiny", "prompt": [4, 5],
                                 "max_tokens": 16,
                                 "priority": "interactive"},
                           timeout=120.0)
        assert resp.status == 200
        inter = json.loads(resp.read())["choices"][0]["text"]
        conn.close()
        assert inter == _oracle_text(engine, [4, 5], 16)
        th.join(timeout=120)
        assert not th.is_alive()

        text, saw_done, status = out["batch"]
        assert status == 200 and saw_done
        assert text == expected
        rt = router.stats()
        assert rt["preemptions"] >= 1
        assert rt["preempted_requests"] >= 1
        assert engine.kv_stats()["cancelled_by_reason"].get(
            "preempt", 0) >= 1
        assert gw.stats()["preemptions"] == rt["preemptions"]
    finally:
        gw.stop()
        engine.stop()


# --------------------------------------------------- disconnect reaping


def test_client_disconnect_frees_decode_slot(stack):
    before = dict(stack.router.stats()["sheds_by_cause"])
    cancelled = stack.engine.kv_stats()["cancelled_by_reason"].get(
        "disconnect", 0)
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": [3, 1],
                             "max_tokens": 400, "stream": True,
                             "token_sleep_s": 0.05})
    assert resp.status == 200
    chunks, _ = _drain_sse(resp, stop_after=3)
    assert len(chunks) == 3
    # http.client holds the fd through the response's makefile(), so
    # close() alone sends no FIN; shutdown() does
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()

    def reaped():
        after = stack.router.stats()["sheds_by_cause"]
        return (after.get("disconnect", 0) > before.get("disconnect", 0)
                and stack.engine.kv_stats()["cancelled_by_reason"].get(
                    "disconnect", 0) > cancelled
                and stack.engine.active_slots == 0)

    assert _wait(reaped), (stack.router.stats()["sheds_by_cause"],
                           stack.engine.kv_stats()["cancelled_by_reason"])
    gs = stack.gw.stats()
    assert gs["disconnects"] >= 1
    assert gs["by_code"].get("499", 0) >= 1


def test_client_gone_while_waiting_frees_decode_slot(stack):
    """The blocking path: a client that goes away before its response
    exists is seen by the connection's watcher and reaped the same way
    (the JAX gateway's aiohttp handler is not cancelled on a disconnect,
    so its blocking request decodes to the end)."""
    before = stack.router.stats()["sheds_by_cause"].get("disconnect", 0)
    n499 = stack.gw.stats()["by_code"].get("499", 0)
    conn = http.client.HTTPConnection(stack.host, stack.port, timeout=60)
    conn.request("POST", "/v1/completions",
                 json.dumps({"model": "tiny", "prompt": [3, 2],
                             "max_tokens": 400, "token_sleep_s": 0.05}),
                 {"Content-Type": "application/json"})
    assert _wait(lambda: stack.engine.active_slots == 1, 10.0)
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    assert _wait(lambda: stack.router.stats()["sheds_by_cause"].get(
        "disconnect", 0) > before and stack.engine.active_slots == 0)
    assert stack.gw.stats()["by_code"].get("499", 0) == n499 + 1


def test_chaos_drop_connection_reaps_like_a_real_drop(stack):
    """The scripted chaos knob exercises the SAME reap path as an organic
    disconnect: the server aborts the transport at token K and the router
    sheds with cause disconnect."""
    spec = json.dumps({"actions": [
        {"action": "drop_connection", "at": "token:5"}]})
    gw = GatewayServer(stack.router, model="tiny",
                       vocab_size=CFG.vocab_size, chaos_spec=spec)
    host, port = gw.ready()
    try:
        before = stack.router.stats()["sheds_by_cause"].get(
            "disconnect", 0)
        conn, resp = _post(host, port, "/v1/completions",
                           body={"model": "tiny", "prompt": [9, 9],
                                 "max_tokens": 400, "stream": True,
                                 "token_sleep_s": 0.02})
        assert resp.status == 200
        with pytest.raises((http.client.IncompleteRead,
                            ConnectionResetError, OSError)):
            while True:
                if not resp.readline():
                    break
            raise ConnectionResetError("server closed early")
        conn.close()
        assert _wait(lambda: stack.router.stats()["sheds_by_cause"].get(
            "disconnect", 0) > before)
        assert gw.stats()["disconnects"] >= 1
    finally:
        gw.stop()


# ------------------------------------------------ deadline propagation


def test_deadline_header_sheds_with_cause(stack):
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       body={"model": "tiny", "prompt": [2, 2],
                             "max_tokens": 400, "token_sleep_s": 0.05},
                       headers={"X-Request-Deadline": "0.2"})
    assert resp.status == 503
    assert resp.headers["X-Shed-Cause"] == "deadline"
    err = json.loads(resp.read())["error"]
    assert err["type"] == "overloaded"
    conn.close()


# ------------------------------------------------------- discovery ops


def test_models_healthz_and_snapshot(stack):
    conn = http.client.HTTPConnection(stack.host, stack.port, timeout=30)
    conn.request("GET", "/v1/models")
    resp = conn.getresponse()
    assert resp.status == 200
    listing = json.loads(resp.read())
    assert "tiny" in [m["id"] for m in listing["data"]]

    conn.request("GET", "/-/healthz")
    assert conn.getresponse().read() == b"ok"

    conn.request("GET", "/-/gateway")
    snap = json.loads(conn.getresponse().read())
    assert snap["role"] == "gateway"
    assert snap["accepted"] >= 1
    assert "interactive" in snap["by_class"]
    conn.close()


# ---------------------------------------------------------- QoS units


def test_token_bucket_refills_at_rate():
    b = TokenBucket(rate_rps=50.0, burst=1.0)
    assert b.try_acquire() == 0.0
    wait = b.try_acquire()
    assert wait > 0.0
    time.sleep(max(wait, 0.025) + 0.01)
    assert b.try_acquire() == 0.0


def test_qos_inflight_quota_and_release():
    gate = QosGate(policies={"t": TenantPolicy(max_inflight=1)})
    gate.admit("t", "interactive")
    with pytest.raises(RequestShedError) as ei:
        gate.admit("t", "interactive")
    assert ei.value.cause == "quota"
    gate.release("t")
    gate.admit("t", "interactive")
    st = gate.stats()
    assert st["tenants"]["t"]["admitted"] == 2
    assert st["tenants"]["t"]["rejected"] == {"quota": 1}


def test_qos_lifetime_quota_reads_router_accounting():
    class FakeRouter:
        def tenant_stats(self):
            return {"t": {"dispatched": 3}}

    gate = QosGate(policies={"t": TenantPolicy(max_requests=3)},
                   router=FakeRouter())
    with pytest.raises(RequestShedError) as ei:
        gate.admit("t")
    assert ei.value.cause == "quota"


# ------------------------------------------------- telemetry roundtrip


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_state_api_sees_gateway_telemetry(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------- the HTTP layer alone


def test_keep_alive_serves_sequential_requests(stack):
    """One connection, five requests of three kinds: each answered in
    order, the connection kept."""
    conn = http.client.HTTPConnection(stack.host, stack.port, timeout=60)
    for i in range(5):
        if i % 2:
            conn.request("GET", "/-/healthz")
            resp = conn.getresponse()
            assert resp.read() == b"ok"
        else:
            _, resp = _post(stack.host, stack.port, "/v1/completions",
                            body={"prompt": [1 + i], "max_tokens": 3},
                            conn=conn)
            assert resp.status == 200
            assert json.loads(resp.read())["usage"][
                "completion_tokens"] == 3
        assert resp.getheader("X-Request-Id")
    conn.close()


def test_body_over_client_max_size_is_413(stack, monkeypatch):
    """A body over the size aiohttp's client_max_size allows is refused
    with aiohttp's text, and a Transfer-Encoding body with 501: each
    before a byte of it is read, the connection closed after."""
    monkeypatch.setattr(tgateway, "CLIENT_MAX_SIZE", 1000)
    conn, resp = _post(stack.host, stack.port, "/v1/completions",
                       raw=b"x" * 2000)
    assert resp.status == 413
    assert resp.getheader("X-Request-Id").startswith("req-")
    assert resp.read() == (b"Maximum request body size 1000 exceeded,"
                           b" actual body size 2000")
    conn.close()
    s = socket.create_connection((stack.host, stack.port), timeout=30)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
              b"Transfer-Encoding: chunked\r\n\r\n5\r\n{}   \r\n0\r\n\r\n")
    head = b""
    while b"\r\n\r\n" not in head:
        head += s.recv(4096)
    assert head.startswith(b"HTTP/1.1 501 Not Implemented\r\n"), head
    s.close()


def test_other_paths_and_methods_get_aiohttp_texts(stack):
    conn = http.client.HTTPConnection(stack.host, stack.port, timeout=30)
    conn.request("GET", "/nope")
    resp = conn.getresponse()
    assert (resp.status, resp.read()) == (404, b"404: Not Found")
    assert resp.getheader("X-Request-Id").startswith("req-")
    conn.request("GET", "/v1/completions")
    resp = conn.getresponse()
    assert (resp.status, resp.read()) == (405, b"405: Method Not Allowed")
    assert resp.getheader("Allow") == "POST"
    conn.close()


# --------------------------------------------------- parity with JAX


def _clock_ops(seed, n=400):
    rng = random.Random(seed)
    t, ops = 100.0, []
    for _ in range(n):
        t += rng.choice([0.0, 0.001, rng.random() * 0.2, rng.random() * 2])
        ops.append((t, rng.choice([1.0, 1.0, 0.5, 2.0])))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_matches_jax(seed):
    rng = random.Random(seed)
    rate, burst = rng.choice([0.0, 0.5, 3.0, 40.0]), \
        rng.choice([None, 0.0, 1.0, 5.0])
    mine, theirs = TokenBucket(rate, burst), jqos.TokenBucket(rate, burst)
    assert (mine.rate_rps, mine.burst) == (theirs.rate_rps, theirs.burst)
    for now, cost in _clock_ops(seed):
        assert mine.try_acquire(cost, now=now) == \
            theirs.try_acquire(cost, now=now), (now, cost)


def _admit_trace(mod, seed, monkeypatch):
    """Drive a gate of `mod` through a seeded admit / release / clock
    sequence: each admit's outcome (admitted, or the shed's cause and
    retry_after_s) and the gate's stats()."""
    rng = random.Random(seed)
    clock = SimpleNamespace(t=0.0)
    monkeypatch.setattr(mod, "time",
                        SimpleNamespace(monotonic=lambda: clock.t))

    class Router:
        def tenant_stats(self):
            return {"q": {"dispatched": rng_router.randrange(6)}}

    rng_router = random.Random(seed + 100)
    gate = mod.QosGate(
        api_keys={"k1": "a", "k2": "b"},
        policies={"a": mod.TenantPolicy(rate_rps=2.0, burst=2.0),
                  "b": mod.TenantPolicy(max_inflight=2, priority="batch"),
                  "q": mod.TenantPolicy(max_requests=4),
                  "z": mod.TenantPolicy(rate_rps=0.0, burst=0.0)},
        router=Router())
    held, out = [], []
    for _ in range(300):
        clock.t += rng.choice([0.0, 0.05, 0.3, 1.1])
        tenant = rng.choice(["a", "b", "q", "z", None, "other"])
        if held and rng.random() < 0.35:
            gate.release(held.pop(rng.randrange(len(held))))
            continue
        try:
            gate.admit(tenant, rng.choice(["interactive", "batch"]))
            held.append(tenant)
            out.append(("ok", tenant))
        except Exception as e:  # noqa: BLE001 — the shed is the outcome
            out.append((type(e).__name__, e.cause, e.retry_after_s, str(e)))
    out.append(gate.stats())
    out.append([gate.resolve(k, "hint") for k in (None, "k1", "k2")])
    out.append([gate.classify(t, r) for t in ("a", "b", None)
                for r in (None, "batch", "interactive")])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_qos_gate_matches_jax(seed, monkeypatch):
    assert _admit_trace(tqos, seed, monkeypatch) == \
        _admit_trace(jqos, seed, monkeypatch)
    for mod in (tqos, jqos):
        with pytest.raises(PermissionError):
            mod.QosGate(api_keys={"k": "t"}).resolve("nope")
        with pytest.raises(ValueError):
            mod.QosGate().classify(None, "urgent")
        with pytest.raises(ValueError):
            mod.TenantPolicy(priority="urgent")


def test_codec_and_sse_frame_match_jax():
    rng = random.Random(0)
    alphabet = "abc xyz\n\t{}\"'é漢字🙂\\"
    for vocab in (1, 3, 7, 256, 32000, 50257):
        mine, theirs = tgateway.ByteCodec(vocab), jgateway.ByteCodec(vocab)
        assert mine.vocab_size == theirs.vocab_size
        for _ in range(50):
            text = "".join(rng.choice(alphabet)
                           for _ in range(rng.randrange(0, 40)))
            toks = mine.encode(text)
            assert toks == theirs.encode(text)
            assert mine.decode(toks) == theirs.decode(toks)
            assert mine.decode(np.asarray(toks, np.int64)) == \
                theirs.decode(toks)
    for payload in (b"[DONE]", "[DONE]", {"a": [1, "é"], "b": None},
                    {"error": {"message": "x\ny"}}, [1, 2.5],
                    {"t": time}):
        assert tgateway._sse_frame(payload) == jgateway._sse_frame(payload)


def test_shed_outcome_matches_jax():
    for cause in ("deadline", "disconnect", "preempt", "preempted",
                  "capacity", "quota", "rate_limit", "failover",
                  "draining", None):
        e = RequestShedError("x", cause=cause or "capacity")
        if cause is None:
            del e.cause
        assert tqos.shed_outcome(e) == jqos.shed_outcome(e)
    assert tqos.CLASSES == jqos.CLASSES


def _norm(obj):
    """A JSON body or SSE frame without its per-request id and time."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


# one script of requests: (method, path, body or raw bytes, headers)
SCRIPT = [
    ("POST", "/v1/completions", b"{this is not json", {}),
    ("POST", "/v1/completions", {"model": "gpt-nope", "prompt": [1]}, {}),
    ("POST", "/v1/completions", {"model": "tiny", "prompt": {"no": 1}}, {}),
    ("POST", "/v1/completions", {"prompt": [1, 2], "max_tokens": "x"}, {}),
    ("POST", "/v1/completions", {"prompt": [1, 2], "priority": "urgent"},
     {}),
    ("POST", "/v1/chat/completions", {"messages": []}, {}),
    ("POST", "/v1/completions", {"prompt": [1, 2]},
     {"Authorization": "Bearer sk-wrong"}),
    ("POST", "/v1/completions", {"prompt": [1, 2]},
     {"Authorization": "Bearer sk-blocked"}),
    ("POST", "/v1/completions", {"prompt": [1, 2], "stream": True},
     {"Authorization": "Bearer sk-blocked"}),
    ("POST", "/v1/completions", [1, 2], {}),
    ("POST", "/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 12},
     {"Authorization": "Bearer sk-alpha"}),
    ("POST", "/v1/completions", {"prompt": "hello there",
                                 "max_tokens": 9, "stream": True},
     {"X-Tenant": "t1", "X-Priority": "batch"}),
    ("POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 7},
     {}),
    ("POST", "/v1/chat/completions",
     {"messages": [{"role": "system", "content": "be terse"},
                   {"content": "why?"}], "max_tokens": 6, "stream": True},
     {"traceparent": f"00-{'ab' * 16}-{'12' * 8}-01"}),
    ("POST", "/v1/completions", {"prompt": [3], "max_tokens": 5000}, {}),
    ("GET", "/v1/models", None, {}),
    ("GET", "/-/healthz", None, {}),
    ("GET", "/v1/completions", None, {}),
    ("GET", "/no/such/path", None, {}),
]


def _run_script(host, port):
    """Each request of SCRIPT on one keep-alive connection: (status,
    header names, body) with a JSON body normalized and an SSE body as
    its normalized frames."""
    conn = http.client.HTTPConnection(host, port, timeout=120)
    out = []
    for method, path, body, headers in SCRIPT:
        raw = body if isinstance(body, bytes) else (
            None if body is None else json.dumps(body))
        hdrs = dict(headers)
        if raw is not None:
            hdrs["Content-Type"] = "application/json"
        conn.request(method, path, raw, hdrs)
        resp = conn.getresponse()
        data = resp.read()
        names = sorted(k.lower() for k, _ in resp.getheaders())
        ctype = resp.getheader("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            frames = [ln[len(b"data: "):] for ln in data.split(b"\n\n")
                      if ln.startswith(b"data: ")]
            parsed = [f.decode() if f == b"[DONE]" else _norm(json.loads(f))
                      for f in frames]
        elif ctype.startswith("application/json"):
            parsed = _norm(json.loads(data))
        else:
            parsed = data.decode()
        rid = resp.getheader("X-Request-Id", "")
        out.append((method, path, resp.status, names,
                    resp.getheader("Retry-After"),
                    resp.getheader("X-Shed-Cause"),
                    rid.split("-", 1)[0], parsed))
    conn.close()
    return out


def _qos(mod, router):
    return mod.QosGate(
        api_keys={"sk-alpha": "alpha", "sk-blocked": "blocked"},
        policies={"blocked": mod.TenantPolicy(rate_rps=0.0, burst=0.0)},
        router=router)


def test_gateway_answers_a_script_like_jax(models):
    """The JAX gateway (aiohttp) and the port's (asyncio streams), each
    over its package's engine on the same weights, answer one script of
    requests with the same statuses, header names, shed headers and
    request-id prefixes, the same JSON bodies and the same SSE frames (ids
    and times aside); the greedy texts are identical. The one difference
    by design: /v1/models says who owns the model."""
    jp, tp = models
    results = {}
    for name, mod, eng, params, cfg, disagg_mod in (
            ("port", tgateway, ContinuousBatchingEngine, tp, CFG,
             tdisagg),
            ("jax", jgateway, JEngine, jp, JCFG, jdisagg)):
        engine = eng(params, cfg, max_batch=2)
        router = disagg_mod.DisaggRouter(colocated=engine,
                                         max_queue_depth=8)
        qmod = tqos if name == "port" else jqos
        gw = mod.GatewayServer(router, model="tiny",
                               vocab_size=cfg.vocab_size,
                               qos=_qos(qmod, router), max_tokens_cap=40)
        host, port = gw.ready()
        try:
            results[name] = (_run_script(host, port), gw.stats())
        finally:
            gw.stop()
            engine.stop()
    (mine, mstats), (theirs, jstats) = results["port"], results["jax"]
    assert len(mine) == len(theirs) == len(SCRIPT)
    for got, want in zip(mine, theirs):
        if got[1] == "/v1/models":
            want = want[:-1] + (_norm(json.loads(json.dumps(
                want[-1]).replace('"ray_tpu"', '"ray_tpu_torch"'))),)
        assert got == want, (got, want)
    # the texts are real decodes, not empty bodies
    assert mine[10][-1]["choices"][0]["text"].count(" ") == 11
    for key in ("accepted", "completed", "streamed", "rate_limited",
                "sheds", "errors", "tokens_out", "by_class", "by_code"):
        assert mstats[key] == jstats[key], key
    assert mstats["qos"] == jstats["qos"]
    assert sorted(mstats) == sorted(jstats)


def _cancel_after(k):
    """(cancel_event, on_tokens) that sets the event once k tokens came."""
    ev = threading.Event()
    seen = []

    def on_tokens(toks):
        seen.extend(toks)
        if len(seen) >= k:
            ev.set()

    return ev, on_tokens


@pytest.mark.parametrize("k", [1, 5])
def test_cancel_event_sheds_disconnect_like_jax_colocated(models, k):
    jp, tp = models
    results = []
    for eng, params, cfg, router_cls in (
            (ContinuousBatchingEngine, tp, CFG, DisaggRouter),
            (JEngine, jp, JCFG, jdisagg.DisaggRouter)):
        engine = eng(params, cfg, max_batch=2)
        router = router_cls(colocated=engine, max_queue_depth=8)
        ev, on_tokens = _cancel_after(k)
        try:
            with pytest.raises(Exception) as ei:
                router.generate([1, 2, 3], 64, on_tokens=on_tokens,
                                cancel_event=ev, token_sleep_s=0.01)
            assert type(ei.value).__name__ == "RequestShedError"
            assert ei.value.cause == "disconnect"
            assert _wait(lambda: engine.kv_stats()["cancelled_by_reason"]
                         .get("disconnect", 0) == 1, 10.0)
            results.append((router.stats()["sheds_by_cause"],
                            engine.kv_stats()["cancelled_by_reason"],
                            router.stats()["shed"],
                            router.stats()["completed"]))
        finally:
            engine.stop()
    assert results[0] == results[1]
    assert results[0][0] == {"disconnect": 1}


def test_cancel_event_sheds_disconnect_like_jax_disaggregated(models):
    """The disaggregated path: the router checks the event between chunk
    pulls and cancels the decode replica's stream under ``disconnect``;
    an event set before the request sheds it at its first attempt."""
    jp, tp = models
    results = []
    for pf_cls, dec_cls, router_cls, params, cfg, kw in (
            (PrefillServer, DecodeServer, DisaggRouter, tp, CFG,
             {"device": "cpu"}),
            (jdisagg.PrefillServer, jdisagg.DecodeServer,
             jdisagg.DisaggRouter, jp, JCFG, {})):
        pf = pf_cls(params, cfg, kv_block_size=BS, kv_pool_blocks=64, **kw)
        dec = dec_cls(params, cfg, max_batch=2, **kw)
        router = router_cls(decode=[dec], prefill=[pf], max_queue_depth=2,
                            affinity_tokens=BS)
        router.stream_chunk_tokens = 2
        ev, on_tokens = _cancel_after(3)
        try:
            with pytest.raises(Exception) as ei:
                router.generate([1, 2, 3, 4, 5], 200, on_tokens=on_tokens,
                                cancel_event=ev, token_sleep_s=0.01)
            assert ei.value.cause == "disconnect"
            assert _wait(lambda: dec.engine.kv_stats()[
                "cancelled_by_reason"].get("disconnect", 0) == 1, 10.0)
            assert _wait(lambda: dec.engine.active_slots == 0, 10.0)
            gone = threading.Event()
            gone.set()
            with pytest.raises(Exception) as ei:
                router.generate([7, 8], 8, cancel_event=gone)
            assert ei.value.cause == "disconnect"
            results.append((router.stats()["sheds_by_cause"],
                            dec.engine.kv_stats()["cancelled_by_reason"]))
        finally:
            dec.stop()
    assert results[0] == results[1]
    assert results[0][0] == {"disconnect": 2}


def test_preemption_counts_into_the_gateway_family(model):
    """A fired preemption adds one to ray_tpu_gateway_preemptions_total
    (the router's hook into the gateway's surface)."""
    fam = tqos.gateway_metrics()["preemptions"]
    before = sum(fam.series().values())
    engine = ContinuousBatchingEngine(model, CFG, max_batch=1)
    router = DisaggRouter(colocated=engine, max_queue_depth=0)
    try:
        first = threading.Event()
        out = {}

        def batch():
            out["b"] = router.generate([7, 8, 9], 300, priority="batch",
                                       on_tokens=lambda t: first.set())

        th = threading.Thread(target=batch, daemon=True)
        th.start()
        assert first.wait(60.0)
        assert router.generate([4, 5], 8, priority="interactive") == \
            engine.generate([4, 5], 8)
        th.join(120)
        assert out["b"] == engine.generate([7, 8, 9], 300)
    finally:
        engine.stop()
    assert router.stats()["preemptions"] == 1
    assert sum(fam.series().values()) == before + 1


# ------------------------------------------- surfaces against JAX's


def _strip_ts(obj):
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def _gateway_reports(h):
    rng = random.Random(5)
    for i in range(70):  # past the 64 snapshots kept
        h.report_gateway_stats(f"w{i % 3}", f"gateway-{i % 67}", {
            "role": "gateway", "accepted": rng.randrange(50),
            "completed": rng.randrange(50), "streamed": rng.randrange(9),
            "tokens_out": rng.randrange(999), "rate_limited": i % 4,
            "sheds": i % 3, "disconnects": i % 2, "errors": i % 5,
            "preemptions": i % 2,
            "by_class": {"interactive": {"accepted": i, "completed": i,
                                         "shed": 0, "disconnects": 1},
                         "batch": {"accepted": 2, "completed": 1,
                                   "shed": 1, "disconnects": 0}},
            "by_code": {"200": i, "429": i % 4, "499": i % 2}})
    h.report_gateway_stats("w", "bad", "not a dict")
    for i in range(10_020):
        h.report_gateway_event({"kind": ["accept", "first_byte", "preempt",
                                         "rate_limit", "disconnect"][i % 5],
                                "class": "batch" if i % 2 else
                                "interactive", "tenant": f"t{i % 3}",
                                "ttft_ms": 1.5 if i % 5 == 1 else None,
                                "ts": 100.0 + i})
    h.report_gateway_event("not a dict")
    h.report_gateway_event({"kind": "accept"})  # stamped on arrival


def test_conductor_gateway_surface_matches_jax(tmp_path):
    """The same gateway reports and events to both packages' conductor
    handlers give the same reads (receive times aside) and the same
    bounds."""
    from ray_tpu._private.conductor import ConductorHandler as JHandler
    from ray_tpu_torch._private.conductor import ConductorHandler as THandler

    th = THandler({"CPU": 2.0}, str(tmp_path / "t"))
    jh = JHandler({"CPU": 2.0}, str(tmp_path / "j"))
    for h in (th, jh):
        _gateway_reports(h)
    for read in (lambda h: h.get_gateway_status(),
                 lambda h: h.get_gateway_events(),
                 lambda h: h.get_gateway_events(7)):
        assert _strip_ts(read(th)) == _strip_ts(read(jh))
    assert len(th.get_gateway_events()) == 10_000
    assert th.get_gateway_status()["totals"]["gateways"] == 64
    for bound in ("_GATEWAY_EVENTS_KEPT", "_GATEWAY_STATS_KEPT"):
        assert getattr(th, bound) == getattr(jh, bound), bound


def test_gateway_lane_matches_jax():
    from ray_tpu.observability import timeline as jtimeline
    from ray_tpu_torch.observability import timeline as ttimeline

    events = [dict(ev, ts=100.0 + i) for i, ev in enumerate(
        [{"kind": "accept", "gateway": "g", "route": "chat",
          "class": "interactive", "tenant": "t1"},
         {"kind": "first_byte", "class": "batch", "ttft_ms": 12.5},
         {"kind": "preempt", "router": "r", "victim_tenant": None,
          "tokens_done": 7},
         {"kind": "rate_limit", "tenant": "t2", "cause": "quota",
          "class": "batch", "retry_after_s": 0.05},
         {"kind": "disconnect", "class": "interactive",
          "phase": "streaming", "tokens_sent": 3}])]
    events.append({"kind": "accept"})  # no ts: left out
    got = ttimeline.gateway_trace_events(events)
    assert got == jtimeline.gateway_trace_events(events)
    assert len(got) == 5 and all(e["pid"] == "gateway" for e in got)
    merged = ttimeline.merged_chrome_trace([], [], [],
                                           gateway_events=events)
    assert merged == jtimeline.merged_chrome_trace([], [], [],
                                                   gateway_events=events)
