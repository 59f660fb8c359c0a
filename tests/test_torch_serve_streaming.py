"""Streaming serve responses of the port (serve/replica.py's
`handle_request_streaming`, the handle's `StreamingDeploymentResponse`,
the proxy's chunked and SSE forwarding) against the JAX package's, on
the CPU.

Twins of 8 of the 9 cases of tests/test_serve_streaming.py, each a
function of `_private/deploy_checks.py` run with a cluster of its own
(`isolated.run_checks`), HTTP over `http.client`. The two engine-backed
replicas serve Llama tiny fp32 on JAX's `llama_init` weights converted
by `from_jax_params`; their streams must equal JAX's `stream_generate`
and JAX's `ContinuousBatchingEngine.stream` on the same weights and
prompts, token for token (greedy).

Not twinned: test_grpc_ingress_unary_and_streaming. The gRPC ingress
is not ported: the port's machines have no grpc package (ROADMAP Queue
1 item 3), so `HTTPOptions(grpc_port=...)` raises.

Parity: the proxy's `_encode_chunk`, raw and SSE, against JAX's.
"""
from __future__ import annotations

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.models.generate import stream_generate as jstream_generate
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import llama_init as jllama_init
from ray_tpu.serve import proxy as jproxy
from ray_tpu_torch._private import isolated
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.serve import proxy as tproxy

JCFG = dataclasses.replace(JLlamaConfig.tiny(), dtype=jnp.float32)
CLUSTER = {"num_cpus": 8}
CHECKS = {name: CLUSTER for name in (
    "stream_handle_first_token_latency",
    "stream_handle_method_and_asyncgen",
    "stream_handle_of_plain_value",
    "stream_handle_error_propagates",
    "stream_http_chunked",
    "stream_http_sse",
    "stream_llm_replica_streams_tokens",
    "stream_llm_continuous_batching_replica")}


@pytest.fixture(scope="module")
def jax_params():
    return jllama_init(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def outcomes(jax_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "llama_tiny.pt"
    torch.save(from_jax_params(jax.tree.map(np.asarray, jax_params),
                               device="cpu"), path)
    return isolated.run_checks(CHECKS, timeout=420.0,
                               inputs={"llama_weights": str(path)})


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_streaming_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def _value(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
    import json

    return json.loads(text)


def test_llm_replica_streams_equal_jax(outcomes, jax_params):
    """The replica's `stream_generate` tokens equal JAX's for the same
    weights and prompt."""
    want = [int(t[0]) for t in jstream_generate(
        jax_params, JCFG, jnp.asarray([[1, 2, 3, 4]], jnp.int32),
        max_new_tokens=6)]
    got = _value(outcomes, "stream_llm_replica_streams_tokens")["tokens"]
    assert got == want


def test_llm_continuous_batching_replica_streams_equal_jax(outcomes,
                                                           jax_params):
    """Three concurrent streams through one engine replica equal JAX's
    engine's, token for token."""
    engine = JEngine(jax_params, JCFG, max_batch=4)
    try:
        want = [[int(t) for t in engine.stream([i + 1, i + 2], 6)]
                for i in range(3)]
    finally:
        engine.stop()
    got = _value(outcomes, "stream_llm_continuous_batching_replica")
    assert got["streams"] == want


@pytest.mark.parametrize("seed", range(3))
def test_encode_chunk_matches_jax(seed):
    rng = random.Random(seed)
    items = ["tok ", "two\nlines\n", "", b"raw\nbytes", b"", {"k": [1, 2]},
             [1, "x"], 7, None, 2.5]
    for _ in range(50):
        word = "".join(rng.choice("ab \n{}\"") for _ in range(rng.randint(
            0, 12)))
        items.append(word)
        items.append(word.encode())
    for item in items:
        for sse in (False, True):
            assert tproxy._encode_chunk(item, sse) == \
                jproxy._encode_chunk(item, sse), (item, sse)
