"""Parity of the PyTorch port's GPT-2 (ray_tpu_torch.models.gpt2) with
the JAX package's, on the CPU, plus the port's isolation rules.

`GPT2Config.tiny()` at fp32, JAX parameters carried over with
`from_jax_params`, the same numpy tokens into both. Tolerance atol/rtol
1e-4 on fp32 logits and loss: the two frameworks sum in different
orders over d_model and the vocab, nothing else differs.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import from_jax_params

JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype=torch.float32)
TOL = dict(atol=1e-4, rtol=1e-4)
PKG = pathlib.Path(__file__).resolve().parents[1] / "ray_tpu_torch"


@pytest.fixture(scope="module")
def params():
    jp = jgpt2.gpt2_init(JCFG, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _tokens(seed, shape, vocab=JCFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def test_config_matches_jax():
    for name in ("small", "medium", "tiny"):
        j, t = getattr(jgpt2.GPT2Config, name)(), \
            getattr(tgpt2.GPT2Config, name)()
        assert (t.vocab_size, t.max_seq_len, t.num_layers, t.num_heads,
                t.d_model, t.head_dim, t.padded_vocab) == \
            (j.vocab_size, j.max_seq_len, j.num_layers, j.num_heads,
             j.d_model, j.head_dim, j.padded_vocab)
    assert tgpt2.GPT2Config.small().padded_vocab == 50304
    assert tgpt2.GPT2Config().dtype == torch.bfloat16


def test_params_keep_the_jax_layout(params):
    jp, tp = params
    jl = jax.tree_util.tree_leaves_with_path(jp)
    init = tgpt2.gpt2_init(TCFG, torch.Generator().manual_seed(0),
                           device="cpu")
    for path, leaf in jl:
        node_t, node_i = tp, init
        for key in path:
            k = key.key if hasattr(key, "key") else key.idx
            node_t, node_i = node_t[k], node_i[k]
        assert tuple(node_t.shape) == tuple(leaf.shape) == \
            tuple(node_i.shape), path
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))


def test_bf16_params_convert_bit_exact():
    a = jnp.asarray([[1.5, -2.25], [3e-3, 7.0]], jnp.bfloat16)
    t = from_jax_params({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


def test_forward_and_loss_match_jax(params):
    jp, tp = params
    tok = _tokens(1, (2, 64))
    tgt = _tokens(2, (2, 64))
    want = jgpt2.gpt2_forward(jp, jnp.asarray(tok, jnp.int32), JCFG)
    with torch.inference_mode():
        got = tgpt2.gpt2_forward(tp, torch.from_numpy(tok), TCFG)
        assert got.shape == (2, 64, TCFG.padded_vocab)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for rows in (1 << 30, 32):  # one chunk, and four
            wl = jgpt2.gpt2_loss(jp, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(tgt, jnp.int32), JCFG,
                                 loss_chunk_rows=rows)
            tl = tgpt2.gpt2_loss(tp, torch.from_numpy(tok),
                                 torch.from_numpy(tgt), TCFG,
                                 loss_chunk_rows=rows)
            np.testing.assert_allclose(float(tl), float(wl), **TOL)


def test_cached_prefill_and_decode_match_jax(params):
    jp, tp = params
    b, t0, steps = 2, 10, 4
    prompt = _tokens(3, (b, t0))
    jcache = jgpt2.gpt2_init_kv_cache(JCFG, b)
    tcache = tgpt2.gpt2_init_kv_cache(TCFG, b, device="cpu")
    with torch.inference_mode():
        jl, jcache = jgpt2.gpt2_forward_cached(
            jp, jnp.asarray(prompt, jnp.int32), JCFG, jcache, 0)
        tl, tcache = tgpt2.gpt2_forward_cached(
            tp, torch.from_numpy(prompt), TCFG, tcache, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        # ragged positions: row 1 decodes two rows behind row 0
        pos = np.array([t0, t0 - 2])
        for i in range(steps):
            tok = _tokens(10 + i, (b,))
            jl, jcache = jgpt2.gpt2_decode(
                jp, jnp.asarray(tok, jnp.int32), JCFG, jcache,
                jnp.asarray(pos + i, jnp.int32))
            tl, tcache = tgpt2.gpt2_decode(
                tp, torch.from_numpy(tok), TCFG, tcache,
                torch.from_numpy(pos + i))
            assert tl.shape == (b, TCFG.padded_vocab)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for jb, tb in zip(jcache, tcache):
            np.testing.assert_allclose(tb["k"].numpy(),
                                       np.asarray(jb["k"]), **TOL)


def test_entry_points_without_device_raise_when_cuda_is_missing():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt2.gpt2_init(TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt2.gpt2_init_kv_cache(TCFG, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_params({"w": np.zeros(2, np.float32)})


def test_port_imports_neither_jax_nor_ray_tpu():
    mods = sorted(
        "ray_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib')) or m == 'ray_tpu' or "
              "m.startswith('ray_tpu.'))\n"
              "print(len(sys.modules), bad)\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 9


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG.parent)) for p in
    list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]))
def test_port_sources_reference_no_jax_package(path):
    src = (PKG.parent / path).read_text()
    # `\b` never falls inside "ray_tpu_torch", so the port's own name
    # does not match
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|ray_tpu)\b|\bray_tpu\.", re.MULTILINE)
    hits = [m.group(0) for m in banned.finditer(src)]
    assert not hits, (path, hits)
