"""Per-tenant online LoRA: adapter-only training against a frozen base,
published as weight-fabric deltas that hot-swap into serving (port of
ray_tpu/online/lora.py).

One :class:`TenantLoraTrainer` per tenant optimizes only its adapter's
A / B leaves (the base params are a constant of the loss, never updated,
never republished) and publishes the adapter tree under ``lora/<tenant>``
every ``publish_every`` steps. Every serving pool over a
`serve.lora.FabricAdapterSource` sees the notice, marks the tenant dirty
and hot-swaps the new version between decode ticks, without touching any
other tenant's requests. Versions continue after whatever the registry
holds (`online.loop.next_publish_version`). The objective is next-token
CE on the batches the caller feeds.

The step runs the model's own forward (`gpt2_forward` / `llama_forward`)
on `models.generate.merge_lora_params` of the base and the adapter: on a
bf16 CUDA base that is the flash attention kernels, forward and
backward. The optimizer is Adam with `optax.adam`'s semantics
(`train.optim.AdamW` with weight decay 0), its state on the base's
device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np


def _full_forward(config) -> Callable:
    from ..models.gpt2 import GPT2Config, gpt2_forward
    from ..models.llama import LlamaConfig, llama_forward

    if isinstance(config, LlamaConfig):
        return llama_forward
    if isinstance(config, GPT2Config):
        return gpt2_forward
    raise TypeError(f"no LoRA training support for {type(config).__name__}")


class TenantLoraTrainer:
    """Adapter-only trainer of one tenant.

    ``step(tokens)`` takes one ``[B, T]`` int batch, runs a next-token CE
    step whose gradients reach only the adapter's A / B leaves, and
    returns the loss. ``publish()`` ships the current adapter to the
    weight fabric; ``fit()`` is the step / publish cadence."""

    def __init__(self, base_params: Any, model_config: Any, tenant: str,
                 *, rank: int = 4, scale: float = 1.0,
                 learning_rate: float = 1e-2, publish_every: int = 2,
                 prefix: str = "lora/", seed: int = 0):
        import torch

        from ..models.generate import lora_targets
        from ..train.optim import AdamW
        from ..tree import tree_device, tree_map

        self.base_params = tree_map(lambda t: t.detach(), base_params)
        self.model_config = model_config
        self.tenant = str(tenant)
        self.rank = int(rank)
        self.scale = float(scale)
        self.publish_every = max(1, int(publish_every))
        self.prefix = prefix
        self.published_versions: List[int] = []
        self.losses: List[float] = []
        self._step = 0
        self.device = tree_device(self.base_params)
        layers = int(model_config.num_layers)
        rng = np.random.default_rng(seed)
        # A random, B zero: the adapter starts as an exact no-op
        self._ab: Dict[str, Dict[str, Any]] = {}
        for name, d_in, d_out in lora_targets(model_config):
            a = (rng.standard_normal((layers, d_in, self.rank)) * 0.02
                 ).astype(np.float32)
            self._ab[name] = {
                "a": torch.from_numpy(a).to(self.device).requires_grad_(),
                "b": torch.zeros((layers, self.rank, d_out),
                                 dtype=torch.float32,
                                 device=self.device).requires_grad_()}
        self._opt = AdamW(learning_rate, weight_decay=0.0)
        self._opt_state = self._opt.init(self._ab)
        self._forward = _full_forward(model_config)

    def _loss(self, tokens) -> Any:
        import torch

        from ..models.generate import merge_lora_params

        cfg = self.model_config
        merged = merge_lora_params(self.base_params, cfg,
                                   {"scale": self.scale, "targets": self._ab})
        logits = self._forward(merged, tokens[:, :-1], cfg)
        logp = torch.log_softmax(logits[..., :cfg.vocab_size], dim=-1)
        ll = logp.gather(-1, tokens[:, 1:, None])[..., 0]
        return -ll.mean()

    # ------------------------------------------------------------- steps

    def step(self, tokens) -> float:
        import torch

        from ..tree import tree_leaves

        tokens = torch.as_tensor(np.asarray(tokens, np.int64),
                                 device=self.device)
        loss = self._loss(tokens)
        grads = torch.autograd.grad(loss, tree_leaves(self._ab))
        self._opt.update_(grads, self._opt_state, self._ab)
        self._step += 1
        loss = float(loss.detach())
        self.losses.append(loss)
        return loss

    def adapter(self) -> Dict[str, Any]:
        """The current adapter as the host tree a serving pool pages
        (serve/lora.py's layout: numpy fp32)."""
        return {"scale": np.float32(self.scale),
                "targets": {name: {"a": ab["a"].detach().cpu().numpy(),
                                   "b": ab["b"].detach().cpu().numpy()}
                            for name, ab in self._ab.items()}}

    def publish(self, *, delta: bool = True) -> int:
        """Publish the current adapter under ``lora/<tenant>``; the
        committed version is appended to ``published_versions``."""
        from ..serve.lora import tenant_weights_name
        from ..weights import publish
        from .loop import next_publish_version

        name = tenant_weights_name(self.tenant, self.prefix)
        version = next_publish_version(name)
        publish(self.adapter(), name=name, version=version, delta=delta)
        self.published_versions.append(version)
        return version

    def fit(self, batches: Iterable[Any], num_steps: Optional[int] = None,
            delta: bool = True) -> Dict[str, Any]:
        """The step / publish cadence over `batches` ([B, T] token
        arrays): a publish every ``publish_every`` steps and one more at
        the end if steps remain unpublished."""
        steps_since_publish = 0
        for i, batch in enumerate(batches):
            if num_steps is not None and i >= num_steps:
                break
            self.step(batch)
            steps_since_publish += 1
            if steps_since_publish >= self.publish_every:
                self.publish(delta=delta)
                steps_since_publish = 0
        if steps_since_publish:
            self.publish(delta=delta)
        return {"tenant": self.tenant, "steps": self._step,
                "losses": list(self.losses),
                "published_versions": list(self.published_versions)}


__all__ = ["TenantLoraTrainer"]
