"""Sampler actors: the generating half of the online loop (port of
ray_tpu/online/sampler.py).

Each sampler is one actor process holding a ``ContinuousBatchingEngine``
behind a ``WeightSync``: the engine decodes rollouts while the sync
thread prefetches each newly published version's chunks and hot-swaps it
between decode ticks. Generation never restarts; a request in flight
continues under the new weights from the next tick on.

A rollout is a small host-side dict::

    {"prompt": int32[...], "completion": int32[...],
     "scores": float32[...],             # per-token logprobs
     "weights_version": int,             # serving when it completed
     "weights_version_start": int,       # serving when it was submitted
     "sampler": str, "ts": float}

Completed rollouts go to the :class:`RolloutBuffer`; a full buffer
rejects the overflow and the sampler holds it and pauses generation until
it lands.

Where the port differs: the sampler takes ``device=`` (CUDA unless the
caller asks for the CPU; the template params are moved there, so the
engine serves on that device), and ``spawn_samplers`` takes
``actor_options`` (e.g. ``{"num_gpus": 1}`` for a sampler that holds a
whole card) and ``actor_class`` (a subclass of :class:`RolloutSampler`).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import _notify
from .metrics import online_metrics


def default_prompt_fn(vocab_size: int, min_len: int = 2,
                      max_len: int = 8) -> Callable:
    """Random-token prompts within the model's vocabulary (the default of
    both RolloutSampler and OnlineTrainer)."""

    def prompt_fn(rng: np.random.Generator) -> List[int]:
        n = int(rng.integers(min_len, max_len + 1))
        return rng.integers(1, max(2, int(vocab_size)), size=n).tolist()

    return prompt_fn


class RolloutSampler:
    """Actor body of one sampler (:func:`spawn_samplers`, or
    ``rt.remote(RolloutSampler).remote(...)``).

    `model_factory()` runs inside the actor and returns
    ``(template_params, config)``: the template's dtypes are the
    sampler's serving layout (its leaves are moved to `device`), `config`
    any family the engine knows (GPT2Config, LlamaConfig)."""

    def __init__(self, sampler_id: str, weights_name: str,
                 model_factory: Callable[[], Any], buffer: Any, *,
                 max_new_tokens: int = 16,
                 eos_token: Optional[int] = None,
                 min_version: int = 1,
                 wait_timeout_s: float = 120.0,
                 max_batch: int = 2,
                 prompt_fn: Optional[Callable] = None,
                 seed: int = 0,
                 poll_interval_s: float = 0.05,
                 prefetch: bool = True,
                 device: Any = "cuda"):
        from .. import weights as wts
        from ..device import resolve_device
        from ..models.engine import ContinuousBatchingEngine
        from ..tree import tree_map

        self.sampler_id = sampler_id
        self.weights_name = weights_name
        self.buffer = buffer
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = eos_token
        self._rng = np.random.default_rng(seed)
        dev = resolve_device(device)
        template, self.config = model_factory()
        template = tree_map(lambda t: t.to(dev), template)
        self.prompt_fn = prompt_fn or default_prompt_fn(
            getattr(self.config, "vocab_size", 256))
        # the learner publishes the first version before samplers spawn:
        # wait for it rather than serve uninitialized weights
        self._sub = wts.WeightSubscriber(weights_name)
        version = self._sub.wait_for_version(min_version,
                                             timeout=wait_timeout_s)
        params = self._sub.fetch(version=version, like=template)
        del template
        self.engine = ContinuousBatchingEngine(
            params, self.config, max_batch=max_batch,
            params_version=version)
        self.sync = wts.WeightSync(
            self.engine, weights_name, consumer=sampler_id,
            poll_interval_s=poll_interval_s, subscriber=self._sub,
            prefetch=prefetch)
        self.rollouts = 0
        self.rollout_tokens = 0
        self.backpressure_waits = 0
        self._seen_version = version
        # the staleness high-water mark, probed at every rollout boundary
        self.max_staleness: Optional[int] = None
        self._held: List[Dict[str, Any]] = []  # rejected, awaiting retry
        self.run_error: Optional[str] = None   # why the loop died, if it did
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_push = 0.0

    # ---------------------------------------------------------- lifecycle

    def start(self) -> bool:
        """Begin the rollout loop on a thread (the actor's RPC loop stays
        free for status() / stop())."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"sampler-{self.sampler_id}")
            self._thread.start()
        return True

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        self.sync.stop()  # closes the shared subscriber too
        self.engine.stop()
        st = self.status()
        self._push_telemetry(force=True)
        return st

    # --------------------------------------------------------------- loop

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self._held:
                    # backpressure: retry before generating anything new;
                    # telemetry still pushes (the learner's publication
                    # gate reads serving_version from it)
                    if not self._flush():
                        self.backpressure_waits += 1
                        self._push_telemetry()
                        self._stop.wait(0.02)
                        continue
                self._held.append(self._rollout_one())
                self._flush()
                self._push_telemetry()
            except Exception as e:  # noqa: BLE001 — a dead loop must show:
                # record the cause, push a last snapshot, stop
                self.run_error = f"{type(e).__name__}: {e}"
                self._push_telemetry(force=True)
                return

    def _rollout_one(self) -> Dict[str, Any]:
        prompt = list(self.prompt_fn(self._rng))
        version_start = self.engine.params_version
        stream = self.engine.stream(prompt, self.max_new_tokens,
                                    self.eos_token)
        completion = list(stream)
        scores = stream.scores
        version = self.engine.params_version
        self.rollouts += 1
        self.rollout_tokens += len(completion)
        m = online_metrics()
        m["rollouts"].inc(1, tags={"sampler": self.sampler_id})
        m["rollout_tokens"].inc(len(completion),
                                tags={"sampler": self.sampler_id})
        _notify.event({"kind": "rollout", "sampler": self.sampler_id,
                       "tokens": len(completion),
                       "weights_version": version})
        if version is not None and version != self._seen_version:
            # the sync swapped while this rollout decoded
            _notify.event({"kind": "swap", "sampler": self.sampler_id,
                           "from_version": self._seen_version,
                           "to_version": version})
            self._seen_version = version
        return {"prompt": np.asarray(prompt, np.int32),
                "completion": np.asarray(completion, np.int32),
                "scores": np.asarray(scores, np.float32),
                "weights_version": version,
                "weights_version_start": version_start,
                "sampler": self.sampler_id, "ts": time.time()}

    def _flush(self) -> bool:
        """Push held rollouts to the buffer; True when all landed."""
        import ray_tpu_torch as rt

        if not self._held:
            return True
        accepted = rt.get(self.buffer.put.remote(list(self._held)),
                          timeout=60.0)
        del self._held[:accepted]
        return not self._held

    # ---------------------------------------------------------- telemetry

    def status(self) -> Dict[str, Any]:
        sync = self.sync.status()
        # fold the sync loop's staleness samples into the high-water mark
        for st in (sync["staleness_versions"],
                   sync["max_staleness_versions"]):
            if st is not None:
                self.max_staleness = st if self.max_staleness is None \
                    else max(self.max_staleness, st)
        return {
            "role": "sampler", "sampler": self.sampler_id,
            "weights_name": self.weights_name,
            "rollouts": self.rollouts,
            "rollout_tokens": self.rollout_tokens,
            "held": len(self._held),
            "backpressure_waits": self.backpressure_waits,
            "run_error": self.run_error,
            "max_staleness_versions": self.max_staleness,
            "serving_version": sync["serving_version"],
            "latest_version": sync["latest_version"],
            "staleness_versions": sync["staleness_versions"],
            "registry_reachable": sync["registry_reachable"],
            "swap_count": sync["swap_count"],
            "prefetch_bytes": sync["prefetch_bytes"],
            "rpc_bytes": sync["rpc_bytes"],
            "shm_bytes": sync["shm_bytes"],
            "fetched_bytes": sync["fetched_bytes"],
        }

    def _push_telemetry(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_push < 0.25:
            return
        self._last_push = now
        _notify.push_stats(f"sampler/{self.sampler_id}", self.status())


def spawn_samplers(num_samplers: int, weights_name: str,
                   model_factory: Callable[[], Any], buffer: Any, *,
                   name_prefix: str = "sampler",
                   actor_options: Optional[Dict[str, Any]] = None,
                   actor_class: type = RolloutSampler,
                   **sampler_kwargs) -> List[Any]:
    """N sampler actors (a process each) on one weight set and one
    buffer; each gets its own sampler id and rng seed. `actor_options`
    go to the actor's `.options()` (e.g. ``{"num_gpus": 1}``)."""
    import ray_tpu_torch as rt

    base_seed = int(sampler_kwargs.pop("seed", 0))
    actor_cls = rt.remote(actor_class)
    if actor_options:
        actor_cls = actor_cls.options(**actor_options)
    return [actor_cls.remote(
        f"{name_prefix}-{i}", weights_name, model_factory, buffer,
        seed=base_seed + i, **sampler_kwargs)
        for i in range(num_samplers)]


__all__ = ["RolloutSampler", "default_prompt_fn", "spawn_samplers"]
