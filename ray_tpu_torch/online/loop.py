"""OnlineTrainer: the closed loop of a learner, sampler actors and a
rollout buffer, wired through the live weight fabric (port of
ray_tpu/online/loop.py).

The workload is online distillation: the learner trains the model to
imitate the completions its own samplers generate through the
continuous-batching engine, and publishes refreshed weights every
``publish_every`` steps through ``train.report(publish_weights=...,
weights_delta=True)``: a delta publication ships only the leaves the
optimizer moved, the samplers' prefetch pulls them while their engines
still decode the old version, and the hot swap lands between decode
ticks. The positional embedding is frozen (``frozen_leaves``), so every
delta skips it.

The loop's invariant: sampler staleness stays <= 1 version while the
learner steps, because a due publication waits (the learner keeps
stepping) until every sampler serves the last one.

The learner. JAX runs `TrainStep` over a mesh of every local device. The
port runs the learner under `train.TorchTrainer` in its ``spmd`` mode, in
the driver, on one device: the one-device `train.step.TrainStep` (the
mesh form on one rank gives the same losses bit for bit, as
tests/test_torch_parallel_gang.py holds). Its loss is `gpt2_hidden`
(whose attention is `ops.attention.flash_attention`: the flash kernels
on a bf16 CUDA batch), then a plain fp32 product against ``wte``,
``log_softmax`` and a masked mean, as JAX's: no fused-CE kernel. Its
optimizer is `train.optim.frozen_adam`: ``optax.multi_transform({"train":
adam, "freeze": set_to_zero})``'s semantics.

Where the port differs: `OnlineTrainer` takes ``device=`` (the
learner's; CUDA unless the caller asks for the CPU), ``sampler_device=``
(a sampler on CUDA holds one whole GPU) and ``sampler_class=`` (a
`RolloutSampler` subclass).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import _notify
from .buffer import RolloutBuffer, from_rollouts
from .sampler import RolloutSampler, spawn_samplers


@dataclass
class OnlineConfig:
    """Knobs of the online loop (tiny defaults: production runs scale
    num_samplers / batch_size / num_steps, not the structure)."""

    num_samplers: int = 2
    num_steps: int = 16
    batch_size: int = 8
    publish_every: int = 2          # learner steps between publishes
    delta: bool = True              # delta-publish refreshed weights
    # defer a due publish while any sampler still serves an older
    # version than the last one published (the learner keeps stepping);
    # max_publish_skips bounds the deferral so a dead sampler cannot
    # silence publication
    gate_on_staleness: bool = True
    max_publish_skips: int = 50
    buffer_capacity: int = 64
    max_new_tokens: int = 12
    max_prompt_len: int = 8
    sampler_max_batch: int = 2
    sampler_prefetch: bool = True
    learning_rate: float = 1e-3
    weights_name: str = "online"
    # top-level param keys the optimizer never moves: delta publication
    # skips them
    frozen_leaves: tuple = ("wpe",)
    seed: int = 0


@dataclass
class OnlineResult:
    """fit()'s result: the learner's metrics, each sampler's final stats
    (with its staleness high-water mark), the buffer's totals and the
    registry's listing of the weight set."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    sampler_stats: List[Dict[str, Any]] = field(default_factory=list)
    buffer_stats: Dict[str, Any] = field(default_factory=dict)
    weight_versions: Dict[str, Any] = field(default_factory=dict)
    max_staleness_versions: Optional[int] = None
    error: Optional[BaseException] = None


def _pad_batch(rollouts: List[Dict[str, Any]], seq_len: int
               ) -> Dict[str, np.ndarray]:
    """Rollouts as fixed-shape LM arrays: tokens = prompt + completion
    padded to seq_len, targets = the next token, mask = 1 on the
    predictions of completion tokens only."""
    n = len(rollouts)
    tokens = np.zeros((n, seq_len), np.int32)
    mask = np.zeros((n, seq_len - 1), np.float32)
    versions = np.zeros(n, np.int64)
    for i, r in enumerate(rollouts):
        seq = np.concatenate([r["prompt"], r["completion"]])[:seq_len]
        tokens[i, :len(seq)] = seq
        p = len(r["prompt"])
        # predictions at p-1 .. len(seq)-2 produce the completion
        mask[i, p - 1:len(seq) - 1] = 1.0
        versions[i] = int(r.get("weights_version") or 0)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "mask": mask, "versions": versions}


def _collate(rollouts: List[Dict[str, Any]], seq_len: int
             ) -> Dict[str, Any]:
    """`_pad_batch` as CPU tensors (int64 token ids; the versions stay a
    numpy array): the learner's batch, moved to its device by the
    step."""
    import torch

    b = _pad_batch(rollouts, seq_len)
    return {"tokens": torch.from_numpy(b["tokens"].astype(np.int64)),
            "targets": torch.from_numpy(b["targets"].astype(np.int64)),
            "mask": torch.from_numpy(b["mask"]),
            "versions": b["versions"]}


def next_publish_version(name: str) -> int:
    """The version a new publisher of `name` starts at: after whatever the
    registry holds, so a second (or restarted) publisher never collides
    with an existing version."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called before "
                           "publishing weights")
    return int(w.conductor.call("weights_latest_version", name,
                                timeout=10.0) or 0) + 1


def _distill_loss_fn(model_config) -> Callable:
    """Masked next-token CE over the completion region: imitate the
    sampler's greedy tokens."""
    import torch

    from ..models.gpt2 import gpt2_hidden
    from ..ops.layers import fp32_logits

    def loss_fn(params, batch):
        x = gpt2_hidden(params, batch["tokens"], model_config)
        logits = fp32_logits(x, params["wte"].T)
        logits = logits[..., :model_config.vocab_size]
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, batch["targets"][..., None])[..., 0]
        mask = batch["mask"]
        return -(ll * mask).sum() / mask.sum().clamp_min(1.0)

    return loss_fn


class OnlineTrainer:
    """A learner in the driver with N sampler actors over one weight-set
    name: the online-distillation loop end to end."""

    def __init__(self, model_config: Any = None, *,
                 config: Optional[OnlineConfig] = None,
                 run_config: Any = None,
                 optimizer: Any = None,
                 prompt_fn: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 device: Any = "cuda",
                 sampler_device: Any = "cuda",
                 sampler_class: type = RolloutSampler):
        from ..device import resolve_device

        if model_config is None:
            import dataclasses

            import torch

            from ..models.gpt2 import GPT2Config

            model_config = dataclasses.replace(GPT2Config.tiny(),
                                               dtype=torch.float32)
        self.model_config = model_config
        self.config = config or OnlineConfig()
        self.run_config = run_config
        self.optimizer = optimizer
        self.prompt_fn = prompt_fn
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.sampler_device = str(sampler_device)
        self.sampler_class = sampler_class

    # ------------------------------------------------------------ pieces

    def _make_optimizer(self):
        if self.optimizer is not None:
            return self.optimizer
        from ..train.optim import frozen_adam

        return frozen_adam(self.config.learning_rate,
                           self.config.frozen_leaves)

    def _seq_len(self) -> int:
        return min(self.model_config.max_seq_len,
                   self.config.max_prompt_len + self.config.max_new_tokens)

    def _init_params(self, device: Any):
        import torch

        from ..models.gpt2 import gpt2_init

        return gpt2_init(self.model_config,
                         torch.Generator().manual_seed(self.config.seed),
                         device=device)

    def _model_factory(self):
        """What the sampler actors run: template params on the CPU (the
        sampler moves them to its device) and the model config."""
        model_config = self.model_config
        seed = self.config.seed

        def factory():
            import torch

            from ray_tpu_torch.models.gpt2 import gpt2_init

            return (gpt2_init(model_config,
                              torch.Generator().manual_seed(seed),
                              device="cpu"), model_config)

        return factory

    def _default_prompt_fn(self):
        from .sampler import default_prompt_fn

        return default_prompt_fn(self.model_config.vocab_size,
                                 max_len=self.config.max_prompt_len)

    # --------------------------------------------------------------- fit

    def fit(self) -> OnlineResult:
        import ray_tpu_torch as rt

        from .. import weights as wts
        from ..train import RunConfig, TorchTrainer

        cfg = self.config
        # the starting point both sides share, published in full before
        # any sampler exists, numbered after whatever the registry holds
        start_version = next_publish_version(cfg.weights_name)
        wts.publish(self._init_params(self.device), name=cfg.weights_name,
                    version=start_version)
        buffer = rt.remote(RolloutBuffer).remote(cfg.buffer_capacity,
                                                 name=cfg.weights_name)
        samplers = spawn_samplers(
            cfg.num_samplers, cfg.weights_name, self._model_factory(),
            buffer, actor_options=(
                {"num_gpus": 1} if self.sampler_device.startswith("cuda")
                else None),
            actor_class=self.sampler_class,
            max_new_tokens=cfg.max_new_tokens,
            max_batch=cfg.sampler_max_batch,
            min_version=start_version,
            prompt_fn=self.prompt_fn or self._default_prompt_fn(),
            prefetch=cfg.sampler_prefetch, seed=cfg.seed,
            device=self.sampler_device)
        out = OnlineResult()
        try:
            rt.get([s.start.remote() for s in samplers], timeout=300.0)
            seq_len = self._seq_len()
            stream = from_rollouts(
                buffer, batch_size=cfg.batch_size,
                collate_fn=lambda rs: _collate(rs, seq_len))
            trainer = TorchTrainer(
                self._train_fn(start_version),
                datasets={"rollouts": stream},
                run_config=self.run_config
                or RunConfig(name=f"online/{cfg.weights_name}"))
            result = trainer.fit()
            out.metrics = result.metrics
            out.metrics_history = result.metrics_history
            out.error = result.error
        finally:
            for s in samplers:
                try:
                    out.sampler_stats.append(rt.get(s.stop.remote(),
                                                    timeout=60.0))
                except Exception:  # noqa: BLE001 — the sampler died
                    pass
                try:
                    rt.kill(s)
                except Exception:  # noqa: BLE001 — already gone
                    pass
            try:
                out.buffer_stats = rt.get(buffer.stats.remote(),
                                          timeout=30.0)
            except Exception:  # noqa: BLE001 — the buffer died
                pass
            try:
                rt.kill(buffer)
            except Exception:  # noqa: BLE001 — already gone
                pass
        stale = [s.get("max_staleness_versions") for s in out.sampler_stats
                 if s.get("max_staleness_versions") is not None]
        out.max_staleness_versions = max(stale) if stale else None
        try:
            from ..util import state

            out.weight_versions = state.weight_versions(cfg.weights_name)
        except Exception:  # noqa: BLE001 — the cluster is down already
            pass
        return out

    def _train_fn(self, start_version: int = 1) -> Callable:
        """The learner (under TorchTrainer's session): the one-device
        TrainStep, batches from the rollout shard with the wait accounted
        as data_wait, the params delta-published every K steps."""
        cfg = self.config
        optimizer = self._make_optimizer()
        loss_fn = self.loss_fn or _distill_loss_fn(self.model_config)
        weights_name = cfg.weights_name
        device = self.device
        init_params = self._init_params

        def train_fn(_tcfg):
            from .. import train
            from ..train.step import TrainStep

            step_fn = TrainStep(loss_fn, optimizer, device=device)
            state = step_fn.init_state(init_params(device))
            shard = train.get_dataset_shard("rollouts")
            batches = shard.iter_batches()
            timer = train.get_step_timer()
            ingested_rollouts = 0
            ingested_tokens = 0
            # the initial full publish went out before the samplers
            # spawned; the learner numbers its publications after it
            published = start_version
            publish_due = False
            publish_skips = 0
            ctx = train.get_context()
            for s in range(1, cfg.num_steps + 1):
                with timer.phase("data_wait"):
                    batch = next(batches)
                versions = batch.pop("versions")
                ingested_rollouts += int(versions.shape[0])
                ingested_tokens += int(batch["mask"].sum())
                state, aux = step_fn(state, batch)
                loss = float(aux["loss"])
                _learner_telemetry(
                    ctx, kind="ingest", step=s,
                    rollouts=int(versions.shape[0]),
                    min_version=int(versions.min()),
                    max_version=int(versions.max()))
                metrics = {"step": s, "loss": loss,
                           "ingested_rollouts": ingested_rollouts,
                           "ingested_tokens": ingested_tokens}
                publish_due = publish_due or s % cfg.publish_every == 0
                gated = (publish_due and cfg.gate_on_staleness
                         and publish_skips < cfg.max_publish_skips
                         and not _samplers_caught_up(published,
                                                     weights_name))
                if publish_due and not gated:
                    # versions number publications consecutively, so
                    # staleness counts publications behind
                    train.report(metrics,
                                 publish_weights=state["params"],
                                 weights_name=weights_name,
                                 weights_delta=cfg.delta,
                                 weights_version=published + 1)
                    published += 1
                    publish_due = False
                    publish_skips = 0
                    _learner_telemetry(ctx, kind="publish", step=s,
                                       version=published, delta=cfg.delta)
                else:
                    if gated:
                        publish_skips += 1
                    train.report(metrics)
                _learner_stats(ctx, steps=s, last_loss=loss,
                               ingested_rollouts=ingested_rollouts,
                               ingested_tokens=ingested_tokens,
                               published_version=published,
                               publish_skips=publish_skips)

        return train_fn


def _samplers_caught_up(last_version: int, weights_name: str,
                        max_age_s: float = 10.0) -> bool:
    """Every live sampler of this loop serves `last_version` or newer:
    the publication gate. Only recent snapshots of this weight set count
    (an errored or silent sampler must not gate the learner); an
    unreachable conductor reads as caught up (the gate never deadlocks
    the learner)."""
    import time

    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        return True
    try:
        st = w.conductor.call("get_online_status", timeout=5.0)
    except Exception:  # noqa: BLE001 — conductor mid-restart
        return True
    now = time.time()
    for s in (st.get("samplers") or {}).values():
        if s.get("weights_name") != weights_name:
            continue
        if s.get("run_error") or now - s.get("ts", now) > max_age_s:
            continue
        v = s.get("serving_version")
        if v is not None and v < last_version:
            return False
    return True


def _learner_stats(ctx, **stats) -> None:
    from .metrics import online_metrics

    prev = getattr(ctx, "_online_ingested", 0)
    cur = stats.get("ingested_rollouts", prev)
    if cur > prev:
        online_metrics()["ingested_rollouts"].inc(
            cur - prev, tags={"run": ctx.run_id})
    ctx._online_ingested = cur
    _notify.push_stats(f"learner/{ctx.run_id}",
                       dict(stats, role="learner", run_id=ctx.run_id))


def _learner_telemetry(ctx, **event) -> None:
    _notify.event(dict(event, run_id=ctx.run_id))


__all__ = ["OnlineConfig", "OnlineResult", "OnlineTrainer",
           "next_publish_version"]
