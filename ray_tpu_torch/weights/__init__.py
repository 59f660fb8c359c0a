"""ray_tpu_torch.weights: the live weight fabric (port of ray_tpu/weights).

Versioned, sharded, in-memory train -> serve weight publication:

- **Producer** (:class:`WeightPublisher` / :func:`publish`): each
  process publishes only its own shards (a DTensor's local block, a
  plain tensor whole from process 0) as chunks in its own object store,
  plus a metadata-only fragment to the conductor's version registry.
  No gather, ever. A CUDA tensor is copied to the host once, at publish
  time; bf16 travels as its bits.
- **Registry** (the conductor): commits a version when the last host's
  fragment lands, keeps the newest K versions (``weights_keep``), reaps
  publishes torn by a producer's death (``weights_publish_ttl_s``) and
  tells producers which chunks to free on the ``weights`` channel.
- **Consumer** (:class:`WeightSubscriber`): reshard-on-fetch, the
  ``restore(like=)`` contract of the port's checkpoints, so a dp/fsdp
  training layout feeds a tp serving layout with no full copy.
- **Serving** (:class:`WeightSync`): hot-swaps a continuous-batching
  engine's params between decode ticks.

The JAX package's weights/metrics.py numbers (publish time, fetched
bytes, staleness in versions) are kept on the publisher, subscriber and
sync objects (`stats()`); their Prometheus side waits for the port of
`util/metrics.py`. Registry views:
``util.state.weight_versions()`` and the conductor's weight events.
"""
from .publisher import WeightPublisher, leaf_content_hashes, publish
from .subscriber import FetchStats, WeightSubscriber
from .sync import WeightSync

__all__ = ["FetchStats", "WeightPublisher", "WeightSubscriber",
           "WeightSync", "leaf_content_hashes", "publish"]
