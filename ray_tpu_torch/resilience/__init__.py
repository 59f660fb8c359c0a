"""Restart policy of the trainer's retry loop (port of the local part of
ray_tpu/resilience). Gang supervision, elastic re-form, preemption and
chaos wait for the port of the actor runtime."""
from .supervisor import backoff_delay

__all__ = ["backoff_delay"]
