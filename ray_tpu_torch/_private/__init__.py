"""The port's runtime internals (ids, flag table, serialization, object
store, refcounts, rpc, worker spawning, the worker and the conductor)."""
