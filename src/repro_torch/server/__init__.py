"""repro_torch.server — production multi-experiment pool service.

The networked tier of the paper's NodIO server: an asyncio HTTP/JSON
frontend speaking the JSON wire protocol of the follow-up paper
("Asynchronous Distributed GAs with Javascript and JSON",
arXiv:2401.17234) over per-experiment namespaces, each backed by the
in-process :class:`~repro_torch.core.async_pool.PoolServer` (WAL journal,
named ``get_since`` cursors, server-side acceptance registry) and
sharded behind consistent hashing.

Public API:
    wire            — verb shapes + JSON (de)serialization (the protocol)
    PoolService     — transport-independent multi-experiment core
    ExperimentConfig— per-namespace capacity/shards/acceptance/seed
    PoolHTTPServer  — asyncio HTTP/1.1 frontend (rate limit+backpressure)
    background_server — run a frontend on a thread (tests/examples)
    RemotePoolServer— blocking wire client with the PoolServer verb
                      surface (drop-in for Host/AsyncHostBridge)
    AsyncWireClient — asyncio wire client (volunteer load harness)

Attributes resolve lazily (PEP 562): the service side pulls in
``repro_torch.core`` (and therefore torch), but a pure client — e.g. a load
harness worker importing only :class:`AsyncWireClient` — must not pay
that import in every volunteer process.

Start a service from the shell:  python -m repro_torch.server --port 8040
"""
_EXPORTS = {
    "wire": ("repro_torch.server.wire", None),
    "AsyncWireClient": ("repro_torch.server.client", "AsyncWireClient"),
    "RemotePoolServer": ("repro_torch.server.client", "RemotePoolServer"),
    "PoolHTTPServer": ("repro_torch.server.http", "PoolHTTPServer"),
    "background_server": ("repro_torch.server.http", "background_server"),
    "RateLimiter": ("repro_torch.server.ratelimit", "RateLimiter"),
    "TokenBucket": ("repro_torch.server.ratelimit", "TokenBucket"),
    "ExperimentConfig": ("repro_torch.server.service", "ExperimentConfig"),
    "HashRing": ("repro_torch.server.service", "HashRing"),
    "PoolService": ("repro_torch.server.service", "PoolService"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    import importlib
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    mod = importlib.import_module(module)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value   # cache for the next lookup
    return value


def __dir__():
    return __all__
