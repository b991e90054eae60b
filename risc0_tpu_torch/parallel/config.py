# The port's own copy of risc0_tpu/parallel/config.py.
"""Cluster configuration (reference r0vm/src/actors/config.rs + the
testdata/*.toml deployment files).

A deployment is described by a TOML file with the same sections the
reference uses:

    version = 1
    [api]       listen = "127.0.0.1:8000"        # REST front door
    [manager]   listen = "127.0.0.1:9000"        # task factory
    [executor]  count = 1                        # CPU execute workers
    [[prover]]  subscribe = ["prove-segment", "lift", "join", "unwrap",
                             "union", "resolve"]  # accel workers
                manager = "10.0.3.24:9000"       # remote factory (optional)
                count = 1
                [prover.simulate]  lift = 0.01   # DevModeDelay fields
    [storage]   path = "/var/lib/risc0"

`load_config` parses/validates; `launch_cluster` builds the factory,
worker pools (local threads, or RemoteWorkers against a remote factory
address), and optionally the REST API server.

The prover pools run the prover `launch_cluster` is given (ProverImpl on
the card, say).  A pool given no prover, or one with a [prover.simulate]
table, runs the DevModeProver with those latencies: that is the API's
simulated cluster, for testing deployments, and never a fallback from
the card: a task that fails on the card fails its job.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from functools import partial

from .scheduler import Factory, TaskKind, Worker, run_task

VERSION = 1

_KIND_NAMES = {
    "execute": TaskKind.EXECUTE,
    "preflight": TaskKind.PREFLIGHT,
    "prove-segment": TaskKind.PROVE_SEGMENT,
    "prove-keccak": TaskKind.PROVE_KECCAK,
    "lift": TaskKind.LIFT,
    "join": TaskKind.JOIN,
    "union": TaskKind.UNION,
    "resolve": TaskKind.RESOLVE,
    "unwrap": TaskKind.UNWRAP,
    "shrink-wrap": TaskKind.SHRINK_WRAP,
}


@dataclass
class ApiConfig:
    listen: str | None = None
    manager: str | None = None
    po2: int | None = None


@dataclass
class ManagerConfig:
    listen: str | None = None


@dataclass
class ExecutorConfig:
    manager: str | None = None
    count: int = 1


@dataclass
class ProverConfig:
    manager: str | None = None
    count: int = 1
    subscribe: list = field(default_factory=list)  # list[TaskKind]
    simulate: dict | None = None  # DevModeDelay kwargs


@dataclass
class StorageConfig:
    path: str = ""
    # listen address for the content-addressed asset server (reference's
    # Asset channel / Bonsai upload+dedup store).  When set, the manager
    # host serves segments/receipts by digest and jobs ship AssetRefs in
    # task payloads instead of MB-scale bytes (parallel/assets.py).
    assets: str | None = None


@dataclass
class AppConfig:
    version: int = VERSION
    api: ApiConfig | None = None
    manager: ManagerConfig | None = None
    executor: ExecutorConfig | None = None
    provers: list = field(default_factory=list)  # list[ProverConfig]
    storage: StorageConfig | None = None


def _addr(s: str) -> tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return host, int(port)


def load_config(path_or_text) -> AppConfig:
    """Parse + validate a cluster TOML (reference config.rs AppConfig)."""
    if isinstance(path_or_text, str) and "\n" not in path_or_text \
            and path_or_text.endswith(".toml"):
        with open(path_or_text, "rb") as f:
            data = tomllib.load(f)
    else:
        text = path_or_text if isinstance(path_or_text, str) \
            else path_or_text.decode()
        data = tomllib.loads(text)

    version = data.get("version")
    if version != VERSION:
        raise ValueError(f"unsupported config version {version!r} "
                         f"(expected {VERSION})")
    cfg = AppConfig(version=version)
    if "api" in data:
        cfg.api = ApiConfig(**data["api"])
    if "manager" in data:
        cfg.manager = ManagerConfig(**data["manager"])
    if "executor" in data:
        cfg.executor = ExecutorConfig(**data["executor"])
    for p in data.get("prover", []):
        kinds = []
        for name in p.get("subscribe", []):
            if name not in _KIND_NAMES:
                raise ValueError(f"unknown task kind {name!r}")
            k = _KIND_NAMES[name]
            if k not in kinds:
                kinds.append(k)
        cfg.provers.append(ProverConfig(
            manager=p.get("manager"), count=p.get("count", 1),
            subscribe=kinds, simulate=p.get("simulate")))
    if "storage" in data:
        cfg.storage = StorageConfig(**data["storage"])
    return cfg


class Cluster:
    """Running deployment: factory (+ optional TCP listener), executor and
    prover pools, optional REST API (reference actors/mod.rs:185-240)."""

    def __init__(self, factory, workers, factory_server=None,
                 api_server=None, asset_server=None):
        self.factory = factory
        self.workers = workers
        self.factory_server = factory_server
        self.api_server = api_server
        self.asset_server = asset_server

    @property
    def asset_addr(self):
        """Address jobs pass to ProofJob(asset_addr=...) to ship segments
        by reference, or None when no asset server is configured."""
        return self.asset_server.addr if self.asset_server else None

    def stop(self):
        for w in self.workers:
            w.stop()
        if self.factory_server is not None:
            self.factory_server.close()
        if self.api_server is not None:
            self.api_server.shutdown()
        if self.asset_server is not None:
            self.asset_server.close()


def launch_cluster(cfg: AppConfig, prover=None) -> Cluster:
    """Build workers per the config.  Local entries (no `manager` addr)
    run as threads on an in-process Factory; entries with a `manager`
    address connect RemoteWorkers to that factory's TCP listener.  Each
    prover pool runs `prover`, or the DevModeProver when `prover` is None
    or the pool has a [prover.simulate] table (the simulated cluster).
    The REST API, if configured, proves with the same prover."""
    from ..zkvm.prover import DevModeDelay, DevModeProver

    factory = Factory()
    factory_server = None
    if cfg.manager is not None and cfg.manager.listen:
        from .remote import FactoryServer

        host, port = _addr(cfg.manager.listen)
        factory_server = FactoryServer(factory, host, port)

    workers = []
    if cfg.executor is not None:
        for i in range(cfg.executor.count):
            workers.append(Worker(factory, [TaskKind.EXECUTE],
                                  partial(run_task, None), f"exec-{i}")
                           .start())

    for pi, pc in enumerate(cfg.provers):
        p = prover
        if p is None or pc.simulate is not None:
            delay = DevModeDelay(**pc.simulate) if pc.simulate else None
            p = DevModeProver(delay)
        proc = partial(run_task, p)
        for i in range(pc.count):
            name = f"prover-{pi}-{i}"
            if pc.manager:
                from .remote import RemoteWorker

                workers.append(RemoteWorker(_addr(pc.manager), pc.subscribe,
                                            proc, name).start())
            else:
                workers.append(Worker(factory, pc.subscribe, proc,
                                      name).start())

    asset_server = None
    if cfg.storage is not None and cfg.storage.assets:
        from .assets import AssetServer, AssetStore

        host, port = _addr(cfg.storage.assets)
        asset_server = AssetServer(
            AssetStore(cfg.storage.path or None), host, port)

    api_server = None
    if cfg.api is not None and cfg.api.listen:
        from ..zkvm.api_server import serve

        host, port = _addr(cfg.api.listen)
        kwargs = {"storage": cfg.storage.path} if cfg.storage else {}
        api_prover = DevModeProver() if prover is None else prover
        api_server = serve(port=port, host=host, prover=api_prover,
                           **kwargs)
        import threading

        threading.Thread(target=api_server.serve_forever,
                         daemon=True).start()

    return Cluster(factory, workers, factory_server, api_server,
                   asset_server)
