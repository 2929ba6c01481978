"""Config hot-reload watcher (the port's copy of
``aigw_tpu/config/watcher.py``).

Polls a config file, a bundle directory (``config/bundle.py``) or a CRD
manifest directory (every ``interval`` seconds, 5 by default),
checksums the loaded config to skip no-op reloads, and swaps in a
freshly built RuntimeConfig on change (built over the current one, so
quota windows survive the reload). A manifest directory goes through
the reconciling control plane (``config/controller.py``), which writes
per-object status conditions; ``not_accepted()`` reads them. An
optional ``transform`` (Config → Config) runs after every load, so a
CLI-side merge (the ``--mcp-config`` backends) survives reloads. A bad
new config is logged and rejected; the gateway keeps serving the last
good one. A live cluster (``kube:<kubeconfig>``, ``kube:in-cluster``)
is list/watched by ``config/kube.py`` and reconciled on every tick, its
conditions patched back onto the objects' status; ``stop`` surrenders
the status writer's Lease before the source stops.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Callable

from aigw_tpu_torch.config.bundle import read_bundle
from aigw_tpu_torch.config.controller import Reconciler, is_manifest_dir
from aigw_tpu_torch.config.model import Config, ConfigError, load_config
from aigw_tpu_torch.config.runtime import RuntimeConfig

logger = logging.getLogger(__name__)

ReloadCallback = Callable[[RuntimeConfig], None]


class ConfigWatcher:
    def __init__(self, path: str, on_reload: ReloadCallback,
                 interval: float = 5.0,
                 transform: Callable[[Config], Config] | None = None):
        self.path = path
        self.on_reload = on_reload
        self.interval = interval
        #: applied after every load; the checksum is the file's, taken
        #: before it
        self.transform = transform
        self._checksum = ""
        self._current: RuntimeConfig | None = None
        self._task: asyncio.Task | None = None
        self._reconciler: Reconciler | None = None
        self._kube_reconciler = None
        self._kube_source = None

    def not_accepted(self) -> dict:
        """Per-object NOT-Accepted conditions from the reconciling
        control plane (empty when the source is not reconciled)."""
        if self._kube_reconciler is not None:
            return self._kube_reconciler.not_accepted()
        if self._reconciler is None:
            return {}
        return self._reconciler.not_accepted()

    def _load(self) -> Config:
        if self.path.startswith("kube:"):
            if self._kube_reconciler is None:
                from aigw_tpu_torch.config.kube import (
                    KubeReconciler,
                    KubeSource,
                    parse_kube_target,
                )

                source = KubeSource(parse_kube_target(self.path))
                source.start()
                if not source.wait_synced(60.0):
                    source.stop()
                    raise ConfigError(
                        f"kube source {self.path!r} never synced "
                        "(API server unreachable?)")
                self._kube_source = source
                self._kube_reconciler = KubeReconciler(source)
            return self._kube_reconciler.load()
        if is_manifest_dir(self.path):
            if self._reconciler is None:
                self._reconciler = Reconciler(self.path)
            return self._reconciler.load()
        if os.path.isdir(self.path):
            return read_bundle(self.path)
        return load_config(self.path)

    def load_initial(self) -> RuntimeConfig:
        """The first load; raises on an invalid config (startup fails
        loudly, reloads do not)."""
        cfg = self._load()
        self._checksum = cfg.checksum()
        if self.transform is not None:
            cfg = self.transform(cfg)
        rc = RuntimeConfig.build(cfg)
        self._current = rc
        self.on_reload(rc)
        return rc

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="config-watcher")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._kube_source is not None:
            if self._kube_reconciler is not None:
                # surrender the status writer's Lease before the loop
                # the surrender runs on is torn down
                self._kube_reconciler.shutdown()
                await asyncio.sleep(0.1)
            await asyncio.to_thread(self._kube_source.stop)
            self._kube_source = None
            self._kube_reconciler = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                cfg = self._load()
                checksum = cfg.checksum()
                if checksum == self._checksum:
                    continue
                if self.transform is not None:
                    cfg = self.transform(cfg)
                rc = RuntimeConfig.build(cfg, previous=self._current)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 (keep the last good)
                logger.warning("config reload failed, keeping current: %s", e)
                continue
            self._checksum = checksum
            self._current = rc
            self.on_reload(rc)
            logger.info(
                "config reloaded (uuid=%s, %d backends, %d routes)",
                cfg.uuid, len(cfg.backends), len(cfg.routes))
