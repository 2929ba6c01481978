"""Config hot-reload watcher (the port's copy of the file half of
``aigw_tpu/config/watcher.py``).

Polls one config file (every ``interval`` seconds, 5 by default),
checksums its content to skip no-op reloads, and swaps in a freshly
built RuntimeConfig on change (built over the current one, so quota
windows survive the reload). An optional ``transform`` (Config →
Config) runs after every load, so a CLI-side merge (the ``--mcp-config``
backends) survives reloads of the file. A bad new config is logged and rejected;
the gateway keeps serving the last good one. Bundle directories, CRD
manifest directories and live clusters are the reference's control
plane, which the port does not carry.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

from aigw_tpu_torch.config.model import Config, load_config
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

    def load_initial(self) -> RuntimeConfig:
        """The first load; raises on an invalid config (startup fails
        loudly, reloads do not)."""
        cfg = load_config(self.path)
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

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                cfg = load_config(self.path)
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
