"""JobServer — the in-process multi-job server, on one device.

Counterpart of ``harmony_tpu/jobserver/server.py``, cut to the in-process
core: ``start``, ``submit`` (returning a ``Future`` of the job's result) and
``shutdown``. Jobs run one at a time, in submission order, on one executor
thread: setup, run and cleanup of the job's entity. Not ported yet: the TCP
control plane, HA, the policy engine, overload control, metrics scraping and
the serving plane.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.utils.platform import DeviceLike


class JobServer:
    def __init__(self, device: DeviceLike = None) -> None:
        self.master = ETMaster(device)
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None

    def start(self) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="jobserver")

    def submit(self, config: JobConfig) -> "Future[Dict[str, Any]]":
        """Queue a job; its future resolves to the entity's result, or to the
        exception that ended the job."""
        with self._lock:
            if self._pool is None:
                raise RuntimeError("server not accepting jobs (not started or shut down)")
            return self._pool.submit(self._dispatch, config)

    def _dispatch(self, config: JobConfig) -> Dict[str, Any]:
        entity = DolphinJobEntity(config)
        try:
            entity.setup(self.master)
            return entity.run()
        finally:
            entity.cleanup()

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting jobs; with ``wait``, let queued jobs finish first."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait, cancel_futures=not wait)
