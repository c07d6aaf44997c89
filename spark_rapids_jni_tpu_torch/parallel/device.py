"""Executor <-> device binding (port of the JAX package's
``parallel/device.py``): the counterpart of the reference's
``cudf::jni::auto_set_device``. Each Spark executor maps to one CUDA
device by its ordinal, round robin over the process's devices, and a
bound thread's ops default to that device (``torch.device`` as a context,
the counterpart of ``jax.default_device``). There is no CPU fallback:
without a card these raise.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..utils.errors import FatalDeviceError

__all__ = ["device_for_executor", "bind_executor", "current_device"]

_local = threading.local()


def _cuda_devices():
    if not torch.cuda.is_available():
        raise FatalDeviceError("no CUDA device is available: an executor binds to a card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_for_executor(executor_id: int) -> torch.device:
    """Deterministic executor -> device mapping (round robin over the
    local CUDA devices, as Spark maps executors to GPUs by ordinal)."""
    devs = _cuda_devices()
    return devs[executor_id % len(devs)]


@contextlib.contextmanager
def bind_executor(executor_id: int):
    """Scope this thread's ops to the executor's device; reentrant."""
    dev = device_for_executor(executor_id)
    prev = getattr(_local, "device", None)
    _local.device = dev
    try:
        with dev:
            yield dev
    finally:
        _local.device = prev


def current_device() -> torch.device:
    """The bound executor's device, else the first CUDA device."""
    dev = getattr(_local, "device", None)
    return dev if dev is not None else _cuda_devices()[0]
