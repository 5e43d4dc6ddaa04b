"""Runtime layer (counterpart of ``mcrt_tpu/runtime/__init__.py``): device
discovery and buffer accounting (:mod:`.platform`) and the native host
library (:mod:`.native`)."""
from .platform import (  # noqa: F401
    BufferManager,
    DeviceInfo,
    buffers,
    device_memory_stats,
    enumerate_devices,
)
