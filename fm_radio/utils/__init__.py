"""Utilities: host<->device transfer helpers, profiling, checkpointing."""

from fm_radio.utils.transfer import (  # noqa: F401
    device_put_complex,
    fetch,
    init_on_device,
)
