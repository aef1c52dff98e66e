"""Scale-out: device meshes, channel sharding (DP-like), time-block sequence
parallelism (SP-like) with halo exchange, and the wideband channelizer.

These are first-class components with NO reference analogue — the reference is
a single-process single-channel pipeline (SURVEY.md §2.10)."""

from fm_radio.parallel.sharding import (  # noqa: F401
    demod_channels_sharded,
    demod_superblock_stream,
    demod_time_parallel,
    make_mesh,
    rds_warmup_blocks,
)
from fm_radio.parallel.channelizer import (  # noqa: F401
    channelize,
    channelizer_init_state,
    make_channelizer_taps,
)
