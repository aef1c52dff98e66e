"""RDS (Radio Data System) decoding: differential-Manchester bit recovery,
CRC-10 block validation with 1-bit correction, 26-bit group synchronisation,
group-type decoders and the station database.

Device/host split (SURVEY.md §2.4): symbol->bit decisions are vectorized
(NumPy/JAX); the bit-serial group-sync state machine and the group-type
decoders run on host — at ~1.2 kbps/channel this is never the bottleneck, and
batched channels decode independently."""

from fm_radio.rds.crc import (  # noqa: F401
    OFFSET_WORDS,
    calculate_crc10,
    crc10_bitserial,
    get_error_from_syndrome,
)
from fm_radio.rds.manchester import DifferentialManchesterDecoder  # noqa: F401
from fm_radio.rds.group_sync import RDSGroupSync  # noqa: F401
from fm_radio.rds.decoder import RDSDecoder  # noqa: F401
from fm_radio.rds.database import RDSDatabase, RDSDatabaseHandler  # noqa: F401
from fm_radio.rds.chain import RDSDecodingChain  # noqa: F401
