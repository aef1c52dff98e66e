"""RDS stack tests: CRC oracle properties, Manchester round-trip,
group sync + error correction, group-type decoders, database fill."""

import numpy as np

from fm_radio.io.synth import encode_rds_group, rds_bits_to_symbols
from fm_radio.rds import (
    OFFSET_WORDS,
    calculate_crc10,
    crc10_bitserial,
    get_error_from_syndrome,
)
from fm_radio.rds.chain import RDSDecodingChain, RDSFullChain
from fm_radio.rds.crc import validate_codeword
from fm_radio.rds.database import TrafficAnnouncement
from fm_radio.rds.decoder import mjd_to_ymd
from fm_radio.rds.manchester import DifferentialManchesterDecoder

RNG = np.random.default_rng(42)


# ------------------------------------------------------------------ CRC10


def test_crc10_linearity_matrix_matches_bitserial():
    xs = RNG.integers(0, 1 << 26, size=200, dtype=np.uint32)
    mat = calculate_crc10(xs)
    ser = np.array([crc10_bitserial(int(v)) for v in xs], dtype=np.uint16)
    np.testing.assert_array_equal(mat, ser)


def test_crc10_valid_codeword_has_zero_syndrome():
    for _ in range(50):
        data = int(RNG.integers(0, 1 << 16))
        crc = crc10_bitserial(data << 10)
        codeword = (data << 10) | crc
        assert crc10_bitserial(codeword) == 0


def test_crc10_single_bit_correction():
    data = 0xBEEF
    codeword = (data << 10) | crc10_bitserial(data << 10)
    for bit in range(26):
        corrupted = codeword ^ (1 << bit)
        is_valid, corrected, pattern, syndrome = validate_codeword(corrupted)
        assert is_valid and corrected == codeword and pattern == (1 << bit)


def test_error_table_unknown_syndrome_returns_zero():
    # find a syndrome not in the 26-entry table
    known = {crc10_bitserial(1 << i) for i in range(26)}
    for s in range(1024):
        if s not in known and s != 0:
            assert get_error_from_syndrome(s) == 0
            break


# ------------------------------------------------------------- Manchester


def test_manchester_round_trip():
    bits = RNG.integers(0, 2, size=128 * 3).astype(np.uint8)
    symbols = rds_bits_to_symbols(bits)
    got = []
    dec = DifferentialManchesterDecoder(buf_size=16, on_bytes=lambda b: got.append(b))
    dec.process(symbols.astype(np.float32))
    out_bits = np.unpackbits(np.concatenate(got))
    # first decoded bit depends on the unknown initial prev_bit; rest match
    np.testing.assert_array_equal(out_bits[1 : len(bits)], bits[1:])


def test_manchester_block_boundaries_and_odd_offsets():
    bits = RNG.integers(0, 2, size=256).astype(np.uint8)
    symbols = rds_bits_to_symbols(bits).astype(np.float32)

    def run(chunks):
        got = []
        dec = DifferentialManchesterDecoder(buf_size=16, on_bytes=lambda b: got.append(b))
        for c in chunks:
            dec.process(c)
        return np.concatenate(got) if got else np.zeros(0, np.uint8)

    whole = run([symbols])
    # odd-sized chunking must give identical bytes
    odd = run([symbols[:17], symbols[17:100], symbols[100:]])
    np.testing.assert_array_equal(whole, odd)
    # sampling the complementary symbol phase gives same XOR stream
    shifted = run([symbols[1:]])
    np.testing.assert_array_equal(whole[1 : len(shifted)], shifted[1:])


# ------------------------------------------------------------- group sync


def _groups_to_bytes(groups, prefix_bits=0, flip_bits=()):
    bits = np.concatenate([encode_rds_group(g) for g in groups])
    if prefix_bits:
        bits = np.concatenate([RNG.integers(0, 2, prefix_bits).astype(np.uint8), bits])
    for fb in flip_bits:
        bits[fb] ^= 1
    # pad to whole bytes
    pad = (-len(bits)) % 8
    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits)


def _mk_group(pi=0x1234, gtype=0, version=0, extra_b=0, c=0x0000, d=0x0000):
    b = (gtype << 12) | (version << 11) | extra_b
    return (pi, b, c, d)


def test_group_sync_locks_and_decodes():
    groups = [_mk_group(c=0xAAAA, d=0x4142), _mk_group(gtype=2, c=0x4344, d=0x4546)]
    data = _groups_to_bytes(groups * 4, prefix_bits=13)
    chain = RDSDecodingChain()
    chain.process(data)
    # A random prefix can cause a false lock (1/1024 per bit — the reference
    # resyncs after 3 bad groups, rds_group_sync.cpp:119-123); eventually the
    # true groups decode fully valid.
    full = [
        [blk.data for blk in g] for g in chain.groups if all(b.is_valid for b in g)
    ]
    assert [0x1234, groups[0][1], 0xAAAA, 0x4142] in full
    assert chain.db.pi_code == 0x1234


def test_group_sync_corrects_single_bit_error():
    groups = [_mk_group(c=0x1111, d=0x2222)] * 3
    # flip one bit inside the second group's C block (bits 104..182 area)
    data = _groups_to_bytes(groups, prefix_bits=0, flip_bits=(104 + 52 + 7,))
    chain = RDSDecodingChain()
    chain.process(data)
    assert len(chain.groups) == 3
    for g in chain.groups:
        assert [blk.data for blk in g] == [0x1234, 0x0000, 0x1111, 0x2222]
        assert all(blk.is_valid for blk in g)


def test_group_sync_resync_after_bad_groups():
    good = [_mk_group(c=0x1111, d=0x2222)]
    bits_good = np.concatenate([encode_rds_group(g) for g in good * 2])
    garbage = RNG.integers(0, 2, 104 * 4).astype(np.uint8)
    bits = np.concatenate([bits_good, garbage, bits_good * 1])
    pad = (-len(bits)) % 8
    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    chain = RDSDecodingChain()
    chain.process(np.packbits(bits))
    # the two leading good groups decode; it desyncs in garbage, then relocks
    valid_groups = [g for g in chain.groups if all(b.is_valid for b in g)]
    assert len(valid_groups) >= 2


# ---------------------------------------------------------- group decoders


def test_decoder_0a_service_name_and_flags():
    chain = RDSDecodingChain()
    groups = []
    name = b"RADIO  1"
    for seg in range(4):
        b_extra = (1 << 4) | (1 << 3) | seg  # TA=1, M/S=music
        d = (name[2 * seg] << 8) | name[2 * seg + 1]
        groups.append(_mk_group(pi=0xF201, gtype=0, extra_b=(1 << 10) | b_extra, d=d))
    chain.process(_groups_to_bytes(groups))
    assert chain.db.service_name_str == "RADIO  1"
    assert chain.db.pi_code == 0xF201
    assert chain.db.is_music
    assert chain.db.traffic_announcement == TrafficAnnouncement.NOW_EON_ANNOUNCE


def test_decoder_2a_radiotext():
    chain = RDSDecodingChain()
    text = b"HELLO JAX WORLD!"
    groups = []
    for seg in range(4):
        c = (text[4 * seg] << 8) | text[4 * seg + 1]
        d = (text[4 * seg + 2] << 8) | text[4 * seg + 3]
        groups.append(_mk_group(gtype=2, extra_b=seg, c=c, d=d))
    chain.process(_groups_to_bytes(groups))
    assert chain.db.radio_text_str.startswith("HELLO JAX WORLD!")


def test_decoder_4a_clock_time():
    # MJD for 2020-01-01 is 58849
    mjd = 58849
    hour, minute = 13, 37
    b_extra = (mjd >> 15) & 0b11
    c = ((mjd & 0x7FFF) << 1) | ((hour >> 4) & 1)
    d = ((hour & 0xF) << 12) | (minute << 6) | (0 << 5) | 2  # LTO=+2 half-hours
    chain = RDSDecodingChain()
    chain.process(_groups_to_bytes([_mk_group(gtype=4, extra_b=b_extra, c=c, d=d)]))
    db = chain.db
    assert (db.year, db.month, db.day) == (2020, 1, 1)
    assert (db.hour, db.minute) == (13, 37)
    assert db.local_time_offset == 2


def test_mjd_conversion():
    assert mjd_to_ymd(58849) == (2020, 1, 1)
    assert mjd_to_ymd(44244) == (1980, 1, 6)


def test_decoder_log_line_format():
    chain = RDSDecodingChain()
    chain.process(_groups_to_bytes([_mk_group(c=0xAAAA, d=0x4142)]))
    line = chain.log_lines[0]
    assert line.startswith("[group] [1234 ")
    assert "PI=1234" in line
    assert "Type  0A" in line  # %+2u ignores + for unsigned: 2-wide space pad


def test_decoder_0b_service_name():
    """Version-B tuning groups (0B): PS name carried in block D, block C' =
    PI.  BEYOND the reference, which logs every B group as unsupported
    (rds_decoder.cpp:128-157)."""
    chain = RDSDecodingChain()
    name = b"BSIDE FM"
    groups = []
    for seg in range(4):
        d = (name[2 * seg] << 8) | name[2 * seg + 1]
        groups.append(_mk_group(pi=0xB0B0, gtype=0, version=1,
                                extra_b=seg, c=0xB0B0, d=d))
    chain.process(_groups_to_bytes(groups * 2))
    assert chain.db.pi_code == 0xB0B0
    assert chain.db.service_name_str == "BSIDE FM"


def test_decoder_1b_programme_item_number():
    """Version-B programme item number (1B): paging code from block B, PIN
    day/time from block D (BEYOND the reference, which logs 1B as
    unsupported, rds_decoder.cpp:128-157)."""
    chain = RDSDecodingChain()
    d = (13 << 11) | (21 << 6) | 45  # day 13, 21:45
    groups = [_mk_group(pi=0x1B1B, gtype=1, version=1,
                        extra_b=0b00111, c=0x1B1B, d=d)] * 3
    chain.process(_groups_to_bytes(groups))
    line = next(ln for ln in chain.log_lines if "Type  1B" in ln)
    assert "radio_paging_code=7" in line
    assert "day=13, time=21:45" in line
    # strict mode still declines it (reference parity)
    strict = RDSDecodingChain(strict_ref=True)
    strict.process(_groups_to_bytes(groups))
    line = next(ln for ln in strict.log_lines if "Type  1B" in ln)
    assert "Unsupported_Code" in line


def test_decoder_2b_radio_text():
    """Version-B RadioText (2B): 2 chars/group from block D, 32-char text."""
    chain = RDSDecodingChain()
    text = b"HELLO FROM SIDE B OF THE DIAL \r "
    groups = []
    for seg in range(16):
        d = (text[2 * seg] << 8) | text[2 * seg + 1]
        groups.append(_mk_group(pi=0x2222, gtype=2, version=1,
                                extra_b=seg, c=0x2222, d=d))
    chain.process(_groups_to_bytes(groups * 2))
    assert chain.db.radio_text_str.startswith("HELLO FROM SIDE B OF THE DIAL")


def test_decoder_15b_fast_tuning():
    """Version-B fast tuning (15B): block-B flags land in the database
    (BEYOND the reference, which logs 15B as unsupported)."""
    chain = RDSDecodingChain()
    groups = [_mk_group(pi=0x15B1, gtype=15, version=1,
                        extra_b=(1 << 4) | 0b11 | (1 << 2), c=0x15B1, d=0x0000)] * 3
    chain.process(_groups_to_bytes(groups))
    assert chain.db.pi_code == 0x15B1
    assert chain.db.traffic_announcement
    assert chain.db.is_stereo


def test_strict_ref_mode_declines_all_b_groups():
    """strict_ref=True restores exact reference semantics: every version-B
    group logs Unsupported_Code (rds_decoder.cpp:146-155) and mutates nothing
    beyond PI/PTY."""
    name = b"BSIDE FM"
    groups = []
    for seg in range(4):
        d = (name[2 * seg] << 8) | name[2 * seg + 1]
        groups.append(_mk_group(pi=0xB0B0, gtype=0, version=1,
                                extra_b=seg, c=0xB0B0, d=d))
    groups.append(_mk_group(pi=0xB0B0, gtype=2, version=1, extra_b=0,
                            c=0xB0B0, d=0x4849))
    data = _groups_to_bytes(groups * 2)

    strict = RDSDecodingChain(strict_ref=True)
    strict.process(data)
    b_lines = [ln for ln in strict.log_lines if "B," in ln.split("Type")[1][:5]]
    assert b_lines and all(ln.endswith("Unsupported_Code") for ln in b_lines)
    assert strict.db.service_name_str.strip() == ""  # 0B payload NOT applied

    superset = RDSDecodingChain()
    superset.process(data)
    assert superset.db.service_name_str == "BSIDE FM"


def test_decoder_0a_alternative_frequencies():
    """AF method A storage — completes the reference's TODO at
    rds_database_decoder_handler.cpp:100-102: count header + VHF codes
    decode into db.alt_freqs (Hz)."""
    chain = RDSDecodingChain()
    # block C: (224+2)<<8 | code  -> "#AF2" header then 90.3 MHz (code 28)
    groups = [
        _mk_group(gtype=0, extra_b=0, c=((224 + 2) << 8) | 28, d=0x2020),
        # 87.6 MHz (code 1) + filler (205)
        _mk_group(gtype=0, extra_b=1, c=(1 << 8) | 205, d=0x2020),
        # duplicate of 90.3 must not double-store
        _mk_group(gtype=0, extra_b=2, c=(28 << 8) | 0, d=0x2020),
    ]
    chain.process(_groups_to_bytes(groups))
    assert chain.db.alt_freq_count == 2
    assert chain.db.alt_freqs == [87_600_000, 90_300_000]


def test_decoder_af_lfmf_escape_and_list_commit():
    """Code 250 escapes one LF/MF code (not a VHF carrier); a list commits
    when the announced count is reached, replacing any previous cycle."""
    chain = RDSDecodingChain()
    groups = [
        # header #AF3, then VHF 90.3
        _mk_group(gtype=0, extra_b=0, c=((224 + 3) << 8) | 28, d=0x2020),
        # LF/MF escape, then MF code 20 -> 531 + 4*9 = 567 kHz
        _mk_group(gtype=0, extra_b=1, c=(250 << 8) | 20, d=0x2020),
        # VHF 87.6 completes the 3-entry list
        _mk_group(gtype=0, extra_b=2, c=(1 << 8) | 205, d=0x2020),
    ]
    chain.process(_groups_to_bytes(groups))
    assert chain.db.alt_freq_count == 3
    assert chain.db.alt_freqs == [567_000, 87_600_000, 90_300_000]
    # a revised list (new header cycle) replaces the old one on commit
    groups2 = [
        _mk_group(gtype=0, extra_b=0, c=((224 + 1) << 8) | 40, d=0x2020),
    ]
    chain.process(_groups_to_bytes(groups2))
    assert chain.db.alt_freqs == [87_500_000 + 40 * 100_000]


def test_station_schedule_long_af_list_commits():
    """9 alternative frequencies need >4 0A groups; the schedule must carry
    every announced code so the decoder's pending list reaches the count."""
    from fm_radio.io.synth import station_group_schedule

    af = [87.6 + 0.1 * i for i in range(9)]
    groups = station_group_schedule(0x1234, ps="NINEAFS ", af_mhz=af)
    chain = RDSDecodingChain()
    chain.process(_groups_to_bytes(groups * 2))
    assert chain.db.alt_freq_count == 9
    assert len(chain.db.alt_freqs) == 9
    np.testing.assert_allclose(
        [f / 1e6 for f in chain.db.alt_freqs], af, atol=1e-6
    )


def test_decoder_14b_eon_ta_switching():
    """14B decodes TP(ON)/TA(ON)/PI(ON) in default mode and prints
    Unsupported_Code under strict_ref (reference parity)."""
    g = _mk_group(pi=0xAB01, gtype=14, version=1,
                  extra_b=(1 << 4) | (1 << 3), c=0xAB01, d=0xCD02)
    data = _groups_to_bytes([g] * 3)
    chain = RDSDecodingChain()
    chain.process(data)
    line = next(ln for ln in chain.log_lines if "Type 14B" in ln)
    assert "TP(on)=1, TA(on)=1, PI(on)=CD02" in line

    strict = RDSDecodingChain(strict_ref=True)
    strict.process(data)
    line = next(ln for ln in strict.log_lines if "Type 14B" in ln)
    assert line.endswith("Unsupported_Code")


def test_fast_resync_recovers_burst_in_one_group():
    """Opt-in fast resync: a framing-destroying burst (all four blocks
    invalid) triggers immediate re-acquisition instead of the reference's
    3-consecutive-errored-groups rule — and behaves identically to the
    default on streams whose errored groups keep a valid block."""
    import numpy as np

    from fm_radio.rds.group_sync import RDSGroupSync
    from fm_radio.rds.crc import OFFSET_WORDS, crc10_bitserial

    def group_bits(pi):
        words = [(pi, "A"), ((4 << 12) | 0x1F, "B"), (0x4142, "C"),
                 (0x4344, "D")]
        bits = []
        for w, off in words:
            cw = ((w << 10) | crc10_bitserial(w << 10)) ^ OFFSET_WORDS[off]
            bits.extend((cw >> (25 - i)) & 1 for i in range(26))
        return bits

    clean = []
    for _ in range(4):
        clean.extend(group_bits(0xAAAA))
    rng = np.random.default_rng(5)
    burst = list(rng.integers(0, 2, 104 + 13))  # one garbage group + misalign
    stream = np.array(clean + burst + clean, np.uint8)

    def count(fast):
        got = []
        gs = RDSGroupSync(on_group=lambda g: got.append(g), fast_resync=fast)
        gs.process_bits(stream)
        return [g for g in got if all(b.is_valid for b in g)]

    slow, fast = count(False), count(True)
    assert len(fast) >= len(slow)
    # fast mode loses at most ~2 groups of the 8 transmitted to the burst
    assert len(fast) >= 6, len(fast)

    # equivalence when every errored group keeps >=1 valid block: flip one
    # bit inside block C of each group -> same decode under both modes
    mild = np.array(clean, np.uint8)
    for g in range(4):
        mild[g * 104 + 60] ^= 1
    def words_of(fast):
        got = []
        gs = RDSGroupSync(on_group=lambda g: got.append(g), fast_resync=fast)
        gs.process_bits(mild)
        return [[(b.data, b.is_valid) for b in g] for g in got]
    assert words_of(False) == words_of(True)
