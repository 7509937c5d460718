"""Global constants of the Mode-S / ADS-B signal chain.

Numerology matches the behavior of the reference implementation
(wiedehopf/readsb) so that decoded frames are bit-for-bit comparable:

- 2.4 MS/s sample rate, 12 MHz timestamp clock (5 ticks / sample)
  (reference: readsb.h MODES_DEFAULT_RATE, util.h 12 MHz clock)
- 326-sample carried overlap between demod blocks
  (reference: readsb.c:288 trailing_samples = (8+112+16)us * 2.4)
- 131072-sample block cadence (reference: readsb.c:228 sdr_buf_size,
  readsb.c:2212 sdr_buf_samples = size/2)
- preamble threshold default 58 / 32 (reference: demod_2400.h)
"""

SAMPLE_RATE = 2_400_000
TICKS_PER_SAMPLE = 5  # 12 MHz timestamp clock / 2.4 MS/s

MODES_PREAMBLE_US = 8
MODES_SHORT_MSG_BITS = 56
MODES_LONG_MSG_BITS = 112
MODES_SHORT_MSG_BYTES = 7
MODES_LONG_MSG_BYTES = 14

# Samples of overlap carried between scan blocks: a full frame plus margin.
# floor((8 + 112 + 16) us * 2.4 samples/us) = 326
TRAILING_SAMPLES = int((MODES_PREAMBLE_US + MODES_LONG_MSG_BITS + 16) * 1e-6 * SAMPLE_RATE)

# Default scan-block size in samples (the reference's SDR buffer cadence).
BLOCK_SAMPLES = 131072

PREAMBLE_THRESHOLD_DEFAULT = 58
PREAMBLE_THRESHOLD_PIZERO = 75
PREAMBLE_THRESHOLD_MIN = 40
PREAMBLE_THRESHOLD_MAX = 400

# Downlink formats that are accepted without any DF-field repair.
VALID_DF_SHORT = (0, 4, 5, 11)
VALID_DF_LONG = (16, 17, 18, 20, 21)
# 1-bit damaged variants of DF17 (accepted when fixDF is enabled):
DF17_DAMAGE_SET = tuple(sorted({17} | {17 ^ (1 << b) for b in range(5)}))

# CRC-24 generator polynomial (Mode-S Annex 10).
CRC24_POLY = 0xFFF409

# Timestamp reported at the end of bit 56: (8 preamble us + 56 bit us) * 12 ticks/us
TIMESTAMP_BIT56_TICKS = (8 + 56) * 12

# Magic timestamps used on the wire (readsb.h:344-348)
MAGIC_MLAT_TIMESTAMP = 0xFF004D4C4154  # "\xffMLAT"
MAGIC_UAT_TIMESTAMP = 0xFF004D4C4155
MAGIC_NOFORWARD_TIMESTAMP = 0xFF004D4C4160
MAGIC_ANY_TIMESTAMP = 0xFFFFFFFFFFFF

HEX_UNKNOWN = 0xEE_EEEE
