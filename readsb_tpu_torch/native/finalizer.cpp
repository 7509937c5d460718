// Native host finalizer: serial scoring / NMS / accept over the device
// pipeline's compacted candidate tensors.
//
// This is the one inherently sequential stage of Mode-S demodulation (the
// "skip past accepted message" rule + ICAO-filter feedback, reference
// demod_2400.c:264-472 / mode_s.c:309-419,443-596).  The Python
// implementation in decode/score.py is the semantic reference; this C++
// version is behaviorally identical and ~100x faster, keeping the host
// side off the critical path at multi-GS/s device rates.
//
// Build: g++ -O2 -shared -fPIC -o libfinalizer.so finalizer.cpp

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <vector>
#include <unordered_map>

namespace {

constexpr uint32_t kPoly = 0xFFF409u;

struct ErrorEntry {
    uint32_t syndrome;
    int8_t nerrors;
    int16_t bit0;
    int16_t bit1;
};

struct IcaoFilter {
    // two-generation exact bitmaps, 2^24 bits each
    std::vector<uint64_t> cur, prev;
    int64_t next_swap_ms = -1;

    IcaoFilter() : cur(1 << 18, 0), prev(1 << 18, 0) {}

    void add(uint32_t addr) {
        addr &= 0xFFFFFF;
        cur[addr >> 6] |= 1ull << (addr & 63);
    }
    bool test(uint32_t addr) const {
        addr &= 0xFFFFFF;
        return ((cur[addr >> 6] | prev[addr >> 6]) >> (addr & 63)) & 1;
    }
    void expire(int64_t now_ms) {
        if (next_swap_ms < 0) { next_swap_ms = now_ms + 60000; return; }
        if (now_ms >= next_swap_ms) {
            std::swap(prev, cur);
            std::fill(cur.begin(), cur.end(), 0);
            next_swap_ms = now_ms + 60000;
        }
    }
};

struct Ctx {
    int nfix = 1;
    bool fix_df = true;
    uint32_t crc_table[256];
    uint32_t bit_syn112[112];
    std::vector<ErrorEntry> table_long, table_short;
    uint32_t df_delta[32];  // syndrome delta for DF field -> 17 rewrite
    uint32_t long_gate = 0, short_gate = 0;
    IcaoFilter icao;
    // stats
    int64_t preambles = 0, rejected_bad = 0, rejected_unknown = 0;
    int64_t accepted[3] = {0, 0, 0};

    void init_crc() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i << 16;
            for (int j = 0; j < 8; ++j)
                c = (c & 0x800000) ? (((c << 1) ^ kPoly) & 0xFFFFFF) : ((c << 1) & 0xFFFFFF);
            crc_table[i] = c;
        }
        uint8_t msg[14];
        std::memset(msg, 0, sizeof msg);
        for (int i = 0; i < 112; ++i) {
            msg[i >> 3] ^= 1 << (7 - (i & 7));
            bit_syn112[i] = checksum(msg, 112);
            msg[i >> 3] ^= 1 << (7 - (i & 7));
        }
        for (int df = 0; df < 32; ++df) {
            int d = df ^ 17;
            uint32_t delta = 0;
            for (int j = 0; j < 5; ++j)
                if ((d >> (4 - j)) & 1) delta ^= bit_syn112[j];
            df_delta[df] = delta;
        }
    }

    uint32_t checksum(const uint8_t* m, int bits) const {
        uint32_t rem = 0;
        int n = bits / 8;
        for (int i = 0; i < n - 3; ++i)
            rem = ((rem << 8) & 0xFFFFFF) ^ crc_table[m[i] ^ (rem >> 16)];
        rem ^= (uint32_t(m[n - 3]) << 16) | (uint32_t(m[n - 2]) << 8) | m[n - 1];
        return rem & 0xFFFFFF;
    }

    // error table: bits 5..nbits only (crc.c:211), exact collisions dropped
    void build_table(std::vector<ErrorEntry>& tab, int bits, int max_correct) {
        tab.clear();
        if (max_correct < 1) return;
        int offset = 112 - bits;
        for (int i = 5; i < bits; ++i) {
            uint32_t s1 = bit_syn112[i + offset];
            tab.push_back({s1, 1, (int16_t)i, -1});
            if (max_correct >= 2)
                for (int j = i + 1; j < bits; ++j)
                    tab.push_back({s1 ^ bit_syn112[j + offset], 2, (int16_t)i, (int16_t)j});
        }
        std::sort(tab.begin(), tab.end(),
                  [](const ErrorEntry& a, const ErrorEntry& b) { return a.syndrome < b.syndrome; });
        // drop ALL entries sharing a syndrome
        std::vector<ErrorEntry> dedup;
        size_t i = 0;
        while (i < tab.size()) {
            size_t j = i;
            while (j + 1 < tab.size() && tab[j + 1].syndrome == tab[i].syndrome) ++j;
            if (j == i) dedup.push_back(tab[i]);
            i = j + 1;
        }
        tab.swap(dedup);

        if (max_correct >= 2) {
            // flag collisions with 3- and 4-bit error patterns
            // (flagCollisions + max_detect=4, crc.c:151-295): a syndrome
            // reachable by an undetected higher-order error must not be
            // "corrected" — this cuts 2-bit coverage to ~65% and is what
            // the reference means by --aggressive being conservative.
            // (Found by the adversarial parity corpus: without this the
            // native path accepted 2-bit fixes the reference rejects.)
            std::unordered_map<uint32_t, size_t> idx;
            idx.reserve(tab.size() * 2);
            for (size_t k = 0; k < tab.size(); ++k) idx.emplace(tab[k].syndrome, k);
            std::vector<char> kill(tab.size(), 0);
            int n = bits - 5;
            std::vector<uint32_t> base(n);
            for (int b = 0; b < n; ++b) base[b] = bit_syn112[b + 5 + offset];
            for (int a = 0; a < n; ++a) {
                for (int b = a + 1; b < n; ++b) {
                    uint32_t s2 = base[a] ^ base[b];
                    for (int c3 = b + 1; c3 < n; ++c3) {
                        uint32_t s3 = s2 ^ base[c3];
                        auto it3 = idx.find(s3);
                        if (it3 != idx.end()) kill[it3->second] = 1;
                        for (int c4 = c3 + 1; c4 < n; ++c4) {
                            auto it4 = idx.find(s3 ^ base[c4]);
                            if (it4 != idx.end()) kill[it4->second] = 1;
                        }
                    }
                }
            }
            std::vector<ErrorEntry> kept;
            kept.reserve(tab.size());
            for (size_t k = 0; k < tab.size(); ++k)
                if (!kill[k]) kept.push_back(tab[k]);
            tab.swap(kept);
        }
    }

    const ErrorEntry* diagnose(const std::vector<ErrorEntry>& tab, uint32_t syn) const {
        auto it = std::lower_bound(
            tab.begin(), tab.end(), syn,
            [](const ErrorEntry& e, uint32_t s) { return e.syndrome < s; });
        if (it != tab.end() && it->syndrome == syn) return &*it;
        return nullptr;
    }
};

inline uint32_t aa_of(const uint8_t* m) {
    return (uint32_t(m[1]) << 16) | (uint32_t(m[2]) << 8) | m[3];
}

inline uint32_t correct_aa(uint32_t addr, int b0, int b1) {
    if (b0 >= 8 && b0 <= 31) addr ^= 1u << (31 - b0);
    if (b1 >= 8 && b1 <= 31) addr ^= 1u << (31 - b1);
    return addr;
}

inline bool all_zero7(const uint8_t* m) {
    for (int i = 0; i < 7; ++i)
        if (m[i]) return false;
    return true;
}

constexpr uint32_t kShortGate = (1u << 0) | (1u << 4) | (1u << 5) | (1u << 11);
constexpr uint32_t kLongBase = (1u << 16) | (1u << 17) | (1u << 18) | (1u << 20) | (1u << 21);
constexpr uint32_t kFixable = (1u << 1) | (1u << 25) | (1u << 21) | (1u << 19) | (1u << 16);

}  // namespace

extern "C" {

struct OutFrame {
    uint8_t msg[14];
    int32_t msgbits;
    int64_t timestamp;
    int32_t score;
    int32_t phase;  // try_phase 4..8
    int32_t correctedbits;
    uint32_t addr;
    float signal_power;
    uint32_t iid;
    int64_t scan_offset;
};

void* rtpu_ctx_new(int nfix, int fix_df) {
    Ctx* c = new Ctx();
    c->nfix = nfix;
    c->fix_df = fix_df && nfix > 0;
    c->init_crc();
    int mc = nfix > 2 ? 2 : nfix;
    c->build_table(c->table_long, 112, mc);
    c->build_table(c->table_short, 56, mc);
    c->short_gate = kShortGate;
    c->long_gate = kLongBase | (c->fix_df ? kFixable : 0);
    return c;
}

void rtpu_ctx_free(void* p) { delete static_cast<Ctx*>(p); }

void rtpu_icao_add(void* p, uint32_t addr) { static_cast<Ctx*>(p)->icao.add(addr); }
int rtpu_icao_test(void* p, uint32_t addr) { return static_cast<Ctx*>(p)->icao.test(addr); }
void rtpu_icao_expire(void* p, int64_t now_ms) { static_cast<Ctx*>(p)->icao.expire(now_ms); }

void rtpu_get_stats(void* p, int64_t* out6) {
    Ctx* c = static_cast<Ctx*>(p);
    out6[0] = c->preambles;
    out6[1] = c->rejected_bad;
    out6[2] = c->rejected_unknown;
    out6[3] = c->accepted[0];
    out6[4] = c->accepted[1];
    out6[5] = c->accepted[2];
}

static int score_msg(Ctx* c, const uint8_t* m, int validbits, uint32_t syn112, uint32_t syn56) {
    int msgtype = m[0] >> 3;

    if (validbits >= 112 && c->fix_df && ((kFixable >> msgtype) & 1) &&
        (syn112 ^ c->df_delta[msgtype]) == 0) {
        return c->icao.test(aa_of(m)) ? 900 : 700;
    }
    int msgbits = msgtype >= 16 ? 112 : 56;
    if (validbits < msgbits) return -2;
    if (all_zero7(m)) return -2;
    uint32_t crc = msgbits == 112 ? syn112 : syn56;

    switch (msgtype) {
        case 0: case 4: case 5: case 16: case 20: case 21:
            return c->icao.test(crc) ? 1000 : -1;
        case 11: {
            uint32_t iid = crc & 0x7F;
            uint32_t addr = aa_of(m);
            if (crc & 0xFFFF80) {
                const ErrorEntry* ei = c->diagnose(c->table_short, crc);
                if (!ei || ei->nerrors > 1) return -2;
                addr = correct_aa(addr, ei->bit0, ei->bit1);
                return c->icao.test(addr) ? 800 : -1;
            }
            if (iid == 0) return c->icao.test(addr) ? 1600 : 750;
            return c->icao.test(addr) ? 1000 : -1;
        }
        case 17: case 18: {
            int nerr = 0;
            int b0 = -1, b1 = -1;
            if (crc != 0) {
                const ErrorEntry* ei = c->diagnose(c->table_long, crc);
                if (!ei) return -2;
                nerr = ei->nerrors;
                b0 = ei->bit0;
                b1 = ei->bit1;
            }
            uint32_t addr = correct_aa(aa_of(m), b0, b1);
            int base = c->icao.test(addr) ? 1800 : 1400;
            return base / (nerr + 1);
        }
        default:
            return -2;
    }
}

// returns 0 accepted / -1 / -2; fills out on accept
static int decode_accept(Ctx* c, const uint8_t* m_in, uint32_t syn112, uint32_t syn56,
                         OutFrame* out) {
    uint8_t m[14];
    std::memcpy(m, m_in, 14);
    if (all_zero7(m)) return -2;

    int msgtype = m[0] >> 3;
    int corrected = 0;
    if (c->fix_df && ((kFixable >> msgtype) & 1) && (syn112 ^ c->df_delta[msgtype]) == 0) {
        m[0] = (17 << 3) | (m[0] & 7);
        syn112 = 0;
        msgtype = 17;
        corrected = 1;
    }
    int msgbits = msgtype >= 16 ? 112 : 56;
    uint32_t crc = msgbits == 112 ? syn112 : syn56;
    uint32_t addr = 0xEEEEEE;
    uint32_t iid = 0;

    auto fixmsg = [&](int b0, int b1) {
        if (b0 >= 0) m[b0 >> 3] ^= 1 << (7 - (b0 & 7));
        if (b1 >= 0) m[b1 >> 3] ^= 1 << (7 - (b1 & 7));
    };

    if (msgtype == 0 || msgtype == 4 || msgtype == 5 || msgtype == 16 ||
        (msgtype >= 24 && msgtype <= 31)) {
        if (!c->icao.test(crc)) return -1;
        addr = crc;
    } else if (msgtype == 11) {
        iid = crc & 0x7F;
        if (crc & 0xFFFF80) {
            const ErrorEntry* ei = c->diagnose(c->table_short, crc);
            if (!ei || ei->nerrors > 1) return -2;
            corrected = ei->nerrors;
            iid = 0;
            fixmsg(ei->bit0, ei->bit1);
            if (!c->icao.test(aa_of(m))) return -1;
        }
        addr = aa_of(m);
    } else if (msgtype == 17 || msgtype == 18) {
        if (crc != 0) {
            const ErrorEntry* ei = c->diagnose(c->table_long, crc);
            if (!ei) return -2;
            uint32_t addr1 = aa_of(m);
            corrected = ei->nerrors;
            fixmsg(ei->bit0, ei->bit1);
            uint32_t addr2 = aa_of(m);
            if (addr1 != addr2 && !c->icao.test(addr2)) return -1;
        }
        addr = aa_of(m);
    } else if (msgtype == 20 || msgtype == 21) {
        if (!c->icao.test(crc)) return -1;
        addr = crc;
    } else {
        return -2;
    }

    if (corrected == 0 && (msgtype == 17 || (msgtype == 11 && iid == 0)))
        c->icao.add(addr);

    std::memcpy(out->msg, m, 14);
    out->msgbits = msgbits;
    out->correctedbits = corrected;
    out->addr = addr;
    out->iid = iid;
    return 0;
}

// Main entry: returns number of accepted frames written to out (<= max_out).
// leftover_skip receives the skip that extends past scan_len.
int rtpu_finalize_block(
    void* ctx_p,
    const int32_t* offsets, int k, int n_cand,
    const uint8_t* corr_fired,            // (k, 3)
    const uint8_t* msg,                   // (k, 5, 14)
    const int32_t* syn112, const int32_t* syn56,  // (k, 5)
    const float* sigsum_long, const float* sigsum_short,  // (k,)
    int64_t scan_len, int64_t block_scan_start, int64_t reset_every,
    int64_t carry_skip,
    OutFrame* out, int max_out, int64_t* leftover_skip) {
    Ctx* c = static_cast<Ctx*>(ctx_p);
    (void)n_cand;

    int n_out = 0;
    int64_t skip_until = carry_skip;

    for (int i = 0; i < k; ++i) {
        int64_t o = offsets[i];
        if (o >= scan_len) break;
        if (o < skip_until) continue;

        const uint8_t* cf = corr_fired + i * 3;
        int phases[5];
        int np = 0;
        if (cf[0]) { phases[np++] = 0; phases[np++] = 1; }
        if (cf[1]) { phases[np++] = 2; phases[np++] = 3; }
        if (cf[2]) { phases[np++] = 4; }

        int bestscore = -42;
        int best = -1;
        for (int pi = 0; pi < np; ++pi) {
            int p = phases[pi];
            const uint8_t* m = msg + (i * 5 + p) * 14;
            int df = m[0] >> 3;
            int validbits;
            if ((c->long_gate >> df) & 1) validbits = 112;
            else if ((c->short_gate >> df) & 1) validbits = 56;
            else {
                if (-2 > bestscore) bestscore = -2;
                continue;
            }
            int s = score_msg(c, m, validbits, (uint32_t)syn112[i * 5 + p],
                              (uint32_t)syn56[i * 5 + p]);
            if (s > bestscore) { bestscore = s; best = p; }
        }

        if (bestscore == -42) continue;
        c->preambles++;
        if (bestscore < 0) {
            if (bestscore == -1) c->rejected_unknown++;
            else c->rejected_bad++;
            continue;
        }

        const uint8_t* mb = msg + (i * 5 + best) * 14;
        int msgbits = (mb[0] >> 3) >= 16 ? 112 : 56;
        OutFrame tmp;
        int res = decode_accept(c, mb, (uint32_t)syn112[i * 5 + best],
                                (uint32_t)syn56[i * 5 + best], &tmp);
        if (res < 0) {
            if (res == -1) c->rejected_unknown++;
            else c->rejected_bad++;
            continue;
        }
        int ci = tmp.correctedbits > 2 ? 2 : tmp.correctedbits;
        c->accepted[ci]++;

        if (n_out < max_out) {
            int64_t gidx = block_scan_start + o;
            int siglen = msgbits * 12 / 5;
            float ss = msgbits == 112 ? sigsum_long[i] : sigsum_short[i];
            tmp.timestamp = gidx * 5 + (8 + 56) * 12 + (best + 4);
            tmp.score = bestscore;
            tmp.phase = best + 4;
            tmp.signal_power = ss / (65535.0f * 65535.0f) / siglen;
            tmp.scan_offset = gidx;
            out[n_out++] = tmp;
        }
        skip_until = o + msgbits * 2 + 1;
        if (reset_every > 0) {
            int64_t bound = (o / reset_every + 1) * reset_every;
            if (skip_until > bound) skip_until = bound;
        }
    }

    *leftover_skip = skip_until > scan_len ? skip_until - scan_len : 0;
    return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Columnar Beast deframer (readBeast, net_io.c:4737-5019): raw stream bytes
// in, frame columns out.  Semantics mirror io/beast.py BeastDeframer exactly
// (fuzz-tested equivalent in tests/test_native_beast.py); the reference's
// per-byte C loop is the precedent for doing this natively.
// ---------------------------------------------------------------------------

extern "C" long rtpu_beast_deframe(
    const uint8_t* buf, long n,
    uint8_t* msgs /* cap x 14 */, int64_t* ts, uint8_t* sig, int32_t* mlen,
    uint64_t* rid, int64_t* synth, long cap,
    uint64_t* io_rid, int64_t* io_synth,
    long* consumed, long* bad,
    uint8_t* cmds /* cmd_cap x 4 */, long cmd_cap, long* n_cmds)
{
    long pos = 0, out = 0, ncmd = *n_cmds, nbad = 0;
    uint64_t cur_rid = *io_rid;
    int64_t cur_synth = *io_synth;
    while (out < cap) {
        long i = pos;
        while (i < n && buf[i] != 0x1A) i++;
        if (i >= n) { pos = n; break; }
        if (i + 1 >= n) { pos = i; break; }  // type byte not yet received
        uint8_t t = buf[i + 1];
        if (t == 0x1A) { pos = i + 2; continue; }  // doubled esc outside frame
        int msg_len = 0, body_len;
        if      (t == '1') { msg_len = 2;  body_len = 9;  }
        else if (t == '2') { msg_len = 7;  body_len = 14; }
        else if (t == '3') { msg_len = 14; body_len = 21; }
        else if (t == '5') { msg_len = 21; body_len = 28; }
        else if (t == 0xE3) body_len = 8;
        else if (t == 0xE8) body_len = 6;
        else if (t == 0xE4) body_len = 16;
        else if (t == 'P') body_len = 3;
        else if (t == 'W') body_len = 1;
        else { nbad++; pos = i + 2; continue; }

        uint8_t body[32];
        int blen = 0;
        long j = i + 2;
        bool incomplete = false, truncated = false;
        while (blen < body_len) {
            if (j >= n) { incomplete = true; break; }
            uint8_t b = buf[j];
            if (b == 0x1A) {
                if (j + 1 >= n) { incomplete = true; break; }
                if (buf[j + 1] == 0x1A) { body[blen++] = 0x1A; j += 2; continue; }
                truncated = true;  // a new frame begins inside this body
                break;
            }
            body[blen++] = b;
            j++;
        }
        if (incomplete) { pos = i; break; }   // wait for more stream data
        if (truncated || blen < body_len) { nbad++; pos = j; continue; }

        if (msg_len) {
            int64_t tv = 0;
            for (int b = 0; b < 6; b++) tv = (tv << 8) | body[b];
            ts[out] = tv;
            sig[out] = body[6];
            mlen[out] = msg_len;
            int copy = msg_len < 14 ? msg_len : 14;
            for (int b = 0; b < copy; b++) msgs[out * 14 + b] = body[7 + b];
            for (int b = copy; b < 14; b++) msgs[out * 14 + b] = 0;
            rid[out] = cur_rid;
            synth[out] = cur_synth;
            out++;
        } else if (t == 0xE3) {
            uint64_t v = 0;
            for (int b = 0; b < 8; b++) v = (v << 8) | body[b];
            cur_rid = v;
        } else if (t == 0xE8) {
            int64_t v = 0;
            for (int b = 0; b < 6; b++) v = (v << 8) | body[b];
            cur_synth = v;
        } else if (t == 0xE4) {
            // UUID: connection identity handled by the server layer
        } else {  // 'P' / 'W' command tokens
            if (ncmd < cmd_cap) {
                cmds[ncmd * 4] = t;
                for (int b = 0; b < 3; b++)
                    cmds[ncmd * 4 + 1 + b] = b < body_len ? body[b] : 0;
                ncmd++;
            }
        }
        pos = j;
    }
    *io_rid = cur_rid;
    *io_synth = cur_synth;
    *consumed = pos;
    *bad += nbad;
    *n_cmds = ncmd;
    return out;
}
