// Native runtime support for omm_tpu_torch: LZ4 block codec + XXH64 (a
// copy of omm_tpu/native/omm_native.cpp).
//
// Clean-room implementations against the public LZ4 block format and
// XXH64 specifications (the reference SDK links the upstream lz4/xxHash
// libraries — serialize_impl.cpp:233-273).  Exposed through a C ABI and
// loaded from Python via ctypes (no pybind11 in this environment).
//
// Build: g++ -O2 -shared -fPIC omm_native.cpp -o libomm_native.so

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// XXH64 (spec: https://github.com/Cyan4973/xxHash/blob/dev/doc/xxhash_spec.md)
// ---------------------------------------------------------------------------

static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl64(acc, 31);
    acc *= P1;
    return acc;
}

static inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
    val = xxh_round(0, val);
    acc ^= val;
    acc = acc * P1 + P4;
    return acc;
}

uint64_t omm_xxh64(const uint8_t* data, size_t len, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint64_t h;

    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2;
        uint64_t v2 = seed + P2;
        uint64_t v3 = seed + 0;
        uint64_t v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xxh_round(v1, read64(p)); p += 8;
            v2 = xxh_round(v2, read64(p)); p += 8;
            v3 = xxh_round(v3, read64(p)); p += 8;
            v4 = xxh_round(v4, read64(p)); p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + P5;
    }

    h += (uint64_t)len;

    while (p + 8 <= end) {
        h ^= xxh_round(0, read64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)read32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }

    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------------------
// LZ4 block format (spec: lz4_Block_format.md)
// ---------------------------------------------------------------------------

int omm_lz4_decompress_safe(const uint8_t* src, int src_size, uint8_t* dst,
                            int dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_size;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;

    if (src_size <= 0) return -1;

    for (;;) {
        if (ip >= iend) return -1;
        const uint8_t token = *ip++;

        // literals
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if ((size_t)(iend - ip) < lit || (size_t)(oend - op) < lit) return -1;
        memcpy(op, ip, lit);
        ip += lit;
        op += lit;

        if (ip == iend) break;  // block ends with literals

        // match
        if (iend - ip < 2) return -1;
        size_t offset = (size_t)ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        if (offset == 0 || (size_t)(op - dst) < offset) return -1;

        size_t mlen = (token & 0xF);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if ((size_t)(oend - op) < mlen) return -1;

        const uint8_t* match = op - offset;
        // overlapping copy must be byte-wise
        for (size_t i = 0; i < mlen; ++i) op[i] = match[i];
        op += mlen;
    }
    return (int)(op - dst);
}

int omm_lz4_compress_bound(int src_size) {
    return src_size + src_size / 255 + 16;
}

// Greedy hash-table compressor (LZ4_compress_default-style fast mode).
int omm_lz4_compress_default(const uint8_t* src, int src_size, uint8_t* dst,
                             int dst_cap) {
    if (src_size < 0 || dst_cap < omm_lz4_compress_bound(src_size))
        return -1;

    const int MINMATCH = 4;
    const int MFLIMIT = 12;   // last match must start 12B before end
    const int LASTLIT = 5;    // last 5 bytes always literals
    uint8_t* op = dst;
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_size;
    const uint8_t* anchor = src;

    auto write_literals = [&](const uint8_t* from, size_t count,
                              size_t match_len_code, bool has_match) {
        uint8_t* token = op++;
        size_t lit = count;
        if (lit >= 15) {
            *token = (uint8_t)(15 << 4);
            size_t rem = lit - 15;
            while (rem >= 255) { *op++ = 255; rem -= 255; }
            *op++ = (uint8_t)rem;
        } else {
            *token = (uint8_t)(lit << 4);
        }
        memcpy(op, from, lit);
        op += lit;
        if (has_match) {
            if (match_len_code >= 15) {
                *token |= 15;
            } else {
                *token |= (uint8_t)match_len_code;
            }
        }
        return token;
    };

    if (src_size >= MFLIMIT + 1) {
        const int HASH_LOG = 16;
        static uint32_t table_storage[1 << 16];
        uint32_t* table = table_storage;
        memset(table, 0, sizeof(uint32_t) * (1 << HASH_LOG));

        const uint8_t* mflimit = iend - MFLIMIT;
        ip++;  // first byte is always literal-ish start

        while (ip <= mflimit) {
            uint32_t seq = read32(ip);
            uint32_t hsh = (seq * 2654435761u) >> (32 - HASH_LOG);
            const uint8_t* match = src + table[hsh];
            table[hsh] = (uint32_t)(ip - src);

            if (match < ip && (size_t)(ip - match) <= 65535 &&
                read32(match) == seq) {
                // extend match forward
                const uint8_t* limit = iend - LASTLIT;
                size_t mlen = MINMATCH;
                while (ip + mlen < limit && match[mlen] == ip[mlen]) mlen++;
                // extend backwards
                while (ip > anchor && match > src && ip[-1] == match[-1]) {
                    ip--; match--; mlen++;
                }

                size_t lit = (size_t)(ip - anchor);
                size_t mcode = mlen - MINMATCH;
                uint8_t* token = write_literals(anchor, lit, mcode, true);
                size_t offset = (size_t)(ip - match);
                *op++ = (uint8_t)(offset & 0xFF);
                *op++ = (uint8_t)(offset >> 8);
                if (mcode >= 15) {
                    size_t rem = mcode - 15;
                    while (rem >= 255) { *op++ = 255; rem -= 255; }
                    *op++ = (uint8_t)rem;
                }
                (void)token;
                ip += mlen;
                anchor = ip;
                if (ip > mflimit) break;
                // insert hash at ip-2 for better chains
                uint32_t s2 = read32(ip - 2);
                table[(s2 * 2654435761u) >> (32 - HASH_LOG)] =
                    (uint32_t)(ip - 2 - src);
            } else {
                ip++;
            }
        }
    }

    // trailing literals
    size_t lit = (size_t)(iend - anchor);
    write_literals(anchor, lit, 0, false);
    return (int)(op - dst);
}

// ---------------------------------------------------------------------------
// OC1 state packing / unpacking and hamming distance — the host-side hot
// loops of the bake pipeline (bake_cpu_impl.cpp:1802-1819 packing; the
// near-duplicate merges compare whole 3-state arrays,
// bake_cpu_impl.cpp:1237-1252,1399-1404).
// ---------------------------------------------------------------------------

// Pack (M,) uint8 states into OC1 bytes: 2 bits/state (4-state) or
// 1 bit/state (2-state).  out must hold max(M*bits/8, 1) zeroed bytes.
// Hot loop runs 8 states per u64 with bit-folds (states are the bake's
// 67 MB/s-scale output; the byte-at-a-time form measured ~0.8 GB/s).
void omm_pack_states(const uint8_t* states, size_t m, int bits,
                     uint8_t* out) {
    if (bits == 2) {
        size_t full8 = m / 8;
        for (size_t i = 0; i < full8; ++i) {
            uint64_t x = read64(states + 8 * i) & 0x0303030303030303ULL;
            x |= x >> 6;   // pair states k,k+1 into byte k's low nibble
            x |= x >> 12;  // pair nibbles into bytes 0 and 4
            out[2 * i] = (uint8_t)(x & 0xFF);
            out[2 * i + 1] = (uint8_t)((x >> 32) & 0xFF);
        }
        for (size_t j = 8 * full8; j < m; ++j)
            out[j >> 2] |= (uint8_t)((states[j] & 3) << ((j & 3) << 1));
    } else {
        size_t full = m / 8;
        for (size_t i = 0; i < full; ++i) {
            uint64_t x = read64(states + 8 * i) & 0x0101010101010101ULL;
            out[i] = (uint8_t)((x * 0x0102040810204080ULL) >> 56);
        }
        for (size_t j = 8 * full; j < m; ++j)
            out[j >> 3] |= (uint8_t)((states[j] & 1) << (j & 7));
    }
}

// XXH64 over the 3-STATE view of a state array (UT==2 reads as UO==3,
// OmmArrayDataView bake_cpu_impl.cpp:374-377) without materializing the
// remapped copy: the exact-dedup stage keys work items by this digest
// (bake_cpu_impl.cpp:1031-1066), and the remap+copy+hash in numpy was
// the single most expensive host stage of a production bake.
// Input bytes must be states in {0..3}; remap is b | (b>>1 & 1).
static inline uint64_t s3map64(uint64_t x) {
    return x | ((x >> 1) & 0x0101010101010101ULL);
}

uint64_t omm_states3_xxh64(const uint8_t* data, size_t len, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint64_t h;

    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2;
        uint64_t v2 = seed + P2;
        uint64_t v3 = seed + 0;
        uint64_t v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xxh_round(v1, s3map64(read64(p))); p += 8;
            v2 = xxh_round(v2, s3map64(read64(p))); p += 8;
            v3 = xxh_round(v3, s3map64(read64(p))); p += 8;
            v4 = xxh_round(v4, s3map64(read64(p))); p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + P5;
    }

    h += (uint64_t)len;

    while (p + 8 <= end) {
        h ^= xxh_round(0, s3map64(read64(p)));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        uint32_t w = read32(p);
        w |= (w >> 1) & 0x01010101u;
        h ^= (uint64_t)w * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        uint8_t b = *p;
        b = (uint8_t)(b | ((b >> 1) & 1));
        h ^= b * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }

    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// Returns states[0] if every byte equals it, else -1 (early exit at the
// first differing 8-byte word).  Special-index promotion scans every
// work item per pass (bake_cpu_impl.cpp:1432-1472); contour-bearing
// items exit within their first cache lines.
int omm_all_uniform_u8(const uint8_t* p, size_t n) {
    if (n == 0) return -1;
    const uint64_t rep = 0x0101010101010101ULL * p[0];
    size_t i = 0;
    for (; i + 8 <= n; i += 8)
        if (read64(p + i) != rep) return -1;
    for (; i < n; ++i)
        if (p[i] != p[0]) return -1;
    return (int)p[0];
}

// Inverse of the device-side strided 2-bit pack (kernels/twophase.py
// _stageD): byte k holds micro-tris {k, k+Q, k+2Q, k+3Q}, Q = ceil(M/4).
void omm_unpack_2bit_strided(const uint8_t* packed, size_t q, size_t m,
                             uint8_t* out) {
    for (int plane = 0; plane < 4; ++plane) {
        size_t base = (size_t)plane * q;
        int shift = 2 * plane;
        size_t n = base < m ? (m - base < q ? m - base : q) : 0;
        for (size_t k = 0; k < n; ++k)
            out[base + k] = (uint8_t)((packed[k] >> shift) & 3);
    }
}

// Reconstruct per-micro-triangle states from the two-phase engine's
// compressed payload (kernels/twophase.py _stageD_spec layout): replays
// the device descent's deterministic scan-order compaction host-side —
// the C++ fast path of _BatchCtx.finish_compact.  This is the
// pipeline's non-overlapped tail (the LAST batch's payload has no later
// device work to hide behind), so the hot loops are byte-granular: a
// 256-entry LUT turns each packed side byte into 4 output states, and
// the final level streams parent-wise (E contiguous child bytes per
// parent) instead of materializing expanded node lists.
// omm_reconstruct_packed below is the same walk emitting the
// SERIALIZE-READY sequential 2-bit OC1 rows instead (4x less memory
// written; the bake consumes them without ever materializing the
// unpacked 4^N-byte arrays).
//
// buf: payload bytes; side stream i starts at side_off[i] (2-bit packed,
// value 0..2 maps to side -1/0/+1); the finals stream (2-bit states)
// starts at final_off.  active: T*M 0/1 mask or NULL (all active).
// scratch: caller-allocated int32[4 * max_nodes] — two ping-pong
// (node_t, node_n) candidate lists.
// skip_final (twophase._skip_final_p): the final level ships NO side
// stream — every child of an unresolved last-mid-level parent is an
// exact-kernel survivor, and the finals stream maps 1:1 to the children
// in scan order (all-active batches only, so `active` is NULL then).
void omm_reconstruct_states(
    const uint8_t* buf, const int64_t* side_off, int64_t final_off,
    const int32_t* levels, int32_t nlevels, int32_t T, int32_t subdiv,
    const int32_t* Cs, const int32_t* Cs_cap, int32_t K,
    uint8_t st_gt, uint8_t st_le, const uint8_t* active,
    int32_t* scratch, int64_t max_nodes, uint8_t* out,
    int32_t skip_final) {
    const int m = nlevels - 1;
    const int64_t M = (int64_t)1 << (2 * subdiv);
    const int64_t N0 = (int64_t)1 << (2 * levels[0]);
    const uint8_t smap[3] = {st_le, 0, st_gt};  // side -1/0/+1

    // byte -> 4 unpacked states (one state per output byte)
    uint32_t lut[256];
    for (int b = 0; b < 256; ++b) {
        uint32_t v = 0;
        for (int k = 0; k < 4; ++k)
            v |= (uint32_t)smap[(b >> (2 * k)) & 3] << (8 * k);
        lut[b] = v;
    }

    #define SIDE(i, j) \
        ((int)((buf[side_off[i] + ((j) >> 2)] >> (((j) & 3) * 2)) & 3) - 1)

    // level 0: dense fill (one run of M/N0 per node) + initial candidate
    // list in the same walk.  span0 is a power of 4: 1 or >= 4.
    const int64_t span0 = M / N0;
    const int64_t total0 = (int64_t)T * N0;
    const uint8_t* s0 = buf + side_off[0];
    int32_t* cur_t = scratch;
    int32_t* cur_n = scratch + max_nodes;
    int32_t* nxt_t = scratch + 2 * max_nodes;
    int32_t* nxt_n = scratch + 3 * max_nodes;
    int64_t cnt = 0;
    if (span0 == 1 && !active) {
        // levels[0] == subdiv: out IS the side stream mapped through lut
        int64_t q = 0;
        for (; q < total0 >> 2; ++q) {
            uint8_t b = s0[q];
            memcpy(out + 4 * q, &lut[b], 4);
            uint8_t z = (uint8_t)(b & ~(b >> 1) & 0x55);
            while (z) {
                int k = __builtin_ctz(z) >> 1;
                z = (uint8_t)(z & (z - 1));
                int64_t j = 4 * q + k;
                cur_t[cnt] = (int32_t)(j / N0);
                cur_n[cnt] = (int32_t)(j % N0);
                ++cnt;
            }
        }
        for (int64_t j = 4 * q; j < total0; ++j) {
            int s = SIDE(0, j);
            out[j] = smap[s + 1];
            if (s == 0) {
                cur_t[cnt] = (int32_t)(j / N0);
                cur_n[cnt] = (int32_t)(j % N0);
                ++cnt;
            }
        }
    } else {
        for (int64_t j = 0; j < total0; ++j) {
            int s = SIDE(0, j);
            memset(out + j * span0, smap[s + 1], (size_t)span0);
            if (s != 0) continue;
            int64_t t = j / N0, g = j % N0;
            if (active) {
                const uint8_t* a = active + t * M + g * span0;
                int any = 0;
                for (int64_t k = 0; k < span0; ++k)
                    if (a[k]) { any = 1; break; }
                if (!any) continue;
            }
            cur_t[cnt] = (int32_t)t;
            cur_n[cnt] = (int32_t)g;
            ++cnt;
        }
    }

    int64_t prev_cnt = cnt;
    for (int i = 1; i <= m; ++i) {
        const int E = 1 << (2 * (levels[i] - levels[i - 1]));  // >= 4
        int64_t Ci = Cs[i - 1] < Cs_cap[i - 1] ? Cs[i - 1] : Cs_cap[i - 1];
        if (Ci > prev_cnt) Ci = prev_cnt;
        const int64_t li_n = (int64_t)1 << (2 * levels[i]);
        const int64_t span = M / li_n;
        const uint8_t* si = buf + side_off[i];
        if (i < m) {
            // parent-wise walk: per child memset + unresolved compaction
            // into the other ping-pong buffer (scan order preserved)
            int64_t w = 0;
            for (int64_t p = 0; p < Ci; ++p) {
                const int64_t pt = cur_t[p];
                const int64_t pn0 = (int64_t)cur_n[p] * E;
                const uint8_t* sp = si + ((p * (int64_t)E) >> 2);
                uint8_t* op = out + (pt * li_n + pn0) * span;
                for (int eb = 0; eb < E >> 2; ++eb) {
                    uint8_t b = sp[eb];
                    if (span == 1) {
                        memcpy(op + 4 * eb, &lut[b], 4);
                    } else {
                        for (int k = 0; k < 4; ++k)
                            memset(op + (4 * eb + k) * span,
                                   smap[(b >> (2 * k)) & 3], (size_t)span);
                    }
                    uint8_t z = (uint8_t)(b & ~(b >> 1) & 0x55);
                    while (z) {
                        int k = __builtin_ctz(z) >> 1;
                        z = (uint8_t)(z & (z - 1));
                        nxt_t[w] = (int32_t)pt;
                        nxt_n[w] = (int32_t)(pn0 + 4 * eb + k);
                        ++w;
                    }
                }
            }
            prev_cnt = w;
            int32_t* tmp;
            tmp = cur_t; cur_t = nxt_t; nxt_t = tmp;
            tmp = cur_n; cur_n = nxt_n; nxt_n = tmp;
        } else if (skip_final) {
            // no final side stream: the finals (2-bit states) expand
            // 1:1 over each parent's E children (fc stays 4-aligned —
            // E is a multiple of 4)
            const uint8_t* fin = buf + final_off;
            uint32_t idlut[256];  // byte -> 4 raw 2-bit states
            for (int b = 0; b < 256; ++b) {
                uint32_t v = 0;
                for (int k = 0; k < 4; ++k)
                    v |= (uint32_t)((b >> (2 * k)) & 3) << (8 * k);
                idlut[b] = v;
            }
            int64_t fc = 0;
            for (int64_t p = 0; p < Ci; ++p) {
                uint8_t* op = out
                    + (int64_t)cur_t[p] * M + (int64_t)cur_n[p] * E;
                for (int eb = 0; eb < E >> 2; ++eb, fc += 4) {
                    if (fc + 4 <= (int64_t)K) {
                        memcpy(op + 4 * eb, &idlut[fin[fc >> 2]], 4);
                    } else {
                        for (int k = 0; k < 4 && fc + k < (int64_t)K; ++k)
                            op[4 * eb + k] = (uint8_t)(
                                (fin[(fc + k) >> 2]
                                 >> (((fc + k) & 3) * 2)) & 3);
                    }
                }
            }
        } else {
            // final level (span == 1): E contiguous out bytes per parent
            // via the LUT, then the finals stream scattered over the
            // survivors in the same ascending scan order
            const uint8_t* fin = buf + final_off;
            int64_t fc = 0;
            for (int64_t p = 0; p < Ci; ++p) {
                const int64_t base =
                    (int64_t)cur_t[p] * M + (int64_t)cur_n[p] * E;
                const uint8_t* sp = si + ((p * (int64_t)E) >> 2);
                uint8_t* op = out + base;
                for (int eb = 0; eb < E >> 2; ++eb) {
                    uint8_t b = sp[eb];
                    memcpy(op + 4 * eb, &lut[b], 4);
                    uint8_t z = (uint8_t)(b & ~(b >> 1) & 0x55);
                    while (z) {
                        int k = __builtin_ctz(z) >> 1;
                        z = (uint8_t)(z & (z - 1));
                        int64_t fid = base + 4 * eb + k;
                        if (active && !active[fid]) continue;
                        if (fc >= K) continue;
                        op[4 * eb + k] = (uint8_t)(
                            (fin[fc >> 2] >> ((fc & 3) * 2)) & 3);
                        ++fc;
                    }
                }
            }
        }
    }
    #undef SIDE
}

// Packed-direct replay: identical descent to omm_reconstruct_states but
// the output is each row's SEQUENTIAL 2-bit pack (state j in byte j>>2
// at shift (j&3)*2 — exactly serialize's OC1_4_State layout,
// bake_cpu_impl.cpp:1802-1819), so the bake can memcpy rows straight
// into the result blob and never materialize the 4^N-byte arrays.
// Restricted by the caller to the all-active case (no prior-state
// merge).  All span boundaries are byte-aligned: every level's span is
// a power of 4 and node offsets are span-multiples.
// row_base (optional, may be NULL): per-row byte offset of row t in
// `out` — the speculative-serialize path hands the FINAL result blob
// plus each item's morton-order offset so rows are written in place
// and the bake's serialize stage never copies them again.  NULL keeps
// the contiguous layout (row t at t*(M/4)).  Requires M >= 4 when set.
void omm_reconstruct_packed(
    const uint8_t* buf, const int64_t* side_off, int64_t final_off,
    const int32_t* levels, int32_t nlevels, int32_t T, int32_t subdiv,
    const int32_t* Cs, const int32_t* Cs_cap, int32_t K,
    uint8_t st_gt, uint8_t st_le,
    int32_t* scratch, int64_t max_nodes, uint8_t* out,
    const int64_t* row_base, int32_t skip_final) {
    const int m = nlevels - 1;
    const int64_t M = (int64_t)1 << (2 * subdiv);
    const int64_t N0 = (int64_t)1 << (2 * levels[0]);
    const uint8_t smap[3] = {st_le, 0, st_gt};  // side -1/0/+1
    // repeat a 2-bit state across a byte (4 states/byte)
    const uint8_t sfill[3] = {(uint8_t)(st_le * 0x55u), 0,
                              (uint8_t)(st_gt * 0x55u)};

    // side byte (4 x 2-bit raw sides) -> packed byte of 4 mapped states
    uint8_t plut[256];
    for (int b = 0; b < 256; ++b) {
        uint8_t v = 0;
        for (int k = 0; k < 4; ++k)
            v |= (uint8_t)(smap[(b >> (2 * k)) & 3] << (2 * k));
        plut[b] = v;
    }

    #define SIDE(i, j) \
        ((int)((buf[side_off[i] + ((j) >> 2)] >> (((j) & 3) * 2)) & 3) - 1)

    const int64_t span0 = M / N0;          // power of 4
    const int64_t total0 = (int64_t)T * N0;
    const uint8_t* s0 = buf + side_off[0];
    int32_t* cur_t = scratch;
    int32_t* cur_n = scratch + max_nodes;
    int32_t* nxt_t = scratch + 2 * max_nodes;
    int32_t* nxt_n = scratch + 3 * max_nodes;
    #define RB(t) (row_base ? row_base[(t)] : (int64_t)(t) * (M >> 2))
    int64_t cnt = 0;
    if (span0 == 1 && !row_base) {
        // levels[0] == subdiv: out IS the side stream mapped bytewise
        int64_t nb = total0 >> 2;
        for (int64_t q = 0; q < nb; ++q) {
            uint8_t b = s0[q];
            out[q] = plut[b];
            uint8_t z = (uint8_t)(b & ~(b >> 1) & 0x55);
            while (z) {
                int k = __builtin_ctz(z) >> 1;
                z = (uint8_t)(z & (z - 1));
                int64_t j = 4 * q + k;
                cur_t[cnt] = (int32_t)(j / N0);
                cur_n[cnt] = (int32_t)(j % N0);
                ++cnt;
            }
        }
        for (int64_t j = 4 * nb; j < total0; ++j) {
            int s = SIDE(0, j);
            out[j >> 2] = (uint8_t)(
                (out[j >> 2] & ~(3u << ((j & 3) * 2)))
                | ((uint32_t)smap[s + 1] << ((j & 3) * 2)));
            if (s == 0) {
                cur_t[cnt] = (int32_t)(j / N0);
                cur_n[cnt] = (int32_t)(j % N0);
                ++cnt;
            }
        }
    } else if (span0 == 1) {
        // per-row bases: levels[0] == subdiv and M >= 4, so each row
        // is exactly N0/4 whole bytes of the side stream
        const int64_t nbr = N0 >> 2;
        for (int64_t t = 0; t < T; ++t) {
            const uint8_t* sp = s0 + t * nbr;
            uint8_t* op = out + row_base[t];
            for (int64_t q = 0; q < nbr; ++q) {
                uint8_t b = sp[q];
                op[q] = plut[b];
                uint8_t z = (uint8_t)(b & ~(b >> 1) & 0x55);
                while (z) {
                    int k = __builtin_ctz(z) >> 1;
                    z = (uint8_t)(z & (z - 1));
                    cur_t[cnt] = (int32_t)t;
                    cur_n[cnt] = (int32_t)(4 * q + k);
                    ++cnt;
                }
            }
        }
    } else {
        // span0 >= 4: each node is span0/4 contiguous packed bytes
        const int64_t sb = span0 >> 2;
        for (int64_t t = 0; t < T; ++t) {
            uint8_t* ob = out + RB(t);
            const int64_t jt = t * N0;
            for (int64_t n = 0; n < N0; ++n) {
                int s = SIDE(0, jt + n);
                memset(ob + n * sb, sfill[s + 1], (size_t)sb);
                if (s != 0) continue;
                cur_t[cnt] = (int32_t)t;
                cur_n[cnt] = (int32_t)n;
                ++cnt;
            }
        }
    }

    int64_t prev_cnt = cnt;
    for (int i = 1; i <= m; ++i) {
        const int E = 1 << (2 * (levels[i] - levels[i - 1]));  // >= 4
        int64_t Ci = Cs[i - 1] < Cs_cap[i - 1] ? Cs[i - 1] : Cs_cap[i - 1];
        if (Ci > prev_cnt) Ci = prev_cnt;
        const int64_t li_n = (int64_t)1 << (2 * levels[i]);
        const int64_t span = M / li_n;     // power of 4
        const uint8_t* si = buf + side_off[i];
        if (i < m) {
            const int64_t sb = span >> 2;  // span >= 16 mid-descent
            int64_t w = 0;
            for (int64_t p = 0; p < Ci; ++p) {
                const int64_t pt = cur_t[p];
                const int64_t pn0 = (int64_t)cur_n[p] * E;
                const uint8_t* sp = si + ((p * (int64_t)E) >> 2);
                // byte offset = node_index * span / 4 (span >= 16 is a
                // power of 4, so the product is always byte-aligned —
                // divide AFTER multiplying)
                uint8_t* op = out + RB(pt) + ((pn0 * span) >> 2);
                for (int eb = 0; eb < E >> 2; ++eb) {
                    uint8_t b = sp[eb];
                    for (int k = 0; k < 4; ++k)
                        memset(op + (4 * eb + k) * sb,
                               sfill[(b >> (2 * k)) & 3], (size_t)sb);
                    uint8_t z = (uint8_t)(b & ~(b >> 1) & 0x55);
                    while (z) {
                        int k = __builtin_ctz(z) >> 1;
                        z = (uint8_t)(z & (z - 1));
                        nxt_t[w] = (int32_t)pt;
                        nxt_n[w] = (int32_t)(pn0 + 4 * eb + k);
                        ++w;
                    }
                }
            }
            prev_cnt = w;
            int32_t* tmp;
            tmp = cur_t; cur_t = nxt_t; nxt_t = tmp;
            tmp = cur_n; cur_n = nxt_n; nxt_n = tmp;
        } else if (skip_final) {
            // no final side stream and the finals ARE already the packed
            // 2-bit states of each parent's E children in scan order
            // (fc advances E, a multiple of 4, per parent — always byte
            // aligned): the final level is a pure memcpy scatter
            const uint8_t* fin = buf + final_off;
            int64_t fc = 0;
            for (int64_t p = 0; p < Ci; ++p, fc += E) {
                uint8_t* op = out + RB(cur_t[p])
                    + (((int64_t)cur_n[p] * E) >> 2);
                int64_t avail = ((int64_t)K - fc) >> 2;
                int64_t nb = E >> 2;
                if (avail < nb) nb = avail < 0 ? 0 : avail;
                memcpy(op, fin + (fc >> 2), (size_t)nb);
            }
        } else {
            // final level (span == 1): E children = E/4 packed bytes per
            // parent via plut, then survivor finals RMW'd in scan order
            const uint8_t* fin = buf + final_off;
            int64_t fc = 0;
            for (int64_t p = 0; p < Ci; ++p) {
                const uint8_t* sp = si + ((p * (int64_t)E) >> 2);
                uint8_t* op = out + RB(cur_t[p])
                    + (((int64_t)cur_n[p] * E) >> 2);
                for (int eb = 0; eb < E >> 2; ++eb) {
                    uint8_t b = sp[eb];
                    uint8_t v = plut[b];
                    uint8_t z = (uint8_t)(b & ~(b >> 1) & 0x55);
                    while (z) {
                        int k = __builtin_ctz(z) >> 1;
                        z = (uint8_t)(z & (z - 1));
                        if (fc >= K) continue;
                        uint8_t st = (uint8_t)(
                            (fin[fc >> 2] >> ((fc & 3) * 2)) & 3);
                        ++fc;
                        v = (uint8_t)((v & ~(3u << (2 * k)))
                                      | ((uint32_t)st << (2 * k)));
                    }
                    op[eb] = v;
                }
            }
        }
    }
    #undef SIDE
    #undef RB
}

// Per-row exact-dedup digest + uniform value from PACKED rows: XXH64
// over the UNPACKED 3-state byte sequence (identical to
// omm_states3_xxh64 of the materialized array) computed by expanding
// each packed byte into 4 remapped bytes through a LUT into a 32-byte
// stripe buffer — reads M/4 bytes per row instead of M.
// row_base (optional, may be NULL): per-row byte offset of row r in
// `packed` (the speculative-serialize blob layout); NULL = contiguous.
void omm_row_post_packed(const uint8_t* packed, int64_t rows, int64_t M,
                         uint64_t* dig, int32_t* uni,
                         const int64_t* row_base) {
    // packed byte -> 4 unpacked 3-state bytes (UT==2 reads as UO==3)
    uint32_t xlut[256];
    for (int b = 0; b < 256; ++b) {
        uint32_t v = 0;
        for (int k = 0; k < 4; ++k) {
            uint8_t s = (uint8_t)((b >> (2 * k)) & 3);
            s = (uint8_t)(s | ((s >> 1) & 1));
            v |= (uint32_t)s << (8 * k);
        }
        xlut[b] = v;
    }
    const int64_t Q = (M + 3) >> 2;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* p = packed + (row_base ? row_base[r] : r * Q);
        // uniform check on the packed row (pattern = s * 0x55)
        uint8_t first = (uint8_t)(p[0] & 3);
        uint8_t pat = (uint8_t)(first * 0x55u);
        int uniform = 1;
        for (int64_t q = 0; q < Q; ++q)
            if (p[q] != pat) { uniform = 0; break; }
        uni[r] = uniform ? (int32_t)first : -1;
        // streaming XXH64 over the expanded 3-state bytes
        uint64_t h;
        if (M >= 32) {
            uint64_t v1 = 0 + P1 + P2, v2 = 0 + P2, v3 = 0,
                     v4 = 0 - P1;
            int64_t nstripes = M / 32;
            for (int64_t s = 0; s < nstripes; ++s) {
                uint32_t e[8];
                const uint8_t* pb = p + 8 * s;
                for (int k = 0; k < 8; ++k) e[k] = xlut[pb[k]];
                uint64_t l1, l2, l3, l4;
                memcpy(&l1, &e[0], 8);
                memcpy(&l2, &e[2], 8);
                memcpy(&l3, &e[4], 8);
                memcpy(&l4, &e[6], 8);
                v1 = rotl64(v1 + l1 * P2, 31) * P1;
                v2 = rotl64(v2 + l2 * P2, 31) * P1;
                v3 = rotl64(v3 + l3 * P2, 31) * P1;
                v4 = rotl64(v4 + l4 * P2, 31) * P1;
            }
            h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12)
                + rotl64(v4, 18);
            h = (h ^ (rotl64(v1 * P2, 31) * P1)) * P1 + P4;
            h = (h ^ (rotl64(v2 * P2, 31) * P1)) * P1 + P4;
            h = (h ^ (rotl64(v3 * P2, 31) * P1)) * P1 + P4;
            h = (h ^ (rotl64(v4 * P2, 31) * P1)) * P1 + P4;
        } else {
            h = P5;
        }
        h += (uint64_t)M;
        // tail: M % 32 expanded bytes (M is a power of 4, so the tail is
        // 0, 4 or 16 bytes -> whole 8-byte words then a possible 4-byte)
        int64_t done = (M / 32) * 32;
        int64_t rem = M - done;
        const uint8_t* pt = p + (done >> 2);
        uint32_t e[4];
        for (int k = 0; k < (int)(rem >> 2); ++k) e[k] = xlut[pt[k]];
        int64_t rb = 0;
        while (rem - rb >= 8) {
            uint64_t l;
            memcpy(&l, (const uint8_t*)e + rb, 8);
            h ^= rotl64(l * P2, 31) * P1;
            h = rotl64(h, 27) * P1 + P4;
            rb += 8;
        }
        if (rem - rb >= 4) {
            uint32_t l;
            memcpy(&l, (const uint8_t*)e + rb, 4);
            h ^= (uint64_t)l * P1;
            h = rotl64(h, 23) * P2 + P3;
            rb += 4;
        }
        // (single bytes impossible: M is a power of 4)
        h ^= h >> 33;
        h *= P2;
        h ^= h >> 29;
        h *= P3;
        h ^= h >> 32;
        dig[r] = h;
    }
}

// Sequential 2-bit unpack (inverse of the packed replay rows /
// serialize's OC1_4_State layout): lazy materialization of
// WorkItem.states.
void omm_unpack_2bit_seq(const uint8_t* packed, size_t m, uint8_t* out) {
    size_t nb = m >> 2;
    for (size_t q = 0; q < nb; ++q) {
        uint8_t b = packed[q];
        out[4 * q] = (uint8_t)(b & 3);
        out[4 * q + 1] = (uint8_t)((b >> 2) & 3);
        out[4 * q + 2] = (uint8_t)((b >> 4) & 3);
        out[4 * q + 3] = (uint8_t)((b >> 6) & 3);
    }
    for (size_t j = 4 * nb; j < m; ++j)
        out[j] = (uint8_t)((packed[j >> 2] >> ((j & 3) * 2)) & 3);
}

// Fused per-row post pass over a (rows, M) state block fresh out of
// omm_reconstruct_states: the exact-dedup digest (3-state XXH64,
// bake_cpu_impl.cpp:1031-1066) and the special-index uniform scan
// (bake_cpu_impl.cpp:1432-1472) for every row while the block is still
// cache-warm — the bake tail then skips both full passes per item.
void omm_row_post(const uint8_t* block, int64_t rows, int64_t M,
                  uint64_t* dig, int32_t* uni) {
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* p = block + r * M;
        dig[r] = omm_states3_xxh64(p, (size_t)M, 0);
        uni[r] = omm_all_uniform_u8(p, (size_t)M);
    }
}

// Batched OC1 pack: all work items' state arrays into the result blob
// in one call (one python->C transition instead of one per item; the
// serialize stage is bake_cpu_impl.cpp:1802-1819 per item).  Each item's
// output span [offs[k], offs[k] + max(ms[k]*bits/8, 1)) is disjoint, so
// items pack on parallel threads, chunked by contiguous index ranges of
// roughly equal INPUT bytes (a single-threaded pack of a production
// bake's ~67 MB of states profiled at ~25 ms — a fourth of the e2e gap
// between omm.bake and the raw classify engine).
void omm_pack_states_batch(const uint64_t* state_ptrs, const int64_t* ms,
                           const int32_t* bits, const int64_t* offs,
                           int64_t n, uint8_t* out) {
    int64_t total = 0;
    for (int64_t k = 0; k < n; ++k) total += ms[k];
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nt = (int64_t)(hw ? hw : 1);
    if (nt > 8) nt = 8;
    if (nt > n) nt = n;
    if (nt < 2 || total < (4 << 20)) {
        for (int64_t k = 0; k < n; ++k)
            omm_pack_states((const uint8_t*)(uintptr_t)state_ptrs[k],
                            (size_t)ms[k], bits[k], out + offs[k]);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve((size_t)nt);
    int64_t per = (total + nt - 1) / nt;
    int64_t k0 = 0, acc = 0;
    for (int64_t t = 0; t < nt && k0 < n; ++t) {
        int64_t k1 = k0, want = acc + per;
        while (k1 < n && (acc < want || k1 == k0)) acc += ms[k1++];
        ts.emplace_back([=]() {
            for (int64_t k = k0; k < k1; ++k)
                omm_pack_states((const uint8_t*)(uintptr_t)state_ptrs[k],
                                (size_t)ms[k], bits[k], out + offs[k]);
        });
        k0 = k1;
    }
    for (auto& th : ts) th.join();
}

// Number of differing bytes between two state arrays (merge distance).
size_t omm_hamming_u8(const uint8_t* a, const uint8_t* b, size_t n) {
    size_t d = 0;
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t xa = read64(a + i) ^ read64(b + i);
        // per-byte nonzero count via bit tricks
        uint64_t hi = (xa & 0x8080808080808080ULL) >> 7;
        uint64_t lo = xa & 0x7F7F7F7F7F7F7F7FULL;
        uint64_t nz = ((lo + 0x7F7F7F7F7F7F7F7FULL) >> 7)
                      & 0x0101010101010101ULL;
        nz |= hi;
        d += (size_t)((nz * 0x0101010101010101ULL) >> 56);
    }
    for (; i < n; ++i) d += a[i] != b[i] ? 1 : 0;
    return d;
}

}  // extern "C"
