// host_aes.cpp — native host-side runtime helpers for micro_aes.
//
// Provides (exposed through ctypes, see native/__init__.py):
//   * an INDEPENDENT scalar AES oracle (fresh FIPS-197 implementation,
//     tables computed at init from the field definition) used for
//     differential testing against the device engines;
//   * forgiving hex codecs for the 14 MB CAVP vector corpus;
//   * batched block preparation (pad + reshape) for zero-copy handoff
//     into the JAX pipelines.
//
// This is deliberately written in a different style from both the
// reference C library and the Python code: word-oriented state, tables
// derived at runtime, no compile-time mode configuration.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

uint8_t SBOX[256];
uint8_t INV_SBOX[256];
bool tables_ready = false;

uint8_t gmul(uint8_t a, uint8_t b) {
    uint8_t r = 0;
    while (b) {
        if (b & 1) r ^= a;
        a = static_cast<uint8_t>((a << 1) ^ ((a & 0x80) ? 0x1B : 0x00));
        b >>= 1;
    }
    return r;
}

void init_tables() {
    if (tables_ready) return;
    // multiplicative inverse via exp/log over generator 3, then affine
    uint8_t exp_t[256], log_t[256];
    uint8_t x = 1;
    for (int i = 0; i < 255; ++i) {
        exp_t[i] = x;
        log_t[x] = static_cast<uint8_t>(i);
        x = gmul(x, 3);
    }
    for (int v = 0; v < 256; ++v) {
        uint8_t inv = v ? exp_t[(255 - log_t[v]) % 255] : 0;
        uint8_t y = inv;
        for (int r = 1; r <= 4; ++r)
            y ^= static_cast<uint8_t>((inv << r) | (inv >> (8 - r)));
        SBOX[v] = y ^ 0x63;
    }
    for (int v = 0; v < 256; ++v) INV_SBOX[SBOX[v]] = static_cast<uint8_t>(v);
    tables_ready = true;
}

struct Schedule {
    uint8_t rk[15][16];
    int rounds;
};

void expand(const uint8_t* key, int keylen, Schedule& s) {
    init_tables();
    const int nk = keylen / 4;
    s.rounds = nk + 6;
    const int nwords = 4 * (s.rounds + 1);
    uint8_t w[60][4];
    std::memcpy(w, key, static_cast<size_t>(keylen));
    uint8_t rcon = 1;
    for (int i = nk; i < nwords; ++i) {
        uint8_t t[4] = {w[i - 1][0], w[i - 1][1], w[i - 1][2], w[i - 1][3]};
        if (i % nk == 0) {
            uint8_t first = t[0];
            t[0] = static_cast<uint8_t>(SBOX[t[1]] ^ rcon);
            t[1] = SBOX[t[2]];
            t[2] = SBOX[t[3]];
            t[3] = SBOX[first];
            rcon = gmul(rcon, 2);
        } else if (nk > 6 && i % nk == 4) {
            for (int j = 0; j < 4; ++j) t[j] = SBOX[t[j]];
        }
        for (int j = 0; j < 4; ++j) w[i][j] = w[i - nk][j] ^ t[j];
    }
    std::memcpy(s.rk, w, static_cast<size_t>(16 * (s.rounds + 1)));
}

inline void add_key(uint8_t* st, const uint8_t* k) {
    for (int i = 0; i < 16; ++i) st[i] ^= k[i];
}

void encrypt_block(const Schedule& s, uint8_t* st) {
    add_key(st, s.rk[0]);
    for (int r = 1; r <= s.rounds; ++r) {
        uint8_t t[16];
        // SubBytes + ShiftRows fused: out[4c+row] = S(in[4((c+row)%4)+row])
        for (int c = 0; c < 4; ++c)
            for (int row = 0; row < 4; ++row)
                t[4 * c + row] = SBOX[st[4 * ((c + row) & 3) + row]];
        if (r != s.rounds) {
            for (int c = 0; c < 4; ++c) {
                uint8_t* a = t + 4 * c;
                uint8_t all = a[0] ^ a[1] ^ a[2] ^ a[3];
                uint8_t a0 = a[0];
                for (int row = 0; row < 4; ++row) {
                    uint8_t next = (row < 3) ? a[row + 1] : a0;
                    st[4 * c + row] = static_cast<uint8_t>(
                        a[row] ^ all ^ gmul(static_cast<uint8_t>(a[row] ^ next), 2));
                }
            }
        } else {
            std::memcpy(st, t, 16);
        }
        add_key(st, s.rk[r]);
    }
}

void decrypt_block(const Schedule& s, uint8_t* st) {
    add_key(st, s.rk[s.rounds]);
    for (int r = s.rounds - 1; r >= 0; --r) {
        uint8_t t[16];
        // InvShiftRows + InvSubBytes fused
        for (int c = 0; c < 4; ++c)
            for (int row = 0; row < 4; ++row)
                t[4 * ((c + row) & 3) + row] = INV_SBOX[st[4 * c + row]];
        add_key(t, s.rk[r]);
        if (r != 0) {
            for (int c = 0; c < 4; ++c) {
                const uint8_t* a = t + 4 * c;
                for (int row = 0; row < 4; ++row) {
                    st[4 * c + row] = static_cast<uint8_t>(
                        gmul(a[row], 14) ^ gmul(a[(row + 1) & 3], 11) ^
                        gmul(a[(row + 2) & 3], 13) ^ gmul(a[(row + 3) & 3], 9));
                }
            }
        } else {
            std::memcpy(st, t, 16);
        }
    }
}

}  // namespace

extern "C" {

// Encrypt/decrypt nblocks independent 16-byte blocks (ECB semantics).
void uaes_oracle_encrypt(const uint8_t* key, int keylen,
                         const uint8_t* in, uint8_t* out, size_t nblocks) {
    Schedule s;
    expand(key, keylen, s);
    for (size_t i = 0; i < nblocks; ++i) {
        std::memcpy(out + 16 * i, in + 16 * i, 16);
        encrypt_block(s, out + 16 * i);
    }
}

void uaes_oracle_decrypt(const uint8_t* key, int keylen,
                         const uint8_t* in, uint8_t* out, size_t nblocks) {
    Schedule s;
    expand(key, keylen, s);
    for (size_t i = 0; i < nblocks; ++i) {
        std::memcpy(out + 16 * i, in + 16 * i, 16);
        decrypt_block(s, out + 16 * i);
    }
}

// Forgiving hex decode (skips non-hex chars); returns bytes written.
size_t uaes_hex_decode(const char* hex, size_t n, uint8_t* out) {
    size_t w = 0;
    int have = 0;
    uint8_t acc = 0;
    for (size_t i = 0; i < n; ++i) {
        char ch = hex[i];
        int v;
        if (ch >= '0' && ch <= '9') v = ch - '0';
        else if (ch >= 'a' && ch <= 'f') v = ch - 'a' + 10;
        else if (ch >= 'A' && ch <= 'F') v = ch - 'A' + 10;
        else continue;
        acc = static_cast<uint8_t>((acc << 4) | v);
        if (++have == 2) {
            out[w++] = acc;
            have = 0;
            acc = 0;
        }
    }
    return w;
}

// Zero-pad a byte stream into 16-byte blocks; returns block count.
size_t uaes_prepare_blocks(const uint8_t* data, size_t n, uint8_t* out,
                           size_t out_capacity_blocks) {
    size_t nb = (n + 15) / 16;
    if (nb > out_capacity_blocks) return 0;
    std::memcpy(out, data, n);
    std::memset(out + n, 0, nb * 16 - n);
    return nb;
}

}  // extern "C"
