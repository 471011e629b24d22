// Native Paillier compute kernels for the masking scheme's offline phase.
//
// This framework's analogue of the reference's C libpaillier + OpenMP blob
// loops (reference palisade_pybind/SHELFI_FHE/src/paillier.c:117-195,
// src/PaillierUtils.cpp:366-492): the batch encrypt / homomorphic-sum /
// decrypt of packed randomness blobs is the host-side hot path, so it is
// native C++ with OpenMP across blobs. Unlike the reference we depend on
// no GMP/Crypto++: a fixed-limb Montgomery bignum (64-bit limbs, u128
// products) is implemented here, and every divisions-needing constant
// (n^-1 mod 2^64k, R^2 mod m, lambda, mu) is precomputed host-side in
// Python integers and passed in as little-endian limb buffers.
//
// Number layout over the C ABI: arrays of uint64_t little-endian limbs,
// fixed width per context (k limbs for mod-n values, 2k for mod-n^2).
//
// Build: g++ -O2 -fopenmp -shared -fPIC paillier.cpp -o libpaillier.so

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef uint64_t u64;
typedef unsigned __int128 u128;

namespace {

constexpr int MAX_LIMBS = 128;   // up to 8192-bit modulus (n^2 of 4096-bit n)

// r = a + b, returns carry. All width `k`.
inline u64 add_n(u64* r, const u64* a, const u64* b, int k) {
    u128 c = 0;
    for (int i = 0; i < k; ++i) {
        c += (u128)a[i] + b[i];
        r[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

// r = a - b, returns borrow.
inline u64 sub_n(u64* r, const u64* a, const u64* b, int k) {
    unsigned char borrow = 0;
    u128 t;
    for (int i = 0; i < k; ++i) {
        t = (u128)a[i] - b[i] - borrow;
        r[i] = (u64)t;
        borrow = (t >> 64) ? 1 : 0;
    }
    return borrow;
}

inline int cmp_n(const u64* a, const u64* b, int k) {
    for (int i = k - 1; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

// Montgomery multiplication (CIOS): r = a * b * R^-1 mod m, R = 2^(64k).
// m odd, m0inv = -m^-1 mod 2^64. r must not alias a or b.
void mont_mul(u64* r, const u64* a, const u64* b, const u64* m, u64 m0inv,
              int k) {
    u64 t[MAX_LIMBS + 2];
    std::memset(t, 0, sizeof(u64) * (k + 2));
    for (int i = 0; i < k; ++i) {
        // t += a[i] * b
        u128 carry = 0;
        for (int j = 0; j < k; ++j) {
            carry += (u128)a[i] * b[j] + t[j];
            t[j] = (u64)carry;
            carry >>= 64;
        }
        carry += t[k];
        t[k] = (u64)carry;
        t[k + 1] = (u64)(carry >> 64);
        // reduce one limb
        u64 mu = t[0] * m0inv;
        carry = (u128)mu * m[0] + t[0];
        carry >>= 64;
        for (int j = 1; j < k; ++j) {
            carry += (u128)mu * m[j] + t[j];
            t[j - 1] = (u64)carry;
            carry >>= 64;
        }
        carry += t[k];
        t[k - 1] = (u64)carry;
        t[k] = t[k + 1] + (u64)(carry >> 64);
        t[k + 1] = 0;
    }
    if (t[k] != 0 || cmp_n(t, m, k) >= 0) {
        sub_n(r, t, m, k);
    } else {
        std::memcpy(r, t, sizeof(u64) * k);
    }
}

// r = base^exp * R mod m with base in Montgomery form (keeps Montgomery).
// exp: e_k limbs (little-endian), scanned left-to-right.
void mont_exp(u64* r, const u64* base_mont, const u64* exp, int e_k,
              const u64* m, u64 m0inv, const u64* one_mont, int k) {
    u64 acc[MAX_LIMBS], tmp[MAX_LIMBS];
    std::memcpy(acc, one_mont, sizeof(u64) * k);
    int started = 0;
    for (int i = e_k - 1; i >= 0; --i) {
        for (int b = 63; b >= 0; --b) {
            if (started) {
                mont_mul(tmp, acc, acc, m, m0inv, k);
                std::memcpy(acc, tmp, sizeof(u64) * k);
            }
            if ((exp[i] >> b) & 1) {
                mont_mul(tmp, acc, base_mont, m, m0inv, k);
                std::memcpy(acc, tmp, sizeof(u64) * k);
                started = 1;
            }
        }
    }
    std::memcpy(r, acc, sizeof(u64) * k);
}

// out (2k limbs) = a (k limbs) * b (k limbs), school-book.
void mul_full(u64* out, const u64* a, const u64* b, int k) {
    std::memset(out, 0, sizeof(u64) * 2 * k);
    for (int i = 0; i < k; ++i) {
        u128 carry = 0;
        for (int j = 0; j < k; ++j) {
            carry += (u128)a[i] * b[j] + out[i + j];
            out[i + j] = (u64)carry;
            carry >>= 64;
        }
        out[i + k] = (u64)carry;
    }
}

// r = a * b mod 2^(64k) (low half only) — for Hensel exact division.
void mul_low(u64* r, const u64* a, const u64* b, int k) {
    u64 t[MAX_LIMBS];
    std::memset(t, 0, sizeof(u64) * k);
    for (int i = 0; i < k; ++i) {
        u128 carry = 0;
        for (int j = 0; j + i < k; ++j) {
            carry += (u128)a[i] * b[j] + t[i + j];
            t[i + j] = (u64)carry;
            carry >>= 64;
        }
    }
    std::memcpy(r, t, sizeof(u64) * k);
}

struct MontCtx {
    const u64* m;        // modulus, k limbs
    const u64* rr;       // R^2 mod m (to enter Montgomery domain)
    const u64* one_mont; // R mod m
    u64 m0inv;
    int k;
};

// normal-domain modular multiply via two mont_muls: a*b mod m.
void mulmod(u64* r, const u64* a, const u64* b, const MontCtx& c) {
    u64 am[MAX_LIMBS];
    mont_mul(am, a, c.rr, c.m, c.m0inv, c.k);   // a*R
    mont_mul(r, am, b, c.m, c.m0inv, c.k);      // a*b
}

}  // namespace

extern "C" {

// ---- Paillier batch kernels ----------------------------------------------
// Context limbs: k = limbs of n; ciphertext width = 2k (mod n^2).
// All constants precomputed host-side:
//   n2      : n^2                      (2k limbs)
//   n2_rr   : R^2 mod n^2, R=2^(128k)  (2k limbs)
//   n2_one  : R mod n^2                (2k limbs)
//   n2_m0inv: -n^2^-1 mod 2^64
//   n       : modulus                  (k limbs)
//   n_hensel: n^-1 mod 2^(128k)        (2k limbs)

// c[i] = (1 + m[i]*n) * r[i]^n mod n^2
// msgs: count x k limbs; rands: count x k limbs; out: count x 2k limbs.
void paillier_encrypt_batch(
    const u64* n, const u64* n2, const u64* n2_rr, const u64* n2_one,
    u64 n2_m0inv, int k, const u64* msgs, const u64* rands, int count,
    u64* out) {
    const int k2 = 2 * k;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < count; ++i) {
        u64 rm[MAX_LIMBS], rn[MAX_LIMBS], gm[MAX_LIMBS], rext[MAX_LIMBS];
        // r -> Montgomery (widen to 2k first)
        std::memset(rext, 0, sizeof(u64) * k2);
        std::memcpy(rext, rands + (size_t)i * k, sizeof(u64) * k);
        mont_mul(rm, rext, n2_rr, n2, n2_m0inv, k2);
        // rn = r^n (Montgomery domain)
        mont_exp(rn, rm, n, k, n2, n2_m0inv, n2_one, k2);
        // gm = 1 + m*n  (normal domain, < n^2)
        mul_full(gm, msgs + (size_t)i * k, n, k);
        u128 cy = (u128)gm[0] + 1;
        gm[0] = (u64)cy;
        for (int j = 1; cy >> 64 && j < k2; ++j) {
            cy = (u128)gm[j] + 1;
            gm[j] = (u64)cy;
        }
        // out = gm * rn * R^-1 = gm * r^n  (rn still Montgomery: cancels)
        mont_mul(out + (size_t)i * k2, gm, rn, n2, n2_m0inv, k2);
    }
}

// out[i] = a[i] * b[i] mod n^2  (homomorphic addition of plaintexts)
void paillier_mul_batch(
    const u64* n2, const u64* n2_rr, u64 n2_m0inv, int k,
    const u64* a, const u64* b, int count, u64* out) {
    const int k2 = 2 * k;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < count; ++i) {
        u64 am[MAX_LIMBS];
        mont_mul(am, a + (size_t)i * k2, n2_rr, n2, n2_m0inv, k2);
        mont_mul(out + (size_t)i * k2, am, b + (size_t)i * k2, n2, n2_m0inv,
                 k2);
    }
}

// m[i] = L(c[i]^lambda mod n^2) * mu mod n,  L(x) = (x-1)/n (exact).
// lambda: k limbs; mu: k limbs; n_* : Montgomery ctx for n;
// n_hensel: n^-1 mod 2^(64k) (k limbs — quotient q < n fits k limbs).
void paillier_decrypt_batch(
    const u64* n, const u64* n_rr, const u64* n_one, u64 n_m0inv,
    const u64* n2, const u64* n2_rr, const u64* n2_one, u64 n2_m0inv,
    const u64* n_hensel, const u64* lambda, const u64* mu, int k,
    const u64* cts, int count, u64* out) {
    const int k2 = 2 * k;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < count; ++i) {
        u64 cm[MAX_LIMBS], cl[MAX_LIMBS], q[MAX_LIMBS];
        mont_mul(cm, cts + (size_t)i * k2, n2_rr, n2, n2_m0inv, k2);
        mont_exp(cl, cm, lambda, k, n2, n2_m0inv, n2_one, k2);
        // leave Montgomery: multiply by 1
        u64 onev[MAX_LIMBS];
        std::memset(onev, 0, sizeof(u64) * k2);
        onev[0] = 1;
        u64 plain[MAX_LIMBS];
        mont_mul(plain, cl, onev, n2, n2_m0inv, k2);
        // x - 1 (x = 1 + q*n exactly)
        sub_n(plain, plain, onev, k2);
        // q = (x-1) * n^-1 mod 2^(64k)
        mul_low(q, plain, n_hensel, k);
        // m = q * mu mod n
        MontCtx cn{n, n_rr, n_one, n_m0inv, k};
        mulmod(out + (size_t)i * k, q, mu, cn);
    }
}

int paillier_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

// Thread-count control for scaling measurements (the reference's OMP
// kernels are likewise ambient-thread-count controlled,
// PaillierUtils.cpp:705-760).
void paillier_set_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

}  // extern "C"
