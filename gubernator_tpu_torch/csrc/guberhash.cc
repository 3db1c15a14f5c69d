// Batch 128-bit key hashing for the host-side assembler hot loop.
//
// The per-request Python overhead of hashing key strings one at a time
// dominates host-side batch assembly at high request rates; this native
// kernel hashes a whole batch in one call. MurmurHash3 x64 128-bit
// (Austin Appleby's public-domain algorithm, implemented here from the
// published spec) — the table identity hash never crosses process
// boundaries (peers route by fnv1 over strings; wire/state carry string
// keys), so the in-process hash choice is free.
//
// Built at first use by gubernator_tpu_torch/ops/_build.py:
//   g++ -std=c++17 -O3 -shared -fPIC -o libguberhash.so guberhash.cc

#include <cstdint>
#include <cstring>

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

static void murmur3_x64_128(const void* key, const int len, const uint32_t seed,
                            uint64_t* out_h1, uint64_t* out_h2) {
  const uint8_t* data = (const uint8_t*)key;
  const int nblocks = len / 16;

  uint64_t h1 = seed;
  uint64_t h2 = seed;

  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (int i = 0; i < nblocks; i++) {
    uint64_t k1, k2;
    memcpy(&k1, data + i * 16, 8);
    memcpy(&k2, data + i * 16 + 8, 8);

    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= ((uint64_t)tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= ((uint64_t)tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= ((uint64_t)tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= ((uint64_t)tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= ((uint64_t)tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= ((uint64_t)tail[9]) << 8; [[fallthrough]];
    case 9:
      k2 ^= ((uint64_t)tail[8]) << 0;
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
      [[fallthrough]];
    case 8: k1 ^= ((uint64_t)tail[7]) << 56; [[fallthrough]];
    case 7: k1 ^= ((uint64_t)tail[6]) << 48; [[fallthrough]];
    case 6: k1 ^= ((uint64_t)tail[5]) << 40; [[fallthrough]];
    case 5: k1 ^= ((uint64_t)tail[4]) << 32; [[fallthrough]];
    case 4: k1 ^= ((uint64_t)tail[3]) << 24; [[fallthrough]];
    case 3: k1 ^= ((uint64_t)tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= ((uint64_t)tail[1]) << 8; [[fallthrough]];
    case 1:
      k1 ^= ((uint64_t)tail[0]) << 0;
      k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= (uint64_t)len;
  h2 ^= (uint64_t)len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;

  *out_h1 = h1;
  *out_h2 = h2;
}

extern "C" {

// Hash one key. Returns hi/lo as signed-compatible uint64.
void guber_hash128(const char* key, int len, uint64_t* hi, uint64_t* lo) {
  murmur3_x64_128(key, len, 0, hi, lo);
  if (*hi == 0 && *lo == 0) *lo = 1;  // (0,0) is the empty-slot sentinel
}

// Hash a packed batch: `data` is the concatenation of all keys, offsets
// has n+1 entries. Also computes each key's slot group (lo % num_groups).
void guber_hash128_batch(const char* data, const int64_t* offsets, int n,
                         uint64_t num_groups, uint64_t* hi, uint64_t* lo,
                         int32_t* group) {
  for (int i = 0; i < n; i++) {
    const char* p = data + offsets[i];
    int len = (int)(offsets[i + 1] - offsets[i]);
    murmur3_x64_128(p, len, 0, &hi[i], &lo[i]);
    if (hi[i] == 0 && lo[i] == 0) lo[i] = 1;
    group[i] = (int32_t)(lo[i] % num_groups);
  }
}

}  // extern "C"
