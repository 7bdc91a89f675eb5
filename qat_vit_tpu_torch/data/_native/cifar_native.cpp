// Native data-plane for the CIFAR input pipeline.
//
// The reference's input pipeline rides on torch's native DataLoader machinery
// (C++ worker pool, pinned-memory collation) and PIL's C decoders. This is
// the equivalent native layer for this package: CIFAR binary-record decode
// (label byte + 3072 CHW bytes -> NHWC), batch gather (the collation hot
// path), and a counter-based shuffle — all branch-free tight loops that the
// GIL-holding numpy path can call through ctypes with zero copies.
//
// Build: g++ -O3 -march=native -shared -fPIC cifar_native.cpp -o libcifar_native.so
// (compiled on demand by qat_vit_tpu_torch/data/native_loader.py).

#include <cstdint>
#include <cstring>

extern "C" {

// CIFAR-10 .bin records: [label u8][R 32x32][G 32x32][B 32x32] per image.
// Decodes n_records into NHWC uint8 images and int32 labels.
// raw must hold n_records * 3073 bytes; images_out n*32*32*3; labels_out n.
void decode_cifar_bin(const uint8_t* raw, int64_t n_records,
                      uint8_t* images_out, int32_t* labels_out) {
    constexpr int64_t REC = 3073;
    constexpr int64_t HW = 32 * 32;
    for (int64_t i = 0; i < n_records; ++i) {
        const uint8_t* rec = raw + i * REC;
        labels_out[i] = static_cast<int32_t>(rec[0]);
        const uint8_t* r = rec + 1;
        const uint8_t* g = r + HW;
        const uint8_t* b = g + HW;
        uint8_t* out = images_out + i * HW * 3;
        for (int64_t p = 0; p < HW; ++p) {
            out[p * 3 + 0] = r[p];
            out[p * 3 + 1] = g[p];
            out[p * 3 + 2] = b[p];
        }
    }
}

// Batch collation: gather `n` images of `img_bytes` each by index.
// The hot path of every train step's host side; memcpy-bound.
void gather_batch(const uint8_t* images, const int64_t* indices, int64_t n,
                  int64_t img_bytes, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(out + i * img_bytes, images + indices[i] * img_bytes,
                    static_cast<size_t>(img_bytes));
    }
}

void gather_labels(const int32_t* labels, const int64_t* indices, int64_t n,
                   int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = labels[indices[i]];
    }
}

// splitmix64: deterministic counter-based RNG for the shuffle.
static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// Fisher-Yates permutation of [0, n) seeded by `seed` (independent of numpy's
// permutation stream — the python layer treats the two as alternative,
// equally-valid shuffles and pins one per run for determinism).
void shuffle_indices(int64_t n, uint64_t seed, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = i;
    uint64_t state = seed;
    for (int64_t i = n - 1; i > 0; --i) {
        state = splitmix64(state);
        int64_t j = static_cast<int64_t>(state % static_cast<uint64_t>(i + 1));
        int64_t t = out[i];
        out[i] = out[j];
        out[j] = t;
    }
}

int32_t native_abi_version() { return 1; }

}  // extern "C"
