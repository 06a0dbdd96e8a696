// gsm_native — the host-side native helper of gsm_renderer_tpu_torch, a copy
// of gsm_renderer_tpu/native/gsm_native.cpp (the same functions, line for
// line, so that both packages decode a file to the same bits).
//
// The IO-side hot paths that run on the host CPU per scene load, exposed
// through a plain C ABI for ctypes:
//
//   * standard 3DGS PLY vertex decode (strided struct -> SoA, with log-scale /
//     logit-opacity conversion, placeholder skip and SH reordering) —
//     behavior parity with Utils/PLYLoader.swift:560-742
//   * PlayCanvas compressed PLY decode (11-10-11 position/scale, 2-bit
//     largest-component quaternion, 8888 color, per-chunk lerp) —
//     Utils/PLYLoader.swift:289-514
//   * 63-bit Morton encode + index sort (Utils/Scene.swift:44-138)
//
// Built by gsm_renderer_tpu_torch/native/__init__.py on first use:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -o libgsm_native.so gsm_native.cpp

#include <algorithm>
#include <atomic>
#include <functional>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

inline float sigmoidf(float x) { return 1.0f / (1.0f + std::exp(-x)); }

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    int64_t chunk = (n + hw - 1) / hw;
    if (chunk < 4096) {  // not worth spawning threads
        fn(0, n);
        return;
    }
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < hw; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min<int64_t>(n, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(fn, lo, hi);
    }
    for (auto& t : ts) t.join();
}

inline float load_f32(const uint8_t* p) {
    float v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t load_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

}  // namespace

extern "C" {

// Decode standard 3DGS PLY vertices (all properties float32 little-endian).
// offs_*: byte offsets of each property inside the vertex struct (-1 = absent).
// sh_rest_offset: offset of f_rest_0; n_rest = number of f_rest properties.
// Returns the number of kept (non-placeholder) vertices.
int64_t ply_decode_standard(
    const uint8_t* body, int64_t vertex_count, int64_t stride,
    int32_t off_x, int32_t off_y, int32_t off_z,
    int32_t off_s0, int32_t off_s1, int32_t off_s2,
    int32_t off_r0, int32_t off_r1, int32_t off_r2, int32_t off_r3,
    int32_t off_op, int32_t off_dc0, int32_t off_dc1, int32_t off_dc2,
    int32_t sh_rest_offset, int32_t n_rest,
    int32_t scale_is_log, int32_t opacity_is_logit, int32_t n_coeffs,
    // outputs (caller-allocated, vertex_count capacity)
    float* positions,   // (n, 3)
    float* scales,      // (n, 3)
    float* rotations,   // (n, 4) (x, y, z, w)
    float* opacities,   // (n,)
    float* harmonics)   // (n, n_coeffs, 3)
{
    // Pass 1: keep mask (placeholder skip must preserve order, so compute a
    // prefix of kept indices serially — cheap compared to decode).
    std::vector<int64_t> kept;
    kept.reserve(vertex_count);
    for (int64_t v = 0; v < vertex_count; ++v) {
        const uint8_t* p = body + v * stride;
        float s0 = off_s0 >= 0 ? load_f32(p + off_s0) : 0.f;
        float s1 = off_s1 >= 0 ? load_f32(p + off_s1) : 0.f;
        float s2 = off_s2 >= 0 ? load_f32(p + off_s2) : 0.f;
        float op = off_op >= 0 ? load_f32(p + off_op) : 0.f;
        bool placeholder = s0 == 2.0f && s1 == 2.0f && s2 == 2.0f &&
                           std::fabs(op - 4.8402f) < 0.001f;
        if (!placeholder) kept.push_back(v);
    }
    const int64_t n = static_cast<int64_t>(kept.size());
    const int higher = n_coeffs - 1;
    // channel stride in the file is its true per-channel count, not the
    // degree-clamped one (PLYLoader.swift:687-721 keeps the real shStride)
    const int file_higher = static_cast<int>(n_rest / 3);

    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* p = body + kept[i] * stride;
            positions[i * 3 + 0] = load_f32(p + off_x);
            positions[i * 3 + 1] = load_f32(p + off_y);
            positions[i * 3 + 2] = load_f32(p + off_z);
            float s0 = load_f32(p + off_s0);
            float s1 = load_f32(p + off_s1);
            float s2 = load_f32(p + off_s2);
            if (scale_is_log) {
                s0 = std::exp(s0);
                s1 = std::exp(s1);
                s2 = std::exp(s2);
            }
            scales[i * 3 + 0] = s0;
            scales[i * 3 + 1] = s1;
            scales[i * 3 + 2] = s2;
            // rot_0 = w, rot_1..3 = x, y, z; normalize
            float w = load_f32(p + off_r0);
            float x = load_f32(p + off_r1);
            float y = load_f32(p + off_r2);
            float z = load_f32(p + off_r3);
            float nrm = std::sqrt(std::max(x * x + y * y + z * z + w * w, 1e-24f));
            rotations[i * 4 + 0] = x / nrm;
            rotations[i * 4 + 1] = y / nrm;
            rotations[i * 4 + 2] = z / nrm;
            rotations[i * 4 + 3] = w / nrm;
            float op = load_f32(p + off_op);
            opacities[i] = opacity_is_logit ? sigmoidf(op) : op;
            if (n_coeffs > 0) {
                float* h = harmonics + i * n_coeffs * 3;
                h[0 * 3 + 0] = off_dc0 >= 0 ? load_f32(p + off_dc0) : 0.f;
                h[0 * 3 + 1] = off_dc1 >= 0 ? load_f32(p + off_dc1) : 0.f;
                h[0 * 3 + 2] = off_dc2 >= 0 ? load_f32(p + off_dc2) : 0.f;
                // PLY layout: [R1..Rk, G1..Gk, B1..Bk] (PLYLoader.swift:699-721)
                for (int ch = 0; ch < 3; ++ch) {
                    for (int c = 0; c < higher && c < file_higher; ++c) {
                        int idx = ch * file_higher + c;
                        float val = (idx < n_rest)
                            ? load_f32(p + sh_rest_offset + idx * 4) : 0.f;
                        h[(1 + c) * 3 + ch] = val;
                    }
                }
            }
        }
    });
    return n;
}

// Decode PlayCanvas compressed vertices (PLYLoader.swift:289-514).
// chunk_data: (n_chunks, 18) float32 rows:
//   min_xyz, max_xyz, min_scale_xyz, max_scale_xyz, min_rgb, max_rgb
void ply_decode_compressed(
    const float* chunk_data, int64_t n_chunks,
    const uint32_t* packed,  // (n, 4): position, rotation, scale, color
    int64_t n,
    float* positions, float* scales, float* rotations, float* opacities,
    float* harmonics /* (n, 1, 3) DC */)
{
    const float SH_C0 = 0.28209479177387814f;
    const float qnorm = 1.0f / (std::sqrt(2.0f) * 0.5f);

    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t ci = std::min(i / 256, n_chunks - 1);
            const float* ck = chunk_data + ci * 18;
            auto unorm = [](uint32_t v, int shift, int bits) {
                uint32_t mask = (1u << bits) - 1u;
                return float((v >> shift) & mask) / float(mask);
            };
            uint32_t pp = packed[i * 4 + 0];
            uint32_t pr = packed[i * 4 + 1];
            uint32_t ps = packed[i * 4 + 2];
            uint32_t pc = packed[i * 4 + 3];

            float tx = unorm(pp, 21, 11), ty = unorm(pp, 11, 10), tz = unorm(pp, 0, 11);
            positions[i * 3 + 0] = ck[0] + (ck[3] - ck[0]) * tx;
            positions[i * 3 + 1] = ck[1] + (ck[4] - ck[1]) * ty;
            positions[i * 3 + 2] = ck[2] + (ck[5] - ck[2]) * tz;

            float sx = unorm(ps, 21, 11), sy = unorm(ps, 11, 10), sz = unorm(ps, 0, 11);
            scales[i * 3 + 0] = std::exp(ck[6] + (ck[9] - ck[6]) * sx);
            scales[i * 3 + 1] = std::exp(ck[7] + (ck[10] - ck[7]) * sy);
            scales[i * 3 + 2] = std::exp(ck[8] + (ck[11] - ck[8]) * sz);

            float a = (unorm(pr, 20, 10) - 0.5f) * qnorm;
            float b = (unorm(pr, 10, 10) - 0.5f) * qnorm;
            float c = (unorm(pr, 0, 10) - 0.5f) * qnorm;
            float m = std::sqrt(std::max(0.0f, 1.0f - (a * a + b * b + c * c)));
            float qx, qy, qz, qw;
            switch (pr >> 30) {
                case 0: qx = a; qy = b; qz = c; qw = m; break;
                case 1: qx = m; qy = b; qz = c; qw = a; break;
                case 2: qx = b; qy = m; qz = c; qw = a; break;
                default: qx = b; qy = c; qz = m; qw = a; break;
            }
            rotations[i * 4 + 0] = qx;
            rotations[i * 4 + 1] = qy;
            rotations[i * 4 + 2] = qz;
            rotations[i * 4 + 3] = qw;

            float cr = ck[12] + (ck[15] - ck[12]) * unorm(pc, 24, 8);
            float cg = ck[13] + (ck[16] - ck[13]) * unorm(pc, 16, 8);
            float cb = ck[14] + (ck[17] - ck[14]) * unorm(pc, 8, 8);
            opacities[i] = unorm(pc, 0, 8);
            harmonics[i * 3 + 0] = (cr - 0.5f) / SH_C0;
            harmonics[i * 3 + 1] = (cg - 0.5f) / SH_C0;
            harmonics[i * 3 + 2] = (cb - 0.5f) / SH_C0;
        }
    });
}

// 63-bit Morton codes over the positions' AABB + stable argsort.
// (Utils/Scene.swift:44-138)
void morton_sort_indices(const float* positions, int64_t n, int64_t* order) {
    if (n == 0) return;
    float lo[3] = {positions[0], positions[1], positions[2]};
    float hi[3] = {positions[0], positions[1], positions[2]};
    for (int64_t i = 0; i < n; ++i) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], positions[i * 3 + k]);
            hi[k] = std::max(hi[k], positions[i * 3 + k]);
        }
    }
    float inv[3];
    for (int k = 0; k < 3; ++k) {
        float ext = std::max(hi[k] - lo[k], 1e-12f);
        inv[k] = float((1 << 21) - 1) / ext;
    }
    auto expand = [](uint64_t v) {
        v &= 0x1FFFFFULL;
        v = (v | (v << 32)) & 0x1F00000000FFFFULL;
        v = (v | (v << 16)) & 0x1F0000FF0000FFULL;
        v = (v | (v << 8)) & 0x100F00F00F00F00FULL;
        v = (v | (v << 4)) & 0x10C30C30C30C30C3ULL;
        v = (v | (v << 2)) & 0x1249249249249249ULL;
        return v;
    };
    std::vector<uint64_t> codes(n);
    parallel_for(n, [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            uint64_t q[3];
            for (int k = 0; k < 3; ++k) {
                float t = (positions[i * 3 + k] - lo[k]) * inv[k];
                t = std::min(std::max(t, 0.0f), float((1 << 21) - 1));
                q[k] = uint64_t(t);
            }
            codes[i] = expand(q[0]) | (expand(q[1]) << 1) | (expand(q[2]) << 2);
        }
    });
    std::iota(order, order + n, int64_t{0});
    std::stable_sort(order, order + n, [&](int64_t a, int64_t b) {
        return codes[a] < codes[b];
    });
}

}  // extern "C"
