// Fused SMPL blend shapes + linear blend skinning for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _blend_skin_kernel
// (human_dynamics_tpu/ops/smpl_pallas.py). Per frame n and vertex v:
//
//   posed_c[n,v] = sum_k coeffs[n,k] * dirs[c,k,v] + vt[c,v]    c in x,y,z, k < 224
//   b_k[n,v]     = sum_j rt_t[k*32 + j, n] * weights_t[j,v]     k < 12, j < 24
//   out_x = b0*px + b1*py + b2*pz + b9   (y: b3..b5 + b10, z: b6..b8 + b11)
//
// Only the three vertex planes (N, V) are written to device memory; the
// (N, V, 3) shaped/posed vertices and the (N, V, 12) blended transforms of
// the composed version never leave registers.
//
// What bounds it: the FP32 pipe. At the main path's shape (N = 1536 frames
// x heads, V = 6890) the two contractions are ~20 GFLOP, while the compulsory
// traffic is the 18.5 MB of dirs plus 127 MB of output planes. dirs is
// re-read once per frame tile, mostly from the 50 MB L2.
//
// Design (simple and correct first; no tensor cores, no TMA):
// - One thread per vertex, VT vertices and NT frames per block.
// - The block's NT rows of coeffs and rt_t are staged in shared memory,
//   laid out so that the inner loops read them as float4 broadcasts.
// - Each thread streams its vertex's column of the planar dirs[c][k][v] and
//   weights_t[j][v]; neighbouring threads read neighbouring addresses.
// - The frame tile is the fast grid axis, so blocks that run together read
//   the same columns of dirs and share them in L2.
// - fp32 accumulation throughout. The ragged frame and vertex edges are
//   bounds-checked instead of padded.

#include <cuda_runtime.h>

namespace {

constexpr int kCoef = 224;  // 10 betas + 207 pose features, zero-padded
constexpr int kRtCh = 12;   // 9 rotation + 3 translation channels
constexpr int kJp = 32;     // row stride of a channel in rt_t (24 joints padded)
constexpr int kJoints = 24;
constexpr int kVt = 128;    // vertices per block: one per thread
constexpr int kNt = 16;     // frames per block

__global__ void __launch_bounds__(kVt) blend_skin_kernel(
    const float* __restrict__ coeffs,     // (N, kCoef)
    const float* __restrict__ rt_t,       // (kRtCh * kJp, N)
    const float* __restrict__ dirs,       // (3, kCoef, V)
    const float* __restrict__ vt,         // (3, V)
    const float* __restrict__ weights_t,  // (kJp, V)
    float* __restrict__ out_x,            // (N, V)
    float* __restrict__ out_y,
    float* __restrict__ out_z,
    int n_frames, int n_verts) {
  __shared__ __align__(16) float cs[kCoef * kNt];            // [k][n]
  __shared__ __align__(16) float rs[kNt * kJoints * kRtCh];  // [n][j][ch]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kNt;
  const int v = blockIdx.y * kVt + tid;

  for (int i = tid; i < kNt * kCoef; i += kVt) {
    const int n = i / kCoef;
    const int k = i - n * kCoef;
    cs[k * kNt + n] =
        (n0 + n < n_frames) ? coeffs[(size_t)(n0 + n) * kCoef + k] : 0.f;
  }
  for (int i = tid; i < kNt * kJoints * kRtCh; i += kVt) {
    const int n = i % kNt;
    const int row = i / kNt;
    const int ch = row / kJoints;
    const int j = row - ch * kJoints;
    rs[(n * kJoints + j) * kRtCh + ch] =
        (n0 + n < n_frames)
            ? rt_t[(size_t)(ch * kJp + j) * n_frames + n0 + n]
            : 0.f;
  }
  __syncthreads();
  if (v >= n_verts) return;  // no barrier below this point

  // 1. Shape + pose blend shapes: K = 224 contraction for NT frames.
  float px[kNt], py[kNt], pz[kNt];
#pragma unroll
  for (int n = 0; n < kNt; ++n) px[n] = py[n] = pz[n] = 0.f;
  const size_t plane = (size_t)kCoef * n_verts;
  const float* dx_col = dirs + v;
  const float* dy_col = dirs + plane + v;
  const float* dz_col = dirs + 2 * plane + v;
#pragma unroll 2
  for (int k = 0; k < kCoef; ++k) {
    const float dx = __ldg(dx_col + (size_t)k * n_verts);
    const float dy = __ldg(dy_col + (size_t)k * n_verts);
    const float dz = __ldg(dz_col + (size_t)k * n_verts);
    const float4* c4 = reinterpret_cast<const float4*>(cs + k * kNt);
#pragma unroll
    for (int q = 0; q < kNt / 4; ++q) {
      const float4 c = c4[q];
      px[4 * q + 0] += c.x * dx; py[4 * q + 0] += c.x * dy; pz[4 * q + 0] += c.x * dz;
      px[4 * q + 1] += c.y * dx; py[4 * q + 1] += c.y * dy; pz[4 * q + 1] += c.y * dz;
      px[4 * q + 2] += c.z * dx; py[4 * q + 2] += c.z * dy; pz[4 * q + 2] += c.z * dz;
      px[4 * q + 3] += c.w * dx; py[4 * q + 3] += c.w * dy; pz[4 * q + 3] += c.w * dz;
    }
  }
  const float vtx = vt[v], vty = vt[n_verts + v], vtz = vt[2 * n_verts + v];

  // 2. Skinning weights of this vertex, kept in registers.
  float w[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) w[j] = __ldg(weights_t + (size_t)j * n_verts + v);

  // 3. Per frame: K = 24 contraction of the 12 transform channels, then the
  //    3x3 rotation + translation of the posed vertex.
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    if (n0 + n < n_frames) {
      float b[kRtCh];
#pragma unroll
      for (int ch = 0; ch < kRtCh; ++ch) b[ch] = 0.f;
      const float4* r4 = reinterpret_cast<const float4*>(rs + n * kJoints * kRtCh);
#pragma unroll
      for (int j = 0; j < kJoints; ++j) {
        const float4 a = r4[3 * j], c = r4[3 * j + 1], d = r4[3 * j + 2];
        b[0] += a.x * w[j]; b[1] += a.y * w[j]; b[2] += a.z * w[j]; b[3] += a.w * w[j];
        b[4] += c.x * w[j]; b[5] += c.y * w[j]; b[6] += c.z * w[j]; b[7] += c.w * w[j];
        b[8] += d.x * w[j]; b[9] += d.y * w[j]; b[10] += d.z * w[j]; b[11] += d.w * w[j];
      }
      const float x = px[n] + vtx, y = py[n] + vty, z = pz[n] + vtz;
      const size_t o = (size_t)(n0 + n) * n_verts + v;
      out_x[o] = b[0] * x + b[1] * y + b[2] * z + b[9];
      out_y[o] = b[3] * x + b[4] * y + b[5] * z + b[10];
      out_z[o] = b[6] * x + b[7] * y + b[8] * z + b[11];
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers are device pointers to contiguous float32 arrays.
int smpl_blend_skin_launch(const float* coeffs, const float* rt_t,
                           const float* dirs, const float* vt,
                           const float* weights_t, float* out_x, float* out_y,
                           float* out_z, int n_frames, int n_verts,
                           void* stream) {
  if (n_frames <= 0 || n_verts <= 0) return (int)cudaSuccess;
  const dim3 grid((n_frames + kNt - 1) / kNt, (n_verts + kVt - 1) / kVt);
  blend_skin_kernel<<<grid, kVt, 0, static_cast<cudaStream_t>(stream)>>>(
      coeffs, rt_t, dirs, vt, weights_t, out_x, out_y, out_z, n_frames,
      n_verts);
  return (int)cudaGetLastError();
}

const char* smpl_blend_skin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Layout constants, so the Python wrapper can check that it matches.
int smpl_blend_skin_layout(int which) {
  switch (which) {
    case 0: return kCoef;
    case 1: return kRtCh;
    case 2: return kJp;
    case 3: return kJoints;
    default: return -1;
  }
}

}  // extern "C"
