// The tri-plane sampler's backward kernel and its launcher, which
// triplane_bwd.cu instantiates. The header comment of triplane_bwd.cu
// describes the function and the design.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "triplane_common.cuh"

namespace hfa {

constexpr int BWD_THREADS = 256;
constexpr int BWD_MIN_BLOCKS = 3;    // blocks a multiprocessor: 85 registers
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_TILE_POINTS = BWD_THREADS;  // a point a thread in step 1
constexpr int BWD_MAX_CELLS = 768;   // buckets a plane (at most 4 a thread)
constexpr int BWD_SORT_MAX_C = 32;   // channels of the sorted path's g tile

// How a batch element's M points are cut into the blocks' tiles. The points
// are lh x lw rays, row-major, of ln samples each (lh * lw * ln == M, point
// m = (row * lw + col) * ln + sample); a tile is th x tw rays x tn samples,
// at most BWD_TILE_POINTS, and there are nth x ntw x ntn tiles. Without a
// layout lh = lw = 1 and ln = M: tiles are contiguous runs of tn points.
struct BwdTiles {
  int lh, lw, ln;
  int th, tw, tn;
  int nth, ntw, ntn;
};

// one 16-byte reduction (red.global.add.v4.f32 on sm_90)
__device__ __forceinline__ void global_add4(float* p, float a, float b,
                                            float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// A point's two axes on each plane: plane 0 spans (u, v) = (x, y), plane 1
// (x, z), plane 2 (z, x); columns run over W, rows over H. With H = W three
// axis footprints serve all three planes, as in the forward.
struct PlaneAxes {
  Axis u[3], v[3];
};

__device__ __forceinline__ PlaneAxes plane_axes(const float* __restrict__ xyz,
                                                float scale, int H, int W) {
  const float x = scale * __ldg(xyz + 0);
  const float y = scale * __ldg(xyz + 1);
  const float z = scale * __ldg(xyz + 2);
  PlaneAxes a;
  a.u[0] = axis_footprint(x, W);
  a.u[1] = a.u[0];
  a.u[2] = axis_footprint(z, W);
  a.v[0] = axis_footprint(y, H);
  if (H == W) {
    a.v[1] = a.u[2];
    a.v[2] = a.u[0];
  } else {
    a.v[1] = axis_footprint(z, H);
    a.v[2] = axis_footprint(x, H);
  }
  return a;
}

__device__ __forceinline__ int warp_max(int v) {
#ifdef HFA_HOST_REHEARSAL
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
#else
  return __reduce_max_sync(0xffffffffu, v);
#endif
}

// a[0..n) ← its exclusive prefix sums and a[n] ← the total, n ≤ 4 x the
// block's threads; every thread of the block calls it
__device__ __forceinline__ void block_exclusive_scan(int* a, int n,
                                                     int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v[4], sum = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid * 4 + k;
    v[k] = i < n ? a[i] : 0;
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum, total = 0;
#pragma unroll
  for (int w = 0; w < BWD_WARPS; ++w) {
    if (w < warp) run += warp_sums[w];
    total += warp_sums[w];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid * 4 + k;
    if (i < n) a[i] = run;
    run += v[k];
  }
  if (tid == 0) a[n] = total;
}

// g (B, M, C), coords (B, M, 3), grad (B, 3, H, W, C) zeroed. Block
// (blockIdx.x, blockIdx.y) takes tile blockIdx.x of batch element
// blockIdx.y. In the direct pass a point is served by 2^lp_shift
// consecutive lanes, each VW channels wide, striding over C, as in the
// forward; in the sorted path a bucket row is. SORT: the sorted path, and
// with it the g tile in shared memory, where a texel row is 16-byte lanes
// of at most 32 channels (the launcher sends any other C to the direct
// pass alone).
template <int VW, bool SORT>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
triplane_bwd_kernel(const float* __restrict__ g,
                    const float* __restrict__ coords,
                    float* __restrict__ grad, int M, int H, int W, int C,
                    float scale, BwdTiles t, int lp_shift) {
  static_assert(!SORT || VW == 4, "the sorted path reads 16-byte lanes");

  extern __shared__ float4 g_tile[];          // (points, C / 4), SORT only
  __shared__ int s_m[BWD_TILE_POINTS];
  // a plane's points in bucket order: each one's row of g_tile and its
  // weights lo_u, hi_u, lo_v, hi_v
  __shared__ int s_sorted[3][BWD_TILE_POINTS];
  __shared__ float4 s_sorted_w[3][BWD_TILE_POINTS];
  __shared__ int s_cell[3][BWD_MAX_CELLS + 1];  // counts, then offsets
  // per plane: -first bucket column, last, -first bucket row, last (all by
  // atomicMax); then the bucket box's corner and size, and the plane's path
  __shared__ int s_box[3][4];
  __shared__ int s_geo[3][4];
  __shared__ int s_path[3];                   // 0 none, 1 sorted, 2 direct
  __shared__ int s_warp[BWD_WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  int tile = blockIdx.x;
  const int tk = tile % t.ntn;
  tile /= t.ntn;
  const int tj = tile % t.ntw;
  const int ti = tile / t.ntw;
  const int r0 = ti * t.th, c0 = tj * t.tw, k0 = tk * t.tn;
  const int nh = min(t.th, t.lh - r0);
  const int nw = min(t.tw, t.lw - c0);
  const int nn = min(t.tn, t.ln - k0);
  const int P = nh * nw * nn;
  const int64_t plane_size = (int64_t)H * W * C;
  const float* gb = g + (int64_t)b * M * C;
  const float* cb = coords + (int64_t)b * M * 3;
  float* grad_b = grad + (int64_t)b * 3 * plane_size;

  // -- 1. a thread a point (samples fastest): its index, its weights on
  // each plane and the buckets of its north-west corners; each plane's
  // bucket box over the points that touch it
  if (tid < 12) (&s_box[0][0])[tid] = INT_MIN;
  __syncthreads();
  const int p = tid;
  int iu[3] = {0, 0, 0}, iv[3] = {0, 0, 0};
  bool touch[3] = {false, false, false};
  float4 wp[3];
  if (p < P) {
    const int k = p % nn;
    const int q = p / nn;
    const int m = ((r0 + q / nw) * t.lw + c0 + q % nw) * t.ln + k0 + k;
    s_m[p] = m;
    if constexpr (SORT) {
      const PlaneAxes a = plane_axes(cb + (int64_t)m * 3, scale, H, W);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        const Axis& au = a.u[pl];
        const Axis& av = a.v[pl];
        // a point no corner of which lies inside the plane is left out: its
        // index and weights mean nothing (NaN or far-off coordinates)
        touch[pl] = (au.v0 || au.v1) && (av.v0 || av.v1);
        iu[pl] = au.i;
        iv[pl] = av.i;
        wp[pl] = make_float4(au.lo, au.hi, av.lo, av.hi);
      }
    }
  }
  if constexpr (SORT) {
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const int box[4] = {touch[pl] ? -iu[pl] : INT_MIN,
                          touch[pl] ? iu[pl] : INT_MIN,
                          touch[pl] ? -iv[pl] : INT_MIN,
                          touch[pl] ? iv[pl] : INT_MIN};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = warp_max(box[i]);
        if (lane == 0 && v != INT_MIN) atomicMax(&s_box[pl][i], v);
      }
    }
  }
  __syncthreads();

  // -- 2. the plan: a plane whose buckets fit s_cell takes the sorted path,
  // any other the direct one; and the tile's g in shared memory
  if (tid == 0) {
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const bool live = s_box[pl][1] != INT_MIN;
      const int u0 = -s_box[pl][0], v0 = -s_box[pl][2];
      const int64_t bw = live ? (int64_t)s_box[pl][1] - u0 + 1 : 0;
      const int64_t bh = live ? (int64_t)s_box[pl][3] - v0 + 1 : 0;
      s_geo[pl][0] = u0;
      s_geo[pl][1] = v0;
      s_geo[pl][2] = (int)bw;
      s_geo[pl][3] = (int)bh;
      s_path[pl] = !SORT ? 2 : !live ? 0 : bw * bh <= BWD_MAX_CELLS ? 1 : 2;
    }
  }
  const int quads = C / 4;
  if constexpr (SORT) {
    // at most 8 rows of 16 bytes a thread (256 points, C <= 32): all of
    // them in flight before the first is stored
    float4 x[BWD_SORT_MAX_C / 4];
#pragma unroll
    for (int k = 0; k < BWD_SORT_MAX_C / 4; ++k) {
      const int i = tid + k * BWD_THREADS;
      const int q = i / quads;
      if (i < P * quads)
        x[k] = __ldg(reinterpret_cast<const float4*>(
            gb + (int64_t)s_m[q] * C + (i - q * quads) * 4));
    }
#pragma unroll
    for (int k = 0; k < BWD_SORT_MAX_C / 4; ++k) {
      const int i = tid + k * BWD_THREADS;
      if (i < P * quads) g_tile[i] = x[k];
    }
  }
  __syncthreads();

  // -- 3. the direct pass: each plane that is not sorted takes g / 3 x
  // weight straight into grad, 16 bytes a lane and corner (one float a
  // lane where C % 4 != 0)
  const int direct = (s_path[0] == 2) | (s_path[1] == 2) << 1
                     | (s_path[2] == 2) << 2;
  const int sub = lane & ((1 << lp_shift) - 1);
  const int slot = tid >> lp_shift;          // a point (or texel) a slot
  const int slots = BWD_THREADS >> lp_shift;
  if (direct) {
    for (int pp = slot; pp < P; pp += slots) {
      const int m = s_m[pp];
      const PlaneAxes a = plane_axes(cb + (int64_t)m * 3, scale, H, W);
      for (int c = sub * VW; c < C; c += VW << lp_shift) {
        float gv[VW];
        if constexpr (SORT) {
          const float4 x = g_tile[pp * quads + c / 4];
          gv[0] = x.x;
          gv[1 % VW] = x.y;
          gv[2 % VW] = x.z;
          gv[3 % VW] = x.w;
        } else if constexpr (VW == 4) {
          const float4 x = __ldg(
              reinterpret_cast<const float4*>(gb + (int64_t)m * C + c));
          gv[0] = x.x;
          gv[1 % VW] = x.y;
          gv[2 % VW] = x.z;
          gv[3 % VW] = x.w;
        } else {
          gv[0] = __ldg(gb + (int64_t)m * C + c);
        }
#pragma unroll
        for (int k = 0; k < VW; ++k) gv[k] = gv[k] / 3.0f;
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) {
          if (!(direct & (1 << pl))) continue;
          const Axis& au = a.u[pl];
          const Axis& av = a.v[pl];
          // corners nw, ne, sw, se (row offset corner >> 1, column offset
          // corner & 1): weight, and whether the texel is inside the plane
          const float wt[4] = {au.lo * av.lo, au.hi * av.lo, au.lo * av.hi,
                               au.hi * av.hi};
          const bool ok[4] = {av.v0 && au.v0, av.v0 && au.v1, av.v1 && au.v0,
                              av.v1 && au.v1};
          const int64_t q = pl * plane_size
              + ((int64_t)av.i * W + au.i) * C + c;
#pragma unroll
          for (int corner = 0; corner < 4; ++corner) {
            if (!ok[corner]) continue;
            float* r = grad_b
                + (q + ((int64_t)(corner >> 1) * W + (corner & 1)) * C);
            if constexpr (VW == 4) {
              global_add4(r, gv[0] * wt[corner], gv[1 % VW] * wt[corner],
                          gv[2 % VW] * wt[corner], gv[3 % VW] * wt[corner]);
            } else {
              atomicAdd(r, gv[0] * wt[corner]);
            }
          }
        }
      }
    }
  }

  // -- 4. the sorted path, the three planes at once: a counting sort of
  // the tile's points by the bucket of their north-west corner (integer
  // shared atomics), then a sweep over each bucket row that sums every
  // point's four corners in registers and adds each texel row to grad at
  // most twice
  if constexpr (SORT) {
    const int sorted = (s_path[0] == 1) | (s_path[1] == 1) << 1
                       | (s_path[2] == 1) << 2;
    if (!sorted) return;                      // the same for the whole block
    int cells[3], rows[3];
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const bool on = (sorted >> pl) & 1;
      cells[pl] = on ? s_geo[pl][2] * s_geo[pl][3] : 0;
      rows[pl] = on ? s_geo[pl][3] : 0;
      for (int i = tid; i <= cells[pl]; i += BWD_THREADS) s_cell[pl][i] = 0;
    }
    __syncthreads();
    int cell[3] = {-1, -1, -1}, rank[3] = {0, 0, 0};
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      if (((sorted >> pl) & 1) && p < P && touch[pl]) {
        cell[pl] = (iv[pl] - s_geo[pl][1]) * s_geo[pl][2]
                   + (iu[pl] - s_geo[pl][0]);
        rank[pl] = atomicAdd(&s_cell[pl][cell[pl]], 1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      if ((sorted >> pl) & 1) {
        block_exclusive_scan(s_cell[pl], cells[pl], s_warp);
        __syncthreads();
      }
    }
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      if (cell[pl] >= 0) {
        const int at = s_cell[pl][cell[pl]] + rank[pl];
        s_sorted[pl][at] = p * quads;
        s_sorted_w[pl][at] = wp[pl];
      }
    }
    __syncthreads();

    // a group of lanes a bucket row, sweeping it west to east: bucket
    // (r, c) holds the points whose north-west corner is texel (r, c), so
    // texel (r, c) takes the bucket's nw sums and the ne sums of the bucket
    // west of it, and texel (r + 1, c) its sw sums and the west bucket's se
    // sums, carried in registers. Each point is read once, each texel gets
    // at most two adds (from the bucket rows above and below it)
    const int c = sub * 4;
    const int total = rows[0] + rows[1] + rows[2];
    for (int x = slot; x < total; x += slots) {
      const int pl = x < rows[0] ? 0 : x < rows[0] + rows[1] ? 1 : 2;
      const int br = x - (pl > 0 ? rows[0] : 0) - (pl > 1 ? rows[1] : 0);
      const int bu0 = s_geo[pl][0], bw = s_geo[pl][2];
      const int row = s_geo[pl][1] + br;
      const int* sorted_pl = s_sorted[pl];
      const float4* w_pl = s_sorted_w[pl];
      const int* offsets = s_cell[pl] + br * bw;
      float* plane_grad = grad_b + pl * plane_size;
      float4 carry_n = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // ne of west
      float4 carry_s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // se of west
      int first = offsets[0];
      for (int bc = 0; bc <= bw; ++bc) {
        float4 nw = make_float4(0.0f, 0.0f, 0.0f, 0.0f), ne = nw, sw = nw,
               se = nw;
        if (bc < bw) {
          const int end = offsets[bc + 1];
          if (c < C) {
            for (int i = first; i < end; ++i) {
              const float4 w4 = w_pl[i];
              const float4 gq = g_tile[sorted_pl[i] + sub];
              const float a_nw = w4.x * w4.z, a_ne = w4.y * w4.z;
              const float a_sw = w4.x * w4.w, a_se = w4.y * w4.w;
              nw.x += gq.x * a_nw; nw.y += gq.y * a_nw;
              nw.z += gq.z * a_nw; nw.w += gq.w * a_nw;
              ne.x += gq.x * a_ne; ne.y += gq.y * a_ne;
              ne.z += gq.z * a_ne; ne.w += gq.w * a_ne;
              sw.x += gq.x * a_sw; sw.y += gq.y * a_sw;
              sw.z += gq.z * a_sw; sw.w += gq.w * a_sw;
              se.x += gq.x * a_se; se.y += gq.y * a_se;
              se.z += gq.z * a_se; se.w += gq.w * a_se;
            }
          }
          first = end;
        }
        const int col = bu0 + bc;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // the north texel (row, col), then the south one (row + 1, col)
          const int r = row + half;
          const float4 v = half == 0
              ? make_float4(nw.x + carry_n.x, nw.y + carry_n.y,
                            nw.z + carry_n.z, nw.w + carry_n.w)
              : make_float4(sw.x + carry_s.x, sw.y + carry_s.y,
                            sw.z + carry_s.z, sw.w + carry_s.w);
          // a texel outside the plane takes nothing (its corners are out of
          // bounds); one no point reaches holds zeros: no reduction
          if (c < C && r >= 0 && r < H && col >= 0 && col < W
              && (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f))
            global_add4(plane_grad + ((int64_t)r * W + col) * C + c,
                        v.x / 3.0f, v.y / 3.0f, v.z / 3.0f, v.w / 3.0f);
        }
        carry_n = ne;
        carry_s = se;
      }
    }
  }
}

// The launch: tiles from the layout (lh, lw, ln) and the tile (th, tw, tn),
// clamped to it. The sorted path where C % 4 == 0 and C <= 32, else the
// direct pass alone, 16-byte lanes where C % 4 == 0, one float a lane
// otherwise.
inline int launch_triplane_bwd(const float* g, const float* coords,
                               float* grad, int B, int M, int H, int W, int C,
                               float scale, int lh, int lw, int ln, int th,
                               int tw, int tn, cudaStream_t stream) {
  if (B <= 0 || M <= 0) return (int)cudaGetLastError();
  if (H < 1 || W < 1 || C < 1 || (int64_t)H * W * C > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (lh < 1 || lw < 1 || ln < 1 || (int64_t)lh * lw * ln != M)
    return (int)cudaErrorInvalidValue;
  const bool sorted = C % 4 == 0 && C <= BWD_SORT_MAX_C;
  const int vw = C % 4 == 0 ? 4 : 1;
  int lp_shift = 0;                    // lanes a point: the power of two that
  while (lp_shift < 5 && (vw << lp_shift) < C) ++lp_shift;   // covers C
  BwdTiles t;
  t.lh = lh;
  t.lw = lw;
  t.ln = ln;
  t.th = th < lh ? th : lh;
  t.tw = tw < lw ? tw : lw;
  t.tn = tn < ln ? tn : ln;
  if (t.th < 1 || t.tw < 1 || t.tn < 1
      || (int64_t)t.th * t.tw * t.tn > BWD_TILE_POINTS)
    return (int)cudaErrorInvalidValue;
  t.nth = (lh + t.th - 1) / t.th;
  t.ntw = (lw + t.tw - 1) / t.tw;
  t.ntn = (ln + t.tn - 1) / t.tn;
  const int64_t tiles = (int64_t)t.nth * t.ntw * t.ntn;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  // the g tile of the sorted path; the static arrays and it pass 48 KB, so
  // the size is opted in
  const size_t smem = sorted ? (size_t)t.th * t.tw * t.tn * C * 4 : 0;
  const int64_t plane_size = (int64_t)H * W * C;
  for (int b0 = 0; b0 < B; b0 += 65535) {          // gridDim.y's limit
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    const dim3 grid((unsigned)tiles, (unsigned)nb);
    const float* gp = g + (int64_t)b0 * M * C;
    const float* co = coords + (int64_t)b0 * M * 3;
    float* gr = grad + (int64_t)b0 * 3 * plane_size;
    if (sorted) {
      auto kernel = triplane_bwd_kernel<4, true>;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, BWD_THREADS, smem, stream>>>(gp, co, gr, M, H, W, C,
                                                  scale, t, lp_shift);
    } else if (vw == 4) {
      triplane_bwd_kernel<4, false><<<grid, BWD_THREADS, 0, stream>>>(
          gp, co, gr, M, H, W, C, scale, t, lp_shift);
    } else {
      triplane_bwd_kernel<1, false><<<grid, BWD_THREADS, 0, stream>>>(
          gp, co, gr, M, H, W, C, scale, t, lp_shift);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace hfa
