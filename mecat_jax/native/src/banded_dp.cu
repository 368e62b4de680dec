// Banded DP segment + local-best endpoint as one CUDA kernel (sm_90a),
// called from JAX through the XLA FFI (mecat_jax/ops/dp_kernel.py).
//
// Exactly the recurrence of ops/align.banded_dp_segment + pick_end_local:
// packed values v = dist * IND_K + indels, band cell w of row i covers target
// position j = i - W/2 + w, cells with j outside [0, tmax] are VINF.  The
// XLA form is a lax.scan over S rows (at least one launch per row, the
// [B, W] carry in device memory); here one warp owns one pair and keeps the
// whole band in registers for all S rows.
//
// Layout: lane l holds the CPL = W/32 consecutive cells w = l*CPL + c.
//   * vertical step (prev[w+1]): in-lane, plus one __shfl_down for the
//     lane's last cell;
//   * horizontal closure cur[w] = min_{u<=w} cand[u] + (w-u)*K1: in-lane
//     prefix min of y = cand - w*K1, a 5-step __shfl_up warp scan of the
//     lane totals, then one exclusive shift;
//   * query and target bytes are staged once per pair in shared memory.
// Best cell: the packed key score*1024 - i per cell (score desc, row asc),
// kept per cell across rows, then one warp reduction (ties -> smallest w):
// the first flat argmax of pick_end_local.  Needs S < 1024.
// Moves: 16 2-bit codes per int32 word, layout [S, B, W/16] — one pair's
// row is W/16 consecutive words, written by one warp store.
// Inactive pairs skip the DP: zero moves and the unconsumable best record
// (r=0, w=W/2, v=VINF).
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kIndK = 4096;
constexpr int kK1 = kIndK + 1;
constexpr int kVinf = 1 << 30;
constexpr int kKeyNone = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int CPL, bool MOVES>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
banded_dp_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ tpad,
                 const int32_t* __restrict__ tmax_in,
                 const int32_t* __restrict__ segq_in,
                 const uint8_t* __restrict__ active,
                 int32_t* __restrict__ moves, int32_t* __restrict__ best,
                 int B, int S, int penalty2) {
  constexpr int W = 32 * CPL;
  constexpr int HALF = W / 2;
  constexpr int WP = W / 16;        // packed words per row
  constexpr int LPW = 16 / CPL;     // lanes per packed word
  extern __shared__ uint32_t smem_words[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;

  if (!active[b]) {
    if (MOVES) {
      for (int x = lane; x < S * WP; x += 32) {
        const int i = x / WP;
        moves[((size_t)i * B + b) * WP + (x - i * WP)] = 0;
      }
    }
    if (lane == 0) {
      best[b] = 0;
      best[B + b] = HALF;
      best[2 * B + b] = kVinf;
    }
    return;
  }

  // stage the pair's S query bytes and S+W framed target bytes
  uint8_t* sq = reinterpret_cast<uint8_t*>(smem_words) + warp * (2 * S + W);
  uint8_t* st = sq + S;
  {
    const uint32_t* gq = reinterpret_cast<const uint32_t*>(q + (size_t)b * S);
    const uint32_t* gt =
        reinterpret_cast<const uint32_t*>(tpad + (size_t)b * (S + W));
    uint32_t* wq = reinterpret_cast<uint32_t*>(sq);
    uint32_t* wt = reinterpret_cast<uint32_t*>(st);
    for (int x = lane; x < S / 4; x += 32) wq[x] = gq[x];
    for (int x = lane; x < (S + W) / 4; x += 32) wt[x] = gt[x];
  }
  __syncwarp();

  const int tmax = tmax_in[b];
  const int segq = segq_in[b];
  const int w0 = lane * CPL;

  int prev[CPL], bkey[CPL], bval[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j0 = w0 + c - HALF;
    const bool v = (j0 >= 0) && (j0 <= tmax);
    prev[c] = v ? j0 * kK1 : kVinf;
    bkey[c] = v ? (j0 - penalty2 * (prev[c] / kIndK)) * 1024 : kKeyNone;
    bval[c] = prev[c];
  }

  // counts-only: rows past segq can change neither the best cell nor any
  // earlier row, so they are not computed
  const int nrows = MOVES ? S : min(S, segq);
  for (int i = 1; i <= nrows; ++i) {
    const int qc = sq[i - 1];
    int nxt = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 31) nxt = kVinf;
    int diag[CPL], vert[CPL], sub[CPL], y[CPL];
    bool valid[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int w = w0 + c;
      sub[c] = (qc == st[i - 1 + w]) ? 0 : 1;
      diag[c] = prev[c] + sub[c] * kIndK;
      vert[c] = ((c + 1 < CPL) ? prev[(c + 1) % CPL] : nxt) + kK1;
      const int j = i - HALF + w;
      valid[c] = (j >= 0) && (j <= tmax);
      const int cand = valid[c] ? min(diag[c], vert[c]) : kVinf;
      y[c] = cand - w * kK1;
    }
#pragma unroll
    for (int c = 1; c < CPL; ++c) y[c] = min(y[c], y[c - 1]);
    int agg = y[CPL - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, agg, off);
      if (lane >= off) agg = min(agg, t);
    }
    int excl = __shfl_up_sync(kFull, agg, 1);
    if (lane == 0) excl = 0x7fffffff;

    uint32_t bits = 0;
    const bool scoring = i <= segq;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int w = w0 + c;
      const int cur =
          valid[c] ? min(min(y[c], excl) + w * kK1, kVinf) : kVinf;
      if (MOVES) {
        const uint32_t m = (cur == diag[c]) ? (uint32_t)sub[c]
                           : (cur == vert[c]) ? 2u : 3u;
        bits |= m << (2 * c);
      }
      if (scoring && valid[c] && cur < kVinf) {
        const int score = i + (i - HALF + w) - penalty2 * (cur / kIndK);
        const int key = score * 1024 - i;
        if (key > bkey[c]) {
          bkey[c] = key;
          bval[c] = cur;
        }
      }
      prev[c] = cur;
    }
    if (MOVES) {
      bits <<= (2 * CPL) * (lane % LPW);
#pragma unroll
      for (int o = 1; o < LPW; o <<= 1) bits |= __shfl_xor_sync(kFull, bits, o);
      if (lane % LPW == 0) {
        moves[((size_t)(i - 1) * B + b) * WP + lane / LPW] = (int32_t)bits;
      }
    }
  }

  // first flat argmax: max key, then smallest band cell
  int kmax = bkey[0], warg = w0, vb = bval[0];
#pragma unroll
  for (int c = 1; c < CPL; ++c) {
    if (bkey[c] > kmax) {
      kmax = bkey[c];
      warg = w0 + c;
      vb = bval[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int k2 = __shfl_xor_sync(kFull, kmax, off);
    const int w2 = __shfl_xor_sync(kFull, warg, off);
    const int v2 = __shfl_xor_sync(kFull, vb, off);
    if (k2 > kmax || (k2 == kmax && w2 < warg)) {
      kmax = k2;
      warg = w2;
      vb = v2;
    }
  }
  if (lane == 0) {
    best[b] = (-kmax) & 1023;   // row index (key = score*1024 - row)
    best[B + b] = warg;
    best[2 * B + b] = vb;
  }
}

template <int CPL, bool MOVES>
cudaError_t launch_cpl(cudaStream_t stream, const uint8_t* q,
                       const uint8_t* tpad, const int32_t* tmax,
                       const int32_t* segq, const uint8_t* active,
                       int32_t* moves, int32_t* best, int B, int S,
                       int penalty2) {
  constexpr int W = 32 * CPL;
  const size_t smem = (size_t)kWarpsPerBlock * (2 * S + W);
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  banded_dp_kernel<CPL, MOVES><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      q, tpad, tmax, segq, active, moves, best, B, S, penalty2);
  return cudaGetLastError();
}

template <bool MOVES>
ffi::Error launch(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                  ffi::Buffer<ffi::U8> tpad, ffi::Buffer<ffi::S32> tmax,
                  ffi::Buffer<ffi::S32> segq, ffi::Buffer<ffi::U8> active,
                  int32_t penalty, int32_t* moves, int32_t* best) {
  const auto qd = q.dimensions();
  const auto td = tpad.dimensions();
  if (qd.size() != 2 || td.size() != 2 || qd[0] != td[0]) {
    return ffi::Error::InvalidArgument("banded_dp: q [B,S], tpad [B,S+W]");
  }
  const int B = (int)qd[0];
  const int S = (int)qd[1];
  const int W = (int)td[1] - S;
  if (S % 4 != 0 || S >= 1024) {
    return ffi::Error::InvalidArgument("banded_dp: S % 4 == 0, S < 1024");
  }
  if (B == 0) return ffi::Error::Success();
  const int p2 = 2 * penalty;
  cudaError_t err;
  switch (W) {
    case 32:
      err = launch_cpl<1, MOVES>(stream, q.typed_data(), tpad.typed_data(),
                                 tmax.typed_data(), segq.typed_data(),
                                 active.typed_data(), moves, best, B, S, p2);
      break;
    case 64:
      err = launch_cpl<2, MOVES>(stream, q.typed_data(), tpad.typed_data(),
                                 tmax.typed_data(), segq.typed_data(),
                                 active.typed_data(), moves, best, B, S, p2);
      break;
    case 128:
      err = launch_cpl<4, MOVES>(stream, q.typed_data(), tpad.typed_data(),
                                 tmax.typed_data(), segq.typed_data(),
                                 active.typed_data(), moves, best, B, S, p2);
      break;
    case 256:
      err = launch_cpl<8, MOVES>(stream, q.typed_data(), tpad.typed_data(),
                                 tmax.typed_data(), segq.typed_data(),
                                 active.typed_data(), moves, best, B, S, p2);
      break;
    default:
      return ffi::Error::InvalidArgument("banded_dp: W in {32,64,128,256}");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("banded_dp launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error DpMovesImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                       ffi::Buffer<ffi::U8> tpad, ffi::Buffer<ffi::S32> tmax,
                       ffi::Buffer<ffi::S32> segq,
                       ffi::Buffer<ffi::U8> active, int32_t penalty,
                       ffi::ResultBuffer<ffi::S32> moves,
                       ffi::ResultBuffer<ffi::S32> best) {
  return launch<true>(stream, q, tpad, tmax, segq, active, penalty,
                      moves->typed_data(), best->typed_data());
}

ffi::Error DpBestImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                      ffi::Buffer<ffi::U8> tpad, ffi::Buffer<ffi::S32> tmax,
                      ffi::Buffer<ffi::S32> segq, ffi::Buffer<ffi::U8> active,
                      int32_t penalty, ffi::ResultBuffer<ffi::S32> best) {
  return launch<false>(stream, q, tpad, tmax, segq, active, penalty, nullptr,
                       best->typed_data());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MecatBandedDpMoves, DpMovesImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("penalty")
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(MecatBandedDpBest, DpBestImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("penalty")
                                  .Ret<ffi::Buffer<ffi::S32>>());
