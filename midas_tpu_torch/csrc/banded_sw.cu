// Banded affine-gap DP (seed extension) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel midas_tpu/align/pallas_sw.py::pallas_banded_align
// (its pl.pallas_call at pallas_sw.py:328, body _make_kernel at :63), all
// three of its variants, selected here by template flags:
//   K1  N_STATS=6, QUAL_PEN=false  full statistics, flat mismatch
//       (species marker mapping, MARKER_SCORING; the main path)
//   K2  N_STATS=6, QUAL_PEN=true   full statistics, bowtie2 --mp quality
//       penalties (pass 2 of genes / snps)
//   K3  N_STATS=1                  score, qend, wstart, wend only
//       (pass 1 of genes / snps), with or without QUAL_PEN
// It computes exactly what the Pallas kernel computes, bit for bit: the
// same float32 operations in the same order (NEG = -1e9, d * gap_extend,
// Kogge-Stone deletion scan), the same tie order (diagonal, then
// deletion, then insertion; on equal best cells the earliest row, then
// the smallest offset). Build with -fmad=false so no multiply-add is
// contracted. The plain version is midas_tpu_torch/align/banded.py.
//
// What bounds it on the H100. Per main-path batch (8192 reads x 8
// candidates = 65,536 pairs, 100 bp reads, band D = 16) the DP visits
// sum(qlen) * D ~= 1.05e8 cells at ~130 float32 / integer operations a
// cell (tally in chip_smoke.py), about 1.4e10 operations: ~0.2 ms at the
// card's 67 TFLOP/s float32 rate. It moves ~18 MB in (queries + windows)
// and ~2.4 MB out, ~6 us at 3.35 TB/s. So it is bound by operations, and
// by their latency chain along the rows: row i needs row i-1.
//
// What the design does about that. The TPU layout (128 pairs on lanes,
// the band on sublanes, the DP state round-tripped through VMEM every
// row) is not carried over. Here one pair runs on one 16-lane half-warp
// with lane = band offset d, so the whole DP state of a cell (H, the
// fresh flag, I and the statistics planes along the argmax path) lives
// in registers for the whole pair and never touches memory. Band shifts
// are __shfl_*_sync(width=16) with the Pallas fill values; the deletion
// prefix-max is a 4-step shuffle scan; the first-occurrence row argmax
// is a 4-step xor-shuffle max plus one ballot. Each half-warp stops at
// its own pair's qlen (exact: local mode masks rows >= qlen, glocal mode
// records at row qlen-1), and masks its own ragged edge, so no padding
// of P is needed. Many independent half-warps in flight hide the row
// chain's latency. Shared-memory staging of the windows and several
// pairs per lane are left for later work.
//
// C interface (ctypes): banded_sw_launch(...) launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND = 16;
constexpr float NEG = -1e9f;
constexpr int THREADS = 256;   // 16 pairs per block

template <bool LOCAL, int NS, bool QP>
__global__ void __launch_bounds__(THREADS)
banded_sw_kernel(const int8_t* __restrict__ query,    // [P, L]
                 const int32_t* __restrict__ qlens,   // [P]
                 const int8_t* __restrict__ ref,      // [P, L + BAND - 1]
                 const int8_t* __restrict__ qpen,     // [P, L] or null
                 float* __restrict__ score,           // [P]
                 int32_t* __restrict__ stats,         // [NS == 6 ? 8 : 3, P]
                 int P, int L, float ma, float mi, float go, float ge,
                 float npen) {
  constexpr int NP = NS == 6 ? NS + 1 : NS;   // scan payload (+ origin d)
  const int lane = threadIdx.x & 31;
  const int d = lane & (BAND - 1);
  const unsigned half_shift = lane & 16;
  const unsigned mask = 0xFFFFu << half_shift;
  const long long p =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / BAND;
  if (p >= P) return;   // whole half-warps leave together

  const int W = L + BAND - 1;
  const int8_t* q = query + p * L;
  const int8_t* r = ref + p * W;
  const int8_t* qp = QP ? qpen + p * L : nullptr;
  const int qlen = qlens[p];
  const float qlen_f = (float)qlen;
  const float df = (float)d;
  const float dge = df * ge;
  const bool top = d == BAND - 1;

  float H = 0.f;
  bool Hf = true;
  float I = NEG;
  float Hst[NS], Ist[NS], best_st[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) Hst[s] = Ist[s] = best_st[s] = 0.f;
  float best = NEG, best_i = 0.f, best_d = 0.f;

  const int rows = qlen < L ? qlen : L;
  for (int i = 0; i < rows; ++i) {
    const float fi = (float)i;
    const int qi = q[i];
    const int ri = r[i + d];
    const bool m = qi == ri && qi < 4 && ri < 4;
    const float is_match = m ? 1.f : 0.f;
    float sub;
    if constexpr (QP) {
      const float pen = qi >= 4 ? npen : (ri >= 4 ? -mi : (float)qp[i]);
      sub = m ? ma : -pen;
    } else {
      sub = m ? ma : mi;
    }

    // stats of a path starting with a diagonal move at row i
    float T1st[NS];
    if constexpr (NS == 6) {
      T1st[0] = (Hf ? 0.f : Hst[0]) + is_match;
      T1st[1] = (Hf ? 0.f : Hst[1]) + (1.f - is_match);
      T1st[2] = Hf ? 0.f : Hst[2];
      T1st[3] = Hf ? 0.f : Hst[3];
      T1st[4] = Hf ? fi : Hst[4];
      T1st[5] = Hf ? fi + df : Hst[5];
    } else {
      T1st[0] = Hf ? fi + df : Hst[0];
    }
    const float T1 = H + sub;

    // insertion: predecessor at offset d+1 of the previous row
    float Hs = __shfl_down_sync(mask, H, 1, BAND);
    bool Hfs = __shfl_down_sync(mask, (int)Hf, 1, BAND) != 0;
    float Is = __shfl_down_sync(mask, I, 1, BAND);
    float Hsts[NS], Ists[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      Hsts[s] = __shfl_down_sync(mask, Hst[s], 1, BAND);
      Ists[s] = __shfl_down_sync(mask, Ist[s], 1, BAND);
    }
    if (top) {
      Hs = NEG;
      Hfs = false;
      Is = NEG;
#pragma unroll
      for (int s = 0; s < NS; ++s) Hsts[s] = Ists[s] = 0.f;
    }
    float open_st[NS];
    if constexpr (NS == 6) {
      open_st[0] = Hfs ? 0.f : Hsts[0];
      open_st[1] = Hfs ? 0.f : Hsts[1];
      open_st[2] = Hfs ? 0.f : Hsts[2];
      open_st[3] = Hfs ? 0.f : Hsts[3];
      open_st[4] = Hfs ? fi : Hsts[4];
      open_st[5] = Hfs ? (fi + 1.f) + df : Hsts[5];
    } else {
      open_st[0] = Hfs ? (fi + 1.f) + df : Hsts[0];
    }
    const float i_ext = Is - ge;
    const float i_open = (Hs - go) - ge;
    const bool take_ext = i_ext >= i_open;
    const float In = take_ext ? i_ext : i_open;
    float Inst[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) Inst[s] = take_ext ? Ists[s] : open_st[s];
    if constexpr (NS == 6) {
      Inst[2] = Inst[2] + 1.f;
      Inst[3] = Inst[3] + (take_ext ? 0.f : 1.f);
    }

    // pre-deletion best; diagonal wins ties over insertion
    const bool take_I = In > T1;
    float HnoD = take_I ? In : T1;
    float pay[NP];
#pragma unroll
    for (int s = 0; s < NS; ++s) pay[s] = take_I ? Inst[s] : T1st[s];
    float A;
    if constexpr (LOCAL) {
      const bool clamp = HnoD <= 0.f;
      if (clamp) {
        HnoD = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) pay[s] = 0.f;
      }
      A = clamp ? NEG : HnoD + dge;
    } else {
      A = HnoD + dge;
    }
    if constexpr (NS == 6) pay[NS] = df;   // gap-origin payload (full stats only)

    // deletion: exclusive Kogge-Stone prefix max with payload
#pragma unroll
    for (int sh = 1; sh < BAND; sh <<= 1) {
      float sA = __shfl_up_sync(mask, A, sh, BAND);
      float sp[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) sp[k] = __shfl_up_sync(mask, pay[k], sh, BAND);
      if (d < sh) {
        sA = NEG;
#pragma unroll
        for (int k = 0; k < NP; ++k) sp[k] = 0.f;
      }
      const bool take = sA > A;
#pragma unroll
      for (int k = 0; k < NP; ++k) pay[k] = take ? sp[k] : pay[k];
      A = take ? sA : A;
    }
    float eA = __shfl_up_sync(mask, A, 1, BAND);
    float ep[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) ep[k] = __shfl_up_sync(mask, pay[k], 1, BAND);
    if (d == 0) {
      eA = NEG;
#pragma unroll
      for (int k = 0; k < NP; ++k) ep[k] = 0.f;
    }
    const float Dv = (eA - go) - dge;
    float Dst[NS];
    if constexpr (NS == 6) {
      const float gap_len = df - ep[NS];
      Dst[0] = ep[0];
      Dst[1] = ep[1];
      Dst[2] = ep[2] + gap_len;
      Dst[3] = ep[3] + 1.f;
      Dst[4] = ep[4];
      Dst[5] = ep[5];
    } else {
      Dst[0] = ep[0];
    }

    // final H: priority diagonal > deletion > insertion
    const bool take_D = Dv > T1;
    float Hn = take_D ? Dv : T1;
    float Hnst[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) Hnst[s] = take_D ? Dst[s] : T1st[s];
    const bool take_I2 = In > Hn;
    Hn = take_I2 ? In : Hn;
#pragma unroll
    for (int s = 0; s < NS; ++s) Hnst[s] = take_I2 ? Inst[s] : Hnst[s];
    bool Hfn = false;
    if constexpr (LOCAL) {
      Hfn = Hn <= 0.f;
      if (Hfn) {
        Hn = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) Hnst[s] = 0.f;
      }
    }

    // best tracking: first offset holding the row maximum
    const float Hm = (!LOCAL || fi < qlen_f) ? Hn : NEG;
    float mx = Hm;
#pragma unroll
    for (int o = BAND / 2; o >= 1; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(mask, mx, o, BAND));
    const unsigned hits = (__ballot_sync(mask, Hm == mx) >> half_shift) & 0xFFFFu;
    const int first = __ffs(hits) - 1;
    const bool improve = LOCAL ? mx > best : fi == qlen_f - 1.f;
    if (improve) {   // uniform across the half-warp
      best = mx;
      best_i = fi;
      best_d = (float)first;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        best_st[s] = __shfl_sync(mask, Hnst[s], first, BAND);
    }

    H = Hn;
    Hf = Hfn;
    I = In;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      Hst[s] = Hnst[s];
      Ist[s] = Inst[s];
    }
  }

  if (d == 0) {
    score[p] = best;
    const int qend = __float2int_rz(best_i + 1.f);
    const int wend = __float2int_rz((best_i + best_d) + 1.f);
    if constexpr (NS == 6) {
      stats[0LL * P + p] = __float2int_rz(best_st[4]);   // qstart
      stats[1LL * P + p] = qend;
      stats[2LL * P + p] = __float2int_rz(best_st[5]);   // wstart
      stats[3LL * P + p] = wend;
      stats[4LL * P + p] = __float2int_rz(best_st[0]);   // matches
      stats[5LL * P + p] = __float2int_rz(best_st[1]);   // mismatches
      stats[6LL * P + p] = __float2int_rz(best_st[2]);   // gap_cols
      stats[7LL * P + p] = __float2int_rz(best_st[3]);   // gap_opens
    } else {
      stats[0LL * P + p] = qend;
      stats[1LL * P + p] = __float2int_rz(best_st[0]);   // wstart
      stats[2LL * P + p] = wend;
    }
  }
}

template <bool LOCAL, int NS, bool QP>
void launch(const int8_t* query, const int32_t* qlens, const int8_t* ref,
            const int8_t* qpen, float* score, int32_t* stats, int P, int L,
            float ma, float mi, float go, float ge, float npen,
            cudaStream_t stream) {
  const long long threads = (long long)P * BAND;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  banded_sw_kernel<LOCAL, NS, QP><<<blocks, THREADS, 0, stream>>>(
      query, qlens, ref, qpen, score, stats, P, L, ma, mi, go, ge, npen);
}

template <bool LOCAL>
void dispatch(int n_stats, const int8_t* query, const int32_t* qlens,
              const int8_t* ref, const int8_t* qpen, float* score,
              int32_t* stats, int P, int L, float ma, float mi, float go,
              float ge, float npen, cudaStream_t stream) {
  if (n_stats == 6) {
    if (qpen)
      launch<LOCAL, 6, true>(query, qlens, ref, qpen, score, stats, P, L, ma,
                             mi, go, ge, npen, stream);
    else
      launch<LOCAL, 6, false>(query, qlens, ref, qpen, score, stats, P, L, ma,
                              mi, go, ge, npen, stream);
  } else {
    if (qpen)
      launch<LOCAL, 1, true>(query, qlens, ref, qpen, score, stats, P, L, ma,
                             mi, go, ge, npen, stream);
    else
      launch<LOCAL, 1, false>(query, qlens, ref, qpen, score, stats, P, L, ma,
                              mi, go, ge, npen, stream);
  }
}

}  // namespace

extern "C" int banded_sw_launch(const void* query, const void* qlens,
                                const void* ref, const void* qpen,
                                void* score, void* stats, int P, int L,
                                int local, int n_stats, float ma, float mi,
                                float go, float ge, float npen,
                                void* stream) {
  if (P <= 0 || L <= 0 || (n_stats != 6 && n_stats != 1))
    return (int)cudaErrorInvalidValue;
  const int8_t* q = (const int8_t*)query;
  const int32_t* ql = (const int32_t*)qlens;
  const int8_t* r = (const int8_t*)ref;
  const int8_t* qp = (const int8_t*)qpen;
  cudaStream_t s = (cudaStream_t)stream;
  if (local)
    dispatch<true>(n_stats, q, ql, r, qp, (float*)score, (int32_t*)stats, P,
                   L, ma, mi, go, ge, npen, s);
  else
    dispatch<false>(n_stats, q, ql, r, qp, (float*)score, (int32_t*)stats, P,
                    L, ma, mi, go, ge, npen, s);
  return (int)cudaGetLastError();
}
