// Banded affine-gap DP (seed extension) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel midas_tpu/align/pallas_sw.py::pallas_banded_align
// (its pl.pallas_call at pallas_sw.py:328, body _make_kernel at :63) and
// its three variants:
//   K1  N_STATS=6, flat mismatch   full statistics (species marker
//       mapping, MARKER_SCORING; the main path)
//   K2  N_STATS=6, QUAL_PEN        full statistics, bowtie2 --mp quality
//       penalties (pass 2 of genes / snps)
//   K3  N_STATS=1                  score, qend, wstart, wend only
//       (pass 1 of genes / snps), with or without QUAL_PEN
// Two kernel functions: k1_packed_kernel runs K1 for rows up to
// K1_PACKED_MAX_L; banded_sw_kernel, a template on the variant flags,
// runs K2, K3 and longer K1 rows. Both compute exactly what the Pallas
// kernel computes, bit for bit: the same float32 operations in the same
// order (NEG = -1e9, d * gap_extend, then (x - gap_open) - gap_extend),
// the same tie order (diagonal, then deletion, then insertion; on equal
// best cells the earliest row, then the smallest offset). Build with
// -fmad=false so no multiply-add is contracted. The plain version is
// midas_tpu_torch/align/banded.py.
//
// What bounds K1 on the H100. Per main-path batch (8192 reads x 8
// candidates = 65,536 pairs, 100 bp reads, band D = 16) the DP visits
// sum(qlen) * D ~= 1.05e8 cells at ~130 float32 / integer operations a
// cell (tally in chip_smoke.py), about 1.4e10 operations: ~0.2 ms at the
// card's 67 TFLOP/s float32 rate (a rate that counts a fused multiply-add
// as two operations; this DP has none, so ~0.4 ms at the real issue rate).
// It moves ~18 MB in and ~2.4 MB out, ~6 us at 3.35 TB/s. So it is bound
// by operations, by their latency chain along the rows (row i needs row
// i-1), and in banded_sw_kernel by warp shuffles: one pair on a 16-lane
// half-warp, lane = band offset, costs ~65 shuffles a cell (band shifts of
// H, the fresh flag, I and 12 statistics planes; a 4-step Kogge-Stone
// over A and 7 payload planes; the row argmax), and Hopper issues 32
// shuffle lanes a clock per SM, ~0.9 ms for the batch.
//
// What k1_packed_kernel does about that. The TPU layout (128 pairs on
// lanes, the band on sublanes, the state round-tripped through VMEM every
// row) is not carried over; the whole DP state of a pair lives in
// registers, and fewer values cross lanes:
// - The six statistics are small integers, held as 16-bit fields two to
//   a 32-bit word (3 words), since every select of the recurrence moves
//   all of them under one condition and every update is one packed add.
//   The deletion's gap origin rides inside the gap_cols field, biased.
// - The fresh flag is not carried: in LOCAL mode H is fresh iff it is 0
//   (a clamp is the only way H becomes 0), in glocal mode iff on row 0;
//   the fill shifted in above the band is never fresh.
// - One pair runs on G = 16 / OPL lanes, lane g holding offsets
//   g*OPL .. g*OPL + OPL - 1 (OPL = K1_OFFSETS_PER_LANE = 4: 4 lanes a
//   pair, 8 pairs a warp, ~90 registers and no spills; of 1, 2, 4 and 8
//   offsets a lane, 4 was the fastest on the H100). Insertion predecessors
//   inside a lane need no shuffle; the deletion scan is an in-lane
//   prefix, a log2(G)-step Kogge-Stone across lanes and an in-lane
//   fix-up, equal to the 16-lane scan bit for bit because its combine
//   (take the lower offsets' element only if strictly greater) is
//   associative and does no arithmetic. On a row that improves the best,
//   each lane keeps the first of its offsets holding the row maximum; the
//   first such lane is picked once, after the last row. ~5.5 shuffles a
//   cell (22 a lane-row) instead of ~65.
// - Four query rows come in one 32-bit load where rows are 4-byte
//   aligned, and each lane slides its window of the reference by one byte
//   a row.
// Each group stops at its own pair's qlen (exact: LOCAL mode masks rows
// >= qlen, glocal mode records at row qlen-1) and masks its own ragged
// edge, so no padding of P is needed.
//
// C interface (ctypes): banded_sw_launch(...) launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND = 16;
constexpr float NEG = -1e9f;
constexpr int THREADS = 256;   // 16 pairs a block in banded_sw_kernel

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

// ---------------------------------------------------------------------------
// K1, packed: N_STATS = 6, flat mismatch, LOCAL or glocal (see the header).

// A packed statistics word holds two 16-bit fields, lo | hi << 16:
//   word 0  matches | mismatches
//   word 1  gap_cols | gap_opens
//   word 2  qstart | wstart
// Every update is a plain add of a packed constant, and every select moves
// whole words, so a field never carries into its neighbour while it stays
// below 2^16. Along any path through rows 0..i (i < L): matches and
// mismatches <= L; qstart < L; wstart < L + BAND; an insertion column
// consumes a row, so there are <= L of them, and the band offset moves up
// one per deletion column and down one per insertion column inside
// [0, BAND), so deletion columns <= L + BAND - 1 and gap_cols, gap_opens
// <= 2L + 15. In the deletion scan gap_cols rides biased as
// gap_cols + BAND - origin <= 2L + 31 (origin = the gap's first offset).
// All fields stay below 2^16 for L <= 32,752; longer rows take the
// template kernel above.
constexpr int K1_PACKED_MAX_L = 32752;

// Band offsets a lane holds in the packed kernel.
constexpr int K1_OFFSETS_PER_LANE = 4;

// One band offset's scan element: the key A and the three payload words.
struct ScanEl {
  float A;
  uint32_t w[3];
};

// The deletion scan's combine: the lower offsets' element wins only if
// strictly greater. It is associative and does no arithmetic, so any
// grouping gives the 16-lane Kogge-Stone's result bit for bit.
__device__ __forceinline__ ScanEl take_lower(const ScanEl& lo,
                                             const ScanEl& hi) {
  const bool t = lo.A > hi.A;
  return ScanEl{t ? lo.A : hi.A,
                {t ? lo.w[0] : hi.w[0], t ? lo.w[1] : hi.w[1],
                 t ? lo.w[2] : hi.w[2]}};
}

__device__ __forceinline__ ScanEl shfl_up_el(unsigned mask, const ScanEl& e,
                                             int sh, int width) {
  return ScanEl{__shfl_up_sync(mask, e.A, sh, width),
                {__shfl_up_sync(mask, e.w[0], sh, width),
                 __shfl_up_sync(mask, e.w[1], sh, width),
                 __shfl_up_sync(mask, e.w[2], sh, width)}};
}

// Fill of the scan below offset 0: A = NEG, empty statistics, origin 0
// (biased gap_cols field BAND).
__device__ __forceinline__ ScanEl scan_fill() {
  return ScanEl{NEG, {0u, (uint32_t)BAND, 0u}};
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <bool LOCAL, int OPL>
__global__ void __launch_bounds__(THREADS)
k1_packed_kernel(const int8_t* __restrict__ query,    // [P, L]
                 const int32_t* __restrict__ qlens,   // [P]
                 const int8_t* __restrict__ ref,      // [P, L + BAND - 1]
                 float* __restrict__ score,           // [P]
                 int32_t* __restrict__ stats,         // [8, P]
                 int P, int L, float ma, float mi, float go, float ge) {
  constexpr int G = BAND / OPL;   // lanes per pair
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int base = lane & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << base;   // G <= 16
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (p >= P) return;   // whole groups leave together

  const int W = L + BAND - 1;
  const int8_t* q = query + p * L;
  const int8_t* r = ref + p * W + g * OPL;   // this lane's first offset
  const int qlen = qlens[p];
  const int rows = qlen < L ? qlen : L;
  const bool top = g == G - 1;
  // 4 query rows per 32-bit load where the rows are 4-byte aligned
  const bool q4 = (L & 3) == 0 && (((uintptr_t)query) & 3) == 0;

  int dof[OPL];
  float dge[OPL];
  float H[OPL], I[OPL];
  uint32_t Hw[OPL][3], Iw[OPL][3];
  int rb[OPL];   // reference bytes of this lane's offsets at the current row
#pragma unroll
  for (int j = 0; j < OPL; ++j) {
    dof[j] = g * OPL + j;
    dge[j] = (float)dof[j] * ge;
    H[j] = 0.f;
    I[j] = NEG;
#pragma unroll
    for (int k = 0; k < 3; ++k) Hw[j][k] = Iw[j][k] = 0u;
    rb[j] = 0;
  }
#pragma unroll
  for (int j = 0; j + 1 < OPL; ++j) rb[j + 1] = r[j];   // slides in below
  // the best cell: its row, and in each lane the first of the lane's
  // offsets holding that row's maximum (OPL if none) with its words; the
  // group picks the first such lane once, after the last row
  float best = NEG;
  int best_i = 0, best_j = OPL;
  uint32_t bw[3] = {0u, 0u, 0u};
  uint32_t qword = 0u;

  for (int i = 0; i < rows; ++i) {
    if ((i & 3) == 0) {
      if (q4) {
        qword = *(const uint32_t*)(q + i);
      } else {
        qword = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (i + k < rows) qword |= (uint32_t)(uint8_t)q[i + k] << (8 * k);
      }
    }
    const int qi = (int)(int8_t)(qword >> (8 * (i & 3)));
    // reference window: one new byte a row, the others slide down
#pragma unroll
    for (int j = 0; j + 1 < OPL; ++j) rb[j] = rb[j + 1];
    rb[OPL - 1] = r[i + OPL - 1];
    const bool row0 = i == 0;

    // insertion predecessor of the lane's last offset: the next lane's
    // first offset of the previous row; above the band, the fill
    float upH = __shfl_down_sync(gmask, H[0], 1, G);
    float upI = __shfl_down_sync(gmask, I[0], 1, G);
    uint32_t upHw[3], upIw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      upHw[k] = __shfl_down_sync(gmask, Hw[0][k], 1, G);
      upIw[k] = __shfl_down_sync(gmask, Iw[0][k], 1, G);
    }
    if (top) {
      upH = upI = NEG;
#pragma unroll
      for (int k = 0; k < 3; ++k) upHw[k] = upIw[k] = 0u;
    }

    float T1[OPL], In[OPL];
    uint32_t T1w[OPL][3], Inw[OPL][3];
    ScanEl S[OPL];   // scan elements, then their in-lane inclusive prefix
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const int rj = rb[j];
      const bool m = qi == rj && qi < 4 && rj < 4;
      const float sub = m ? ma : mi;
      // H is fresh (its path starts here) iff LOCAL clamped it, which is
      // the only way it becomes 0, or, in glocal mode, on row 0. A fresh
      // H has empty statistics.
      const bool hf = LOCAL ? H[j] == 0.f : row0;
      T1[j] = H[j] + sub;
      T1w[j][0] = Hw[j][0] + (m ? 1u : 0x10000u);
      T1w[j][1] = Hw[j][1];
      T1w[j][2] = hf ? pack2(i, i + dof[j]) : Hw[j][2];

      // insertion: predecessor at offset d + 1 of the previous row
      const bool last = j == OPL - 1;
      const int jn = last ? j : j + 1;
      const float pH = last ? upH : H[jn];
      const float pI = last ? upI : I[jn];
      uint32_t pHw[3], pIw[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pHw[k] = last ? upHw[k] : Hw[jn][k];
        pIw[k] = last ? upIw[k] : Iw[jn][k];
      }
      // the fill above the band is never fresh (in LOCAL: NEG != 0)
      const bool pf = LOCAL ? pH == 0.f : row0 && !(last && top);
      const float i_ext = pI - ge;
      const float i_open = (pH - go) - ge;
      const bool take_ext = i_ext >= i_open;
      In[j] = take_ext ? i_ext : i_open;
      Inw[j][0] = take_ext ? pIw[0] : pHw[0];
      Inw[j][1] = (take_ext ? pIw[1] : pHw[1]) + (take_ext ? 1u : 0x10001u);
      Inw[j][2] = take_ext ? pIw[2]
                           : (pf ? pack2(i, (i + 1) + dof[j]) : pHw[2]);

      // pre-deletion best; diagonal wins ties over insertion
      const bool take_I = In[j] > T1[j];
      const float h = take_I ? In[j] : T1[j];
      ScanEl e;
#pragma unroll
      for (int k = 0; k < 3; ++k) e.w[k] = take_I ? Inw[j][k] : T1w[j][k];
      if constexpr (LOCAL) {
        const bool clamp = h <= 0.f;
        if (clamp) e.w[0] = e.w[1] = e.w[2] = 0u;
        e.A = clamp ? NEG : h + dge[j];
      } else {
        e.A = h + dge[j];
      }
      e.w[1] += (uint32_t)(BAND - dof[j]);   // bias: gap_cols - origin + BAND
      S[j] = j ? take_lower(S[j - 1], e) : e;
    }

    // deletion: exclusive prefix over the band. In-lane prefix (above),
    // Kogge-Stone over the lanes' totals, shift to the exclusive form.
    const ScanEl mine = S[OPL - 1];
    ScanEl X = mine;
#pragma unroll
    for (int sh = 1; sh < G; sh <<= 1) {
      ScanEl s = shfl_up_el(gmask, X, sh, G);
      if (g < sh) s = scan_fill();
      X = take_lower(s, X);
    }
    ScanEl Xe = shfl_up_el(gmask, X, 1, G);
    if (g == 0) Xe = scan_fill();

    float Hn[OPL];
    uint32_t Hnw[OPL][3];
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const ScanEl E = j ? take_lower(Xe, S[j - 1]) : Xe;
      const float Dv = (E.A - go) - dge[j];
      uint32_t Dw[3];
      Dw[0] = E.w[0];
      // gap_cols + (d - origin), and one more gap open
      Dw[1] = E.w[1] + (uint32_t)(dof[j] - BAND) + 0x10000u;
      Dw[2] = E.w[2];

      // final H: priority diagonal > deletion > insertion
      const bool take_D = Dv > T1[j];
      float hn = take_D ? Dv : T1[j];
      uint32_t w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = take_D ? Dw[k] : T1w[j][k];
      const bool take_I2 = In[j] > hn;
      hn = take_I2 ? In[j] : hn;
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = take_I2 ? Inw[j][k] : w[k];
      if constexpr (LOCAL) {
        if (hn <= 0.f) {
          hn = 0.f;
          w[0] = w[1] = w[2] = 0u;
        }
      }
      Hn[j] = hn;
#pragma unroll
      for (int k = 0; k < 3; ++k) Hnw[j][k] = w[k];
    }

    // best tracking: the first offset holding the row maximum (rows here
    // are all < qlen, so LOCAL needs no row mask)
    float mx = Hn[0];
#pragma unroll
    for (int j = 1; j < OPL; ++j) mx = fmaxf(mx, Hn[j]);
#pragma unroll
    for (int o = G / 2; o >= 1; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, o, G));
    const bool improve = LOCAL ? mx > best : i == qlen - 1;
    if (improve) {   // uniform across the group
      best = mx;
      best_i = i;
      best_j = OPL;
#pragma unroll
      for (int j = OPL - 1; j >= 0; --j) {
        if (Hn[j] == mx) {
          best_j = j;
#pragma unroll
          for (int k = 0; k < 3; ++k) bw[k] = Hnw[j][k];
        }
      }
    }

#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      H[j] = Hn[j];
      I[j] = In[j];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        Hw[j][k] = Hnw[j][k];
        Iw[j][k] = Inw[j][k];
      }
    }
  }

  // first offset holding the best row's maximum: the first lane with a
  // hit (none if no row ever improved: then best_d = 0, empty words)
  const unsigned hits = (__ballot_sync(gmask, best_j < OPL) >> base) &
                        ((1u << G) - 1u);
  const int src = hits ? __ffs(hits) - 1 : 0;
  const int best_d = __shfl_sync(gmask, g * OPL + best_j, src, G);
#pragma unroll
  for (int k = 0; k < 3; ++k) bw[k] = __shfl_sync(gmask, bw[k], src, G);
  if (g == 0) {
    score[p] = best;
    stats[0LL * P + p] = (int32_t)(bw[2] & 0xFFFFu);   // qstart
    stats[1LL * P + p] = best_i + 1;                   // qend
    stats[2LL * P + p] = (int32_t)(bw[2] >> 16);       // wstart
    stats[3LL * P + p] = best_i + (hits ? best_d : 0) + 1;   // wend
    stats[4LL * P + p] = (int32_t)(bw[0] & 0xFFFFu);   // matches
    stats[5LL * P + p] = (int32_t)(bw[0] >> 16);       // mismatches
    stats[6LL * P + p] = (int32_t)(bw[1] & 0xFFFFu);   // gap_cols
    stats[7LL * P + p] = (int32_t)(bw[1] >> 16);       // gap_opens
  }
}

template <bool LOCAL>
void launch_k1_packed(const int8_t* query, const int32_t* qlens,
                      const int8_t* ref, float* score, int32_t* stats, int P,
                      int L, float ma, float mi, float go, float ge,
                      cudaStream_t stream) {
  constexpr int OPL = K1_OFFSETS_PER_LANE;
  const long long threads = (long long)P * (BAND / OPL);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  k1_packed_kernel<LOCAL, OPL><<<blocks, THREADS, 0, stream>>>(
      query, qlens, ref, score, stats, P, L, ma, mi, go, ge);
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
    else if (L <= K1_PACKED_MAX_L)
      launch_k1_packed<LOCAL>(query, qlens, ref, score, stats, P, L, ma, mi,
                              go, ge, stream);
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

// The longest row K1's packed kernel takes (longer ones go to the
// template kernel).
extern "C" int banded_sw_k1_packed_max_l(void) { return K1_PACKED_MAX_L; }
