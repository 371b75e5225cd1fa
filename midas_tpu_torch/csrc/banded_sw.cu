// Banded affine-gap DP (seed extension) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel midas_tpu/align/pallas_sw.py::pallas_banded_align
// (its pl.pallas_call at pallas_sw.py:328, body _make_kernel at :63) and
// its four variants:
//   K1       NS=6, flat mismatch   full statistics (species marker
//            mapping, MARKER_SCORING)
//   K2       NS=6, QP              full statistics, bowtie2 --mp quality
//            penalties (pass 2 of genes / snps)
//   K3_qpen  NS=1, QP              score, qend, wstart, wend only (pass 1
//            of genes / snps)
//   K3       NS=1, flat mismatch   as K3_qpen (no production caller)
// One kernel function, packed_sw_kernel<LOCAL, NS, QP, OPL>, runs all four;
// only full-statistics rows longer than PACKED_MAX_L take the template
// kernel banded_sw_kernel<LOCAL, QP>, one pair per 16-lane half-warp.
// Both compute exactly what the Pallas kernel computes, bit for bit: the
// same float32 operations in the same order (NEG = -1e9, d * gap_extend,
// then (x - gap_open) - gap_extend; the quality-scaled substitution as
// pallas_sw.py:126-132), the same tie order (diagonal, then deletion, then
// insertion; on equal best cells the earliest row, then the smallest
// offset). Build with -fmad=false so no multiply-add is contracted. The
// plain version is midas_tpu_torch/align/banded.py.
//
// What bounds the DP on the H100. It visits sum(qlen) * D cells (D = 16);
// a cell is a chain of ~60-130 float32 / integer operations (tally in
// chip_smoke.py) and needs row i-1 of its pair, while it moves ~2 bytes
// in per cell. So every variant is bound by operations, by their latency
// chain along the rows, and by warp shuffles where the band spans lanes:
// Hopper issues 32 shuffle lanes a clock per SM. With one band offset a
// lane (the template kernel) a cell costs ~65 shuffles at full statistics
// (band shifts of H, the fresh flag, I and 12 statistics planes; a 4-step
// Kogge-Stone over A and 7 payload planes; the row argmax) and ~20 score
// only, and every per-row instruction runs 16 times a pair.
//
// What packed_sw_kernel does about that. The TPU layout (128 pairs on
// lanes, the band on sublanes, the state round-tripped through VMEM every
// row) is not carried over; the whole DP state of a pair lives in
// registers, and fewer values cross lanes:
// - NS=6: the six statistics are small integers, held as 16-bit fields two
//   to a 32-bit word (3 words), since every select of the recurrence moves
//   all of them under one condition and every update is one packed add.
//   The deletion's gap origin rides inside the gap_cols field, biased.
//   NS=1: one plain 32-bit word, wstart, and no gap origin.
// - The fresh flag is not carried: in LOCAL mode H is fresh iff it is 0
//   (a clamp is the only way H becomes 0, whatever the mismatch penalty),
//   in glocal mode iff on row 0; the fill shifted in above the band is
//   never fresh.
// - One pair runs on G = 16 / OPL lanes, lane g holding offsets
//   g*OPL .. g*OPL + OPL - 1; OPL is one constant per variant (below).
//   Insertion predecessors inside a lane need no shuffle; the deletion
//   scan is an in-lane prefix, a log2(G)-step Kogge-Stone across lanes and
//   an in-lane fix-up, equal to the 16-lane scan bit for bit because its
//   combine (take the lower offsets' element only if strictly greater) is
//   associative and does no arithmetic. On a row that improves the best,
//   each lane keeps the first of its offsets holding the row maximum; the
//   first such lane is picked once, after the last row. Shuffles a cell:
//   NS=6 at 4 offsets a lane 5.5 (22 a lane-row), at 2 offsets 13.5 (27
//   a lane-row); NS=1 at 4 offsets a lane 3 (12 a lane-row).
// - The query byte, the qpen byte, loop control and addressing are paid
//   once a row for OPL cells; four query rows, and four qpen rows, come in
//   one 32-bit load where that array's rows are 4-byte aligned, and each
//   lane slides its window of the reference by one byte a row.
// Each group stops at its own pair's qlen (exact: LOCAL mode masks rows
// >= qlen, glocal mode records at row qlen-1) and masks its own ragged
// edge, so no padding of P is needed.
// What then bounds each variant at its path's shape: K1 (65,536 pairs a
// species batch) and K3_qpen (32,768 pairs, genes pass 1) fill the card
// and are bound by instruction issue, shuffles included; K2 (8,192 pairs,
// one per read in genes pass 2) gives too few warps to hide the latency
// of its row chain, so it takes fewer offsets a lane and more lanes.
//
// C interface (ctypes): banded_sw_launch(...) launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND = 16;
constexpr float NEG = -1e9f;
constexpr int THREADS = 256;   // 16 pairs a block in banded_sw_kernel

// ---------------------------------------------------------------------------
// The template kernel: full statistics, one pair per 16-lane half-warp,
// lane = band offset. Runs only the NS=6 rows above PACKED_MAX_L.

template <bool LOCAL, bool QP>
__global__ void __launch_bounds__(THREADS)
banded_sw_kernel(const int8_t* __restrict__ query,    // [P, L]
                 const int32_t* __restrict__ qlens,   // [P]
                 const int8_t* __restrict__ ref,      // [P, L + BAND - 1]
                 const int8_t* __restrict__ qpen,     // [P, L] or null
                 float* __restrict__ score,           // [P]
                 int32_t* __restrict__ stats,         // [8, P]
                 int P, int L, float ma, float mi, float go, float ge,
                 float npen) {
  constexpr int NS = 6, NP = NS + 1;   // statistics; scan payload + origin d
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
    T1st[0] = (Hf ? 0.f : Hst[0]) + is_match;
    T1st[1] = (Hf ? 0.f : Hst[1]) + (1.f - is_match);
    T1st[2] = Hf ? 0.f : Hst[2];
    T1st[3] = Hf ? 0.f : Hst[3];
    T1st[4] = Hf ? fi : Hst[4];
    T1st[5] = Hf ? fi + df : Hst[5];
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
    open_st[0] = Hfs ? 0.f : Hsts[0];
    open_st[1] = Hfs ? 0.f : Hsts[1];
    open_st[2] = Hfs ? 0.f : Hsts[2];
    open_st[3] = Hfs ? 0.f : Hsts[3];
    open_st[4] = Hfs ? fi : Hsts[4];
    open_st[5] = Hfs ? (fi + 1.f) + df : Hsts[5];
    const float i_ext = Is - ge;
    const float i_open = (Hs - go) - ge;
    const bool take_ext = i_ext >= i_open;
    const float In = take_ext ? i_ext : i_open;
    float Inst[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) Inst[s] = take_ext ? Ists[s] : open_st[s];
    Inst[2] = Inst[2] + 1.f;
    Inst[3] = Inst[3] + (take_ext ? 0.f : 1.f);

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
    pay[NS] = df;   // gap-origin payload

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
    const float gap_len = df - ep[NS];
    Dst[0] = ep[0];
    Dst[1] = ep[1];
    Dst[2] = ep[2] + gap_len;
    Dst[3] = ep[3] + 1.f;
    Dst[4] = ep[4];
    Dst[5] = ep[5];

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
    stats[0LL * P + p] = __float2int_rz(best_st[4]);   // qstart
    stats[1LL * P + p] = __float2int_rz(best_i + 1.f);   // qend
    stats[2LL * P + p] = __float2int_rz(best_st[5]);   // wstart
    stats[3LL * P + p] = __float2int_rz((best_i + best_d) + 1.f);   // wend
    stats[4LL * P + p] = __float2int_rz(best_st[0]);   // matches
    stats[5LL * P + p] = __float2int_rz(best_st[1]);   // mismatches
    stats[6LL * P + p] = __float2int_rz(best_st[2]);   // gap_cols
    stats[7LL * P + p] = __float2int_rz(best_st[3]);   // gap_opens
  }
}

// ---------------------------------------------------------------------------
// The packed kernel: every variant, LOCAL or glocal (see the header).

// With full statistics (NS = 6) a cell's statistics are three words, each
// holding two 16-bit fields, lo | hi << 16:
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
// All fields stay below 2^16 for L <= 32,752; longer full-statistics rows
// take the template kernel above. Score only (NS = 1), the one word is
// wstart as a plain 32-bit integer, so every row length takes this kernel.
constexpr int PACKED_MAX_L = 32752;

// Band offsets a lane, one constant per variant: the fastest of the
// layouts tried on the H100 at the variant's path shape (PERF.md). At 2
// offsets a lane K2's 8,192 pairs make 65,536 threads, twice the warps
// of 4 offsets a lane.
constexpr int K1_OFFSETS_PER_LANE = 4;
constexpr int K2_OFFSETS_PER_LANE = 2;
constexpr int K3_OFFSETS_PER_LANE = 4;   // K3 and K3_qpen

constexpr int offsets_per_lane(int ns, bool qp) {
  return ns == 1 ? K3_OFFSETS_PER_LANE
                 : (qp ? K2_OFFSETS_PER_LANE : K1_OFFSETS_PER_LANE);
}

// One band offset's scan element: the key A and the statistics words.
// The helpers below build it by aggregate initialisation, one form per
// word count: built word by word in a loop, K1's LOCAL instantiation took
// 89 registers instead of 86 (ptxas, sm_90a).
template <int NW>
struct ScanEl {
  float A;
  uint32_t w[NW];
};

// The deletion scan's combine: the lower offsets' element wins only if
// strictly greater. It is associative and does no arithmetic, so any
// grouping gives the 16-lane Kogge-Stone's result bit for bit.
template <int NW>
__device__ __forceinline__ ScanEl<NW> take_lower(const ScanEl<NW>& lo,
                                                 const ScanEl<NW>& hi) {
  const bool t = lo.A > hi.A;
  if constexpr (NW == 3)
    return ScanEl<NW>{t ? lo.A : hi.A,
                      {t ? lo.w[0] : hi.w[0], t ? lo.w[1] : hi.w[1],
                       t ? lo.w[2] : hi.w[2]}};
  else
    return ScanEl<NW>{t ? lo.A : hi.A, {t ? lo.w[0] : hi.w[0]}};
}

template <int NW>
__device__ __forceinline__ ScanEl<NW> shfl_up_el(unsigned mask,
                                                 const ScanEl<NW>& x, int sh,
                                                 int width) {
  if constexpr (NW == 3)
    return ScanEl<NW>{__shfl_up_sync(mask, x.A, sh, width),
                      {__shfl_up_sync(mask, x.w[0], sh, width),
                       __shfl_up_sync(mask, x.w[1], sh, width),
                       __shfl_up_sync(mask, x.w[2], sh, width)}};
  else
    return ScanEl<NW>{__shfl_up_sync(mask, x.A, sh, width),
                      {__shfl_up_sync(mask, x.w[0], sh, width)}};
}

// Fill of the scan below offset 0: A = NEG, empty statistics; with full
// statistics, origin 0 (biased gap_cols field BAND).
template <int NW>
__device__ __forceinline__ ScanEl<NW> scan_fill() {
  if constexpr (NW == 3)
    return ScanEl<NW>{NEG, {0u, (uint32_t)BAND, 0u}};
  else
    return ScanEl<NW>{NEG, {0u}};
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Rows i .. i+3 of one pair's byte row (query or qpen), byte k of the
// word = row i + k: one 32-bit load where the rows are 4-byte aligned,
// else bytes up to `rows`.
__device__ __forceinline__ uint32_t load_rows4(const int8_t* row, int i,
                                               int rows, bool aligned) {
  if (aligned) return *(const uint32_t*)(row + i);
  uint32_t w = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < rows) w |= (uint32_t)(uint8_t)row[i + k] << (8 * k);
  return w;
}

template <bool LOCAL, int NS, bool QP, int OPL>
__global__ void __launch_bounds__(THREADS)
packed_sw_kernel(const int8_t* __restrict__ query,    // [P, L]
                 const int32_t* __restrict__ qlens,   // [P]
                 const int8_t* __restrict__ ref,      // [P, L + BAND - 1]
                 const int8_t* __restrict__ qpen,     // [P, L] if QP
                 float* __restrict__ score,           // [P]
                 int32_t* __restrict__ stats,         // [NS == 6 ? 8 : 3, P]
                 int P, int L, float ma, float mi, float go, float ge,
                 float npen) {
  constexpr int NW = NS == 6 ? 3 : 1;   // statistics words of a cell
  constexpr int G = BAND / OPL;         // lanes per pair
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int base = lane & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << base;   // G <= 16
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (p >= P) return;   // whole groups leave together

  const int W = L + BAND - 1;
  const int8_t* q = query + p * L;
  const int8_t* qp = QP ? qpen + p * L : nullptr;
  const int8_t* r = ref + p * W + g * OPL;   // this lane's first offset
  const int qlen = qlens[p];
  const int rows = qlen < L ? qlen : L;
  const bool top = g == G - 1;
  // each array's own test: 4 rows per 32-bit load where its rows are
  // 4-byte aligned
  const bool q4 = (L & 3) == 0 && (((uintptr_t)query) & 3) == 0;
  const bool qp4 = QP && (L & 3) == 0 && (((uintptr_t)qpen) & 3) == 0;

  int dof[OPL];
  float dge[OPL];
  float H[OPL], I[OPL];
  uint32_t Hw[OPL][NW], Iw[OPL][NW];
  int rb[OPL];   // reference bytes of this lane's offsets at the current row
#pragma unroll
  for (int j = 0; j < OPL; ++j) {
    dof[j] = g * OPL + j;
    dge[j] = (float)dof[j] * ge;
    H[j] = 0.f;
    I[j] = NEG;
#pragma unroll
    for (int k = 0; k < NW; ++k) Hw[j][k] = Iw[j][k] = 0u;
    rb[j] = 0;
  }
#pragma unroll
  for (int j = 0; j + 1 < OPL; ++j) rb[j + 1] = r[j];   // slides in below
  // the best cell: its row, and in each lane the first of the lane's
  // offsets holding that row's maximum (OPL if none) with its words; the
  // group picks the first such lane once, after the last row
  float best = NEG;
  int best_i = 0, best_j = OPL;
  uint32_t bw[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) bw[k] = 0u;
  uint32_t qword = 0u, pword = 0u;

  for (int i = 0; i < rows; ++i) {
    if ((i & 3) == 0) {
      qword = load_rows4(q, i, rows, q4);
      if constexpr (QP) pword = load_rows4(qp, i, rows, qp4);
    }
    const int qi = (int)(int8_t)(qword >> (8 * (i & 3)));
    float qpf = 0.f;   // this row's mismatch penalty (QP)
    if constexpr (QP) qpf = (float)(int8_t)(pword >> (8 * (i & 3)));
    // reference window: one new byte a row, the others slide down
#pragma unroll
    for (int j = 0; j + 1 < OPL; ++j) rb[j] = rb[j + 1];
    rb[OPL - 1] = r[i + OPL - 1];
    const bool row0 = i == 0;

    // insertion predecessor of the lane's last offset: the next lane's
    // first offset of the previous row; above the band, the fill
    float upH = __shfl_down_sync(gmask, H[0], 1, G);
    float upI = __shfl_down_sync(gmask, I[0], 1, G);
    uint32_t upHw[NW], upIw[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      upHw[k] = __shfl_down_sync(gmask, Hw[0][k], 1, G);
      upIw[k] = __shfl_down_sync(gmask, Iw[0][k], 1, G);
    }
    if (top) {
      upH = upI = NEG;
#pragma unroll
      for (int k = 0; k < NW; ++k) upHw[k] = upIw[k] = 0u;
    }

    float T1[OPL], In[OPL];
    uint32_t T1w[OPL][NW], Inw[OPL][NW];
    ScanEl<NW> S[OPL];   // scan elements, then their in-lane inclusive prefix
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const int rj = rb[j];
      const bool m = qi == rj && qi < 4 && rj < 4;
      float sub;
      if constexpr (QP) {
        // a read N costs npen, a reference N -mismatch, a mismatch qpen
        const float pen = qi >= 4 ? npen : (rj >= 4 ? -mi : qpf);
        sub = m ? ma : -pen;
      } else {
        sub = m ? ma : mi;
      }
      // H is fresh (its path starts here) iff LOCAL clamped it, which is
      // the only way it becomes 0, or, in glocal mode, on row 0. A fresh
      // H has empty statistics.
      const bool hf = LOCAL ? H[j] == 0.f : row0;
      T1[j] = H[j] + sub;
      if constexpr (NS == 6) {
        T1w[j][0] = Hw[j][0] + (m ? 1u : 0x10000u);
        T1w[j][1] = Hw[j][1];
        T1w[j][2] = hf ? pack2(i, i + dof[j]) : Hw[j][2];
      } else {
        T1w[j][0] = hf ? (uint32_t)(i + dof[j]) : Hw[j][0];
      }

      // insertion: predecessor at offset d + 1 of the previous row
      const bool last = j == OPL - 1;
      const int jn = last ? j : j + 1;
      const float pH = last ? upH : H[jn];
      const float pI = last ? upI : I[jn];
      uint32_t pHw[NW], pIw[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        pHw[k] = last ? upHw[k] : Hw[jn][k];
        pIw[k] = last ? upIw[k] : Iw[jn][k];
      }
      // the fill above the band is never fresh (in LOCAL: NEG != 0)
      const bool pf = LOCAL ? pH == 0.f : row0 && !(last && top);
      const float i_ext = pI - ge;
      const float i_open = (pH - go) - ge;
      const bool take_ext = i_ext >= i_open;
      In[j] = take_ext ? i_ext : i_open;
      if constexpr (NS == 6) {
        Inw[j][0] = take_ext ? pIw[0] : pHw[0];
        Inw[j][1] = (take_ext ? pIw[1] : pHw[1]) + (take_ext ? 1u : 0x10001u);
        Inw[j][2] = take_ext ? pIw[2]
                             : (pf ? pack2(i, (i + 1) + dof[j]) : pHw[2]);
      } else {
        Inw[j][0] = take_ext ? pIw[0]
                             : (pf ? (uint32_t)((i + 1) + dof[j]) : pHw[0]);
      }

      // pre-deletion best; diagonal wins ties over insertion
      const bool take_I = In[j] > T1[j];
      const float h = take_I ? In[j] : T1[j];
      ScanEl<NW> e;
#pragma unroll
      for (int k = 0; k < NW; ++k) e.w[k] = take_I ? Inw[j][k] : T1w[j][k];
      if constexpr (LOCAL) {
        const bool clamp = h <= 0.f;
        if (clamp) {
#pragma unroll
          for (int k = 0; k < NW; ++k) e.w[k] = 0u;
        }
        e.A = clamp ? NEG : h + dge[j];
      } else {
        e.A = h + dge[j];
      }
      if constexpr (NS == 6)
        e.w[1] += (uint32_t)(BAND - dof[j]);   // bias: gap_cols - origin + BAND
      S[j] = j ? take_lower(S[j - 1], e) : e;
    }

    // deletion: exclusive prefix over the band. In-lane prefix (above),
    // Kogge-Stone over the lanes' totals, shift to the exclusive form.
    ScanEl<NW> X = S[OPL - 1];
#pragma unroll
    for (int sh = 1; sh < G; sh <<= 1) {
      ScanEl<NW> s = shfl_up_el(gmask, X, sh, G);
      if (g < sh) s = scan_fill<NW>();
      X = take_lower(s, X);
    }
    ScanEl<NW> Xe = shfl_up_el(gmask, X, 1, G);
    if (g == 0) Xe = scan_fill<NW>();

    float Hn[OPL];
    uint32_t Hnw[OPL][NW];
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const ScanEl<NW> E = j ? take_lower(Xe, S[j - 1]) : Xe;
      const float Dv = (E.A - go) - dge[j];
      uint32_t Dw[NW];
      if constexpr (NS == 6) {
        Dw[0] = E.w[0];
        // gap_cols + (d - origin), and one more gap open
        Dw[1] = E.w[1] + (uint32_t)(dof[j] - BAND) + 0x10000u;
        Dw[2] = E.w[2];
      } else {
        Dw[0] = E.w[0];
      }

      // final H: priority diagonal > deletion > insertion
      const bool take_D = Dv > T1[j];
      float hn = take_D ? Dv : T1[j];
      uint32_t w[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = take_D ? Dw[k] : T1w[j][k];
      const bool take_I2 = In[j] > hn;
      hn = take_I2 ? In[j] : hn;
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = take_I2 ? Inw[j][k] : w[k];
      if constexpr (LOCAL) {
        if (hn <= 0.f) {
          hn = 0.f;
#pragma unroll
          for (int k = 0; k < NW; ++k) w[k] = 0u;
        }
      }
      Hn[j] = hn;
#pragma unroll
      for (int k = 0; k < NW; ++k) Hnw[j][k] = w[k];
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
          for (int k = 0; k < NW; ++k) bw[k] = Hnw[j][k];
        }
      }
    }

#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      H[j] = Hn[j];
      I[j] = In[j];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
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
  for (int k = 0; k < NW; ++k) bw[k] = __shfl_sync(gmask, bw[k], src, G);
  if (g == 0) {
    const int qend = best_i + 1;
    const int wend = best_i + (hits ? best_d : 0) + 1;
    score[p] = best;
    if constexpr (NS == 6) {
      stats[0LL * P + p] = (int32_t)(bw[2] & 0xFFFFu);   // qstart
      stats[1LL * P + p] = qend;
      stats[2LL * P + p] = (int32_t)(bw[2] >> 16);       // wstart
      stats[3LL * P + p] = wend;
      stats[4LL * P + p] = (int32_t)(bw[0] & 0xFFFFu);   // matches
      stats[5LL * P + p] = (int32_t)(bw[0] >> 16);       // mismatches
      stats[6LL * P + p] = (int32_t)(bw[1] & 0xFFFFu);   // gap_cols
      stats[7LL * P + p] = (int32_t)(bw[1] >> 16);       // gap_opens
    } else {
      stats[0LL * P + p] = qend;
      stats[1LL * P + p] = (int32_t)bw[0];               // wstart
      stats[2LL * P + p] = wend;
    }
  }
}

struct Args {
  const int8_t* query;
  const int32_t* qlens;
  const int8_t* ref;
  const int8_t* qpen;
  float* score;
  int32_t* stats;
  int P, L;
  float ma, mi, go, ge, npen;
  cudaStream_t stream;
};

template <bool LOCAL, int NS, bool QP>
void launch_packed(const Args& a) {
  constexpr int OPL = offsets_per_lane(NS, QP);
  const long long threads = (long long)a.P * (BAND / OPL);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  packed_sw_kernel<LOCAL, NS, QP, OPL><<<blocks, THREADS, 0, a.stream>>>(
      a.query, a.qlens, a.ref, a.qpen, a.score, a.stats, a.P, a.L, a.ma,
      a.mi, a.go, a.ge, a.npen);
}

template <bool LOCAL, bool QP>
void launch_template(const Args& a) {
  const long long threads = (long long)a.P * BAND;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  banded_sw_kernel<LOCAL, QP><<<blocks, THREADS, 0, a.stream>>>(
      a.query, a.qlens, a.ref, a.qpen, a.score, a.stats, a.P, a.L, a.ma,
      a.mi, a.go, a.ge, a.npen);
}

template <bool LOCAL>
void dispatch(int n_stats, const Args& a) {
  const bool qp = a.qpen != nullptr;
  if (n_stats == 1) {
    if (qp) launch_packed<LOCAL, 1, true>(a);
    else launch_packed<LOCAL, 1, false>(a);
  } else if (a.L <= PACKED_MAX_L) {
    if (qp) launch_packed<LOCAL, 6, true>(a);
    else launch_packed<LOCAL, 6, false>(a);
  } else {
    if (qp) launch_template<LOCAL, true>(a);
    else launch_template<LOCAL, false>(a);
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
  const Args a{(const int8_t*)query, (const int32_t*)qlens,
               (const int8_t*)ref,   (const int8_t*)qpen,
               (float*)score,        (int32_t*)stats,
               P, L, ma, mi, go, ge, npen, (cudaStream_t)stream};
  if (local)
    dispatch<true>(n_stats, a);
  else
    dispatch<false>(n_stats, a);
  return (int)cudaGetLastError();
}

// The packed kernel's band offsets a lane for a variant (n_stats 6 or 1,
// with or without qpen).
extern "C" int banded_sw_offsets_per_lane(int n_stats, int qual_pen) {
  return offsets_per_lane(n_stats, qual_pen != 0);
}

// The longest row the full-statistics variants take on the packed kernel
// (longer ones go to the template kernel).
extern "C" int banded_sw_packed_max_l(void) { return PACKED_MAX_L; }
