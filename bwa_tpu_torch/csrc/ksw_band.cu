// Kernel K2: batched banded ksw_extend2 with in-kernel query/.pac gather.
//
// Replaces the JAX package's Pallas kernel
// bwa_tpu/ops/ksw_pallas.py::_mk_band_kernel as called through
// bwa_tpu/ops/ext_gather.py::_side_call (ExtGatherEngine.run_fused) and
// ::_ext_band_meta (ExtGatherEngine.run): one pass of mem_chain2aln seed
// extensions (ksw.c:416-515 semantics) in band-relative coordinates
// p = j - (i - W), W = P/2 - 1.  Its host-array mode (bwa_ksw_band_arrays)
// replaces the same body as called through
// bwa_tpu/ops/ksw_pallas.py::_extend_band (extend_band_pallas): query rows
// and target rows come from [n, Q] and [n, T] code arrays instead of read
// coordinates and the .pac.
//
// Design: one block per problem, thread t owning the S consecutive band
// slots p = t*S .. t*S+S-1 (S = 1 up to P = 1024, 2 up to 2048, 4 up to
// 4096, so a block never exceeds 1024 threads).  The block sweeps the
// target rows i = 0..tlen-1 and stops at the first row where the problem
// is done (row max 0 or z-drop) -- nothing after that row can change an
// output.  Per row:
//   * the band slides one column right: slot p takes slot p+1's H/E and
//     query code, and slot P-1 takes q[i-W+P-1] with the first-row eh
//     init value (stale cells keep their init, as in the reference);
//   * the diagonal H(i-1, j-1) is the slot's own H, E(i-1, j) the slot's
//     own E, and F is an in-row prefix max of max(M - oe_ins, 0) +
//     j*e_ins (a scan over the thread's own slots, then a block scan of
//     the thread totals: warp shuffles, then the warp totals);
//   * block reductions give the row max with its largest column (ties go
//     to the larger column), and the first/last non-zero cells that set
//     the adaptive band for the next row.
// The query windows come from the batch's flat read codes in direction
// qdir, the target rows from the 2-bit .pac with the reverse complement on
// the reverse half (bns_get_seq, bntseq.c:403-424).
//
// What bounds it: the DP is ~20 integer operations per cell on P cells per
// row; the inputs are a few bytes per row.  It is compute- and
// synchronisation-bound: each row costs a dozen block barriers, so the
// kernel leans on many resident blocks (one problem each) to keep the
// SMs busy.

#include "ksw_common.cuh"

namespace {

using namespace ksw;

constexpr int MAX_P = 4096;   // widest band: 4 slots per thread

struct BandArgs {
  const uint8_t *pac;     // 2-bit packed forward reference
  int64_t l_pac;
  const uint8_t *qflat;   // flat read codes of the batch
  int64_t nq;
  // host-array mode (ts != nullptr): problem r's query is qflat[r*q_stride
  // ...] forwards, its target ts[r*t_stride ...]; qbase/qdir/tbase/tdir
  // and the .pac are not read
  const uint8_t *ts;
  int64_t q_stride, t_stride;
  const int64_t *qbase, *tbase;
  const int32_t *qdir, *qlen, *tdir, *tlen, *w, *h0;
  int32_t *out;           // [n, 7]: score qle tle gtle gscore max_off rows
  int n, P, W;
  int mat[25];
  int o_del, e_del, o_ins, e_ins, zdrop;
};

__device__ __forceinline__ int q_at(const BandArgs &a, int64_t qb, int qd,
                                    int ql, int64_t jq) {
  if (jq < 0 || jq >= ql) return 4;
  int64_t idx = qb + (int64_t)qd * jq;
  idx = idx < 0 ? 0 : (idx > a.nq - 1 ? a.nq - 1 : idx);
  return a.qflat[idx];
}

__device__ __forceinline__ int pac_at(const BandArgs &a, int64_t pos) {
  int64_t two_l = a.l_pac * 2;
  int64_t pc = pos < 0 ? 0 : (pos > two_l - 1 ? two_l - 1 : pos);
  bool fwd = pc < a.l_pac;
  int64_t f = fwd ? pc : two_l - 1 - pc;
  int code = (a.pac[f >> 2] >> (((~f) & 3) << 1)) & 3;
  return fwd ? code : 3 - code;
}

template <int S>
__global__ void __launch_bounds__(1024) ksw_band_kernel(BandArgs a) {
  extern __shared__ int smem[];
  const int P = a.P, W = a.W;
  int *sH = smem;          // [P] H(i-1, j-1) at slot p (eh[j].h)
  int *sE = sH + P;        // [P] E(i, j)
  int *sQ = sE + P;        // [P] query code at slot p
  int *sRun = sQ + P;      // [P] row scan / Hrow exchange
  __shared__ int64_t red[MAXW];
  __shared__ int wtot[MAXW];

  const int prob = blockIdx.x;
  const int p0 = threadIdx.x * S;  // this thread's slots: p0 .. p0+S-1
  const bool arrays = a.ts != nullptr;
  const int64_t qb = arrays ? prob * a.q_stride : a.qbase[prob];
  const int64_t tb = arrays ? prob * a.t_stride : a.tbase[prob];
  const int qd = arrays ? 1 : a.qdir[prob];
  const int td = arrays ? 1 : a.tdir[prob];
  const int qlen = a.qlen[prob], tlen = a.tlen[prob];
  const int w = a.w[prob], h0 = a.h0[prob];
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int e_del = a.e_del, e_ins = a.e_ins;
  const int e1 = h0 - oe_ins > 0 ? h0 - oe_ins : 0;

  // row-0 band state
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int p = p0 + k;
    sH[p] = eh_init(p - W, h0, e1, e_ins, qlen);
    sE[p] = 0;
    sQ[p] = q_at(a, qb, qd, qlen, p - W);
  }
  int beg = 0, end = qlen, mx = h0, mx_i = -1, mx_j = -1, mx_ie = -1;
  int gsc = -1, mx_off = 0, rows = 0;
  __syncthreads();

  for (int i = 0; i < tlen; ++i) {
    rows = i + 1;
    if (i > 0) {  // slide the band one column right
      const int j_ent = i - W + P - 1;
      int hn[S], en[S], qn[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int p = p0 + k;
        const bool last = p == P - 1;
        hn[k] = last ? eh_init(j_ent, h0, e1, e_ins, qlen) : sH[p + 1];
        en[k] = last ? 0 : sE[p + 1];
        qn[k] = last ? q_at(a, qb, qd, qlen, j_ent) : sQ[p + 1];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < S; ++k) {
        sH[p0 + k] = hn[k];
        sE[p0 + k] = en[k];
        sQ[p0 + k] = qn[k];
      }
      __syncthreads();
    }
    const int tci = arrays ? a.ts[tb + i] : pac_at(a, tb + (int64_t)td * i);
    const int beg_r = beg > i - w ? beg : i - w;
    int end_r = end < i + w + 1 ? end : i + w + 1;
    end_r = end_r < qlen ? end_r : qlen;
    int h1 = h0 - (a.o_del + e_del * (i + 1));
    h1 = h1 > 0 ? h1 : 0;
    const int h1_init = beg_r == 0 ? h1 : 0;

    int colj[S], Hold[S], Eold[S], M[S], e_cur[S], run[S];
    bool inband[S];
    int loc = NEG;  // prefix max over this thread's slots
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int p = p0 + k;
      colj[k] = p + (i - W);
      inband[k] = colj[k] >= beg_r && colj[k] < end_r;
      Hold[k] = sH[p];
      Eold[k] = sE[p];
      const int sc = a.mat[tci * 5 + sQ[p]];
      const int m = Hold[k] != 0 ? Hold[k] + sc : 0;
      M[k] = inband[k] ? m : NEG;
      e_cur[k] = inband[k] ? Eold[k] : NEG;
      const int g = inband[k] ? imax(M[k] - oe_ins, 0) : NEG;
      loc = imax(loc, g + colj[k] * e_ins);
      run[k] = loc;
    }
    const int pre = block_scan_max_excl(loc, wtot);
#pragma unroll
    for (int k = 0; k < S; ++k) sRun[p0 + k] = imax(pre, run[k]);
    __syncthreads();
    int Hrow[S];
    int64_t key = INT64_MIN;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int p = p0 + k;
      int F = p >= 1 ? sRun[p - 1] - (colj[k] - 1) * e_ins : NEG;
      if (colj[k] == beg_r) F = 0;
      if (!inband[k]) F = NEG;
      int hr = imax(imax(M[k], e_cur[k]), F);
      Hrow[k] = inband[k] ? hr : NEG;
      const int64_t kk = inband[k]
          ? (((int64_t)Hrow[k] << 32) | (uint32_t)colj[k]) : INT64_MIN;
      key = kk > key ? kk : key;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S; ++k) sRun[p0 + k] = Hrow[k];
    // row max and its largest column
    key = block_max64(key, red);  // also orders the sRun writes
    int mraw = key == INT64_MIN ? NEG : (int)(key >> 32);
    const int mrow = mraw > 0 ? mraw : 0;
    const int mj = mrow > 0 ? (int)(uint32_t)(key & 0xffffffffu) : -1;
    int h_last = h1_init;
    if (end_r > beg_r) h_last = sRun[end_r - 1 - (i - W)];
    if (end_r == qlen && h_last >= gsc) {
      mx_ie = i;
      gsc = h_last > gsc ? h_last : gsc;
    }
    bool nz[S];
    int first = 0x3fffffff;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int p = p0 + k;
      const int t_del = imax(M[k] - oe_del, 0);
      const int Enew = imax(e_cur[k] - e_del, t_del);
      const int Hsh = colj[k] >= 1 ? sRun[(p + P - 1) % P] : h1_init;
      int H2 = inband[k] ? Hsh : Hold[k];
      int E2 = inband[k] ? Enew : Eold[k];
      if (colj[k] == end_r) {
        H2 = h_last;
        E2 = 0;
      }
      sH[p] = H2;
      sE[p] = E2;
      nz[k] = !(H2 == 0 && E2 == 0);
      if (nz[k] && colj[k] >= beg_r && colj[k] < end_r && colj[k] < first)
        first = colj[k];
    }

    const bool brk0 = mrow == 0;
    const bool imp = !brk0 && mrow > mx;
    if (imp) {
      mx_i = i;
      int d = mj - i < 0 ? i - mj : mj - i;
      mx_off = mx_off > d ? mx_off : d;
      mx_j = mj;
    }
    bool brkz = false;
    if (!brk0 && !imp && a.zdrop > 0) {
      int d_i = i - mx_i, d_j = mj - mx_j;
      if (d_i > d_j) brkz = mx - mrow - (d_i - d_j) * e_del > a.zdrop;
      else brkz = mx - mrow - (d_j - d_i) * e_ins > a.zdrop;
    }
    if (imp) mx = mrow;

    const int first_nz = block_min32(first, red);
    const int beg_n = first_nz < end_r ? first_nz : end_r;
    int last = beg_n - 1;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (nz[k] && colj[k] >= beg_n && colj[k] <= end_r)
        last = imax(last, colj[k]);
    const int last_nz = block_max32(last, red);
    const int end_n = last_nz + 2 < qlen ? last_nz + 2 : qlen;
    if (brk0 || brkz) break;
    beg = beg_n;
    end = end_n;
  }
  if (threadIdx.x == 0) {
    int32_t *o = a.out + (int64_t)prob * 7;
    o[0] = mx;
    o[1] = mx_j + 1;
    o[2] = mx_i + 1;
    o[3] = mx_ie + 1;
    o[4] = gsc;
    o[5] = mx_off;
    o[6] = rows;  // target rows swept (work diagnostic)
  }
}

template <int S>
int launch(const BandArgs &a, cudaStream_t stream) {
  const size_t shm = (size_t)4 * a.P * sizeof(int);
  // opt in to the dynamic shared memory: from P = 3072 it and the static
  // reduction arrays pass the default 48 KB per block
  cudaError_t e = cudaFuncSetAttribute(
      ksw_band_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  ksw_band_kernel<S><<<a.n, a.P / S, shm, stream>>>(a);
  return (int)cudaGetLastError();
}

int run(BandArgs &a, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const int P = a.P;
  const int S = P <= 1024 ? 1 : (P <= 2048 ? 2 : 4);
  if (P < 32 || P > MAX_P || P % (32 * S) != 0)
    return (int)cudaErrorInvalidValue;
  a.W = P / 2 - 1;
  if (S == 1) return launch<1>(a, stream);
  if (S == 2) return launch<2>(a, stream);
  return launch<4>(a, stream);
}

}  // namespace

extern "C" int bwa_ksw_band(const uint8_t *pac, int64_t l_pac,
                            const uint8_t *qflat, int64_t nq,
                            const int64_t *qbase, const int32_t *qdir,
                            const int32_t *qlen, const int64_t *tbase,
                            const int32_t *tdir, const int32_t *tlen,
                            const int32_t *w, const int32_t *h0,
                            const int32_t *mat, int o_del, int e_del,
                            int o_ins, int e_ins, int zdrop, int P, int n,
                            int32_t *out, void *stream) {
  BandArgs a{pac, l_pac, qflat, nq, nullptr, 0, 0, qbase, tbase, qdir,
             qlen, tdir, tlen, w, h0, out, n, P, 0, {0}, o_del, e_del,
             o_ins, e_ins, zdrop};
  for (int k = 0; k < 25; ++k) a.mat[k] = mat[k];
  return run(a, (cudaStream_t)stream);
}

// host-array mode: qs [n, Q] and ts [n, T] row-major code arrays
extern "C" int bwa_ksw_band_arrays(const uint8_t *qs, int64_t Q,
                                   const uint8_t *ts, int64_t T,
                                   const int32_t *qlen, const int32_t *tlen,
                                   const int32_t *w, const int32_t *h0,
                                   const int32_t *mat, int o_del, int e_del,
                                   int o_ins, int e_ins, int zdrop, int P,
                                   int n, int32_t *out, void *stream) {
  BandArgs a{nullptr, 0, qs, (int64_t)n * Q, ts, Q, T, nullptr, nullptr,
             nullptr, qlen, nullptr, tlen, w, h0, out, n, P, 0, {0}, o_del,
             e_del, o_ins, e_ins, zdrop};
  for (int k = 0; k < 25; ++k) a.mat[k] = mat[k];
  return run(a, (cudaStream_t)stream);
}
