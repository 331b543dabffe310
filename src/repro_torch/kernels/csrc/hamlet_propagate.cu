// Masked prefix propagation for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hamlet_propagate.py
// (masked_prefix_propagate_pallas, body _propagate_kernel).  Per batch
// element it solves (I - L) C = B with L strictly lower triangular:
//
//     c[i] = base[i] + sum_{j<i} mask[i, j] * c[j]
//
// What bounds it on this card:
//   * bytes: the strict lower triangle of the mask is the only large operand
//     (nb * b * (b-1) / 2 entries against nb * b * d for base and out, with d
//     of 1-5 on every workload), and each entry feeds d multiply-adds, so the
//     roofline bound is the bytes of base, out and that triangle at the HBM
//     rate;
//   * the chain floor: every row depends on every earlier row, so a batch
//     element is b dependent steps (a warp shuffle and a multiply-add each)
//     that no bandwidth shortens.  The engine's buckets are small (251
//     distinct shapes in 263 launches per run, the costliest at nb = 2), so
//     on the main path a block's time is this chain plus what else sits on
//     it, on 2 of 132 SMs.
//
// Design: lookahead forward substitution over 32-row tiles T_0, T_1, ...
// One block per (batch element, chunk of kCols columns); kCols is 1, 2 or 4,
// chosen from d, so no accumulator idles at d <= 2.  The running right-hand
// side acc[b][kCols] starts as base and lives in shared memory, or in the
// output in global memory when it does not fit beside the copy rings (a
// size variant chosen by shape).  In iteration t:
//   * warp 0 solves T_t.  Lane r holds in registers row r of the diagonal
//     block mask[T_t, T_t] and row r of the lookahead block
//     mask[T_{t+1}, T_t].  Each round of the chain shuffles out two rows:
//     c[j] is final, and row j + 1 lacks only the j term, which every lane
//     adds itself; lanes below take both terms into their own row, and every
//     lane takes the lookahead terms into its row of T_{t+1}, kept in
//     registers for the next solve.  So the chain touches no memory, pays
//     one shuffle latency per two rows, and the lookahead update rides in
//     its idle issue slots instead of costing a pass and a barrier;
//   * warps 1..7, meanwhile, apply the panel of T_{t-1}:
//     acc[i] += mask[i, T_{t-1}] c[T_{t-1}] for every row i from T_{t+1} on,
//     in 32 x 32 blocks dealt round-robin.  Each warp streams its blocks
//     through its own ring of kStages shared-memory slots, filled by 8-byte
//     cp.async (an odd b leaves rows only 8-byte aligned, which rules out
//     16-byte copies and TMA) kStages - 1 blocks ahead of the block it
//     applies, across iteration boundaries, so the mask's bytes are in
//     flight while the chain runs.  They also copy warp 0's next diagonal
//     and lookahead blocks two tiles ahead, and signal them with an
//     mbarrier (cp.async.mbarrier.arrive): a copy issued from warp 0 would
//     queue behind the rings' copies on the chain;
//   * one barrier: T_{t+1} now holds every earlier tile's contribution.
// The critical path per tile is max(solve, panel) + one barrier, where it
// was stripe read + solve + two barriers.  Every strict-lower mask entry is
// read from device memory once.
//
// Semantics kept from the row oracle (repro_torch.kernels.ref
// .torch_prefix_propagate_batched): only mask[i, j] with j < i is read (the
// diagonal and the upper triangle are never copied); every product is
// formed, zeros included, so 0 * inf gives NaN where the oracle's does; f64
// and f32 accumulate in their own type (no tensor cores, so no TF32); int32
// accumulates in uint32, i.e. exactly modulo 2^32 like the oracle's wrapping
// int32 arithmetic.
#include <cstdint>

#include "hamlet_kernels.h"

namespace {

constexpr int kTile = 32;          // rows per tile: one warp solves a tile
constexpr int kPitch = kTile + 1;  // padded smem row: lane r reads row r
                                   // without bank conflicts
constexpr int kWarps = 8;          // warp 0 solves, warps 1..7 update
constexpr int kUpdaters = kWarps - 1;
constexpr int kStages = 3;         // ring slots per updater warp
constexpr int kSolverSlots = 4;    // diagonal + lookahead block, two sets
constexpr int kBlockElems = kTile * kPitch;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;   // dynamic shared memory of a block, sm_90

template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<int32_t> {
  using type = uint32_t;  // wrapping arithmetic without signed overflow
};

// dynamic shared memory: the updaters' rings, the solver slots, the two
// set_ready mbarriers, then acc when it lives there
template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return size_t(kUpdaters * kStages + kSolverSlots) * kBlockElems * sizeof(T);
}
template <typename T>
__host__ __device__ constexpr size_t fixed_bytes() {
  return ring_bytes<T>() + 2 * sizeof(uint64_t);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The mbarrier's pending count drops by one once every cp.async this thread
// has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// One warp copies rows r = r_first, r_first + r_step, ... of the 32 x 32
// block at rows i0.., columns j0.. of one b x b mask into dst (pitch
// kPitch), lane l taking column j0 + l of each row.  Rows at or past b are
// skipped; with kStrict, so is every entry on or right of the diagonal
// (column >= row).
template <typename T, bool kStrict>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ m,
                                          int b, int i0, int j0, int lane,
                                          int r_first = 0, int r_step = 1) {
  const uint32_t s = smem_addr(dst);
  const int rows = min(kTile, b - i0);
  for (int r = r_first; r < rows; r += r_step) {
    if (kStrict && lane >= r) continue;
    const T* src = m + int64_t(i0 + r) * b + j0 + lane;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     s + uint32_t((r * kPitch + lane) * sizeof(T))),
                 "l"(src), "n"(sizeof(T))
                 : "memory");
  }
}

// The panel blocks in the order they are applied: iteration t
// (1 <= t <= nT - 2) applies column tile t - 1 to row tiles t + 1 .. nT - 1.
// Block g of that flat order belongs to updater g % kUpdaters, which steps
// its cursor kUpdaters blocks at a time.  t >= nT means no block is left.
struct PanelCursor {
  int t, row;
  __device__ __forceinline__ void advance(int steps, int nT) {
    row += steps;
    while (t <= nT - 2 && row >= nT) {
      const int over = row - nT;
      ++t;
      row = t + 1 + over;
    }
    if (t > nT - 2) t = nT;
  }
};

// Lane r takes row r of the diagonal block (dg, strict lower part only) and
// of the lookahead block (lk), and every lane the entries that link the rows
// of each pair (2k, 2k + 1): w[k] = mask[2k + 1, 2k] of the diagonal block.
template <typename T, typename Acc>
__device__ __forceinline__ void load_set(const T* slot, int lane,
                                         Acc (&dg)[kTile], Acc (&lk)[kTile],
                                         Acc (&w)[kTile / 2]) {
#pragma unroll
  for (int jj = 0; jj < kTile; ++jj) {
    dg[jj] = jj < lane ? static_cast<Acc>(slot[lane * kPitch + jj]) : Acc(0);
    lk[jj] = static_cast<Acc>(slot[kBlockElems + lane * kPitch + jj]);
  }
#pragma unroll
  for (int k = 0; k < kTile / 2; ++k)
    w[k] = __shfl_sync(kFull, dg[2 * k], 2 * k + 1);
}

template <typename T, int kCols, bool kSmemAcc>
__global__ void __launch_bounds__(kWarps * 32, 1)
    masked_propagate_kernel(const T* __restrict__ base,
                            const T* __restrict__ mask, T* out, int b, int d) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* solver_slots = ring + kUpdaters * kStages * kBlockElems;
  // solver set t has landed: set_ready[t % 2]
  uint64_t* set_ready = reinterpret_cast<uint64_t*>(smem_raw + ring_bytes<T>());
  Acc* sacc = reinterpret_cast<Acc*>(smem_raw + fixed_bytes<T>());

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t bi = blockIdx.x;
  const int col0 = blockIdx.y * kCols;
  const int nc = min(kCols, d - col0);
  const int nT = (b + kTile - 1) / kTile;
  const T* B = base + bi * b * d;
  const T* M = mask + bi * b * b;
  T* O = out + bi * b * d;

  // the running right-hand side; a solved row holds c
  auto acc_ld = [&](int i, int cc) -> Acc {
    if (kSmemAcc) return sacc[i * kCols + cc];
    return cc < nc ? static_cast<Acc>(O[int64_t(i) * d + col0 + cc]) : Acc(0);
  };
  auto acc_st = [&](int i, int cc, Acc v) {
    if (kSmemAcc) sacc[i * kCols + cc] = v;
    else if (cc < nc) O[int64_t(i) * d + col0 + cc] = static_cast<T>(v);
  };

  // warp 0's set t (diagonal block of T_t, lookahead block T_{t+1} x T_t)
  // sits in solver slots 2 (t % 2) and 2 (t % 2) + 1.  The updaters copy it
  // (warp u the rows u, u + 7, ...), so that no copy waits in warp 0's
  // issue queue, and each of their threads arrives on set_ready[t % 2] when
  // its copies have landed.
  auto copy_set = [&](int t) {
    const int u = warp - 1;
    T* slot = solver_slots + (t & 1) * 2 * kBlockElems;
    copy_rows<T, true>(slot, M, b, t * kTile, t * kTile, lane, u, kUpdaters);
    if (t + 1 < nT)
      copy_rows<T, false>(slot + kBlockElems, M, b, (t + 1) * kTile,
                          t * kTile, lane, u, kUpdaters);
  };
  // warp 0 waits for set t: the (t / 2)-th phase of set_ready[t % 2]
  auto wait_set = [&](int t) { mbarrier_wait(&set_ready[t & 1], (t >> 1) & 1); };
  // updaters: block k of a warp's sequence sits in slot k % kStages of its
  // ring; one cp.async group per block, empty past the last
  T* my_ring = ring + (warp > 0 ? warp - 1 : 0) * kStages * kBlockElems;
  PanelCursor to_copy{1, 2}, to_apply{1, 2};
  int n_copied = 0, n_applied = 0;
  auto issue_block = [&]() {
    if (to_copy.t < nT) {
      copy_rows<T, false>(my_ring + (n_copied % kStages) * kBlockElems, M, b,
                          to_copy.row * kTile, (to_copy.t - 1) * kTile, lane);
      ++n_copied;
      to_copy.advance(kUpdaters, nT);
    }
    cp_async_commit();
  };

  // prologue: the first copies go out before base is read, so the two
  // latencies overlap; the arrivals wait for the mbarriers' initialisation
  if (threadIdx.x < 2)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(&set_ready[threadIdx.x])),
                 "r"(kUpdaters * 32)
                 : "memory");
  if (warp > 0) {
    copy_set(0);
    if (nT > 1) copy_set(1);
    to_copy.advance(warp - 1, nT);
    to_apply.advance(warp - 1, nT);
#pragma unroll
    for (int s = 0; s + 1 < kStages; ++s) issue_block();
  }
  for (int e = threadIdx.x; e < b * kCols; e += blockDim.x) {
    const int i = e / kCols, cc = e % kCols;
    acc_st(i, cc, cc < nc ? static_cast<Acc>(B[int64_t(i) * d + col0 + cc])
                          : Acc(0));
  }
  __syncthreads();  // the base rows and the mbarriers
  Acc dg[kTile], lk[kTile], w[kTile / 2], nx[kCols];
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) nx[cc] = Acc(0);
  if (warp == 0) {
    wait_set(0);
    load_set(solver_slots, lane, dg, lk, w);
  } else {
    cp_async_arrive(&set_ready[0]);
    if (nT > 1) cp_async_arrive(&set_ready[1]);
  }
  __syncthreads();  // set 0 is in registers: its slots may be refilled

  for (int t = 0; t < nT; ++t) {
    const int r0 = t * kTile;
    if (warp == 0) {
      // forward substitution in T_t: lane owns row r0 + lane
      const int i = r0 + lane;
      Acc v[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        v[cc] = i < b ? acc_ld(i, cc) + nx[cc] : Acc(0);
        nx[cc] = Acc(0);
      }
      // two rows per shuffle round: c[jj] is final, and row jj + 1 lacks
      // only the jj term, which every lane adds itself (w holds its
      // coefficient), in the order lane jj + 1 would; one shuffle latency
      // per two rows on the chain, the same roundings as row by row
#pragma unroll
      for (int jj = 0; jj < kTile; jj += 2) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const Acc c0 = __shfl_sync(kFull, v[cc], jj);
          const Acc c1 = __shfl_sync(kFull, v[cc], jj + 1) + w[jj / 2] * c0;
          // rows at or above jj are final: only later rows take the term
          if (lane > jj) v[cc] += dg[jj] * c0;
          if (lane > jj + 1) v[cc] += dg[jj + 1] * c1;
          nx[cc] += lk[jj] * c0;
          nx[cc] += lk[jj + 1] * c1;
        }
      }
      if (i < b) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          acc_st(i, cc, v[cc]);
          if (kSmemAcc && cc < nc)
            O[int64_t(i) * d + col0 + cc] = static_cast<T>(v[cc]);
        }
      }
      if (t + 1 < nT) {
        wait_set(t + 1);
        load_set(solver_slots + ((t + 1) & 1) * 2 * kBlockElems, lane, dg,
                 lk, w);
      }
    } else {
      // set t + 2 goes into the slots warp 0 emptied before the last barrier
      if (t + 2 < nT) {
        copy_set(t + 2);
        cp_async_arrive(&set_ready[t & 1]);
      }
      // the panel of T_{t-1}, for rows from T_{t+1} on
      while (to_apply.t == t) {
        issue_block();
        cp_async_wait<kStages - 1>();
        __syncwarp();
        const T* blk = my_ring + (n_applied % kStages) * kBlockElems;
        const int j0 = (t - 1) * kTile;
        const int i = to_apply.row * kTile + lane;
        Acc s0[kCols], s1[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) s0[cc] = s1[cc] = Acc(0);
#pragma unroll
        for (int jj = 0; jj < kTile; jj += 2) {
          const Acc m0 = static_cast<Acc>(blk[lane * kPitch + jj]);
          const Acc m1 = static_cast<Acc>(blk[lane * kPitch + jj + 1]);
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            s0[cc] += m0 * acc_ld(j0 + jj, cc);
            s1[cc] += m1 * acc_ld(j0 + jj + 1, cc);
          }
        }
        if (i < b) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            acc_st(i, cc, acc_ld(i, cc) + (s0[cc] + s1[cc]));
          }
        }
        __syncwarp();  // the slot is free before it is copied into again
        ++n_applied;
        to_apply.advance(kUpdaters, nT);
      }
    }
    __syncthreads();
  }
}

template <typename T, int kCols, bool kSmemAcc>
cudaError_t launch_shape(const T* base, const T* mask, T* out, int nb, int b,
                         int d, cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  auto kernel = masked_propagate_kernel<T, kCols, kSmemAcc>;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const size_t smem =
      fixed_bytes<T>() + (kSmemAcc ? size_t(b) * kCols * sizeof(Acc) : 0);
  const dim3 grid(nb, (d + kCols - 1) / kCols);
  kernel<<<grid, kWarps * 32, smem, stream>>>(base, mask, out, b, d);
  return cudaGetLastError();
}

template <typename T, int kCols>
cudaError_t launch_cols(const void* base, const void* mask, void* out, int nb,
                        int b, int d, cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  const T* bp = static_cast<const T*>(base);
  const T* mp = static_cast<const T*>(mask);
  T* op = static_cast<T*>(out);
  if (fixed_bytes<T>() + size_t(b) * kCols * sizeof(Acc) <= size_t(kSmemMax))
    return launch_shape<T, kCols, true>(bp, mp, op, nb, b, d, stream);
  return launch_shape<T, kCols, false>(bp, mp, op, nb, b, d, stream);
}

template <typename T>
cudaError_t launch_typed(const void* base, const void* mask, void* out,
                         int nb, int b, int d, cudaStream_t stream) {
  if (d == 1) return launch_cols<T, 1>(base, mask, out, nb, b, d, stream);
  if (d == 2) return launch_cols<T, 2>(base, mask, out, nb, b, d, stream);
  return launch_cols<T, 4>(base, mask, out, nb, b, d, stream);
}

}  // namespace

cudaError_t launch_masked_propagate(int dtype, const void* base,
                                    const void* mask, void* out, int nb,
                                    int b, int d, cudaStream_t stream) {
  if (nb <= 0 || b <= 0 || d <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kHamletF64:
      return launch_typed<double>(base, mask, out, nb, b, d, stream);
    case kHamletF32:
      return launch_typed<float>(base, mask, out, nb, b, d, stream);
    case kHamletI32:
      return launch_typed<int32_t>(base, mask, out, nb, b, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
