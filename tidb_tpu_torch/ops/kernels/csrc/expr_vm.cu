// K2/K3: the expression VM of the scan-aggregate fragment.
//
// Replaces: tidb_tpu/ops/device.py:235-1040 compile_expr and its family,
// traced into tidb_tpu/executor/device_exec.py:480 _build_pipeline.pipeline
// (live-row mask AND filters -> group keys -> aggregate inputs), and, with
// LOADG, the same expressions over a join fragment's joined row space
// (tidb_tpu/executor/device_join.py:704 gather_env + each f(env)): leaf
// filters, probe keys, ON residuals, final conditions, aggregate inputs.
//
// Bound on the card: memory.  Each row reads the input columns it computes
// on once and writes the mask and the computed key and value columns once;
// a key or value that is an input column unchanged is handed on as that
// column by the wrapper and never copied (its program has no STORE for
// it).  The arithmetic per row is a few dozen integer ops.  Least time =
// bytes moved / 3.35 TB/s.  A LOADG reads one 32-byte sector at random per
// row and column read through a row index, plus the index (8 bytes a row).
//
// Design.  The flat register program ops/kernels/expr_vm.py assembles —
// 8 int32 per instruction, registers of 64 bits (int64 or float64 bit
// patterns) plus a null byte, constants in two tables — is interpreted by
// persistent blocks of VM_THREADS threads that walk tiles of
// VM_THREADS * RPT rows (RPT 4, 2 or 1).  Per tile every thread decodes each
// instruction once (from shared memory, where the block staged the stream
// when it fits beside the register file; else from device memory through
// the read-only cache) and applies it to its RPT rows, strided by the block width, so loads stay coalesced
// and RPT loads (a LOADG's random sectors too) are in flight per thread.
// The register file is sized to the program (n_regs, not MAX_REGS) and
// lives in shared memory, register-major: register r of the tile's rows is
// one run of 8-byte words (one warp's access is 256 consecutive bytes),
// its null bytes beside it in a run of their own.  The result of the last
// instruction stays in real registers (acc): the wrapper marks each
// operand that reads it and each result that a later instruction reads
// from the register file (expr_vm.py kernel_stream), so a value used only
// by the next instruction never touches shared memory.  Nothing sits in
// local memory (ptxas: 0 bytes stack frame): the ops that call the
// device's division routines run their rows one at a time on the
// register file, so nothing but the row is live across a call.  The
// constant tables are staged in shared memory when they fit after the
// stream.  Arguments
// (every column pointer, dtype, row index and null mask) come by value in
// the kernel's parameter space; a uniform index reads them from the
// constant bank.  Every thread runs the same instruction at the same time,
// so the opcode switch does not diverge.  Each case reads all its operands
// before it writes, so the destination may reuse an operand's register.
// Float ops use the _rn intrinsics, so no multiply-add is contracted and
// the result is bit-identical to the torch interpreter.
#include "common.cuh"

#define MAX_REGS 64
#define VM_MAX_IN 64
#define VM_MAX_OUT 64
#define VM_THREADS 256

// The flag bits above an instruction's opcode (expr_vm.py kernel_stream):
// operand a, b or c is the last result (acc); the result is written to
// its register.
#define F_A 1
#define F_B 2
#define F_C 4
#define F_WB 8

enum {
  LOAD, CONST, I2F, F2I, MULK, DIVKF,
  ADD_I, SUB_I, MUL_I, ADD_F, SUB_F, MUL_F,
  CMP_I, CMP_F, DIV_F, DIV_DEC,
  AND, OR, NOT, ISNULL, NEG_I, NEG_F, ABS_I, ABS_F,
  IN_I, IN_F, NZ_F, TRUTHY, BAND, BOR, BNOT,
  SEL, COALESCE, CIVIL, FLOORDIVK,
  LUT_I, LUT_F, LUTN_I, LUTN_F, ROUNDDIVK, RINT,
  STORE, MASK, LOADG
};

// The launch's arguments, by value.  in_idx / in_ext are read by LOADG
// only: a row-index tensor (int64) and an extra null mask (bool), each
// null when absent.
struct VmArgs {
  i64 n, n_live;
  int n_instr, n_regs, n_ci, n_cf;
  const int* prog;
  const i64* ci;
  const double* cf;
  unsigned char* mask;
  const void* in_data[VM_MAX_IN];
  const unsigned char* in_null[VM_MAX_IN];
  const i64* in_idx[VM_MAX_IN];
  const unsigned char* in_ext[VM_MAX_IN];
  i64* out_data[VM_MAX_OUT];
  unsigned char* out_null[VM_MAX_OUT];
  unsigned char in_dtype[VM_MAX_IN];
  // the join finish epilogue (fin_kind >= 0, a join kind): the mask is a
  // join's match flag, and each row also gets the kind's valid flag from
  // fin_pvalid (null: every row valid) and the no-match flag; the valid
  // rows are counted into *fin_count through fin_status (a ticket, then a
  // count for each of fin_slots blocks: all 0 between launches)
  int fin_kind;
  int fin_slots;
  const unsigned char* fin_pvalid;
  unsigned char* fin_valid;
  unsigned char* fin_nohit;
  i64* fin_count;
  u64* fin_status;
};

__device__ __forceinline__ double as_f(i64 v) { return __longlong_as_double(v); }
__device__ __forceinline__ i64 as_i(double v) { return __double_as_longlong(v); }

template <typename T>
__device__ __forceinline__ bool cmp_op(int code, T a, T b) {
  switch (code) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

// Membership by binary search with numpy's clip-then-compare semantics.
template <typename T>
__device__ __forceinline__ bool in_sorted(const T* t, int len, T v) {
  if (len == 0) return false;
  int lo = 0, hi = len;  // first index with t[i] >= v (searchsorted left)
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (t[mid] < v) lo = mid + 1; else hi = mid;
  }
  if (lo > len - 1) lo = len - 1;
  return t[lo] == v;
}

__device__ __forceinline__ i64 civil(i64 z, int part) {
  z = z + 719468;
  i64 era = floordiv(z >= 0 ? z : z - 146096, 146097);
  i64 doe = z - era * 146097;
  i64 yoe = floordiv(doe - floordiv(doe, 1460) + floordiv(doe, 36524)
                     - floordiv(doe, 146096), 365);
  i64 y = yoe + era * 400;
  i64 doy = doe - (365 * yoe + floordiv(yoe, 4) - floordiv(yoe, 100));
  i64 mp = floordiv(5 * doy + 2, 153);
  i64 d = doy - floordiv(153 * mp + 2, 5) + 1;
  i64 m = mp < 10 ? mp + 3 : mp - 9;
  if (m <= 2) y += 1;
  return part == 0 ? y : (part == 1 ? m : d);
}

__device__ __forceinline__ i64 clip_code(i64 v, i64 len) {
  return v < 0 ? 0 : (v > len - 1 ? len - 1 : v);
}

// The rows of one thread in a tile: k = 0 .. RPT-1, column c of the tile.
#define ROWS _Pragma("unroll") for (int k = 0; k < RPT; ++k)
#define COL(k) (threadIdx.x + (k) * VM_THREADS)
#define RV(r, k) V[(r) * T + COL(k)]
#define RN(r, k) NL[(r) * T + COL(k)]

// Operand N of every row: the last result (flag BIT) or register R.
#define OPND(USE, BIT, R, VS, NS)                                        \
  if (!(USE)) {                                                          \
    ROWS { VS[k] = 0; NS[k] = false; }                                   \
  } else if (fl & (BIT)) {                                               \
    ROWS { VS[k] = acc[k]; NS[k] = accn[k]; }                            \
  } else {                                                               \
    ROWS { VS[k] = RV(R, k); NS[k] = RN(R, k) != 0; }                    \
  }

// One ALU instruction over the thread's rows: read the NA operands of
// every row, then compute the body (which sets r and nr from x, y, z, nx,
// ny, nz) into acc, and write it to the register file when a later
// instruction reads it there.
#define ALU(NA, ...)                                                     \
  {                                                                      \
    i64 xs[RPT], ys[RPT], zs[RPT];                                       \
    bool nxs[RPT], nys[RPT], nzs[RPT];                                   \
    OPND(NA > 0, F_A, ra, xs, nxs)                                       \
    OPND(NA > 1, F_B, rb, ys, nys)                                       \
    OPND(NA > 2, F_C, rc, zs, nzs)                                       \
    ROWS {                                                               \
      const i64 x = xs[k], y = ys[k], z = zs[k];                         \
      const bool nx = nxs[k], ny = nys[k], nz = nzs[k];                  \
      i64 r = 0;                                                         \
      bool nr = false;                                                   \
      __VA_ARGS__;                                                       \
      (void)x; (void)y; (void)z; (void)nx; (void)ny; (void)nz;           \
      acc[k] = r;                                                        \
      accn[k] = nr;                                                      \
    }                                                                    \
    if (fl & F_WB) {                                                     \
      ROWS { RV(dst, k) = acc[k]; RN(dst, k) = accn[k]; }                \
    }                                                                    \
  }                                                                      \
  break

// An instruction that calls a division routine: row by row from the
// register file to the register file (kernel_stream never forwards its
// operands or its result), so no other row's values are live across the
// call.
#define SERIAL(NA, ...)                                                  \
  {                                                                      \
    ROWS { acc[k] = 0; accn[k] = false; }                                \
    ROWS {                                                               \
      const i64 x = RV(ra, k), y = NA > 1 ? RV(rb, k) : 0;               \
      const bool nx = RN(ra, k) != 0, ny = NA > 1 ? RN(rb, k) != 0 : false; \
      i64 r = 0;                                                         \
      bool nr = false;                                                   \
      __VA_ARGS__;                                                       \
      (void)y; (void)ny;                                                 \
      RV(dst, k) = r;                                                    \
      RN(dst, k) = nr;                                                   \
    }                                                                    \
  }                                                                      \
  break

// Loads of one input column at the rows src[k] (ok[k] false: 0), the
// column's dtype widened to int64 (integers) or float64 bits (floats).
#define GATHER(TYPE, CONV)                                               \
  {                                                                      \
    const TYPE* p = (const TYPE*)d;                                      \
    ROWS v[k] = ok[k] ? CONV(p[src[k]]) : 0;                             \
  }                                                                      \
  break
#define AS_I64(x) ((i64)(x))
#define F32_BITS(x) as_i((double)(x))

template <int RPT>
__device__ __forceinline__ void load_rows(const void* d, int dtype,
                                          const i64 (&src)[RPT],
                                          const bool (&ok)[RPT],
                                          i64 (&v)[RPT]) {
  switch (dtype) {
    case 0:
    case 2: GATHER(i64, AS_I64);  // float64: keep the bit pattern
    case 1: GATHER(int, AS_I64);
    case 3: GATHER(float, F32_BITS);
    case 4: GATHER(unsigned char, AS_I64);
    case 5: GATHER(short, AS_I64);
    default: GATHER(signed char, AS_I64);
  }
}

// The epilogue's count.  Each tile's warps add their valid rows to their
// block's slot of fin_status (one atomic a warp and tile, no state kept
// across the program's instructions); the block that takes the last
// ticket sums and clears the slots, through the shared register file (no
// tile uses it any more), writes the count and clears the ticket.  Every
// thread of the block calls it.
__device__ __forceinline__ void finish_count(const VmArgs& a, i64* part) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __threadfence();  // this block's slot adds, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const u64 t = atomicAdd((unsigned long long*)&a.fin_status[0], 1ull);
    part[0] = t == (u64)gridDim.x - 1;
  }
  __syncthreads();
  if (!part[0]) return;
  __threadfence();
  i64 s = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += VM_THREADS)
    s += (i64)atomicExch((unsigned long long*)&a.fin_status[1 + b], 0ull);
  s = warp_sum_i64(s);
  __syncthreads();
  if (lane == 0) part[1 + w] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    i64 total = 0;
    for (int i = 0; i < VM_THREADS / 32; ++i) total += part[1 + i];
    *a.fin_count = total;
    atomicExch((unsigned long long*)&a.fin_status[0], 0ull);
  }
}

// Shared memory of a block: the register file's values (n_regs x T
// words) and null bytes (n_regs x T), then what STAGE stages: 0 nothing
// (the stream and the constant tables are read from device memory), 1 the
// instruction stream, 2 the stream and the constant tables.
template <int RPT, int STAGE>
__global__ void __launch_bounds__(VM_THREADS)
expr_vm_kernel(const VmArgs a) {
  constexpr int T = VM_THREADS * RPT;  // rows of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  i64* V = (i64*)smem;
  unsigned char* NL = smem + (size_t)a.n_regs * T * 8;
  int4* sprog = (int4*)(smem + (size_t)a.n_regs * T * 9);
  i64* sci = (i64*)(sprog + 2 * a.n_instr);
  double* scf = (double*)(sci + a.n_ci);
  if (STAGE > 0) {
    for (int i = threadIdx.x; i < 2 * a.n_instr; i += VM_THREADS)
      sprog[i] = __ldg((const int4*)a.prog + i);
  }
  if (STAGE > 1) {
    for (int i = threadIdx.x; i < a.n_ci; i += VM_THREADS) sci[i] = __ldg(a.ci + i);
    for (int i = threadIdx.x; i < a.n_cf; i += VM_THREADS) scf[i] = __ldg(a.cf + i);
  }
  const int4* prog = STAGE > 0 ? sprog : (const int4*)a.prog;
  const i64* ci = STAGE > 1 ? sci : a.ci;
  const double* cf = STAGE > 1 ? scf : a.cf;
  __syncthreads();
  // the thread's first row of each tile (no separate tile counter: the
  // fewer values live across a division routine's call, the fewer spill)
  for (i64 row0 = (i64)blockIdx.x * T + threadIdx.x; row0 - threadIdx.x < a.n;
       row0 += (i64)gridDim.x * T) {
    unsigned keep = 0;  // the mask, bit k for row k
    ROWS keep |= (row0 + (i64)k * VM_THREADS < a.n_live ? 1u : 0u) << k;
    i64 acc[RPT];
    bool accn[RPT];
    ROWS { acc[k] = 0; accn[k] = false; }
    for (int pc = 0; pc < a.n_instr; ++pc) {
      const int4 w0 = STAGE > 0 ? prog[2 * pc] : __ldg(prog + 2 * pc);
      const int4 w1 = STAGE > 0 ? prog[2 * pc + 1] : __ldg(prog + 2 * pc + 1);
      const int op = w0.x & 0xff, fl = w0.x >> 8;
      const int dst = w0.y, ra = w0.z, rb = w0.w;
      const int rc = w1.x, i0 = w1.y, i1 = w1.z, i2 = w1.w;
      switch (op) {
        case LOAD:
        case LOADG: {
          // LOADG: a column of another relation, read through the row
          // index of this row space (the join fragment's gather_env), its
          // nulls ORed with the row space's null-extension mask
          const void* d = a.in_data[i0];
          const unsigned char* nl = a.in_null[i0];
          const i64* gi = op == LOADG ? a.in_idx[i0] : nullptr;
          const unsigned char* ext = op == LOADG ? a.in_ext[i0] : nullptr;
          i64 src[RPT];
          bool ok[RPT];
          ROWS {
            const i64 row = row0 + (i64)k * VM_THREADS;
            ok[k] = row < a.n;
            src[k] = row;
          }
          if (gi) {
            ROWS src[k] = ok[k] ? gi[src[k]] : 0;
          }
          load_rows<RPT>(d, a.in_dtype[i0], src, ok, acc);
          ROWS accn[k] = ok[k] && nl[src[k]] != 0;
          if (ext) {
            ROWS accn[k] = accn[k] || (ok[k] && ext[row0 + (i64)k * VM_THREADS] != 0);
          }
          if (fl & F_WB) {
            ROWS { RV(dst, k) = acc[k]; RN(dst, k) = accn[k]; }
          }
          break;
        }
        case CONST: ALU(0, r = i2 ? as_i(cf[i0]) : ci[i0]; nr = i1 != 0);
        case I2F: ALU(1, r = as_i((double)x); nr = nx);
        case F2I: ALU(1, r = (i64)as_f(x); nr = nx);
        case MULK: ALU(1, r = wrap_mul(x, ci[i0]); nr = nx);
        case DIVKF: SERIAL(1, r = as_i(__ddiv_rn(as_f(x), cf[i0])); nr = nx);
        case ADD_I: ALU(2, r = wrap_add(x, y); nr = nx | ny);
        case SUB_I: ALU(2, r = wrap_sub(x, y); nr = nx | ny);
        case MUL_I: ALU(2, r = wrap_mul(x, y); nr = nx | ny);
        case ADD_F: ALU(2, r = as_i(__dadd_rn(as_f(x), as_f(y))); nr = nx | ny);
        case SUB_F: ALU(2, r = as_i(__dsub_rn(as_f(x), as_f(y))); nr = nx | ny);
        case MUL_F: ALU(2, r = as_i(__dmul_rn(as_f(x), as_f(y))); nr = nx | ny);
        case CMP_I: ALU(2, r = cmp_op<i64>(i0, x, y); nr = nx | ny);
        case CMP_F: ALU(2, r = cmp_op<double>(i0, as_f(x), as_f(y)); nr = nx | ny);
        case DIV_F: SERIAL(2, {
          const bool zero = as_f(y) == 0.0;
          r = as_i(__ddiv_rn(as_f(x), zero ? 1.0 : as_f(y)));
          nr = nx | ny | zero;
        });
        case DIV_DEC: SERIAL(2, {
          const bool zero = y == 0;
          const i64 num = wrap_mul(x, ci[i0]);
          const i64 den = zero ? 1 : y;
          const i64 sign = ((num < 0) != (den < 0)) ? -1 : 1;
          const i64 q = floordiv(wrap_add(wrap_mul(2, wrap_abs(num)), wrap_abs(den)),
                                 wrap_mul(2, wrap_abs(den)));
          r = wrap_mul(sign, q);
          nr = nx | ny | zero;
        });
        case AND: ALU(2, {
          const bool ta = (x != 0) && !nx, tb = (y != 0) && !ny;
          const bool fa = (x == 0) && !nx, fb = (y == 0) && !ny;
          r = ta && tb;
          nr = !(fa || fb) && (nx || ny);
        });
        case OR: ALU(2, {
          const bool ta = (x != 0) && !nx, tb = (y != 0) && !ny;
          r = ta || tb;
          nr = !r && (nx || ny);
        });
        case NOT: ALU(1, r = x == 0; nr = nx);
        case ISNULL: ALU(1, r = nx; nr = false);
        case NEG_I: ALU(1, r = wrap_neg(x); nr = nx);
        case NEG_F: ALU(1, r = as_i(-as_f(x)); nr = nx);
        case ABS_I: ALU(1, r = wrap_abs(x); nr = nx);
        case ABS_F: ALU(1, r = as_i(fabs(as_f(x))); nr = nx);
        case IN_I: ALU(1, {
          const bool hit = in_sorted<i64>(ci + i0, i1, x);
          r = hit;
          nr = nx || (!hit && i2);
        });
        case IN_F: ALU(1, {
          const bool hit = in_sorted<double>(cf + i0, i1, as_f(x));
          r = hit;
          nr = nx || (!hit && i2);
        });
        case NZ_F: ALU(1, r = as_f(x) != 0.0; nr = nx);
        case TRUTHY: ALU(1, r = (x != 0) && !nx; nr = false);
        case BAND: ALU(2, r = x & y; nr = false);
        case BOR: ALU(2, r = x | y; nr = false);
        case BNOT: ALU(1, r = 1 - x; nr = false);
        case SEL: ALU(3, r = x ? y : z; nr = x ? ny : nz);
        case COALESCE: ALU(2, r = nx ? y : x; nr = nx && ny);
        case CIVIL: ALU(1, r = civil(x, i0); nr = nx);
        case FLOORDIVK: SERIAL(1, r = floordiv(x, ci[i0]); nr = nx);
        case LUT_I: ALU(1, r = ci[i0 + clip_code(x, i1)]; nr = nx);
        case LUT_F: ALU(1, r = as_i(cf[i0 + clip_code(x, i1)]); nr = nx);
        case LUTN_I: ALU(1, {
          const i64 code = nx ? (i64)i1 : clip_code(x, i1);
          r = ci[i0 + code];
          nr = ci[i2 + code] != 0;
        });
        case LUTN_F: ALU(1, {
          const i64 code = nx ? (i64)i1 : clip_code(x, i1);
          r = as_i(cf[i0 + code]);
          nr = ci[i2 + code] != 0;
        });
        case ROUNDDIVK: SERIAL(1, {
          const i64 den = ci[i0];
          const i64 sign = x < 0 ? -1 : 1;
          r = wrap_mul(sign, floordiv(wrap_add(wrap_mul(2, wrap_abs(x)), den), 2 * den));
          nr = nx;
        });
        case RINT: ALU(1, r = (i64)rint(as_f(x)); nr = nx);
        case STORE: {
          // outputs are int64 or float64 columns: the register's bits as is
          i64 xs[RPT];
          bool nxs[RPT];
          OPND(true, F_A, ra, xs, nxs)
          i64* od = a.out_data[i0];
          unsigned char* on = a.out_null[i0];
          ROWS {
            const i64 row = row0 + (i64)k * VM_THREADS;
            if (row < a.n) {
              od[row] = xs[k];
              on[row] = nxs[k];
            }
          }
          break;
        }
        case MASK: {
          i64 xs[RPT];
          bool nxs[RPT];
          OPND(true, F_A, ra, xs, nxs)
          ROWS {
            if (xs[k] == 0 || nxs[k]) keep &= ~(1u << k);
          }
          break;
        }
        default: break;
      }
    }
    unsigned vbits = 0;  // the finish's valid rows, bit k for row k
    ROWS {
      const i64 row = row0 + (i64)k * VM_THREADS;
      if (row < a.n) {
        const bool h = (keep >> k) & 1u;
        a.mask[row] = h;
        if (a.fin_kind >= 0) {
          const bool pv = a.fin_pvalid ? a.fin_pvalid[row] != 0 : true;
          const bool v = kind_valid(a.fin_kind, pv, h);
          a.fin_valid[row] = v;
          a.fin_nohit[row] = !h;
          vbits |= (unsigned)v << k;
        }
      }
    }
    if (a.fin_kind >= 0) {
      int c = 0;
      ROWS c += __popc(__ballot_sync(0xffffffffu, (vbits >> k) & 1u));
      if ((threadIdx.x & 31) == 0 && c)
        atomicAdd((unsigned long long*)&a.fin_status[1 + blockIdx.x],
                  (unsigned long long)c);
    }
  }
  if (a.fin_kind >= 0) finish_count(a, V);
}

// hdr layout (int64), mirrored by ops/kernels/expr_vm.py pack_args:
//  0 n, 1 n_live, 2 n_instr, 3 n_regs, 4 n_ci, 5 n_cf, 6 rows per thread,
//  7 stage (expr_vm_kernel's STAGE), 8 shared bytes, 9 n_in, 10 n_out,
//  11 prog, 12 ci, 13 cf, 14 mask,
//  16 + 5 i: input i's data, nulls, dtype code, row index, null mask;
//  16 + 5 VM_MAX_IN + 2 s: output s's data, nulls;
//  HDR_FIN: the finish epilogue's join kind (-1: none), validity, valid
//  and no-match flags, count, status (1 + slots int64 words, zeroed once)
//  and slots (at least the launch's blocks).
#define HDR_IN 16
#define HDR_OUT (HDR_IN + 5 * VM_MAX_IN)
#define HDR_FIN (HDR_OUT + 2 * VM_MAX_OUT)

static int make_args(const i64* h, VmArgs* a, int* rpt, int* stage,
                     size_t* shared) {
  a->n = h[0];
  a->n_live = h[1];
  a->n_instr = (int)h[2];
  a->n_regs = (int)h[3];
  a->n_ci = (int)h[4];
  a->n_cf = (int)h[5];
  *rpt = (int)h[6];
  *stage = (int)h[7];
  *shared = (size_t)h[8];
  const int n_in = (int)h[9], n_out = (int)h[10];
  if (n_in > VM_MAX_IN || n_out > VM_MAX_OUT || a->n_regs > MAX_REGS ||
      a->n_regs < 1 || *stage < 0 || *stage > 2)
    return (int)cudaErrorInvalidValue;
  a->prog = (const int*)h[11];
  a->ci = (const i64*)h[12];
  a->cf = (const double*)h[13];
  a->mask = (unsigned char*)h[14];
  for (int i = 0; i < VM_MAX_IN; ++i) {
    const i64* e = h + HDR_IN + 5 * i;
    const bool on = i < n_in;
    a->in_data[i] = on ? (const void*)e[0] : nullptr;
    a->in_null[i] = on ? (const unsigned char*)e[1] : nullptr;
    a->in_dtype[i] = on ? (unsigned char)e[2] : 0;
    a->in_idx[i] = on ? (const i64*)e[3] : nullptr;
    a->in_ext[i] = on ? (const unsigned char*)e[4] : nullptr;
  }
  for (int s = 0; s < VM_MAX_OUT; ++s) {
    const bool on = s < n_out;
    a->out_data[s] = on ? (i64*)h[HDR_OUT + 2 * s] : nullptr;
    a->out_null[s] = on ? (unsigned char*)h[HDR_OUT + 2 * s + 1] : nullptr;
  }
  a->fin_kind = (int)h[HDR_FIN];
  a->fin_pvalid = (const unsigned char*)h[HDR_FIN + 1];
  a->fin_valid = (unsigned char*)h[HDR_FIN + 2];
  a->fin_nohit = (unsigned char*)h[HDR_FIN + 3];
  a->fin_count = (i64*)h[HDR_FIN + 4];
  a->fin_status = (u64*)h[HDR_FIN + 5];
  a->fin_slots = (int)h[HDR_FIN + 6];
  if (a->fin_kind > JK_ANTI ||
      (a->fin_kind >= 0 && (!a->fin_count || !a->fin_status ||
                            (a->n > 0 && (!a->fin_valid || !a->fin_nohit)))))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int RPT, int STAGE>
static int launch(const VmArgs& a, size_t shared, cudaStream_t st) {
  // per device: the dynamic shared bytes allowed so far (0: the default
  // 48 KB), the SM count, and the occupancy at the last shared size
  static size_t opted[TIDB_MAX_DEVICES];
  static int per_sm[TIDB_MAX_DEVICES], sms[TIDB_MAX_DEVICES];
  static size_t per_sm_for[TIDB_MAX_DEVICES];
  auto kernel = expr_vm_kernel<RPT, STAGE>;
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return (int)e;
  if (shared > 48 * 1024 && shared > opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shared);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = shared;
  }
  if (per_sm[dev] < 1 || per_sm_for[dev] != shared) {
    if ((e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, VM_THREADS,
                                                      shared);
    if (e != cudaSuccess) return (int)e;
    per_sm[dev] = n < 1 ? 1 : n;
    per_sm_for[dev] = shared;
  }
  const i64 wave = (i64)per_sm[dev] * sms[dev];
  const i64 tiles = (a.n + (i64)VM_THREADS * RPT - 1) / ((i64)VM_THREADS * RPT);
  const i64 grid = tiles < wave ? tiles : wave;
  if (a.fin_kind >= 0 && grid > a.fin_slots) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, VM_THREADS, shared, st>>>(a);
  return (int)cudaGetLastError();
}

template <int STAGE>
static int launch_rpt(const VmArgs& a, int rpt, size_t shared, cudaStream_t st) {
  switch (rpt) {
    case 1: return launch<1, STAGE>(a, shared, st);
    case 2: return launch<2, STAGE>(a, shared, st);
    case 4: return launch<4, STAGE>(a, shared, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int expr_vm_run(const i64* hdr, void* stream) {
  VmArgs a;
  int rpt, stage;
  size_t shared;
  int rc = make_args(hdr, &a, &rpt, &stage, &shared);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.n <= 0) {
    if (a.fin_kind < 0) return 0;
    return (int)cudaMemsetAsync(a.fin_count, 0, sizeof(i64), st);
  }
  switch (stage) {
    case 0: return launch_rpt<0>(a, rpt, shared, st);
    case 1: return launch_rpt<1>(a, rpt, shared, st);
    default: return launch_rpt<2>(a, rpt, shared, st);
  }
}

extern "C" const char* tidb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
