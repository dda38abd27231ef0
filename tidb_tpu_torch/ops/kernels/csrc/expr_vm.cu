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
// Design (the simple, correct first one): one thread per row in a
// grid-stride loop interprets the flat register program that
// ops/kernels/expr_vm.py assembles — 8 int32 per instruction, registers of
// 64 bits (int64 or float64 bit patterns) plus a null byte, constants in
// two tables.  Every thread runs the same instruction at the same time, so
// the opcode switch does not diverge.  Each case reads its operands before
// it writes, so the destination may reuse an operand's register.  Float
// ops use the _rn intrinsics, so no multiply-add is contracted and the
// result is bit-identical to the torch interpreter.  Fusing this pass into
// the aggregate's loads is a later change.
#include "common.cuh"

#define MAX_REGS 64
#define INSTR_W 8

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

__device__ __forceinline__ double as_f(i64 v) { return __longlong_as_double(v); }
__device__ __forceinline__ i64 as_i(double v) { return __double_as_longlong(v); }

__device__ __forceinline__ i64 load_in(const void* p, int dtype, i64 row) {
  switch (dtype) {
    case 0: return ((const i64*)p)[row];
    case 1: return (i64)((const int*)p)[row];
    case 2: return ((const i64*)p)[row];  // float64: keep the bit pattern
    case 3: return as_i((double)((const float*)p)[row]);
    case 4: return (i64)((const unsigned char*)p)[row];
    case 5: return (i64)((const short*)p)[row];
    default: return (i64)((const signed char*)p)[row];
  }
}

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

// meta layout (int64): [in_data x n_in | in_null x n_in | in_dtype x n_in |
//                       in_idx x n_in | in_ext x n_in |
//                       out_data x n_out | out_null x n_out]
// in_idx / in_ext are read by LOADG only: a row-index tensor (int64) and
// an extra null mask (bool), each 0 when absent.
__global__ void expr_vm_kernel(const int* __restrict__ prog, int n_instr,
                               const i64* __restrict__ ci,
                               const double* __restrict__ cf, int n_in,
                               const i64* __restrict__ meta,
                               unsigned char* __restrict__ mask_out,
                               int n_out, i64 n, i64 n_live) {
  i64 R[MAX_REGS];
  unsigned char N[MAX_REGS];
  for (int r = 0; r < MAX_REGS; ++r) { R[r] = 0; N[r] = 0; }
  const i64* out_meta = meta + 5 * n_in;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (i64)gridDim.x * blockDim.x) {
    bool mask = row < n_live;
    for (int pc = 0; pc < n_instr; ++pc) {
      const int* ins = prog + pc * INSTR_W;
      const int op = __ldg(ins + 0), dst = __ldg(ins + 1);
      const int a = __ldg(ins + 2), b = __ldg(ins + 3), c = __ldg(ins + 4);
      const int i0 = __ldg(ins + 5), i1 = __ldg(ins + 6), i2 = __ldg(ins + 7);
      const i64 x = R[a], y = R[b], z = R[c];
      const bool nx = N[a], ny = N[b], nz = N[c];
      i64 r = 0;
      bool nr = false;
      switch (op) {
        case LOAD: {
          const void* d = (const void*)meta[i0];
          const unsigned char* nl = (const unsigned char*)meta[n_in + i0];
          const int dt = (int)meta[2 * n_in + i0];
          i64 v = load_in(d, dt, row);
          // integer sources widen to int64; float sources are float64 bits
          r = v;
          nr = nl[row] != 0;
          break;
        }
        case LOADG: {
          // a column of another relation, read through the row index of
          // this row space (the join fragment's gather_env), its nulls
          // ORed with the row space's null-extension mask
          const void* d = (const void*)meta[i0];
          const unsigned char* nl = (const unsigned char*)meta[n_in + i0];
          const int dt = (int)meta[2 * n_in + i0];
          const i64* gi = (const i64*)meta[3 * n_in + i0];
          const unsigned char* ext = (const unsigned char*)meta[4 * n_in + i0];
          const i64 src = gi ? gi[row] : row;
          r = load_in(d, dt, src);
          nr = nl[src] != 0 || (ext && ext[row] != 0);
          break;
        }
        case CONST: r = i2 ? as_i(cf[i0]) : ci[i0]; nr = i1 != 0; break;
        case I2F: r = as_i((double)x); nr = nx; break;
        case F2I: r = (i64)as_f(x); nr = nx; break;
        case MULK: r = wrap_mul(x, ci[i0]); nr = nx; break;
        case DIVKF: r = as_i(__ddiv_rn(as_f(x), cf[i0])); nr = nx; break;
        case ADD_I: r = wrap_add(x, y); nr = nx | ny; break;
        case SUB_I: r = wrap_sub(x, y); nr = nx | ny; break;
        case MUL_I: r = wrap_mul(x, y); nr = nx | ny; break;
        case ADD_F: r = as_i(__dadd_rn(as_f(x), as_f(y))); nr = nx | ny; break;
        case SUB_F: r = as_i(__dsub_rn(as_f(x), as_f(y))); nr = nx | ny; break;
        case MUL_F: r = as_i(__dmul_rn(as_f(x), as_f(y))); nr = nx | ny; break;
        case CMP_I: r = cmp_op<i64>(i0, x, y); nr = nx | ny; break;
        case CMP_F: r = cmp_op<double>(i0, as_f(x), as_f(y)); nr = nx | ny; break;
        case DIV_F: {
          const bool zero = as_f(y) == 0.0;
          r = as_i(__ddiv_rn(as_f(x), zero ? 1.0 : as_f(y)));
          nr = nx | ny | zero;
          break;
        }
        case DIV_DEC: {
          const bool zero = y == 0;
          const i64 num = wrap_mul(x, ci[i0]);
          const i64 den = zero ? 1 : y;
          const i64 sign = ((num < 0) != (den < 0)) ? -1 : 1;
          const i64 q = floordiv(wrap_add(wrap_mul(2, wrap_abs(num)), wrap_abs(den)),
                                 wrap_mul(2, wrap_abs(den)));
          r = wrap_mul(sign, q);
          nr = nx | ny | zero;
          break;
        }
        case AND: {
          const bool ta = (x != 0) && !nx, tb = (y != 0) && !ny;
          const bool fa = (x == 0) && !nx, fb = (y == 0) && !ny;
          r = ta && tb;
          nr = !(fa || fb) && (nx || ny);
          break;
        }
        case OR: {
          const bool ta = (x != 0) && !nx, tb = (y != 0) && !ny;
          r = ta || tb;
          nr = !r && (nx || ny);
          break;
        }
        case NOT: r = x == 0; nr = nx; break;
        case ISNULL: r = nx; nr = false; break;
        case NEG_I: r = wrap_neg(x); nr = nx; break;
        case NEG_F: r = as_i(-as_f(x)); nr = nx; break;
        case ABS_I: r = wrap_abs(x); nr = nx; break;
        case ABS_F: r = as_i(fabs(as_f(x))); nr = nx; break;
        case IN_I: {
          const bool hit = in_sorted<i64>(ci + i0, i1, x);
          r = hit;
          nr = nx || (!hit && i2);
          break;
        }
        case IN_F: {
          const bool hit = in_sorted<double>(cf + i0, i1, as_f(x));
          r = hit;
          nr = nx || (!hit && i2);
          break;
        }
        case NZ_F: r = as_f(x) != 0.0; nr = nx; break;
        case TRUTHY: r = (x != 0) && !nx; nr = false; break;
        case BAND: r = x & y; nr = false; break;
        case BOR: r = x | y; nr = false; break;
        case BNOT: r = 1 - x; nr = false; break;
        case SEL: r = x ? y : z; nr = x ? ny : nz; break;
        case COALESCE: r = nx ? y : x; nr = nx && ny; break;
        case CIVIL: r = civil(x, i0); nr = nx; break;
        case FLOORDIVK: r = floordiv(x, ci[i0]); nr = nx; break;
        case LUT_I: r = ci[i0 + clip_code(x, i1)]; nr = nx; break;
        case LUT_F: r = as_i(cf[i0 + clip_code(x, i1)]); nr = nx; break;
        case LUTN_I:
        case LUTN_F: {
          const i64 code = nx ? (i64)i1 : clip_code(x, i1);
          r = op == LUTN_I ? ci[i0 + code] : as_i(cf[i0 + code]);
          nr = ci[i2 + code] != 0;
          break;
        }
        case ROUNDDIVK: {
          const i64 den = ci[i0];
          const i64 sign = x < 0 ? -1 : 1;
          r = wrap_mul(sign, floordiv(wrap_add(wrap_mul(2, wrap_abs(x)), den), 2 * den));
          nr = nx;
          break;
        }
        case RINT: r = (i64)rint(as_f(x)); nr = nx; break;
        case STORE: {
          // outputs are int64 or float64 columns: the register's bits as is
          ((i64*)out_meta[i0])[row] = x;
          ((unsigned char*)out_meta[n_out + i0])[row] = nx;
          continue;
        }
        case MASK: mask = mask && (x != 0) && !nx; continue;
        default: continue;
      }
      R[dst] = r;
      N[dst] = nr;
    }
    mask_out[row] = mask;
  }
}

extern "C" int expr_vm_run(const int* prog, i64 n_instr, const i64* ci,
                           const double* cf, i64 n_in, const i64* meta,
                           unsigned char* mask, i64 n_out, i64 n, i64 n_live,
                           void* stream) {
  if (n <= 0) return 0;
  expr_vm_kernel<<<grid_for(n), TIDB_THREADS, 0, (cudaStream_t)stream>>>(
      prog, (int)n_instr, ci, cf, (int)n_in, meta, mask, (int)n_out, n, n_live);
  return (int)cudaGetLastError();
}

extern "C" const char* tidb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
