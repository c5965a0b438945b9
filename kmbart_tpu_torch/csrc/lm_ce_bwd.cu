// K8 in one pass, and K10's second pass on units of its own: the LM loss's
// backward through the tied head (kmbart_tpu/ops/pallas_lm_ce.py:289
// _bwd_call, body _bwd_kernel :53),
//   dlogits[n, v] = bf16(scale[n] (exp(logits - m[n]) inv_se[n] - [v == label[n]]))
//   dh[n, :]      = bf16(sum_v dlogits[n, v] W[v, :])
// with the dlogits formed on chip from the bf16 logits and fed straight to
// the dh product, and written once (the dW product outside reads them).
//
// What bounds it on an H100: the product, 2 N V D FLOP (396 GFLOP at N
// 5120, V 50320, D 768: 0.40 ms at 989 TFLOP/s; 0.72 ms at N 9216). The
// bytes it must move are the logits read once and the dlogits written once
// (515 MB each in bf16 at N 5120) and W (77 MB): 0.33 ms at 3.35 TB/s, under
// the FLOP time, so the two can overlap. The TPU kernel formed each dlogits
// tile once and added its product into a [tn, D] fp32 accumulator kept in
// VMEM across the vocab sweep. Here a work unit is 64 rows across the whole
// of D = 768 (a "column group"; wider heads take more groups, each forming
// the same dlogits, the first storing them), its 64 x 768 fp32 sum in the
// registers of two consumer warpgroups, each 64 x 384 as two m64n192k16
// accumulators (192 registers a thread). The vocab is walked in 32-deep
// slices through a ring of NST stages, each holding the slice's A tile
// ([64 rows, 32 columns] bf16, 64-byte swizzle, 4 KB) and W's [32, 768]
// slice (twelve 64-column MN-major blocks by one 3-D TMA box, 128-byte
// swizzle, 48 KB): 208 KB.
// The A tile arrives as logits and the four
// warps of the third warpgroup rewrite it in place, 16 bytes a thread at a
// time, with kmb_wg::dlogit (the function K10's EPI_DLOGITS epilogue
// calls, so the two give the same bits), 0 past V; after a proxy fence each
// arrives on the stage's "ready" barrier, on which the two MMA warpgroups
// wait before their wgmma read the tile as A, and their first thread
// stores it by TMA into the padded [N, padded_vocab(V)] dlogits buffer (its
// map spans the padded row, so the pad columns get the zeros formed there).
// The first transform thread is also the producer: after its chunks of
// each slice it keeps the ring three slices ahead, W's slice by one 3-D
// TMA. Each dlogits element is formed once and written once, the logits
// are read from HBM once, and the dlogits never come back.
//
// K10's second pass (dh_tiles) loads the dlogits K10's first pass wrote as
// A, so it has no transform, and it runs on units of its own: 128 rows by
// a 384-column half of D (DH_*), each MMA warpgroup on 64 of the rows and
// all 384 columns (the same two m64n192k16 accumulators, 192 registers a
// thread), both reading one W slice, A from registers (wgmma's RS form,
// loaded by ldmatrix). A stage is then 8 KB of dlogits and 24 KB of W (32
// KB where K8's is 52 KB), DH_NST of them. The plan
// (ops/lm_ce.py dh_plan) takes K8's vocab parts, and each dh element's sum
// is the chain K8's kernel runs for it (the same wgmma shape over the same
// 192 columns and the same slices of the same part, in order), so K10's dh
// equals K8's bit for bit on K7's logits; the two halves of a row block
// run next to each other and share its dlogits rows in L2.
//
// What clock64 timelines of one block on an H100 showed, and what the
// design does about it: a warp's wgmma issue waits until the tensor pipe
// takes the instruction, so work placed between a slice's wgmma and the
// next runs in series with them (990 cycles of issue, then 921 of
// transform, when the MMA warps formed the slices themselves); the MMA
// warps therefore only issue. The transform's expf chains ran one element
// after another on warps with few registers to spare (about 90 cycles an
// element): a chunk's eight elements are formed with no branch (the exact
// dlogit, then a mask at V), so that their chains may overlap. A stage
// goes back to the producer as soon as the MMA warps' product of it has
// completed (released a slice later, as K10's pass does, the four stages
// held the transform of slice k + 1 behind the product of slice k), and the
// producer waits for it only after the transform of the next slice. Without
// the transform (the route K10's second pass took before it had units of
// its own) this kernel is bound by each SM's shared memory: a slice moves
// about 116 KB through it (52 KB of TMA writes, 64 KB of wgmma operand
// reads) for 768 cycles of tensor work, and the time a slice (about
// 1,100-1,300 cycles) did not fall when fewer blocks shared the L2. The
// transform (another 12 KB, and the expf) adds about a sixth to that at N
// 5120. K10's units move 96 KB a slice (32 KB of TMA writes): a timeline
// put them at 1,311 cycles a slice against 1,647 for K8's units with the
// transform off, the MMA warps still waiting for data at about a fifth of
// their span. A from registers reads each slice's A once (88 KB a slice):
// 4% faster on an H100, with one set of fragments whose product is waited
// for before the next slice's ldmatrix (two sets, taking turns, measured
// no faster) and 232 registers for the MMA warpgroups (at 224 ptxas spilled
// and serialized the wgmma, 40% slower).
//
// 64 rows at N 5120 give 80 units (144 at N 9216), which do not fill 132
// SMs evenly, so the plan (ops/lm_ce.py bwd_plan) splits the vocab walk into
// parts: units are (part, row block, column group), parts slowest, so the
// persistent blocks walk the vocab in step and a W slice comes from HBM
// about once; each part's fp32 sums go to [splits, N, D] and finalize_sum
// adds them in part order (deterministic, no atomics). Registers: ptxas gives
// the kernel 168 a thread at 384 threads, and setmaxnreg moves them to 224
// for the MMA warpgroups (192 accumulators; 216 spilled) and 56 for the
// third (bwd_launch refuses another launch count).
#include "wgmma_gemm.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;                  // a unit's rows
constexpr int SK = 32;                    // vocab slice depth
constexpr int WG_COLS = 384;              // a consumer warpgroup's columns
constexpr int GROUP_COLS = 2 * WG_COLS;   // a unit's columns
constexpr int NST = 4;                    // ring stages
constexpr int A_BYTES = ROWS * SK * 2;    // the logits or dlogits slice
constexpr int WBOX_BYTES = SK * 128;      // W: 64 columns x 32 deep
constexpr int W_BOXES = GROUP_COLS / 64;
constexpr int STAGE_BYTES = A_BYTES + W_BOXES * WBOX_BYTES;
constexpr int SMEM_BYTES = NST * STAGE_BYTES + 24 * NST + 1024;  // + barriers, alignment
// setmaxnreg: ptxas gives the kernel 168 registers a thread at 384 threads;
// the MMA warpgroups take 224 (192 accumulators) and the third, the
// producer's and the transform's, gives back what they take: 128 (168 -
// AUX_REGS) = 256 (MMA_REGS - 168)
constexpr int MMA_REGS = 224;
constexpr int AUX_REGS = 56;
constexpr int LAUNCH_REGS = 168;
static_assert(128 * (LAUNCH_REGS - AUX_REGS) == 256 * (MMA_REGS - LAUNCH_REGS), "setmaxnreg balances");
static_assert(STAGE_BYTES % 1024 == 0, "swizzled boxes want 1024-byte aligned stages");
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
// K10's second pass (dh_tiles): units of 128 rows by a 384-column half of
// D, each MMA warpgroup on 64 of the rows and all 384 columns, both reading
// one W slice; a stage holds the [128, 32] dlogits slice (8 KB) and W's
// [32, 384] (24 KB). Its third warpgroup only loads, so the MMA warpgroups
// take 232 registers (192 accumulators and a slice's A fragments; at 224
// ptxas spilled and serialized the wgmma) and it keeps 40.
constexpr int DH_ROWS = 128;
constexpr int DH_COLS = WG_COLS;
constexpr int DH_NST = 6;
constexpr int DH_A_BYTES = DH_ROWS * SK * 2;
constexpr int DH_W_BOXES = DH_COLS / 64;
constexpr int DH_STAGE_BYTES = DH_A_BYTES + DH_W_BOXES * WBOX_BYTES;
constexpr int DH_SMEM_BYTES = DH_NST * DH_STAGE_BYTES + 16 * DH_NST + 1024;
static_assert(DH_STAGE_BYTES % 1024 == 0, "swizzled boxes want 1024-byte aligned stages");
static_assert(DH_SMEM_BYTES <= 232448, "over the 227 KB a block may use");
constexpr int DH_MMA_REGS = 232;
constexpr int DH_AUX_REGS = 40;
static_assert(128 * (LAUNCH_REGS - DH_AUX_REGS) == 256 * (DH_MMA_REGS - LAUNCH_REGS),
              "setmaxnreg balances");

struct BwdArgs {
  const float* row_m;       // each row's logit max, [N]
  const float* row_inv_se;  // 1 / each row's exp-sum, [N]
  const float* row_scale;   // each row's loss scale (0: an ignored label), [N]
  const int* labels;        // each row's label column, [N]
  bf16* dh;                 // [N, D] when splits == 1
  float* partial;           // fp32 [splits, N, D] when splits > 1
  int N, V, D;
  int ksteps, kper, splits;  // 32-deep slices: all, a part's, parts
  int groups;                // 768-column groups of D
};

// d[64 x 192] += A[64 x 16] * B[16 x 192]; B MN-major (TRANS_B 1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, %99;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// the same with A from registers: the four .b32 of an m64k16 A fragment
// (ldmatrix.x4 of the warp's 16 rows gives them in order)
__device__ __forceinline__ void wgmma_m64n192k16_rs(float (&d)[96], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the A fragment of a warp's 16 rows at 16 columns from a 64-byte-swizzled
// tile; addr: this lane's row and 16-byte chunk (dh_tiles)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// wgmma descriptor of a K-major tile with 64-byte swizzle: rows of 64
// bytes, 8-row groups 512 bytes apart (SBO); LBO unused
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// W's [32, 768] slice by one TMA: the map views W [V, D] as [D / 64][V][64]
// (bwd_launch's w_shape), so a {64, 32, 12} box lands as twelve [32][64] MN-major blocks
// 4 KB apart, what twelve 2-D boxes would give
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Unit t of the block's share (t = blockIdx.x, + gridDim.x, ...): parts
// slowest, then row blocks, then column groups; its slices [kb, kb + nk)
struct Unit {
  int row0, col0, split, kb, nk;
};

// (K8's units are UR = 64 rows by UC = 768 columns; K10's second pass's
// 128 by 384, p.groups the column blocks of D, the two halves of a row
// block next to each other)
template <int UR = ROWS, int UC = GROUP_COLS>
__device__ __forceinline__ int unit_count(const BwdArgs& p) {
  return p.splits * ((p.N + UR - 1) / UR) * p.groups;
}

template <int UR = ROWS, int UC = GROUP_COLS>
__device__ __forceinline__ Unit unit_at(int t, const BwdArgs& p) {
  const int per = ((p.N + UR - 1) / UR) * p.groups;
  Unit u;
  u.split = t / per;
  const int r = t % per;
  u.row0 = r / p.groups * UR;
  u.col0 = r % p.groups * UC;
  u.kb = u.split * p.kper;
  u.nk = min(p.ksteps, u.kb + p.kper) - u.kb;
  return u;
}

// The producer's place in the block's slices: the next slice to load
// (ring slot q, slice k of unit t)
struct Cursor {
  int t, k;
  uint32_t q;
  Unit u;
};

// Loads the cursor's slice into its stage once that is free (the logits
// slice and W's, all of W's twelve blocks: TMA zero-fills those
// past D), and moves the cursor on; nothing past the block's last unit.
__device__ __forceinline__ void produce(Cursor& c, int units, const BwdArgs& p, uint32_t base,
                                        uint32_t full0, uint32_t empty0,
                                        const CUtensorMap* map_a, const CUtensorMap* map_w) {
  if (c.t >= units) return;
  const uint32_t stage = c.q % NST, full = full0 + 8 * stage;
  const uint32_t a_s = base + stage * STAGE_BYTES;
  kmb_wg::mbar_wait(empty0 + 8 * stage, ((c.q / NST) & 1) ^ 1);  // round 0 finds it free
  kmb_wg::mbar_expect_tx(full, STAGE_BYTES);
  kmb_wg::tma_load(a_s, map_a, full, c.k * SK, c.u.row0);
  tma_load3(a_s + A_BYTES, map_w, full, 0, c.k * SK, c.u.col0 / 64);
  ++c.q;
  if (++c.k == c.u.kb + c.u.nk) {
    c.t += gridDim.x;
    if (c.t < units) {
      c.u = unit_at(c.t, p);
      c.k = c.u.kb;
    }
  }
}

// The transform's row inputs of one 16-byte chunk of a slice (chunk c:
// row c / 4), loaded once a unit (0 past N: those rows' dlogits are 0, and
// clipped)
struct RowStats {
  float m, inv_se, scale;
  int label;
};

__device__ __forceinline__ RowStats row_stats(const BwdArgs& p, int row0, int c) {
  const int row = row0 + (c >> 2);
  RowStats rs = {0.f, 0.f, 0.f, -1};
  if (row < p.N) {
    rs.m = p.row_m[row];
    rs.inv_se = p.row_inv_se[row];
    rs.scale = p.row_scale[row];
    rs.label = p.labels[row];
  }
  return rs;
}

// Chunk c (16 bytes) of a slice's A tile: row c / 4, physical chunk c % 4,
// which holds the columns 8 (chunk ^ (row / 2 % 4)) + [0, 8) of the slice
// (TMA's 64-byte swizzle). Its byte offset in the tile, and its first
// column in the slice.
__device__ __forceinline__ uint32_t chunk_offset(int c) { return (c >> 2) * 64 + (c & 3) * 16; }

__device__ __forceinline__ int chunk_col(int c) { return 8 * ((c & 3) ^ ((c >> 3) & 3)); }

// chunk x of logits (columns col0 + [0, 8) of its row) as dlogits, 0 at
// columns past V: all eight are formed (TMA's zeros past V give finite
// values) and then masked, with no branch, so that their exponentials
// overlap
__device__ __forceinline__ uint4 form_chunk(uint4 x, int col0, const RowStats& rs, int V) {
  const int lim = V - col0, lab = rs.label - col0;
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  float d[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float logit = __uint_as_float(e & 1 ? w[e / 2] & 0xFFFF0000u : w[e / 2] << 16);
    const float v = kmb_wg::dlogit(logit, rs.m, rs.inv_se, rs.scale, lab == e);
    d[e] = e < lim ? v : 0.f;
  }
  return make_uint4(kmb_wg::pack_bf16(d[0], d[1]), kmb_wg::pack_bf16(d[2], d[3]),
                    kmb_wg::pack_bf16(d[4], d[5]), kmb_wg::pack_bf16(d[6], d[7]));
}

// K8's kernel: forms the A tiles from logits and stores them through
// map_dl. Warps 0-7 (two warpgroups) issue the wgmma, and their first
// thread the TMA store of each formed tile. Warps 8-11 form the slices
// (chunks t and t + 128 of the 256, t < 128 their thread); thread 256 also
// loads. Barriers a stage: full (the TMA bytes), ready (the four transform
// warps' arrivals, each after its proxy fence), empty (the eight MMA warps'
// arrivals once their wgmma have read the stage, the first's also once its
// store has).
__device__ __forceinline__ void bwd_tiles(const CUtensorMap* map_a, const CUtensorMap* map_w,
                                          const CUtensorMap* map_dl, const BwdArgs& p) {
  namespace wg = kmb_wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t full0 = base + NST * STAGE_BYTES;  // full[s] at full0 + 8s
  const uint32_t empty0 = full0 + 8 * NST;          // empty[s] at empty0 + 8s
  const uint32_t ready0 = empty0 + 8 * NST;         // ready[s] at ready0 + 8s
  const int units = unit_count(p);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      wg::mbar_init(full0 + 8 * s, 1);  // the producer's arrive, plus the bytes
      wg::mbar_init(empty0 + 8 * s, 8);  // one arrive from each MMA warp
      wg::mbar_init(ready0 + 8 * s, 4);  // one arrive from each transform warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(AUX_REGS));
    const int tt = threadIdx.x - 256;
    Cursor cur = {static_cast<int>(blockIdx.x), 0, 0, {}};
    if (cur.t < units) {
      cur.u = unit_at(cur.t, p);
      cur.k = cur.u.kb;
    }
    {
      // the four warps form the slices, chunks tt and tt + 128 each; the
      // first thread also loads, LEAD slices ahead, after its own chunks of
      // each slice are in: the stage it refills is the one the product of
      // the slice before reads, so that wait falls after the transform of
      // this slice and not before it (before it, the transform and the
      // product ran in series: 6% slower at N 5120 on an H100; two slices
      // ahead, 6% slower still)
      constexpr uint32_t LEAD = NST - 1;
      uint32_t q = 0;
      if (tt == 0)
        while (cur.q < LEAD && cur.t < units)
          produce(cur, units, p, base, full0, empty0, map_a, map_w);
      for (int ti = blockIdx.x; ti < units; ti += gridDim.x) {
        const Unit u = unit_at(ti, p);
        const RowStats rs[2] = {row_stats(p, u.row0, tt), row_stats(p, u.row0, tt + 128)};
        for (int k = u.kb; k < u.kb + u.nk; ++k, ++q) {
          const uint32_t stage = q % NST, a_s = base + stage * STAGE_BYTES;
          wg::mbar_wait(full0 + 8 * stage, (q / NST) & 1);
          // the thread's chunks in place: both loads issued before either
          // is used, then the stores
          uint4 x[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) x[i] = kmb_wg::lds128(a_s + chunk_offset(tt + 128 * i));
#pragma unroll
          for (int i = 0; i < 2; ++i)
            x[i] = form_chunk(x[i], k * SK + chunk_col(tt + 128 * i), rs[i], p.V);
#pragma unroll
          for (int i = 0; i < 2; ++i) kmb_wg::sts128(a_s + chunk_offset(tt + 128 * i), x[i]);
          wg::fence_async_smem();
          __syncwarp();
          if (tt % 32 == 0) wg::mbar_arrive(ready0 + 8 * stage);
          if (tt == 0)
            while (cur.q < q + 1 + LEAD && cur.t < units)
              produce(cur, units, p, base, full0, empty0, map_a, map_w);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
    const int t = threadIdx.x, cw = t / 128, tw = t % 128;
    const bool lane0 = t % 32 == 0, leader = t == 0;
    uint32_t q = 0;
    for (int ti = blockIdx.x; ti < units; ti += gridDim.x) {
      const Unit u = unit_at(ti, p);
      const int wcol = u.col0 + cw * WG_COLS;  // the warpgroup's first column
      const bool on0 = wcol < p.D, on1 = wcol + 192 < p.D;
      const bool store = u.col0 == 0 && leader;  // the first column group stores
      float acc[2][96];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 96; ++j) acc[h][j] = 0.f;
      wg::fence_acc(acc[0]);
      wg::fence_acc(acc[1]);
      for (int it = 0; it < u.nk; ++it, ++q) {
        const uint32_t stage = q % NST;
        const uint32_t a_s = base + stage * STAGE_BYTES;
        const uint32_t w_s = a_s + A_BYTES + cw * (W_BOXES / 2) * WBOX_BYTES;
        wg::mbar_wait(ready0 + 8 * stage, (q / NST) & 1);
        if (store) {
          wg::tma_store(map_dl, a_s, (u.kb + it) * SK, u.row0);
          wg::tma_store_commit();
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < SK / 16; ++kk) {
          const uint64_t da = sw64_desc(a_s + 32 * kk);
          if (on0)
            wgmma_m64n192k16<1>(acc[0], da, wg::sw128_desc(w_s + 2048 * kk, WBOX_BYTES, 1024));
          if (on1)
            wgmma_m64n192k16<1>(acc[1], da,
                                wg::sw128_desc(w_s + 3 * WBOX_BYTES + 2048 * kk, WBOX_BYTES, 1024));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // this slice is read by this warp's wgmma (and by its store): its
        // share of handing the stage back at once, so that the transform
        // may run a slice ahead (with the release a slice later, as K10's
        // second pass does, the four stages held the transform of slice k +
        // 1 behind the product of slice k)
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (store) wg::tma_store_wait_read();
        if (lane0) wg::mbar_arrive(empty0 + 8 * stage);
      }
      wg::fence_acc(acc[0]);
      wg::fence_acc(acc[1]);
      // thread tw holds, for h, j < 24 and hh, the pair acc[h][4j + 2hh],
      // acc[h][4j + 2hh + 1] at row r0 + 8hh and columns 192h + 8j + c0 + {0, 1}
      // of the warpgroup's share
      const int r0 = 16 * (tw / 32) + (tw % 32) / 4, c0 = 2 * (tw % 4);
      const size_t part = static_cast<size_t>(u.split) * p.N * p.D;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 24; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = u.row0 + r0 + 8 * hh, col = wcol + 192 * h + 8 * j + c0;
            if (row >= p.N || col >= p.D) continue;  // D is even: a pair is in or out whole
            const size_t at = static_cast<size_t>(row) * p.D + col;
            const float v0 = acc[h][4 * j + 2 * hh], v1 = acc[h][4 * j + 2 * hh + 1];
            if (p.splits > 1)
              *reinterpret_cast<float2*>(p.partial + part + at) = make_float2(v0, v1);
            else
              *reinterpret_cast<__nv_bfloat162*>(p.dh + at) = __floats2bfloat162_rn(v0, v1);
          }
    }
    if (leader) wg::tma_store_wait_all();
  }
}

// K10's second pass on 128-row units (DH_*): dh = dlogits @ W, the dlogits
// K10's first pass wrote loaded as A. Thread 256 loads (a slice: the [128,
// 32] dlogits box and W's [32, 384] by one 3-D TMA); MMA warpgroup cw
// takes the unit's rows [64 cw, 64 cw + 64) across all 384 columns, as two
// m64n192k16 accumulators on the columns K8's warpgroups give theirs, with
// A from registers (wgmma's RS form: each slice's fragments by ldmatrix,
// read once where the shared-memory form read A once for each of the two
// wgmma), and hands each stage back once its product has completed. Each
// element's sum is the chain K8's kernel runs for it: the same wgmma shape
// over the same 192 columns, the same slices of the same part in order.
__device__ __forceinline__ void dh_tiles(const CUtensorMap* map_a, const CUtensorMap* map_w,
                                         const BwdArgs& p) {
  namespace wg = kmb_wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t full0 = base + DH_NST * DH_STAGE_BYTES;  // full[s] at full0 + 8s
  const uint32_t empty0 = full0 + 8 * DH_NST;             // empty[s] at empty0 + 8s
  const int units = unit_count<DH_ROWS, DH_COLS>(p);

  if (threadIdx.x == 0) {
    for (int s = 0; s < DH_NST; ++s) {
      wg::mbar_init(full0 + 8 * s, 1);   // the producer's arrive, plus the bytes
      wg::mbar_init(empty0 + 8 * s, 8);  // one arrive from each MMA warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DH_AUX_REGS));
    if (threadIdx.x == 256) {
      uint32_t q = 0;
      for (int ti = blockIdx.x; ti < units; ti += gridDim.x) {
        const Unit u = unit_at<DH_ROWS, DH_COLS>(ti, p);
        for (int k = u.kb; k < u.kb + u.nk; ++k, ++q) {
          const uint32_t stage = q % DH_NST, full = full0 + 8 * stage;
          const uint32_t a_s = base + stage * DH_STAGE_BYTES;
          wg::mbar_wait(empty0 + 8 * stage, ((q / DH_NST) & 1) ^ 1);  // round 0 finds it free
          wg::mbar_expect_tx(full, DH_STAGE_BYTES);
          wg::tma_load(a_s, map_a, full, k * SK, u.row0);
          tma_load3(a_s + DH_A_BYTES, map_w, full, 0, k * SK, u.col0 / 64);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(DH_MMA_REGS));
    const int t = threadIdx.x, cw = t / 128, tw = t % 128;
    const bool lane0 = t % 32 == 0;
    // this lane's ldmatrix address in the warpgroup's 64 x 32 A tile, for
    // each k16 step: row 16 (warp) + lane % 16, logical chunk 2 kk + lane /
    // 16, stored at chunk ^ (row / 2 % 4) (TMA's 64-byte swizzle)
    uint32_t a_off[SK / 16];
    {
      const int row = 16 * (tw / 32) + t % 16;
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk)
        a_off[kk] = row * 64 + (((2 * kk + t % 32 / 16) ^ (row / 2 % 4)) * 16);
    }
    uint32_t q = 0;
    for (int ti = blockIdx.x; ti < units; ti += gridDim.x) {
      const Unit u = unit_at<DH_ROWS, DH_COLS>(ti, p);
      const bool on0 = u.col0 < p.D, on1 = u.col0 + 192 < p.D;
      float acc[2][96];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 96; ++j) acc[h][j] = 0.f;
      wg::fence_acc(acc[0]);
      wg::fence_acc(acc[1]);
      for (int it = 0; it < u.nk; ++it, ++q) {
        const uint32_t stage = q % DH_NST;
        const uint32_t a_s = base + stage * DH_STAGE_BYTES + cw * (DH_A_BYTES / 2);
        const uint32_t w_s = base + stage * DH_STAGE_BYTES + DH_A_BYTES;
        wg::mbar_wait(full0 + 8 * stage, (q / DH_NST) & 1);
        uint32_t ar[SK / 16][4];
#pragma unroll
        for (int kk = 0; kk < SK / 16; ++kk) ldmatrix_x4(ar[kk], a_s + a_off[kk]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < SK / 16; ++kk) {
          if (on0)
            wgmma_m64n192k16_rs(acc[0], ar[kk], wg::sw128_desc(w_s + 2048 * kk, WBOX_BYTES, 1024));
          if (on1)
            wgmma_m64n192k16_rs(acc[1], ar[kk],
                                wg::sw128_desc(w_s + 3 * WBOX_BYTES + 2048 * kk, WBOX_BYTES, 1024));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the product reads ar until it completes: wait for it (the other
        // warpgroup's keeps the tensor pipe busy), then hand the stage back
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (lane0) wg::mbar_arrive(empty0 + 8 * stage);
      }
      wg::fence_acc(acc[0]);
      wg::fence_acc(acc[1]);
      // thread tw holds, for h, j < 24 and hh, the pair acc[h][4j + 2hh],
      // acc[h][4j + 2hh + 1] at row 64 cw + r0 + 8hh and columns 192h + 8j +
      // c0 + {0, 1} of the unit
      const int r0 = 64 * cw + 16 * (tw / 32) + (tw % 32) / 4, c0 = 2 * (tw % 4);
      const size_t part = static_cast<size_t>(u.split) * p.N * p.D;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 24; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = u.row0 + r0 + 8 * hh, col = u.col0 + 192 * h + 8 * j + c0;
            if (row >= p.N || col >= p.D) continue;  // D is even: a pair is in or out whole
            const size_t at = static_cast<size_t>(row) * p.D + col;
            const float v0 = acc[h][4 * j + 2 * hh], v1 = acc[h][4 * j + 2 * hh + 1];
            if (p.splits > 1)
              *reinterpret_cast<float2*>(p.partial + part + at) = make_float2(v0, v1);
            else
              *reinterpret_cast<__nv_bfloat162*>(p.dh + at) = __floats2bfloat162_rn(v0, v1);
          }
    }
  }
}

// K8: the dlogits formed from the logits on chip, stored, and fed to dh
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_bwd_gemm(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_dl, const BwdArgs p) {
  bwd_tiles(&map_a, &map_w, &map_dl, p);
}

// K10's second pass: dh from the dlogits K10's first pass wrote, on
// 128-row units
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_dh_gemm(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_dl, const BwdArgs p) {
  dh_tiles(&map_a, &map_w, p);
}

__global__ void lm_ce_dh_finalize(const float* __restrict__ partial,
                                  const float* __restrict__ bias, bf16* __restrict__ out, int M,
                                  int Ncols, int nsplit) {
  kmb_wg::finalize_sum(partial, bias, out, M, Ncols, nsplit);
}

typedef void (*BwdKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const BwdArgs);

// One launch of `kernel` (configured: a bit per device whose attributes are
// set) on units of UR rows by UC columns with SMEM bytes of shared memory
// (K8's kernel, or DH_* for K10's second pass), with A [N, V] at row pitch
// lda (the logits or the dlogits), W [V, D], and for K8 the dlogits buffer
// dl [N, ldo]; then, when the plan splits the vocab walk, finalize_sum of
// the parts into p.dh. The host refuses a register count at which
// setmaxnreg cannot balance (wgmma_gemm.cuh).
template <int UR = ROWS, int UC = GROUP_COLS, int SMEM = SMEM_BYTES>
inline cudaError_t bwd_launch(BwdKernel kernel, unsigned& configured, const void* A, int lda,
                              const void* W, void* dl, int ldo, BwdArgs p, bf16* dh, int ctas,
                              cudaStream_t s) {
  namespace wg = kmb_wg;
  p.ksteps = (p.V + SK - 1) / SK;
  p.groups = (p.D + UC - 1) / UC;
  const int units = p.splits * ((p.N + UR - 1) / UR) * p.groups;
  if (p.N < 1 || p.D < 64 || p.D % 64 || lda < p.V || lda % 8 || ctas < 1 || ctas > units ||
      p.splits < 1 || p.kper < 1 || (p.splits - 1) * p.kper >= p.ksteps ||
      p.splits * p.kper < p.ksteps || (p.splits > 1) != (p.partial != nullptr) ||
      (dl != nullptr && (ldo < p.V || ldo % 8 || ldo >= p.V + 8)))
    return cudaErrorInvalidValue;
  p.dh = dh;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 32 || !(configured >> device & 1)) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs != LAUNCH_REGS) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    if (device < 32) configured |= 1u << device;
  }
  CUtensorMap ta, tw, tdl = {};
  // W [V, D] (D % 64 == 0) as the 3-D map tma_load3 reads: sizes {64, V, D /
  // 64} with pitches {2 D, 128} bytes, boxes {64, SK, UC / 64}
  const wg::MapShape w_shape = {3, {64, p.V, p.D / 64}, {2ll * p.D, 128}, {64, SK, UC / 64},
                                CU_TENSOR_MAP_SWIZZLE_128B};
  err = wg::cached_map(&ta, A, p.V, p.N, lda, SK, UR, device, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess) err = wg::cached_map(&tw, W, w_shape, device);
  if (err == cudaSuccess && dl != nullptr)
    err = wg::cached_map(&tdl, dl, ldo, p.N, ldo, SK, ROWS, device, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, wg::THREADS, SMEM, s>>>(ta, tw, tdl, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  return wg::finalize_launch(lm_ce_dh_finalize, p.partial, nullptr, dh, p.N, p.D, p.splits, s);
}

}  // namespace

// K8: from the bf16 logits [N, V] at row pitch ldl (ldl % 8 == 0), the
// statistics m, inv_se, scale (fp32 [N]) and labels (int32 [N]), the bf16
// dlogits into dl [N, ldo] (ldo = V rounded up to 8; pad columns zero) and
// dh bf16 [N, D] = dlogits @ w [V, D], in one launch on `ctas` persistent
// blocks with the vocab walked in `splits` parts of kper 32-deep slices
// (ops/lm_ce.py bwd_plan); partial: fp32 [splits, N, D] scratch when splits
// > 1, summed into dh by a second launch. Every pointer 16-byte aligned, D %
// 8 == 0.
KMB_EXPORT int kmb_lm_ce_bwd(const void* logits, const void* w, const void* m,
                             const void* inv_se, const void* scale, const void* labels, void* dl,
                             void* dh, void* partial, int N, int V, int D, int ldl, int ldo,
                             int ctas, int splits, int kper, void* stream) {
  static unsigned configured = 0;  // a bit per device
  BwdArgs p = {};
  p.row_m = (const float*)m;
  p.row_inv_se = (const float*)inv_se;
  p.row_scale = (const float*)scale;
  p.labels = (const int*)labels;
  p.partial = (float*)partial;
  p.N = N;
  p.V = V;
  p.D = D;
  p.kper = kper;
  p.splits = splits;
  if (dl == nullptr) return cudaErrorInvalidValue;
  return bwd_launch(lm_ce_bwd_gemm, configured, logits, ldl, w, dl, ldo, p, (bf16*)dh, ctas,
                    (cudaStream_t)stream);
}

// K10's second pass: dh bf16 [N, D] = dl [N, V] (row pitch ldl, ldl % 8 ==
// 0) @ w [V, D] on 128-row units (ops/lm_ce.py dh_plan: K8's parts, ctas of
// its own units), partial as kmb_lm_ce_bwd's; its dh equals K8's bit for
// bit on the same dlogits.
KMB_EXPORT int kmb_lm_ce_dh(const void* dl, const void* w, void* dh, void* partial, int N, int V,
                            int ldl, int D, int ctas, int splits, int kper, void* stream) {
  static unsigned configured = 0;  // a bit per device
  BwdArgs p = {};
  p.partial = (float*)partial;
  p.N = N;
  p.V = V;
  p.D = D;
  p.kper = kper;
  p.splits = splits;
  return bwd_launch<DH_ROWS, DH_COLS, DH_SMEM_BYTES>(lm_ce_dh_gemm, configured, dl, ldl, w,
                                                     nullptr, 0, p, (bf16*)dh, ctas,
                                                     (cudaStream_t)stream);
}
