// CRUSH rule walk on Hopper: one thread per object id runs the scalar
// crush_do_rule of Ceph's mapper.c over a flattened map.
//
// Replaces the XLA program ceph_tpu/crush/mapper.py:1103 (compile_rule:
// the vmapped one_x at :1157, jitted at :1306) and carries the staged
// sweeps of :1321 (sweep) and :1395 (sweep_device).  That program is
// shaped by vmap and by a chip without 64-bit integers: the descent
// unrolled at trace time, every lane paying the batch's worst-case
// retries, the straw2 quotient built from u32 limbs.  Here each thread
// walks its own id as the C does (csrc/crush_oracle.cc is the scalar
// model; the straw, list and tree choosers follow mapper.py:484-550):
//
// - straw2 (mapper.c:334-384): draw = -((2^48 - crush_ln(hash3(x, id, r)
//   & 0xffff)) / w) in exact 64-bit math, S64_MIN for w == 0; the
//   strictly greater draw wins, so ties keep the first item.  sm_90 has
//   no 64-bit integer divide: the compiler emits a software sequence;
//   the ln tables are read from device memory through the read-only
//   path (lanes index them differently, which the constant cache would
//   serialise);
// - uniform (mapper.c:73 bucket_perm_choose): the lazily built
//   permutation is path independent (step p swaps p and p + hash3(x, id,
//   p) % (size - p)), so perm[pr] is found by tracing position pr back
//   through steps pr .. 0: O(pr) hashes and no per-thread permutation;
// - firstn (mapper.c:460) with local retries, the perm fallback,
//   collide / reject, and the chooseleaf recursion (vary_r, stable,
//   descend_once); indep (mapper.c:655) in breadth-first rounds, r' =
//   rep + numrep * ftotal ((numrep + 1) in a uniform bucket whose size
//   numrep divides), with ITEM_NONE holes; OP_SET_* steps override the
//   tunables for the steps after them;
// - the work vectors (w, o and the leaf vector c of do_rule) live in
//   local memory, kMaxResult entries each.
//
// Attempt budget (the staged sweeps): budget 0 runs the rule's own tries.
// budget B > 0 refuses any retry once B attempts were made at that choose
// (firstn rep, indep round loop, or either in the leaf recursion); a
// refusal clears the id's clean flag.  A clean id never met a refusal,
// so it took exactly the attempts of the full walk and its result is the
// full walk's.  Unclean ids can be appended (an atomic per warp) to a
// capacity-sized index buffer that the next stage's launch reads, so a
// sweep's stages chain on the device without a host sync.
//
// Bound: operations.  The healthy 1024-OSD / 64-host map with chooseleaf
// firstn 3 draws about 3 x (64 + 16) straw2 items per id, each a hash32_3
// (183 integer ops: 3 seed XORs and 5 mixes of 36), a crush_ln (about
// 20) and a 64-bit divide; the output is 12 bytes an id.  The launch can
// count its draws and other hashes into a stats buffer, so the bound is
// taken from the work a run did (chip_smoke.py crush_bound).

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kAlgUniform = 1;
constexpr int kAlgList = 2;
constexpr int kAlgTree = 3;
constexpr int kAlgStraw = 4;
constexpr int kAlgStraw2 = 5;

constexpr int32_t kItemUndef = 0x7ffffffe;  // CRUSH_ITEM_UNDEF
constexpr int32_t kItemNone = 0x7fffffff;   // CRUSH_ITEM_NONE
constexpr uint32_t kHashSeed = 1315423911u;

constexpr int kMaxResult = 32;  // ops/crush_rule.py MAX_RESULT
constexpr int kMaxSteps = 32;   // ops/crush_rule.py MAX_STEPS
constexpr int kThreads = 128;

// Mirrored field for field by ops/crush_rule.py _RuleArgs.
struct RuleArgs {
  // the map ([B, S] row-major; u32 planes as raw words)
  const int32_t* items;
  const uint32_t* weights;  // straw2 weights with choose_args applied
  const int32_t* sizes;
  const int32_t* algs;
  const int32_t* types;
  const uint32_t* straws;        // [B, S] or null (no straw bucket)
  const uint32_t* sum_weights;   // [B, S] or null (no list bucket)
  const uint32_t* tree_weights;  // [B, tree_stride] or null
  const int32_t* tree_nodes;     // [B] or null
  const uint32_t* dev_weights;   // [weight_max], 16.16 reweights
  const unsigned long long* rh_lh;  // RH_LH_TBL [258]
  const unsigned long long* ll;     // LL_TBL [256]
  // the ids
  const int32_t* xs;
  int32_t* out;        // [N, result_max]
  uint8_t* clean;      // [N] or null
  const int32_t* lanes;       // ids to walk (indices into xs) or null
  const int32_t* lane_count;  // number of valid entries of lanes, or null
  int32_t* bad;               // append buffer for unclean ids, or null
  int32_t* bad_count;         // its counter (counts past bad_cap too)
  unsigned long long* stats;  // [3]: straw2 draws, other hashes, chooses
  int64_t n;  // threads: ids without a lane list, else the list's capacity
  int32_t n_buckets, max_size, max_devices, weight_max, tree_stride;
  int32_t result_max, budget, bad_cap, idx_base;
  // choose_total_tries, choose_local_tries, choose_local_fallback_tries,
  // chooseleaf_descend_once, chooseleaf_vary_r, chooseleaf_stable
  int32_t tunables[6];
  int32_t n_steps;
  int32_t steps[kMaxSteps * 3];
};

struct Walk {
  uint32_t x;
  int budget;
  bool clean;
  unsigned draws, hashes, chooses;
};

__device__ __forceinline__ void hashmix(uint32_t& a, uint32_t& b,
                                        uint32_t& c) {
  a = a - b; a = a - c; a = a ^ (c >> 13);
  b = b - c; b = b - a; b = b ^ (a << 8);
  c = c - a; c = c - b; c = c ^ (b >> 13);
  a = a - b; a = a - c; a = a ^ (c >> 12);
  b = b - c; b = b - a; b = b ^ (a << 16);
  c = c - a; c = c - b; c = c ^ (b >> 5);
  a = a - b; a = a - c; a = a ^ (c >> 3);
  b = b - c; b = b - a; b = b ^ (a << 10);
  c = c - a; c = c - b; c = c ^ (b >> 15);
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b, x = 231232, y = 1232;
  hashmix(a, b, h);
  hashmix(x, a, h);
  hashmix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b,
                                          uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c, x = 231232, y = 1232;
  hashmix(a, b, h);
  hashmix(c, x, h);
  hashmix(y, a, h);
  hashmix(b, x, h);
  hashmix(y, c, h);
  return h;
}

__device__ __forceinline__ uint32_t hash4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  uint32_t h = kHashSeed ^ a ^ b ^ c ^ d, x = 231232, y = 1232;
  hashmix(a, b, h);
  hashmix(c, d, h);
  hashmix(a, x, h);
  hashmix(y, b, h);
  hashmix(c, x, h);
  hashmix(y, d, h);
  return h;
}

// 2^44 * log2(x + 1) in fixed point (mapper.c:248-290), x < 2^16.
__device__ __forceinline__ uint64_t crush_ln(const RuleArgs& a,
                                             uint32_t xin) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    const int bits = __clz(x & 0x1FFFF) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  const int index1 = (x >> 8) << 1;
  const uint64_t rh = __ldg(a.rh_lh + index1 - 256);
  uint64_t lh = __ldg(a.rh_lh + index1 + 1 - 256);
  const uint64_t xl64 = (static_cast<uint64_t>(x) * rh) >> 48;
  const uint64_t ll = __ldg(a.ll + (xl64 & 0xff));
  lh = (lh + ll) >> (48 - 12 - 32);
  return (static_cast<uint64_t>(iexpon) << (12 + 32)) + lh;
}

__device__ __forceinline__ int32_t item_at(const RuleArgs& a, int bno,
                                           int i) {
  return __ldg(a.items + static_cast<int64_t>(bno) * a.max_size + i);
}

__device__ __forceinline__ int straw2_choose(const RuleArgs& a, int bno,
                                             int size, uint32_t r, Walk& w) {
  const int64_t row = static_cast<int64_t>(bno) * a.max_size;
  int high = 0;
  int64_t high_draw = 0;
  for (int i = 0; i < size; ++i) {
    const uint32_t wt = __ldg(a.weights + row + i);
    int64_t draw = INT64_MIN;
    if (wt != 0) {
      const uint32_t u =
          hash3(w.x, static_cast<uint32_t>(__ldg(a.items + row + i)), r) &
          0xffff;
      // 2^48 - crush_ln(u) >= 0, so the truncating s64 divide of
      // div64_s64 is the unsigned quotient of the magnitude, negated
      const uint64_t mag = (1ull << 48) - crush_ln(a, u);
      draw = -static_cast<int64_t>(mag / wt);
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  w.draws += size;
  return item_at(a, bno, high);
}

// perm[pr] of bucket_perm_choose's permutation, traced back from step pr.
__device__ __noinline__ int perm_choose(const RuleArgs& a, int bno, int size,
                                        uint32_t r, Walk& w) {
  const uint32_t bid = static_cast<uint32_t>(-1 - bno);
  const uint32_t usize = static_cast<uint32_t>(size);
  const uint32_t pr = r % usize;
  uint32_t t = pr;
  if (pr < usize - 1) {
    t = pr + hash3(w.x, bid, pr) % (usize - pr);
    ++w.hashes;
  }
  for (int p = static_cast<int>(pr) - 1; p >= 0; --p) {
    const uint32_t up = static_cast<uint32_t>(p);
    const uint32_t i = hash3(w.x, bid, up) % (usize - up);
    if (t == up + i) t = up;
  }
  w.hashes += pr;
  return item_at(a, bno, static_cast<int>(t));
}

__device__ __noinline__ int straw_choose(const RuleArgs& a, int bno, int size,
                                         uint32_t r, Walk& w) {
  const int64_t row = static_cast<int64_t>(bno) * a.max_size;
  int high = 0;
  uint64_t high_draw = 0;
  for (int i = 0; i < size; ++i) {
    const uint64_t draw =
        static_cast<uint64_t>(
            hash3(w.x, static_cast<uint32_t>(__ldg(a.items + row + i)), r) &
            0xffff) *
        __ldg(a.straws + row + i);
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  w.hashes += size;
  return item_at(a, bno, high);
}

__device__ __noinline__ int list_choose(const RuleArgs& a, int bno, int size,
                                        uint32_t r, Walk& w) {
  const int64_t row = static_cast<int64_t>(bno) * a.max_size;
  const uint32_t bid = static_cast<uint32_t>(-1 - bno);
  for (int i = size - 1; i >= 0; --i) {
    ++w.hashes;
    const int32_t item = __ldg(a.items + row + i);
    uint64_t t = hash4(w.x, static_cast<uint32_t>(item), r, bid) & 0xffff;
    t = (t * __ldg(a.sum_weights + row + i)) >> 16;
    if (t < __ldg(a.weights + row + i)) return item;
  }
  return item_at(a, bno, 0);
}

__device__ __noinline__ int tree_choose(const RuleArgs& a, int bno,
                                        uint32_t r, Walk& w) {
  const uint32_t* nw =
      a.tree_weights + static_cast<int64_t>(bno) * a.tree_stride;
  const uint32_t bid = static_cast<uint32_t>(-1 - bno);
  int n = __ldg(a.tree_nodes + bno) >> 1;
  while (n > 0 && !(n & 1)) {
    ++w.hashes;
    const uint64_t t =
        (static_cast<uint64_t>(hash4(w.x, static_cast<uint32_t>(n), r, bid)) *
         __ldg(nw + n)) >> 32;
    const int half = (n & -n) >> 1;
    n = (t < __ldg(nw + n - half)) ? n - half : n + half;
  }
  return item_at(a, bno, n >> 1);
}

__device__ __noinline__ int bucket_choose(const RuleArgs& a, int bno,
                                          uint32_t r, bool perm, Walk& w) {
  const int size = __ldg(a.sizes + bno);
  ++w.chooses;
  if (perm) return perm_choose(a, bno, size, r, w);
  switch (__ldg(a.algs + bno)) {
    case kAlgStraw2: return straw2_choose(a, bno, size, r, w);
    case kAlgUniform: return perm_choose(a, bno, size, r, w);
    case kAlgList: return list_choose(a, bno, size, r, w);
    case kAlgTree: return tree_choose(a, bno, r, w);
    case kAlgStraw: return straw_choose(a, bno, size, r, w);
    default: return item_at(a, bno, 0);  // mapper.c: unknown alg
  }
}

// Reweight rejection (mapper.c:424-438).
__device__ __forceinline__ bool is_out(const RuleArgs& a, int item, Walk& w) {
  if (item >= a.weight_max) return true;
  const uint32_t wt = __ldg(a.dev_weights + (item < 0 ? 0 : item));
  if (wt >= 0x10000) return false;
  if (wt == 0) return true;
  ++w.hashes;
  return (hash2(w.x, static_cast<uint32_t>(item)) & 0xffff) >= wt;
}

// The type of an item, 0 for a device or a bucket id past the map.
__device__ __forceinline__ int item_type(const RuleArgs& a, int item,
                                         bool& valid_bucket) {
  valid_bucket = item < 0 && -1 - item < a.n_buckets;
  return valid_bucket ? __ldg(a.types - 1 - item) : 0;
}

// crush_choose_firstn (mapper.c:460); kOuter: the rule's own choose, which
// may recurse once into the leaf choose (kOuter false).
template <bool kOuter>
__device__ int choose_firstn(const RuleArgs& a, Walk& w, int bucket_bno,
                             int numrep, int type, int32_t* out, int outpos,
                             int out_size, int tries, int recurse_tries,
                             int local_retries, int local_fallback,
                             bool recurse_to_leaf, int vary_r, int stable,
                             int32_t* out2, int parent_r) {
  int count = out_size;
  for (int rep = stable ? 0 : outpos; rep < numrep && count > 0; ++rep) {
    int ftotal = 0;
    bool skip_rep = false, retry_descent;
    int item = 0;
    do {
      retry_descent = false;
      int in_bno = bucket_bno;
      int flocal = 0;
      bool retry_bucket;
      do {
        retry_bucket = false;
        const int r = rep + parent_r + ftotal;
        const int size = __ldg(a.sizes + in_bno);
        bool collide = false, reject = false;
        if (size == 0) {
          reject = true;
        } else {
          const bool perm = local_fallback > 0 && flocal >= (size >> 1) &&
                            flocal > local_fallback;
          item = bucket_choose(a, in_bno, static_cast<uint32_t>(r), perm, w);
          if (item >= a.max_devices) {
            skip_rep = true;
            break;
          }
          bool valid_bucket;
          const int itemtype = item_type(a, item, valid_bucket);
          if (itemtype != type) {
            if (!valid_bucket) {
              skip_rep = true;
              break;
            }
            in_bno = -1 - item;
            retry_bucket = true;
            continue;
          }
          for (int i = 0; i < outpos; ++i) {
            if (out[i] == item) {
              collide = true;
              break;
            }
          }
          if constexpr (kOuter) {
            if (!collide && recurse_to_leaf) {
              if (item < 0) {
                const int sub_r = vary_r ? (r >> (vary_r - 1)) : 0;
                if (choose_firstn<false>(
                        a, w, -1 - item, stable ? 1 : outpos + 1, 0, out2,
                        outpos, count, recurse_tries, 0, local_retries,
                        local_fallback, false, vary_r, stable, nullptr,
                        sub_r) <= outpos)
                  reject = true;
              } else {
                out2[outpos] = item;
              }
            }
          }
          if (!reject && !collide && itemtype == 0)
            reject = is_out(a, item, w);
        }
        if (reject || collide) {
          ++ftotal;
          ++flocal;
          if (collide && flocal <= local_retries)
            retry_bucket = true;
          else if (local_fallback > 0 && flocal <= size + local_fallback)
            retry_bucket = true;
          else if (ftotal < tries)
            retry_descent = true;
          else
            skip_rep = true;
          if ((retry_bucket || retry_descent) && w.budget > 0 &&
              ftotal >= w.budget) {
            w.clean = false;  // the budget refuses this retry
            retry_bucket = retry_descent = false;
            skip_rep = true;
          }
        }
      } while (retry_bucket);
    } while (retry_descent);
    if (skip_rep) continue;
    out[outpos] = item;
    ++outpos;
    --count;
  }
  return outpos;
}

// crush_choose_indep (mapper.c:655).
template <bool kOuter>
__device__ void choose_indep(const RuleArgs& a, Walk& w, int bucket_bno,
                             int left, int numrep, int type, int32_t* out,
                             int outpos, int tries, int recurse_tries,
                             bool recurse_to_leaf, int32_t* out2,
                             int parent_r) {
  const int endpos = outpos + left;
  for (int rep = outpos; rep < endpos; ++rep) {
    out[rep] = kItemUndef;
    if (kOuter) out2[rep] = kItemUndef;
  }
  const int limit = (w.budget > 0 && w.budget < tries) ? w.budget : tries;
  for (int ftotal = 0; left > 0 && ftotal < limit; ++ftotal) {
    for (int rep = outpos; rep < endpos; ++rep) {
      if (out[rep] != kItemUndef) continue;
      int in_bno = bucket_bno;
      for (;;) {
        const int size = __ldg(a.sizes + in_bno);
        int r = rep + parent_r;
        if (__ldg(a.algs + in_bno) == kAlgUniform && size % numrep == 0)
          r += (numrep + 1) * ftotal;
        else
          r += numrep * ftotal;
        if (size == 0) break;
        const int item =
            bucket_choose(a, in_bno, static_cast<uint32_t>(r), false, w);
        if (item >= a.max_devices) {
          out[rep] = kItemNone;
          if (kOuter) out2[rep] = kItemNone;
          --left;
          break;
        }
        bool valid_bucket;
        const int itemtype = item_type(a, item, valid_bucket);
        if (itemtype != type) {
          if (!valid_bucket) {
            out[rep] = kItemNone;
            if (kOuter) out2[rep] = kItemNone;
            --left;
            break;
          }
          in_bno = -1 - item;
          continue;
        }
        bool collide = false;
        for (int i = outpos; i < endpos; ++i) {
          if (out[i] == item) {
            collide = true;
            break;
          }
        }
        if (collide) break;
        if constexpr (kOuter) {
          if (recurse_to_leaf) {
            if (item < 0) {
              choose_indep<false>(a, w, -1 - item, 1, numrep, 0, out2, rep,
                                  recurse_tries, 0, false, nullptr, r);
              if (out2[rep] == kItemNone) break;
            } else {
              out2[rep] = item;
            }
          }
        }
        if (itemtype == 0 && is_out(a, item, w)) break;
        out[rep] = item;
        --left;
        break;
      }
    }
  }
  if (left > 0 && limit < tries) w.clean = false;  // the budget ran out
  for (int rep = outpos; rep < endpos; ++rep) {
    if (out[rep] == kItemUndef) out[rep] = kItemNone;
    if (kOuter && out2[rep] == kItemUndef) out2[rep] = kItemNone;
  }
}

// crush_do_rule (mapper.c:900); writes result_max entries to `result`.
__device__ void do_rule(const RuleArgs& a, Walk& w, int32_t* result) {
  int32_t wbuf[kMaxResult], obuf[kMaxResult], cbuf[kMaxResult];
  int32_t* wv = wbuf;
  int32_t* ov = obuf;
  const int R = a.result_max;
  int wsize = 0, result_len = 0;
  int choose_tries = a.tunables[0] + 1;
  int choose_leaf_tries = 0;
  int local_retries = a.tunables[1];
  int local_fallback = a.tunables[2];
  const int descend_once = a.tunables[3];
  int vary_r = a.tunables[4];
  int stable = a.tunables[5];
  for (int s = 0; s < a.n_steps; ++s) {
    const int op = a.steps[3 * s];
    const int arg1 = a.steps[3 * s + 1];
    const int arg2 = a.steps[3 * s + 2];
    switch (op) {
      case 1:  // take
        if ((arg1 >= 0 && arg1 < a.max_devices) ||
            (arg1 < 0 && -1 - arg1 < a.n_buckets)) {
          wv[0] = arg1;
          wsize = 1;
        }
        break;
      case 8:
        if (arg1 > 0) choose_tries = arg1;
        break;
      case 9:
        if (arg1 > 0) choose_leaf_tries = arg1;
        break;
      case 10:
        if (arg1 >= 0) local_retries = arg1;
        break;
      case 11:
        if (arg1 >= 0) local_fallback = arg1;
        break;
      case 12:
        if (arg1 >= 0) vary_r = arg1;
        break;
      case 13:
        if (arg1 >= 0) stable = arg1;
        break;
      case 2:   // choose firstn
      case 3:   // choose indep
      case 6:   // chooseleaf firstn
      case 7: {  // chooseleaf indep
        if (wsize == 0) break;
        const bool firstn = op == 2 || op == 6;
        const bool recurse = op == 6 || op == 7;
        int osize = 0;
        for (int i = 0; i < wsize; ++i) {
          int numrep = arg1;
          if (numrep <= 0) {
            numrep += R;
            if (numrep <= 0) continue;
          }
          const int bno = -1 - wv[i];
          if (bno < 0 || bno >= a.n_buckets) continue;
          if (firstn) {
            const int recurse_tries =
                choose_leaf_tries ? choose_leaf_tries
                                  : (descend_once ? 1 : choose_tries);
            osize += choose_firstn<true>(
                a, w, bno, numrep, arg2, ov + osize, 0, R - osize,
                choose_tries, recurse_tries, local_retries, local_fallback,
                recurse, vary_r, stable, cbuf + osize, 0);
          } else {
            const int out_size = numrep < R - osize ? numrep : R - osize;
            choose_indep<true>(a, w, bno, out_size, numrep, arg2, ov + osize,
                               0, choose_tries,
                               choose_leaf_tries ? choose_leaf_tries : 1,
                               recurse, cbuf + osize, 0);
            osize += out_size;
          }
        }
        if (recurse)
          for (int j = 0; j < osize; ++j) ov[j] = cbuf[j];
        int32_t* t = ov;
        ov = wv;
        wv = t;
        wsize = osize;
        break;
      }
      case 4:  // emit
        for (int i = 0; i < wsize && result_len < R; ++i)
          result[result_len++] = wv[i];
        wsize = 0;
        break;
      default:
        break;
    }
  }
  for (int i = result_len; i < R; ++i) result[i] = kItemNone;
}

// One slot of a capacity-sized append buffer: one atomic per group of
// threads that arrive together.
__device__ __forceinline__ int append_slot(int32_t* counter) {
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, static_cast<int>(g.size()));
  return g.shfl(base, 0) + static_cast<int>(g.thread_rank());
}

__device__ __forceinline__ void add_stat(unsigned long long* at,
                                         unsigned v) {
  cg::coalesced_group g = cg::coalesced_threads();
  const unsigned long long sum =
      cg::reduce(g, static_cast<unsigned long long>(v),
                 cg::plus<unsigned long long>());
  if (g.thread_rank() == 0) atomicAdd(at, sum);
}

__global__ void __launch_bounds__(kThreads)
    crush_rule_kernel(const __grid_constant__ RuleArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t n = a.n;
  if (a.lane_count) {
    const int64_t c = *a.lane_count;
    n = c < n ? (c < 0 ? 0 : c) : n;
  }
  if (t >= n) return;
  const int64_t lane = a.lanes ? a.lanes[t] : t;
  Walk w{static_cast<uint32_t>(a.xs[lane]), a.budget, true, 0, 0, 0};
  do_rule(a, w, a.out + lane * a.result_max);
  if (a.clean) a.clean[lane] = w.clean;
  if (!w.clean && a.bad) {
    const int pos = append_slot(a.bad_count);
    if (pos < a.bad_cap) a.bad[pos] = static_cast<int32_t>(lane) + a.idx_base;
  }
  if (a.stats) {
    add_stat(a.stats, w.draws);
    add_stat(a.stats + 1, w.hashes);
    add_stat(a.stats + 2, w.chooses);
  }
}

}  // namespace

extern "C" {

// K6.  args: host pointer to the launch's RuleArgs (ops/crush_rule.py
// _RuleArgs); one thread per id.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
int crush_rule_launch(const void* args, void* stream) {
  const RuleArgs& a = *static_cast<const RuleArgs*>(args);
  if (a.result_max < 1 || a.result_max > kMaxResult || a.n_steps < 0 ||
      a.n_steps > kMaxSteps || a.n < 0 || a.n_buckets < 1 ||
      a.max_size < 1 || a.weight_max < 1 || a.budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  crush_rule_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The size of RuleArgs, which the wrapper checks against its mirror.
int crush_rule_args_size() { return static_cast<int>(sizeof(RuleArgs)); }

}  // extern "C"
