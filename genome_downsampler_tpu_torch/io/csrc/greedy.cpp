// Exact unit-cost MCP greedy on host — the C-speed production CPU path.
//
// Same algorithm family as the device sweep (solvers/device_sweep.py): a
// left-to-right position sweep taking from the farthest end buckets first
// (a bitmask skip-index makes each take amortized O(1)), followed by
// earliest-start-per-end-bucket identity reconstruction. Bit-compatible
// with the device solvers (identical counts and tie-breaks), so it doubles
// as the large-scale oracle. Complexity O(n + R) with counting sorts — no
// comparison sort, no heap.
//
// Memory: all large buffers live in a process-lifetime arena reused across
// calls and sized int32. This matters doubly in virtualized environments
// where first-touch page population can be orders of magnitude slower than
// warm memory (measured 0.1 GB/s faults vs 5+ GB/s warm on an 8-core virtualized host).
//
// Replaces the role of OR-Tools SimpleMinCostFlow in the reference
// (reference/libs/qmcp-solver/src/mcp_cpu_cost_scaling_solver.cpp)
// with a provably optimal combinatorial sweep (see greedy_mcp.py for the
// exchange-argument proof).

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

namespace {

// Reusable zero-on-demand buffers (grow-only).
template <typename T>
struct Arena {
    std::vector<T> v;
    T* get(int64_t count) {
        if ((int64_t)v.size() < count) v.resize(count);
        return v.data();
    }
    T* get_zeroed(int64_t count) {
        T* p = get(count);
        std::memset(p, 0, sizeof(T) * count);
        return p;
    }
};

struct Buffers {
    Arena<int32_t> diff, dec, avail, sel_per_end, counts, by_start, by_end;
    Arena<int64_t> offsets, offsets2;
    // reconstruction offsets fit int32 (cumulative counts <= R < 2^31);
    // separate arenas halve the first-touch page cost at chromosome scale
    Arena<int32_t> roff, roff2;
    Arena<uint64_t> mask;
    Arena<uint8_t> selected;
};

Buffers& bufs() {
    static Buffers b;
    return b;
}

// Worker count for the range-partitioned passes: every thread scans all R
// reads, so parallelism only pays while cores are real — clamp to the
// machine (gd_pack_blocked takes an explicit parameter for the same reason).
int64_t default_threads() {
    unsigned hc = std::thread::hardware_concurrency();
    return std::max<int64_t>(1, std::min<int64_t>(hc ? hc : 2, 16));
}

}  // namespace

extern "C" {

// Selects an exact minimum-count subset meeting min(cov, M) per base.
// start/end: int64[R] inclusive; n: genome length; target_opt: optional
// int64[n] external per-base target (pass NULL to use min(cov, M)).
// out_sel: malloc'd ascending read indices (caller frees via gd_free_i64).
// Returns selected count, or -1 on error.
int64_t gd_greedy_mcp(
    const int64_t* start, const int64_t* end, int64_t R,
    int64_t n, int64_t max_coverage, const int64_t* target_opt,
    int64_t** out_sel) {
    *out_sel = nullptr;
    if (R == 0) {
        *out_sel = static_cast<int64_t*>(std::malloc(1));
        return 0;
    }
    if (R >= INT32_MAX || n >= INT32_MAX) return -1;
    int64_t max_span = 0;
    for (int64_t i = 0; i < R; ++i) {
        int64_t sp = end[i] - start[i] + 1;
        if (sp > max_span) max_span = sp;
        if (start[i] < 0 || end[i] >= n || sp <= 0) return -1;
    }
    const int64_t L = max_span;
    const bool dbg = std::getenv("GD_DEBUG_TIMING") != nullptr;
    auto tick = std::chrono::steady_clock::now();
    auto lap = [&](const char* what) {
        if (!dbg) return;
        auto now = std::chrono::steady_clock::now();
        std::fprintf(stderr, "[greedy] %s: %.2fs\n", what,
                     std::chrono::duration<double>(now - tick).count());
        tick = now;
    };

    Buffers& B = bufs();

    // coverage difference array (consumed as a running sum in the sweep)
    int32_t* diff = B.diff.get_zeroed(n + 2);
    if (!target_opt) {
        for (int64_t i = 0; i < R; ++i) {
            diff[start[i]]++;
            diff[end[i] + 1]--;
        }
    }
    lap("target");

    // reads bucketed by start via counting sort (stable -> index order kept)
    int32_t* counts = B.counts.get_zeroed(n + 1);
    for (int64_t i = 0; i < R; ++i) counts[start[i]]++;
    int64_t* start_off = B.offsets.get(n + 2);
    start_off[0] = 0;
    for (int64_t j = 0; j <= n; ++j) start_off[j + 1] = start_off[j] + counts[j];
    int32_t* by_start = B.by_start.get(R);
    {
        // counts doubles as the cursor (reset to zero-relative)
        for (int64_t i = 0; i < R; ++i) {
            int64_t s = start[i];
            by_start[start_off[s] + (start_off[s + 1] - start_off[s] -
                                     counts[s]--)] = (int32_t)i;
        }
    }
    lap("bucket_by_start");

    // the sweep over absolute end positions, with a bitmask skip-index so a
    // take touches only nonempty end buckets
    int32_t* avail = B.avail.get_zeroed(n + 1);
    int32_t* dec = B.dec.get_zeroed(n + 2);
    int32_t* sel_per_end = B.sel_per_end.get_zeroed(n);
    const int64_t words = (n + 64) / 64;
    uint64_t* mask = B.mask.get_zeroed(words);
    auto set_bit = [&](int64_t e) { mask[e >> 6] |= 1ull << (e & 63); };
    auto clear_bit = [&](int64_t e) { mask[e >> 6] &= ~(1ull << (e & 63)); };
    auto highest_in = [&](int64_t lo, int64_t hi) -> int64_t {
        int64_t wl = lo >> 6, wh = hi >> 6;
        uint64_t m = mask[wh] & (~0ull >> (63 - (hi & 63)));
        if (wh == wl) m &= ~0ull << (lo & 63);
        if (m) return (wh << 6) + 63 - __builtin_clzll(m);
        for (int64_t w = wh - 1; w > wl; --w)
            if (mask[w]) return (w << 6) + 63 - __builtin_clzll(mask[w]);
        if (wh != wl) {
            m = mask[wl] & (~0ull << (lo & 63));
            if (m) return (wl << 6) + 63 - __builtin_clzll(m);
        }
        return -1;
    };

    int64_t cur = 0;    // selected reads covering the current position
    int64_t cov = 0;    // input coverage running sum
    for (int64_t p = 0; p < n; ++p) {
        for (int64_t q = start_off[p]; q < start_off[p + 1]; ++q) {
            int64_t e = end[by_start[q]];
            if (avail[e]++ == 0) set_bit(e);
        }
        cur -= dec[p];
        cov += diff[p];
        int64_t t = target_opt ? target_opt[p]
                               : std::min<int64_t>(cov, max_coverage);
        int64_t deficit = t - cur;
        int64_t hi = std::min(p + L - 1, n - 1);
        while (deficit > 0) {
            int64_t e = highest_in(p, hi);
            // with target = min(cov, M) a candidate always exists
            // (feasibility proof); an external target may be unmeetable —
            // take what there is, like the device sweep's clip
            if (e < 0) break;
            int64_t take = std::min<int64_t>(avail[e], deficit);
            avail[e] -= take;
            if (avail[e] == 0) clear_bit(e);
            sel_per_end[e] += take;
            dec[e + 1] += take;
            cur += take;
            deficit -= take;
            hi = e;  // next take must be at a lower end
        }
        // stock ending here expires for later positions
        if (avail[p] > 0) { avail[p] = 0; clear_bit(p); }
    }
    lap("sweep");

    // reconstruction: per end bucket, earliest (start, index) first.
    // stable counting re-sort of by_start by end gives (end, start, index)
    // order without comparisons.
    int32_t* end_cnt = B.counts.get_zeroed(n + 1);
    for (int64_t i = 0; i < R; ++i) end_cnt[end[i]]++;
    int64_t* end_off = B.offsets2.get(n + 2);
    end_off[0] = 0;
    for (int64_t j = 0; j <= n; ++j) end_off[j + 1] = end_off[j] + end_cnt[j];
    int32_t* by_end = B.by_end.get(R);
    for (int64_t q = 0; q < R; ++q) {
        int32_t i = by_start[q];  // already start-then-index ordered
        int64_t e = end[i];
        by_end[end_off[e] + (end_off[e + 1] - end_off[e] - end_cnt[e]--)] = i;
    }
    uint8_t* selected = B.selected.get_zeroed(R);
    int64_t total = 0;
    for (int64_t e = 0; e < n; ++e) {
        int64_t quota = sel_per_end[e];
        for (int64_t q = end_off[e]; quota > 0; ++q, --quota) {
            selected[by_end[q]] = 1;
            total++;
        }
    }
    lap("reconstruct");
    int64_t* out = static_cast<int64_t*>(
        std::malloc(sizeof(int64_t) * std::max<int64_t>(total, 1)));
    int64_t w = 0;
    for (int64_t i = 0; i < R; ++i)
        if (selected[i]) out[w++] = i;
    *out_sel = out;
    return total;
}

void gd_free_i64(int64_t* p) { std::free(p); }

// Capped-coverage target min(coverage, M) per base — the device sweep's
// input, computed host-side so the solver ships one small target array
// instead of the raw start/end arrays (transfer diet for the dev relay;
// semantics of ops/coverage.py::capped_coverage). Threaded difference
// histogram + sequential cumsum. out: caller-allocated int32[n_pad]
// (positions >= n get 0 coverage by construction since end < n).
// Returns 0, -1 on error.
int64_t gd_capped_target(
    const int64_t* start, const int64_t* end, int64_t R,
    int64_t n_pad, int64_t max_coverage, int32_t* out) {
    if (n_pad >= INT32_MAX) return -1;
    for (int64_t i = 0; i < R; ++i)
        if (start[i] < 0 || end[i] < start[i] || end[i] >= n_pad) return -1;
    const int64_t T = default_threads();
    std::vector<std::vector<int32_t>> part(T);
    std::vector<std::thread> pool;
    for (int64_t k = 0; k < T; ++k) {
        pool.emplace_back([&, k] {
            auto& d = part[k];
            d.assign(n_pad + 1, 0);
            int64_t r0 = R * k / T, r1 = R * (k + 1) / T;
            for (int64_t r = r0; r < r1; ++r) {
                d[start[r]]++;
                d[end[r] + 1]--;
            }
        });
    }
    for (auto& th : pool) th.join();
    int64_t run = 0;
    const int32_t cap = (int32_t)std::min<int64_t>(max_coverage, INT32_MAX);
    for (int64_t j = 0; j < n_pad; ++j) {
        for (int64_t k = 0; k < T; ++k) run += part[k][j];
        out[j] = run < cap ? (int32_t)run : cap;
    }
    return 0;
}

// Identity reconstruction for the device sweep solvers: given the per-end
// selected counts the kernel emits (solvers/device_sweep.reconstruct_selection
// semantics), mark, per end bucket e, the sel_per_end[e] reads with smallest
// (start, index). Two stable counting sorts — O(R + n), no comparison sort;
// the numpy lexsort this replaces costs seconds at 10M+ reads.
// out_selected: caller-allocated uint8[R]. Returns selected count, -1 on
// error (bounds, or a bucket quota exceeding its read count).
int64_t gd_reconstruct(
    const int64_t* start, const int64_t* end, int64_t R,
    const int64_t* sel_per_end, int64_t n, uint8_t* out_selected) {
    if (R >= INT32_MAX || n >= INT32_MAX) return -1;
    std::memset(out_selected, 0, (size_t)R);
    if (R == 0) return 0;
    for (int64_t i = 0; i < R; ++i)
        if (start[i] < 0 || end[i] < start[i] || end[i] >= n) return -1;

    Buffers& B = bufs();
    // Both counting sorts are range-partitioned across threads on the key
    // (position) space, the gd_pack_blocked pattern: each thread scans all
    // reads but counts/places only keys in its own range, so cursors and
    // output slices never conflict and stability within a position is the
    // scan order — identical to the sequential sort.
    const int64_t T = default_threads();
    int32_t* counts = B.counts.get_zeroed(n + 1);
    int32_t* start_off = B.roff.get(n + 2);
    int32_t* by_start = B.by_start.get(R);
    {
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k)
            pool.emplace_back([&, k] {
                int64_t lo = n * k / T, hi = (k == T - 1) ? n + 1 : n * (k + 1) / T;
                for (int64_t i = 0; i < R; ++i) {
                    int64_t s = start[i];
                    if (s >= lo && s < hi) counts[s]++;
                }
            });
        for (auto& th : pool) th.join();
    }
    start_off[0] = 0;
    for (int64_t j = 0; j <= n; ++j)
        start_off[j + 1] = start_off[j] + counts[j];
    {
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k)
            pool.emplace_back([&, k] {
                int64_t lo = n * k / T, hi = (k == T - 1) ? n + 1 : n * (k + 1) / T;
                for (int64_t i = 0; i < R; ++i) {
                    int64_t s = start[i];
                    if (s < lo || s >= hi) continue;
                    by_start[start_off[s] + (start_off[s + 1] - start_off[s] -
                                             counts[s]--)] = (int32_t)i;
                }
            });
        for (auto& th : pool) th.join();
    }
    // stable counting re-sort by end -> (end, start, index) order
    int32_t* end_cnt = B.counts.get_zeroed(n + 1);
    int32_t* end_off = B.roff2.get(n + 2);
    int32_t* by_end = B.by_end.get(R);
    {
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k)
            pool.emplace_back([&, k] {
                int64_t lo = n * k / T, hi = (k == T - 1) ? n + 1 : n * (k + 1) / T;
                for (int64_t i = 0; i < R; ++i) {
                    int64_t e = end[i];
                    if (e >= lo && e < hi) end_cnt[e]++;
                }
            });
        for (auto& th : pool) th.join();
    }
    end_off[0] = 0;
    for (int64_t j = 0; j <= n; ++j) end_off[j + 1] = end_off[j] + end_cnt[j];
    {
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k)
            pool.emplace_back([&, k] {
                int64_t lo = n * k / T, hi = (k == T - 1) ? n + 1 : n * (k + 1) / T;
                for (int64_t q = 0; q < R; ++q) {
                    int32_t i = by_start[q];
                    int64_t e = end[i];
                    if (e < lo || e >= hi) continue;
                    by_end[end_off[e] + (end_off[e + 1] - end_off[e] -
                                         end_cnt[e]--)] = i;
                }
            });
        for (auto& th : pool) th.join();
    }
    std::atomic<int64_t> total{0};
    std::atomic<bool> quota_ok{true};
    {
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k)
            pool.emplace_back([&, k] {
                int64_t lo = n * k / T, hi = n * (k + 1) / T;
                int64_t local = 0;
                for (int64_t e = lo; e < hi; ++e) {
                    int64_t quota = sel_per_end[e];
                    if (quota < 0 || quota > end_off[e + 1] - end_off[e]) {
                        quota_ok = false;
                        return;
                    }
                    for (int64_t q = end_off[e]; quota > 0; ++q, --quota) {
                        out_selected[by_end[q]] = 1;
                        local++;
                    }
                }
                total += local;
            });
        for (auto& th : pool) th.join();
    }
    if (!quota_ok) return -1;
    return total.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Blocked packing for the device sweep (ops/pallas_blocked.pack_blocked):
// bucket reads by (window, block-within-window) into a padded code array
// packed[nbw][W][cap] with code = start_rel * L + (span - 1), sentinel -1.
// Counting sort, O(R) — the numpy argsort path costs minutes at 10M+ reads
// on an 8-core host. Returns 0 on success; outputs are malloc'd (free with
// gd_free_i64 / gd_free_i32).
namespace {
// pack arenas: packed/rid/slots reuse across calls — on virtualized hosts
// first-touch page population of a fresh 100+ MB malloc costs more than
// the packing itself (measured 1-2 s/call at 6M reads)
struct PackArenas {
    Arena<int32_t> packed, counts, rid;
    Arena<uint16_t> packed16;
    Arena<int64_t> slots;
    Arena<uint8_t> selmask;
};
PackArenas& pack_bufs() {
    static PackArenas p;
    return p;
}
}  // namespace

// out_slots (optional, pass NULL to skip): int64[R] flat slot index of each
// read within the packed array ((t * W + w) * cap + fill_rank) — the
// inverse permutation the device-side reconstruction mask is addressed by.
// All outputs are arena-owned: valid until the next gd_pack_blocked call,
// NOT free'd by the caller.
extern "C" int64_t gd_pack_blocked(
    const int64_t* start, const int64_t* end, int64_t R, int64_t n,
    int64_t W, int64_t B, int64_t L, int64_t cap_multiple,
    int64_t cap_floor, int64_t threads,
    int32_t** out_packed, int32_t** out_counts,
    int64_t* out_win, int64_t* out_cap, int64_t** out_slots) {
    *out_packed = nullptr;
    *out_counts = nullptr;
    if (out_slots) *out_slots = nullptr;
    int64_t win = (n + W - 1) / W;
    win = (win + B - 1) / B * B;
    int64_t nbw = win / B;
    int64_t groups = nbw * W;
    int64_t T = std::max<int64_t>(1, std::min<int64_t>(threads, 32));

    PackArenas& P = pack_bufs();
    int32_t* counts = P.counts.get_zeroed(std::max<int64_t>(groups, 1));
    std::atomic<bool> ok{true};
    {
        // per-thread count arrays, merged after — the count pass is
        // bandwidth-bound and parallelizes cleanly
        std::vector<std::vector<int32_t>> part(T);
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k) {
            pool.emplace_back([&, k] {
                auto& c = part[k];
                c.assign(groups, 0);
                int64_t r0 = R * k / T, r1 = R * (k + 1) / T;
                for (int64_t r = r0; r < r1; ++r) {
                    int64_t span = end[r] - start[r] + 1;
                    // span cap is L-1: the sweep kernel reserves code lane
                    // L-1 for the injected per-position target
                    if (start[r] < 0 || start[r] >= W * win || span < 1 ||
                        span >= L) { ok = false; return; }
                    int64_t w = start[r] / win, t = (start[r] % win) / B;
                    c[t * W + w]++;
                }
            });
        }
        for (auto& th : pool) th.join();
        if (!ok) return -1;
        for (int64_t k = 0; k < T; ++k)
            for (int64_t g = 0; g < groups; ++g) counts[g] += part[k][g];
    }
    int64_t maxc = 0;
    for (int64_t g = 0; g < groups; ++g) maxc = std::max<int64_t>(maxc, counts[g]);
    // cap = max(floor, round_to_multiple(maxc, cap_multiple)) — kept
    // IDENTICAL to the numpy fallback in ops/pallas_blocked.pack_blocked so
    // both paths produce the same packed shape (same jit cache key)
    int64_t cap = std::max<int64_t>(
        std::max<int64_t>(cap_multiple, cap_floor),
        (maxc + cap_multiple - 1) / cap_multiple * cap_multiple);

    int32_t* packed = P.packed.get(std::max<int64_t>(groups * cap, 1));
    int64_t* slots =
        out_slots ? P.slots.get(std::max<int64_t>(R, 1)) : nullptr;
    int32_t* rid_all = P.rid.get(std::max<int64_t>(groups * cap, 1));

    // placement: partition the GENOME (t-ranges) across threads; each scans
    // every read but touches only its own packed slice — parallel first-touch
    // page population plus better write locality on slow-fault VMs.
    // Each group is then stable-sorted by code: equal-code (same (start,
    // end)) reads stay in original index order — the tie-break contract the
    // reconstruction mask depends on — while code-sorted groups let the
    // device compute intra-cell ranks per contiguous run.
    {
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k) {
            pool.emplace_back([&, k] {
                int64_t t0 = nbw * k / T, t1 = nbw * (k + 1) / T;
                if (t0 == t1) return;
                std::memset(packed + t0 * W * cap, 0xFF,
                            sizeof(int32_t) * (t1 - t0) * W * cap);
                std::vector<int32_t> fill((t1 - t0) * W, 0);
                int32_t* rid = rid_all + t0 * W * cap;
                for (int64_t r = 0; r < R; ++r) {
                    int64_t w = start[r] / win, t = (start[r] % win) / B;
                    if (t < t0 || t >= t1) continue;
                    int64_t g = t * W + w;
                    int64_t start_rel = start[r] % B;
                    int64_t span = end[r] - start[r] + 1;
                    int64_t gl = g - t0 * W;
                    int64_t f = fill[gl]++;
                    packed[g * cap + f] = (int32_t)(start_rel * L + (span - 1));
                    rid[gl * cap + f] = (int32_t)r;
                }
                std::vector<int32_t> perm(cap), tmp(cap);
                for (int64_t gl = 0; gl < (t1 - t0) * W; ++gl) {
                    int32_t cnt = fill[gl];
                    if (cnt <= 1) {
                        if (slots && cnt == 1)
                            slots[rid[gl * cap]] = (t0 * W + gl) * cap;
                        continue;
                    }
                    int32_t* pc = packed + (t0 * W + gl) * cap;
                    int32_t* pr = rid + gl * cap;
                    for (int32_t i = 0; i < cnt; ++i) perm[i] = i;
                    std::stable_sort(perm.begin(), perm.begin() + cnt,
                                     [&](int32_t x, int32_t y) {
                                         return pc[x] < pc[y];
                                     });
                    std::copy(pc, pc + cnt, tmp.begin());
                    for (int32_t i = 0; i < cnt; ++i) {
                        pc[i] = tmp[perm[i]];
                        if (slots)
                            slots[pr[perm[i]]] = (t0 * W + gl) * cap + i;
                    }
                }
            });
        }
        for (auto& th : pool) th.join();
    }
    if (out_slots) *out_slots = slots;
    *out_packed = packed;
    *out_counts = counts;
    *out_win = win;
    *out_cap = cap;
    return 0;
}

// Compact the arena-held padded codes to a flat valid-codes stream in
// group order (uint16; groups are already code-sorted): what actually
// ships to the device — the padded (group, cap) layout is rebuilt there
// by a scatter, so the transfer carries R codes instead of groups * cap.
// counts: int32[groups]. Arena-owned output.
// Direct flat packer (TWIN of gd_pack_blocked below: the validation,
// count merge, cap rounding and per-group stable-sort/tie-break logic
// must stay byte-identical between the two — guarded by
// tests/test_blocked_sweep.py::test_pack_flat_direct_matches_two_step
// across three geometries): emits the FLAT uint16 valid-code stream (group
// order, code-sorted within groups — byte-identical to gd_pack_blocked
// followed by gd_pack_flat_u16) WITHOUT materializing the padded int32
// arena at all. At chr1 scale the padded arena is ~1 GB of sentinel-
// filled memory built only to be compacted away; skipping it roughly
// halves the pack phase (the largest device-path host cost in the r5
// config-5 bench). `out_slots` still gets PADDED indices
// ((t*W + w) * cap + rank) — the device reconstruction bitmask stays
// padded-shaped, rebuilt on device by expand_flat_codes.
// Outputs are arena-owned: valid until the next pack call.
extern "C" int64_t gd_pack_flat_direct(
    const int64_t* start, const int64_t* end, int64_t R, int64_t n,
    int64_t W, int64_t B, int64_t L, int64_t cap_multiple,
    int64_t cap_floor, int64_t threads,
    uint16_t** out_flat, int32_t** out_counts,
    int64_t* out_win, int64_t* out_cap, int64_t** out_slots) {
    *out_flat = nullptr;
    *out_counts = nullptr;
    if (out_slots) *out_slots = nullptr;
    int64_t win = (n + W - 1) / W;
    win = (win + B - 1) / B * B;
    int64_t nbw = win / B;
    int64_t groups = nbw * W;
    if (B * L > 0x10000) return -1;  // codes must fit uint16
    int64_t T = std::max<int64_t>(1, std::min<int64_t>(threads, 32));

    PackArenas& P = pack_bufs();
    int32_t* counts = P.counts.get_zeroed(std::max<int64_t>(groups, 1));
    std::atomic<bool> ok{true};
    {
        std::vector<std::vector<int32_t>> part(T);
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k) {
            pool.emplace_back([&, k] {
                auto& c = part[k];
                c.assign(groups, 0);
                int64_t r0 = R * k / T, r1 = R * (k + 1) / T;
                for (int64_t r = r0; r < r1; ++r) {
                    int64_t span = end[r] - start[r] + 1;
                    if (start[r] < 0 || start[r] >= W * win || span < 1 ||
                        span >= L) { ok = false; return; }
                    int64_t w = start[r] / win, t = (start[r] % win) / B;
                    c[t * W + w]++;
                }
            });
        }
        for (auto& th : pool) th.join();
        if (!ok) return -1;
        for (int64_t k = 0; k < T; ++k)
            for (int64_t g = 0; g < groups; ++g) counts[g] += part[k][g];
    }
    int64_t maxc = 0;
    for (int64_t g = 0; g < groups; ++g)
        maxc = std::max<int64_t>(maxc, counts[g]);
    int64_t cap = std::max<int64_t>(
        std::max<int64_t>(cap_multiple, cap_floor),
        (maxc + cap_multiple - 1) / cap_multiple * cap_multiple);

    uint16_t* flat = P.packed16.get(std::max<int64_t>(R, 1));
    int32_t* rid_all = P.rid.get(std::max<int64_t>(R, 1));
    int64_t* slots =
        out_slots ? P.slots.get(std::max<int64_t>(R, 1)) : nullptr;
    // group offsets into the flat stream (prefix over groups)
    std::vector<int64_t> goff(groups + 1, 0);
    for (int64_t g = 0; g < groups; ++g) goff[g + 1] = goff[g] + counts[g];

    {
        std::vector<std::thread> pool;
        for (int64_t k = 0; k < T; ++k) {
            pool.emplace_back([&, k] {
                int64_t t0 = nbw * k / T, t1 = nbw * (k + 1) / T;
                if (t0 == t1) return;
                int64_t g_lo = t0 * W, g_hi = t1 * W;
                std::vector<int32_t> fill(g_hi - g_lo, 0);
                for (int64_t r = 0; r < R; ++r) {
                    int64_t w = start[r] / win, t = (start[r] % win) / B;
                    if (t < t0 || t >= t1) continue;
                    int64_t g = t * W + w;
                    int64_t start_rel = start[r] % B;
                    int64_t span = end[r] - start[r] + 1;
                    int64_t f = fill[g - g_lo]++;
                    flat[goff[g] + f] =
                        (uint16_t)(start_rel * L + (span - 1));
                    rid_all[goff[g] + f] = (int32_t)r;
                }
                std::vector<int32_t> perm, tmp;
                for (int64_t g = g_lo; g < g_hi; ++g) {
                    int32_t cnt = fill[g - g_lo];
                    if (cnt <= 1) {
                        if (slots && cnt == 1)
                            slots[rid_all[goff[g]]] = g * cap;
                        continue;
                    }
                    uint16_t* pc = flat + goff[g];
                    int32_t* pr = rid_all + goff[g];
                    perm.resize(cnt);
                    tmp.resize(cnt);
                    for (int32_t i = 0; i < cnt; ++i) perm[i] = i;
                    std::stable_sort(perm.begin(), perm.end(),
                                     [&](int32_t x, int32_t y) {
                                         return pc[x] < pc[y];
                                     });
                    for (int32_t i = 0; i < cnt; ++i) tmp[i] = pc[perm[i]];
                    for (int32_t i = 0; i < cnt; ++i) {
                        pc[i] = (uint16_t)tmp[i];
                        if (slots)
                            slots[pr[perm[i]]] = g * cap + i;
                    }
                }
            });
        }
        for (auto& th : pool) th.join();
    }
    *out_flat = flat;
    *out_counts = counts;
    *out_win = win;
    *out_cap = cap;
    if (out_slots) *out_slots = slots;
    return 0;
}

extern "C" int64_t gd_pack_flat_u16(
    const int32_t* packed, const int32_t* counts, int64_t groups,
    int64_t cap, uint16_t** out) {
    int64_t total = 0;
    for (int64_t g = 0; g < groups; ++g) total += counts[g];
    uint16_t* flat = pack_bufs().packed16.get(std::max<int64_t>(total, 1));
    const int64_t T = default_threads();
    // per-thread group ranges with precomputed flat offsets
    std::vector<int64_t> goff(T + 1, 0);
    {
        std::vector<int64_t> csum(T, 0);
        for (int64_t k = 0; k < T; ++k) {
            int64_t g0 = groups * k / T, g1 = groups * (k + 1) / T;
            int64_t s = 0;
            for (int64_t g = g0; g < g1; ++g) s += counts[g];
            csum[k] = s;
        }
        for (int64_t k = 0; k < T; ++k) goff[k + 1] = goff[k] + csum[k];
    }
    std::vector<std::thread> pool;
    for (int64_t k = 0; k < T; ++k)
        pool.emplace_back([&, k] {
            int64_t g0 = groups * k / T, g1 = groups * (k + 1) / T;
            int64_t w = goff[k];
            for (int64_t g = g0; g < g1; ++g) {
                const int32_t* pc = packed + g * cap;
                for (int32_t i = 0; i < counts[g]; ++i)
                    flat[w++] = (uint16_t)pc[i];
            }
        });
    for (auto& th : pool) th.join();
    *out = flat;
    return total;
}

// Narrow arena-held packed codes to uint16 (sentinel -1 -> 0xFFFF); valid
// when B * L <= 2^16. Arena-owned output (overwritten by the next call).
extern "C" int64_t gd_pack_to_u16(
    const int32_t* packed, int64_t count, uint16_t** out) {
    uint16_t* p16 = pack_bufs().packed16.get(std::max<int64_t>(count, 1));
    const int64_t T = default_threads();
    std::vector<std::thread> pool;
    for (int64_t k = 0; k < T; ++k)
        pool.emplace_back([&, k] {
            int64_t lo = count * k / T, hi = count * (k + 1) / T;
            for (int64_t i = lo; i < hi; ++i)
                p16[i] = (uint16_t)packed[i];  // -1 wraps to 0xFFFF
        });
    for (auto& th : pool) th.join();
    *out = p16;
    return 0;
}

// Selection extraction from the device bitmask: out01[r] = bit slots[r] of
// `bits`. Threaded by read range; returns the selected count.
extern "C" int64_t gd_mask_select(
    const uint8_t* bits, const int64_t* slots, int64_t R, uint8_t* out01) {
    const int64_t T = default_threads();
    std::atomic<int64_t> total{0};
    std::vector<std::thread> pool;
    for (int64_t k = 0; k < T; ++k)
        pool.emplace_back([&, k] {
            int64_t lo = R * k / T, hi = R * (k + 1) / T;
            int64_t local = 0;
            for (int64_t r = lo; r < hi; ++r) {
                uint8_t b = (bits[slots[r] >> 3] >> (slots[r] & 7)) & 1;
                out01[r] = b;
                local += b;
            }
            total += local;
        });
    for (auto& th : pool) th.join();
    return total.load();
}

extern "C" void gd_free_i32(int32_t* p) { std::free(p); }
