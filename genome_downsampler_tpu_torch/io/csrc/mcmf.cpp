// Exact quality-weighted selection (QMCP) via cost-scaling min-cost flow
// with convex (piecewise-linear) arc costs.
//
// The production-scale exact solver for the reference's qmcp problem
// (arc cost max_quality - quality + 1,
// reference/libs/qmcp-solver/src/qmcp_cpu_cost_scaling_solver.cpp):
// Goldberg-Tarjan epsilon-scaling push-relabel implemented from the
// published algorithm on the interval-flow network the SURVEY derives:
//
//   nodes 0..n on the genome line;
//   read arcs  start -> end+1;
//   chain arcs i+1 -> i, large capacity, cost 0;
//   node supplies -demand[i] from the capped-coverage difference
//   (mcp_cpu_cost_scaling_solver.cpp:59-66 semantics).
//
// Three scale enablers over a textbook implementation:
//  1. *Convex bucket arcs.* All reads sharing (start, end) collapse into a
//     single arc whose cost is convex piecewise-linear: the k-th unit of
//     flow costs the k-th cheapest read of the bucket (costs sorted
//     ascending). Marginal-cost residuals make eps-optimality and
//     push/relabel work unchanged. The SARS-scale graph drops from one arc
//     per read (millions) to one per distinct (start, end) (tens of
//     thousands) — every scan, push, and Dijkstra shrinks accordingly.
//  2. *Maximal admissible pushes.* A push moves every unit whose own
//     marginal reduced cost is negative (a prefix of the sorted segment,
//     found by binary search) in one step.
//  3. *Global price update* (the min-cost analogue of global relabel, as in
//     Goldberg's CS2): Dijkstra from all deficit nodes over reverse
//     residual arcs with lengths floor(rc/eps)+1 >= 0, lowering prices by
//     dist*eps. Without it, excess shuttles along the zero-cost chain arcs
//     as a random walk over n nodes and the solver stalls beyond ~50k
//     reads.
//
// flows[b] = units selected from bucket b (its cheapest flows[b] reads).
// Deterministic: fixed arc order, FIFO active queue.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <queue>
#include <utility>
#include <vector>

namespace {

constexpr int64_t INF64 = INT64_MAX / 4;

// Convex-cost arc solver. Arc a: u(a) -> v(a) with capacity cap(a) and
// per-unit scaled marginal costs mc(a, k) for k in [0, cap): nondecreasing
// in k. Flow f(a); forward residual marginal = mc(a, f), backward residual
// marginal = -mc(a, f-1).
struct ConvexCostScaling {
    int32_t N = 0;
    int32_t A = 0;  // arcs (each stored once; adjacency lists hold +/- ids)
    std::vector<int32_t> tail, head;
    std::vector<int64_t> cap, flow;
    // marginal costs: cost_pool[cost_off[a] + k] * scale
    std::vector<int64_t> cost_pool;
    std::vector<int64_t> cost_off;
    int64_t scale = 1;

    // adjacency: entries 2a (forward direction of arc a) and 2a+1
    // (backward), stored CSR (contiguous per-node entry ranges) — the
    // per-phase Dijkstra sweeps every node's incident entries, and the
    // linked-list layout this replaced cost ~2x in cache misses on the
    // hot settle loop (VERDICT r4 #6 micro-optimization)
    std::vector<int32_t> csr_off, csr_ent;
    std::vector<int64_t> p, excess;
    std::vector<int32_t> cur;  // per-node cursor: index into csr_ent
    int64_t eps = 1;
    int64_t n_pushes = 0, n_relabels = 0, n_updates = 0, n_dij_pops = 0;

    void finish_graph() {
        csr_off.assign((size_t)N + 1, 0);
        for (int32_t a = 0; a < A; ++a) {
            csr_off[tail[a] + 1]++;
            csr_off[head[a] + 1]++;
        }
        for (int32_t u = 0; u < N; ++u) csr_off[u + 1] += csr_off[u];
        csr_ent.resize(2 * (size_t)A);
        std::vector<int32_t> fill(csr_off.begin(), csr_off.end() - 1);
        for (int32_t a = 0; a < A; ++a) {
            csr_ent[fill[tail[a]]++] = 2 * a;
            csr_ent[fill[head[a]]++] = 2 * a + 1;
        }
        flow.assign(A, 0);
    }

    // directed residual view of adjacency entry x (x = 2a or 2a+1):
    //   forward (x even): u=tail, v=head, residual cap-flow, marg mc(f)
    //   backward (x odd): u=head, v=tail, residual flow, marg -mc(f-1)
    inline int32_t arc_of(int32_t x) const { return x >> 1; }
    inline bool is_fwd(int32_t x) const { return (x & 1) == 0; }
    inline int32_t to_of(int32_t x) const {
        int32_t a = x >> 1;
        return (x & 1) ? tail[a] : head[a];
    }
    inline int64_t resid_of(int32_t x) const {
        int32_t a = x >> 1;
        return (x & 1) ? flow[a] : cap[a] - flow[a];
    }
    inline int64_t marg_of(int32_t x) const {
        int32_t a = x >> 1;
        if (cost_off[a] < 0) return 0;  // constant-zero-cost (chain) arc
        if (x & 1) return -cost_pool[cost_off[a] + flow[a] - 1] * scale;
        return cost_pool[cost_off[a] + flow[a]] * scale;
    }
    // maximal admissible push on directed entry x given dp = p[u] - p[v]:
    // every pushed unit must individually have marginal rc < 0. Costs are
    // sorted, so the admissible units form a prefix (forward) / suffix
    // (backward) of the segment — found by binary search. Pushing the whole
    // prefix keeps the reverse marginals' rc > 0, preserving eps-optimality.
    inline int64_t adm_amount(int32_t x, int64_t dp) const {
        int32_t a = x >> 1;
        int64_t off = cost_off[a];
        if (off < 0) return INF64;  // constant-zero-cost: all residual units
        if (x & 1) {
            // backward: rc(k) = -mc[k]*scale + dp < 0  <=>  mc[k]*scale > dp
            // (a suffix of [0, flow) since mc is nondecreasing)
            int64_t f = flow[a];
            int64_t lo = 0, hi = f;
            while (lo < hi) {
                int64_t mid = (lo + hi) / 2;
                if (cost_pool[off + mid] * scale > dp) hi = mid;
                else lo = mid + 1;
            }
            return f - lo;
        }
        // forward: units k in [flow, k1) with mc[k]*scale < -dp
        int64_t f = flow[a], c = cap[a];
        int64_t lo = f, hi = c;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (cost_pool[off + mid] * scale < -dp) lo = mid + 1;
            else hi = mid;
        }
        return lo - f;
    }

    // Dial's bucket-queue Dijkstra state, reused across updates. Distances
    // (and arc lengths) are clamped to DMAX; clamping only *under*estimates
    // shortest distances, which preserves the d(u) <= d(v) + len(a)
    // consistency that eps-optimality needs — it can only make the price
    // decrease smaller, never wrong.
    static constexpr int32_t DMAX = 4095;
    std::vector<int32_t> dist_;
    std::vector<uint8_t> done_;
    std::vector<std::vector<int32_t>> buckets_;

    void price_update() {
        if (dist_.empty()) {
            dist_.assign(N, INT32_MAX);
            done_.assign(N, 0);
            buckets_.resize(DMAX + 1);
        }
        int64_t n_excess = 0, n_deficit = 0;
        for (int32_t u = 0; u < N; ++u) {
            done_[u] = 0;
            dist_[u] = INT32_MAX;
            if (excess[u] < 0) {
                dist_[u] = 0;
                buckets_[0].push_back(u);
                n_deficit++;
            } else if (excess[u] > 0) {
                n_excess++;
            }
        }
        if (n_deficit == 0 || n_excess == 0) {
            buckets_[0].clear();
            return;
        }
        n_updates++;
        // run to completion (no early exit): the final d's must satisfy
        // d(u) <= d(v) + len(a) for *every* residual arc, which a partial
        // Dijkstra cannot guarantee for its frontier
        int32_t dmax = 0;
        for (int32_t d = 0; d <= DMAX; ++d) {
            auto& bkt = buckets_[d];
            for (size_t bi = 0; bi < bkt.size(); ++bi) {  // bkt may grow
                int32_t v = bkt[bi];
                if (done_[v] || dist_[v] != d) continue;  // stale entry
                done_[v] = 1;
                n_dij_pops++;
                dmax = d;
                // incoming residual arcs of v: reverse x^1 of every
                // adjacency entry x incident to v pointing away from v
                for (int32_t k = csr_off[v]; k < csr_off[v + 1]; ++k) {
                    int32_t x = csr_ent[k];
                    int32_t xr = x ^ 1;  // directed entry (u -> v)
                    if (resid_of(xr) <= 0) continue;
                    int32_t u = to_of(x);  // == tail of xr
                    if (done_[u]) continue;
                    int64_t rc = marg_of(xr) + p[u] - p[v];
                    int64_t len = rc >= 0 ? rc / eps + 1 : (rc + 1) / eps;
                    int64_t nd = std::min<int64_t>(d + len, DMAX);
                    if (nd < dist_[u]) {
                        dist_[u] = (int32_t)nd;
                        buckets_[nd].push_back(u);
                    }
                }
            }
            bkt.clear();
        }
        for (int32_t d = 0; d <= DMAX; ++d) buckets_[d].clear();
        for (int32_t u = 0; u < N; ++u) {
            int64_t d = done_[u] ? dist_[u] : (int64_t)dmax + 1;
            if (d > 0) p[u] -= d * eps;
        }
        for (int32_t u = 0; u < N; ++u) cur[u] = csr_off[u];
    }

    bool refine_phase() {
        // restore eps-optimality: for each arc set flow so every unit with
        // negative marginal reduced cost is saturated and every unit with
        // positive one is empty (costs sorted -> the split is a prefix,
        // found by binary search)
        for (int32_t a = 0; a < A; ++a) {
            int64_t dp = p[tail[a]] - p[head[a]];
            int64_t off = cost_off[a], c = cap[a];
            if (off < 0) {  // constant-zero-cost arc
                int64_t f_new = dp < 0 ? c : (dp > 0 ? 0 : flow[a]);
                if (f_new != flow[a]) {
                    int64_t delta = f_new - flow[a];
                    excess[tail[a]] -= delta;
                    excess[head[a]] += delta;
                    flow[a] = f_new;
                }
                continue;
            }
            // f* = count of units with cost*scale + dp < 0
            int64_t lo = 0, hi = c;
            while (lo < hi) {
                int64_t mid = (lo + hi) / 2;
                if (cost_pool[off + mid] * scale + dp < 0) lo = mid + 1;
                else hi = mid;
            }
            int64_t f_lo = lo;  // saturate all negative-marginal units
            // units with zero reduced marginal may keep current flow
            int64_t f_new = std::min(std::max(flow[a], f_lo), c);
            // but any unit with positive marginal must be empty:
            // f_hi = count of units with cost*scale + dp <= 0
            lo = f_lo; hi = c;
            while (lo < hi) {
                int64_t mid = (lo + hi) / 2;
                if (cost_pool[off + mid] * scale + dp <= 0) lo = mid + 1;
                else hi = mid;
            }
            f_new = std::min(f_new, lo);
            if (f_new != flow[a]) {
                int64_t delta = f_new - flow[a];
                excess[tail[a]] -= delta;
                excess[head[a]] += delta;
                flow[a] = f_new;
            }
        }
        price_update();
        // FIFO discharge (measured better than highest-price-first here:
        // the chain + shortcut topology keeps FIFO waves short)
        std::deque<int32_t> active;
        std::vector<uint8_t> in_q(N, 0);
        for (int32_t u = 0; u < N; ++u)
            if (excess[u] > 0) { active.push_back(u); in_q[u] = 1; }

        const int64_t relabel_budget = 1 + N;
        int64_t relabels = 0;
        while (!active.empty()) {
            int32_t u = active.front();
            active.pop_front();
            in_q[u] = 0;
            while (excess[u] > 0) {
                if (cur[u] == csr_off[u + 1]) {
                    int64_t best = INT64_MIN;
                    for (int32_t k = csr_off[u]; k < csr_off[u + 1]; ++k) {
                        int32_t e = csr_ent[k];
                        if (resid_of(e) > 0)
                            best = std::max(best,
                                            p[to_of(e)] - marg_of(e) - eps);
                    }
                    if (best == INT64_MIN) return false;  // infeasible
                    p[u] = best;
                    cur[u] = csr_off[u];
                    n_relabels++;
                    if (++relabels >= relabel_budget) {
                        price_update();
                        relabels = 0;
                    }
                    continue;
                }
                int32_t x = csr_ent[cur[u]];
                int64_t dp = p[u] - p[to_of(x)];
                if (resid_of(x) > 0 && marg_of(x) + dp < 0) {
                    n_pushes++;
                    int64_t amt = std::min(
                        std::min(excess[u], resid_of(x)), adm_amount(x, dp));
                    int32_t a = arc_of(x);
                    flow[a] += is_fwd(x) ? amt : -amt;
                    excess[u] -= amt;
                    int32_t v = to_of(x);
                    excess[v] += amt;
                    if (excess[v] > 0 && !in_q[v]) {
                        active.push_back(v);
                        in_q[v] = 1;
                    }
                } else {
                    cur[u]++;
                }
            }
        }
        return true;
    }

    bool run(int64_t max_scaled_cost) {
        p.assign(N, 0);
        cur.assign(N, 0);
        eps = std::max<int64_t>(max_scaled_cost, 1);
        const int64_t alpha = 16;
        const bool stats = std::getenv("GD_MCMF_STATS") != nullptr;
        while (true) {
            eps = std::max<int64_t>(eps / alpha, 1);
            for (int32_t u = 0; u < N; ++u) cur[u] = csr_off[u];
            auto t0 = std::chrono::steady_clock::now();
            n_pushes = n_relabels = n_updates = n_dij_pops = 0;
            if (!refine_phase()) return false;
            if (stats) {
                double ms = std::chrono::duration<double, std::milli>(
                                std::chrono::steady_clock::now() - t0)
                                .count();
                std::fprintf(
                    stderr,
                    "[mcmf] eps=%lld phase=%.0fms pushes=%lld relabels=%lld "
                    "updates=%lld dij_pops=%lld\n",
                    (long long)eps, ms, (long long)n_pushes,
                    (long long)n_relabels, (long long)n_updates,
                    (long long)n_dij_pops);
            }
            if (eps == 1) break;
        }
        return true;
    }
};

// Successive shortest paths on the convex-arc graph. For this problem the
// total supply equals the positive variation of the capped-coverage target
// (a few thousand for flat targets, independent of read count), so SSP's
// O(F * Dijkstra) beats eps-scaling's repeated whole-graph refine phases by
// an order of magnitude on typical inputs. Potentials keep reduced
// marginals nonnegative (Johnson); each augmentation moves the full
// equal-marginal run along the path, so convexity is preserved.
struct ConvexSSP {
    ConvexCostScaling& g;  // reuse graph storage + accessors (eps unused)
    explicit ConvexSSP(ConvexCostScaling& s) : g(s) {}

    std::vector<int64_t> pi, dist;
    // generation stamps instead of per-augmentation O(N) clears: an entry
    // is valid only when its stamp equals the current generation
    std::vector<int32_t> dist_gen, done_gen;
    std::vector<int32_t> settled;
    // zero-length-edge fast path: nodes reached at exactly the current
    // popped distance (rc == 0 — the chain arcs and the zero-reduced-cost
    // corridor along established shortest paths) settle via this stack
    // with no heap traffic. On this line network most relaxations are
    // zero-length, so this removes the O(log n) factor from the dominant
    // Dijkstra cost (ROADMAP "QMCP engines": line-aware shortest paths).
    std::vector<int32_t> zstack;
    int32_t gen = 0;

    // forward residual units sharing the current marginal cost (the safe
    // augmentation amount on entry x)
    int64_t run_at_marginal(int32_t x) const {
        int32_t a = x >> 1;
        int64_t off = g.cost_off[a];
        if (off < 0)
            return g.resid_of(x);  // constant cost: whole residual
        if (x & 1) {
            int64_t f = g.flow[a];
            int64_t c = g.cost_pool[off + f - 1];
            int64_t lo = 0, hi = f - 1;
            while (lo < hi) {
                int64_t mid = (lo + hi) / 2;
                if (g.cost_pool[off + mid] == c) hi = mid;
                else lo = mid + 1;
            }
            return f - lo;
        }
        int64_t f = g.flow[a], cap = g.cap[a];
        int64_t c = g.cost_pool[off + f];
        int64_t lo = f, hi = cap;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (g.cost_pool[off + mid] == c) lo = mid + 1;
            else hi = mid;
        }
        return lo - f;
    }

    // --- primal-dual blocking-flow routing -------------------------------
    // After the potential update every supply->deficit shortest path is a
    // zero-reduced-cost corridor, and cost ties make that corridor a rich
    // subgraph (at production scale each cost class holds ~1e5 reads). The
    // r4 engine walked ONE path along the static Dijkstra parent forest and
    // gave up at the first changed marginal — measured: phases ==
    // augmentations == total supply, i.e. one full-line Dijkstra per unit
    // of flow (the VERDICT r4 #6 profile). This DFS instead routes a
    // blocking flow over the admissible subgraph (next-unit reduced
    // marginal == 0) with current-arc pointers, dead-node marking and
    // truncate-to-first-saturated-arc, so one Dijkstra serves as many units
    // as the corridor admits; the phase count becomes the number of
    // distinct shortest-path cost levels (measured: 50 phases -> ~3).
    //
    // Pushing only on rc == 0 arcs preserves the SSP invariant (the new
    // reverse unit has rc == 0, the next forward unit rc >= 0 by convexity),
    // so every routed unit rides a true shortest path and the flow stays
    // optimal for its value — the classical primal-dual argument.
    std::vector<int32_t> cur2;        // per-node current-arc pointer
    std::vector<uint8_t> dead_, onpath_;
    std::vector<int32_t> pstack_, nstack_;

    inline bool admissible_from(int32_t u, int32_t x) const {
        if (g.resid_of(x) <= 0) return false;
        return g.marg_of(x) + pi[u] - pi[g.to_of(x)] == 0;
    }

    // ---- line-sweep distance engine (opt-in: GD_SSP_DIST=sweep; the
    // per-phase Dijkstra stays the default — see the measured round-count
    // explosion note at the env check in run()) ------------------------
    //
    // The r4 profile (VERDICT #6): phases == augmentations == supply, one
    // full-line Dijkstra per unit of flow — 239.7 s at 25M reads. Layer
    // costs are strictly increasing on real data, so the phase count
    // cannot drop; the fix is making each phase's distance computation a
    // flat sequential scan instead of a heap traversal.
    //
    // Every residual arc family composes with the always-residual chain
    // arcs (i+1 -> i, zero cost) into "composite moves" relaxable inside
    // one directional pass over the line:
    //   L->R pass (positions ascending, Gauss-Seidel):
    //     - chain-up residuals (i -> i+1 where chainflow > 0): segmented
    //       running min of d + pi over positive-chainflow runs;
    //     - bucket-forward (s -> e+1) and shortcut-reverse (i -> i+st)
    //       arcs + trailing chain-downs: candidate d[tail] + marg + pi
    //       valid on (tail, tail+span]; per-span monotone deques (FIFO
    //       expiry within a span class) under a tournament-min tree.
    //   R->L pass (descending):
    //     - chain-downs alone: plain running min of d + pi;
    //     - bucket-backward refunds (e+1 -> s) + trailing chain-downs:
    //       running min, candidates anchored at s.
    // Rounds repeat until a full round improves nothing; the round count
    // equals the direction-alternation depth of the shortest paths
    // (measured 2-4), each pass O(n + B) with flat arrays and no heap.
    std::vector<int64_t> d_;
    std::vector<int32_t> ins_off_, ins_ids_;  // L->R candidates by position
    std::vector<int32_t> bkt_off_;            // buckets by tail (ids sorted)
    std::vector<int32_t> span_class_;
    std::vector<int64_t> class_span_;
    int32_t n_classes_ = 0;
    int32_t B_ = 0;  // bucket-arc count (prefix of g's arc array)
    struct DqEnt {
        int64_t v;
        int64_t p;
    };
    std::vector<std::vector<DqEnt>> dq_;
    std::vector<int32_t> dq_head_;
    std::vector<int64_t> tval_;  // tournament: node values
    std::vector<int32_t> targ_;  // tournament: argmin class per node
    int32_t P_ = 1;
    int64_t n_sweep_rounds_ = 0;

    void tour_update(int32_t c, int64_t v) {
        int32_t i = P_ + c;
        tval_[i] = v;
        targ_[i] = c;
        for (i >>= 1; i >= 1; i >>= 1) {
            int32_t l = 2 * i, r = 2 * i + 1;
            if (tval_[l] <= tval_[r]) {
                tval_[i] = tval_[l];
                targ_[i] = targ_[l];
            } else {
                tval_[i] = tval_[r];
                targ_[i] = targ_[r];
            }
        }
    }

    inline int64_t dq_front_val(int32_t c) const {
        return dq_head_[c] < (int32_t)dq_[c].size() ? dq_[c][dq_head_[c]].v
                                                    : INF64;
    }

    inline void dq_insert(int32_t c, int64_t v, int64_t p) {
        auto& q = dq_[c];
        while ((int32_t)q.size() > dq_head_[c] && q.back().v >= v)
            q.pop_back();
        bool was_front = (int32_t)q.size() == dq_head_[c];
        q.push_back({v, p});
        if (was_front) tour_update(c, v);
    }

    inline int64_t dq_query(int64_t j) {
        // global min over class fronts, popping expired fronts lazily
        // (front = oldest insert within its class -> earliest expiry)
        while (true) {
            int64_t v = tval_[1];
            if (v >= INF64) return INF64;
            int32_t c = targ_[1];
            const DqEnt& f = dq_[c][dq_head_[c]];
            if (f.p + class_span_[c] >= j) return v;
            dq_head_[c]++;
            tour_update(c, dq_front_val(c));
        }
    }

    bool sweep_init() {
        const int32_t N = g.N;
        const int64_t n = N - 1;
        B_ = 0;
        while (B_ < g.A && g.cost_off[B_] >= 0) B_++;
        // span classes over bucket + shortcut arcs
        constexpr int64_t SWEEP_MAX_SPAN = 1 << 16;
        int64_t max_span = 0;
        for (int32_t a = 0; a < B_; ++a)
            max_span = std::max<int64_t>(max_span, g.head[a] - g.tail[a]);
        if (max_span >= SWEEP_MAX_SPAN) return false;  // Dijkstra fallback
        span_class_.assign(max_span + 4097 + 1, -1);
        class_span_.clear();
        n_classes_ = 0;
        std::vector<int32_t> cand;  // bucket + shortcut arc ids
        cand.reserve(g.A - n);
        for (int32_t a = 0; a < B_; ++a) cand.push_back(a);
        for (int32_t a = B_ + (int32_t)n; a < g.A; ++a) cand.push_back(a);
        auto span_of = [&](int32_t a) -> int64_t {
            return a < B_ ? g.head[a] - g.tail[a] : g.tail[a] - g.head[a];
        };
        auto inspos_of = [&](int32_t a) -> int32_t {
            return a < B_ ? g.tail[a] : g.head[a];
        };
        for (int32_t a : cand) {
            int64_t s = span_of(a);
            if (s >= (int64_t)span_class_.size())
                span_class_.resize(s + 1, -1);
            if (span_class_[s] == -1) {
                span_class_[s] = n_classes_++;
                class_span_.push_back(s);
            }
        }
        P_ = 1;
        while (P_ < std::max(n_classes_, 1)) P_ <<= 1;
        tval_.assign(2 * P_, INF64);
        targ_.assign(2 * P_, 0);
        dq_.assign(n_classes_, {});
        dq_head_.assign(n_classes_, 0);
        // CSR of L->R candidates by insertion position
        ins_off_.assign(N + 1, 0);
        for (int32_t a : cand) ins_off_[inspos_of(a) + 1]++;
        for (int32_t j = 0; j < N; ++j) ins_off_[j + 1] += ins_off_[j];
        ins_ids_.resize(cand.size());
        {
            std::vector<int32_t> cur(ins_off_.begin(), ins_off_.end() - 1);
            for (int32_t a : cand) ins_ids_[cur[inspos_of(a)]++] = a;
        }
        // buckets by tail: ids are already tail-sorted by construction
        bkt_off_.assign(N + 1, 0);
        for (int32_t a = 0; a < B_; ++a) bkt_off_[g.tail[a] + 1]++;
        for (int32_t j = 0; j < N; ++j) bkt_off_[j + 1] += bkt_off_[j];
        d_.assign(N, INF64);
        return true;
    }

    bool sweep_pass_lr() {
        const int32_t N = g.N;
        // reset deques + tournament
        for (int32_t c = 0; c < n_classes_; ++c) {
            dq_[c].clear();
            dq_head_[c] = 0;
        }
        std::fill(tval_.begin(), tval_.end(), INF64);
        bool improved = false;
        int64_t cu = INF64;  // chain-up segmented running min of d + pi
        for (int32_t j = 0; j < N; ++j) {
            if (j > 0) {
                if (g.flow[B_ + (j - 1)] > 0) {
                    if (d_[j - 1] < INF64)
                        cu = std::min(cu, d_[j - 1] + pi[j - 1]);
                } else {
                    cu = INF64;
                }
            }
            int64_t best = std::min(cu, dq_query(j));
            if (best < INF64) {
                int64_t nd = best - pi[j];
                if (nd < d_[j]) {
                    d_[j] = nd;
                    improved = true;
                    if (cu < INF64) cu = std::min(cu, nd + pi[j]);
                }
            }
            if (d_[j] >= INF64) continue;
            int64_t base = d_[j] + pi[j];
            for (int32_t k = ins_off_[j]; k < ins_off_[j + 1]; ++k) {
                int32_t a = ins_ids_[k];
                if (a < B_) {
                    if (g.flow[a] >= g.cap[a]) continue;
                    int64_t v = base +
                                g.cost_pool[g.cost_off[a] + g.flow[a]] *
                                    g.scale;
                    dq_insert(span_class_[g.head[a] - g.tail[a]], v, j);
                } else {
                    if (g.flow[a] <= 0) continue;  // shortcut reverse
                    dq_insert(span_class_[g.tail[a] - g.head[a]], base, j);
                }
            }
        }
        return improved;
    }

    bool sweep_pass_rl() {
        const int32_t N = g.N;
        bool improved = false;
        int64_t cd = INF64;  // chain-down running min of d + pi
        int64_t bw = INF64;  // bucket-backward composite running min
        for (int32_t j = N - 1; j >= 0; --j) {
            if (j + 1 < N && d_[j + 1] < INF64)
                cd = std::min(cd, d_[j + 1] + pi[j + 1]);
            // backward refunds anchored at this tail position
            for (int32_t a = bkt_off_[j]; a < bkt_off_[j + 1]; ++a) {
                if (g.flow[a] <= 0) continue;
                int32_t h = g.head[a];
                if (d_[h] >= INF64) continue;
                int64_t v =
                    d_[h] -
                    g.cost_pool[g.cost_off[a] + g.flow[a] - 1] * g.scale +
                    pi[h];
                bw = std::min(bw, v);
            }
            int64_t best = std::min(cd, bw);
            if (best < INF64) {
                int64_t nd = best - pi[j];
                if (nd < d_[j]) {
                    d_[j] = nd;
                    improved = true;
                    cd = std::min(cd, nd + pi[j]);
                }
            }
        }
        return improved;
    }

    // exact distances from all active supplies into d_ (INF64 where
    // unreachable); returns rounds used
    int32_t sweep_distances() {
        const int32_t N = g.N;
        std::fill(d_.begin(), d_.end(), INF64);
        for (int32_t u = 0; u < N; ++u)
            if (g.excess[u] > 0) d_[u] = 0;
        int32_t rounds = 0;
        while (true) {
            rounds++;
            bool i1 = sweep_pass_lr();
            bool i2 = sweep_pass_rl();
            if (!i1 && !i2) break;
        }
        n_sweep_rounds_ += rounds;
        return rounds;
    }

    int64_t route_admissible() {
        const int32_t N = g.N;
        cur2.assign(N, -2);  // -2 = uninitialised (lazily set to csr_off)
        dead_.assign(N, 0);
        onpath_.assign(N, 0);
        int64_t routed = 0;
        for (int32_t s = 0; s < N; ++s) {
            if (g.excess[s] <= 0 || dead_[s]) continue;
            pstack_.clear();
            nstack_.clear();
            onpath_[s] = 1;
            int32_t v = s;
            while (true) {
                if (g.excess[v] < 0) {
                    // push along the stack; delta = min(endpoint excesses,
                    // equal-marginal runs along the path)
                    int64_t delta =
                        std::min(g.excess[s], -g.excess[v]);
                    for (int32_t x : pstack_)
                        delta = std::min(delta, run_at_marginal(x));
                    for (int32_t x : pstack_)
                        g.flow[x >> 1] += (x & 1) ? -delta : delta;
                    g.excess[s] -= delta;
                    g.excess[v] += delta;
                    routed += delta;
                    if (g.excess[s] == 0) {
                        for (int32_t u : nstack_) onpath_[u] = 0;
                        onpath_[s] = 0;
                        break;  // next supply
                    }
                    // truncate to the first arc the push made inadmissible
                    size_t k = 0;
                    int32_t u = s;
                    while (k < pstack_.size() &&
                           admissible_from(u, pstack_[k])) {
                        u = nstack_[k];
                        ++k;
                    }
                    for (size_t i = k; i < nstack_.size(); ++i)
                        onpath_[nstack_[i]] = 0;
                    pstack_.resize(k);
                    nstack_.resize(k);
                    v = u;
                    continue;
                }
                if (cur2[v] == -2) cur2[v] = g.csr_off[v];
                int32_t x = -1;
                while (cur2[v] < g.csr_off[v + 1]) {
                    int32_t e = g.csr_ent[cur2[v]];
                    int32_t w = g.to_of(e);
                    if (!dead_[w] && !onpath_[w] && admissible_from(v, e)) {
                        x = e;
                        break;
                    }
                    cur2[v]++;
                }
                if (x == -1) {
                    dead_[v] = 1;
                    if (v == s) {
                        onpath_[s] = 0;
                        break;  // supply exhausted its corridor
                    }
                    onpath_[v] = 0;
                    pstack_.pop_back();
                    nstack_.pop_back();
                    v = nstack_.empty() ? s : nstack_.back();
                } else {
                    int32_t w = g.to_of(x);
                    pstack_.push_back(x);
                    nstack_.push_back(w);
                    onpath_[w] = 1;
                    v = w;
                }
            }
        }
        return routed;
    }

    bool run() {
        const int32_t N = g.N;
        pi.assign(N, 0);
        int64_t excess_total = 0;
        for (int32_t u = 0; u < N; ++u)
            if (g.excess[u] > 0) excess_total += g.excess[u];
        const bool stats = std::getenv("GD_MCMF_STATS") != nullptr;
        auto t0 = std::chrono::steady_clock::now();
        int64_t n_phases = 0, n_aug = 0, supply0 = excess_total;

        // GD_SSP_DIST=sweep enables the directional-pass distance engine.
        // NOT the default: measured on 200k reads / 500 kb (2026-08-21),
        // its round count explodes with accumulated flow (2 rounds at
        // phase 1 -> 280+ by phase 28) because SSP shortest paths become
        // path-long exchange cascades alternating direction at every
        // bucket hop — the "pass count = few direction reversals" premise
        // holds only for the first flow layers. Kept for the low-flow
        // regime and as the measured record of why the ROADMAP r4 design
        // (block-sequential bidirectional Gauss-Seidel) cannot replace
        // the per-phase Dijkstra at depth.
        const char* de = std::getenv("GD_SSP_DIST");
        bool use_sweep = de && std::strcmp(de, "sweep") == 0;
        if (use_sweep) use_sweep = sweep_init();

        using QE = std::pair<int64_t, int32_t>;
        dist.assign(N, INF64);
        dist_gen.assign(N, -1);
        done_gen.assign(N, -1);
        auto dist_of = [&](int32_t u) {
            return dist_gen[u] == gen ? dist[u] : INF64;
        };
        std::vector<std::pair<int64_t, int32_t>> sinks;
        while (excess_total > 0) {
            n_phases++;
            gen++;
            if (stats && n_phases % 1000 == 0) {
                std::fprintf(stderr,
                             "[ssp] phase=%lld excess=%lld aug=%lld\n",
                             (long long)n_phases, (long long)excess_total,
                             (long long)n_aug);
            }
            if (use_sweep) {
                auto tp = std::chrono::steady_clock::now();
                int32_t rounds = sweep_distances();
                int64_t D = INF64;
                for (int32_t u = 0; u < N; ++u)
                    if (g.excess[u] < 0 && d_[u] < D) D = d_[u];
                if (D >= INF64) return false;  // no augmenting path
                if (D > 0)
                    for (int32_t u = 0; u < N; ++u)
                        pi[u] += std::min(d_[u], D);
                auto tr = std::chrono::steady_clock::now();
                int64_t moved = route_admissible();
                if (stats) {
                    auto te = std::chrono::steady_clock::now();
                    std::fprintf(
                        stderr,
                        "[ssp-sweep] phase=%lld rounds=%d D=%lld "
                        "moved=%lld dist_ms=%.0f route_ms=%.0f\n",
                        (long long)n_phases, rounds, (long long)D,
                        (long long)moved,
                        std::chrono::duration<double, std::milli>(tr - tp)
                            .count(),
                        std::chrono::duration<double, std::milli>(te - tr)
                            .count());
                }
                if (moved <= 0) return false;
                n_aug += moved;
                excess_total -= moved;
                continue;
            }
            // Phase: ONE multi-source Dijkstra (on reduced marginal
            // costs, >= 0 by invariant), then route as many endpoints as
            // the parent forest still admits. The parent forest carries
            // exactly one path per NON-ROOT endpoint, so the Dijkstra is
            // rooted at the SMALLER endpoint side: many supplies feeding
            // few deficits run the reverse (deficit-rooted) search and
            // each supply gets its own path — the difference between
            // hours and minutes at chr1 scale (VERDICT round-1 item 10;
            // ROADMAP "QMCP engines").
            int64_t n_exc = 0, n_def = 0;
            for (int32_t u = 0; u < N; ++u) {
                n_exc += g.excess[u] > 0;
                n_def += g.excess[u] < 0;
            }
            if (n_exc >= n_def) {
                // --- reverse phase: roots at deficits (the smaller side)
                std::priority_queue<QE, std::vector<QE>, std::greater<QE>>
                    pq;
                for (int32_t u = 0; u < N; ++u)
                    if (g.excess[u] < 0) {
                        dist[u] = 0;
                        dist_gen[u] = gen;
                        pq.push({0, u});
                    }
                settled.clear();
                sinks.clear();  // here: sources, nearest-first
                zstack.clear();
                int64_t found = 0;
                auto settle_rev = [&](int64_t d, int32_t w) -> bool {
                    done_gen[w] = gen;
                    settled.push_back(w);
                    if (g.excess[w] > 0) {
                        sinks.push_back({d, w});
                        found += g.excess[w];
                        if (found >= excess_total) return true;
                    }
                    for (int32_t k = g.csr_off[w]; k < g.csr_off[w + 1];
                         ++k) {
                        int32_t x = g.csr_ent[k];
                        int32_t xr = x ^ 1;  // arc (v -> w)
                        if (g.resid_of(xr) <= 0) continue;
                        int32_t v = g.to_of(x);
                        if (done_gen[v] == gen) continue;
                        int64_t rc = g.marg_of(xr) + pi[v] - pi[w];
                        int64_t nd = d + (rc > 0 ? rc : 0);
                        if (nd < dist_of(v)) {
                            dist[v] = nd;
                            dist_gen[v] = gen;
                            // nd == d settles heap-free at this level
                            if (nd == d) zstack.push_back(v);
                            else pq.push({nd, v});
                        }
                    }
                    return false;
                };
                bool stop = false;
                while (!pq.empty() && !stop) {
                    auto [d, w] = pq.top();
                    pq.pop();
                    if (done_gen[w] == gen) continue;
                    stop = settle_rev(d, w);
                    while (!zstack.empty() && !stop) {
                        int32_t v = zstack.back();
                        zstack.pop_back();
                        if (done_gen[v] == gen) continue;
                        stop = settle_rev(d, v);
                    }
                }
                if (sinks.empty()) return false;  // no augmenting path
                const int64_t D = sinks.back().first;
                for (int32_t u : settled)
                    pi[u] += D - std::min(dist[u], D);
            } else {
                // --- forward phase: roots at supplies ---------------------
                std::priority_queue<QE, std::vector<QE>, std::greater<QE>>
                    pq;
                for (int32_t u = 0; u < N; ++u)
                    if (g.excess[u] > 0) {
                        dist[u] = 0;
                        dist_gen[u] = gen;
                        pq.push({0, u});
                    }
                settled.clear();
                sinks.clear();
                zstack.clear();
                int64_t deficit_found = 0;
                const int64_t want = excess_total;
                auto settle_fwd = [&](int64_t d, int32_t u) -> bool {
                    done_gen[u] = gen;
                    settled.push_back(u);
                    if (g.excess[u] < 0) {
                        sinks.push_back({d, u});
                        deficit_found -= g.excess[u];
                        // enough deficit endpoints to absorb all excess:
                        // the rest of the line cannot shorten a found path
                        if (deficit_found >= want) return true;
                    }
                    for (int32_t k = g.csr_off[u]; k < g.csr_off[u + 1];
                         ++k) {
                        int32_t x = g.csr_ent[k];
                        if (g.resid_of(x) <= 0) continue;
                        int32_t v = g.to_of(x);
                        if (done_gen[v] == gen) continue;
                        int64_t rc = g.marg_of(x) + pi[u] - pi[v];
                        // rc >= 0 modulo clamping noise; guard for safety
                        int64_t nd = d + (rc > 0 ? rc : 0);
                        if (nd < dist_of(v)) {
                            dist[v] = nd;
                            dist_gen[v] = gen;
                            if (nd == d) zstack.push_back(v);
                            else pq.push({nd, v});
                        }
                    }
                    return false;
                };
                bool stop = false;
                while (!pq.empty() && !stop) {
                    auto [d, u] = pq.top();
                    pq.pop();
                    if (done_gen[u] == gen) continue;
                    stop = settle_fwd(d, u);
                    while (!zstack.empty() && !stop) {
                        int32_t v = zstack.back();
                        zstack.pop_back();
                        if (done_gen[v] == gen) continue;
                        stop = settle_fwd(d, v);
                    }
                }
                if (sinks.empty()) return false;  // no augmenting path
                // potentials: pi[u] += dist[u] - D for settled nodes, where
                // D is the LAST settled distance (every found sink then has
                // an rc == 0 corridor; unsettled nodes keep pi, consistent
                // because their dist >= D). The constant D cancels in
                // reduced-cost differences.
                const int64_t D = sinks.back().first;
                for (int32_t u : settled)
                    pi[u] += std::min(dist[u], D) - D;
            }
            // blocking-flow routing over the zero-rc corridor (direction-
            // independent: admissibility is symmetric under the updated pi)
            int64_t moved = route_admissible();
            if (moved <= 0) return false;  // should be impossible: the
            // first DFS walk precedes any push and the corridor is fresh
            n_aug += moved;
            excess_total -= moved;
        }
        if (stats) {
            double ms = std::chrono::duration<double, std::milli>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
            std::fprintf(stderr,
                         "[mcmf-ssp] supply=%lld phases=%lld "
                         "units_routed=%lld sweep_rounds=%lld "
                         "engine=%s total=%.0fms\n",
                         (long long)supply0, (long long)n_phases,
                         (long long)n_aug, (long long)n_sweep_rounds_,
                         use_sweep ? "sweep" : "dijkstra", ms);
        }
        return true;
    }
};

// Build + solve. Buckets: distinct (start, end) with sorted per-unit costs
// pool[off[b] .. off[b+1]). flows[b] = selected units. Returns false on
// invalid/infeasible input.
bool solve_convex(
    const int64_t* bstart, const int64_t* bend, const int64_t* off,
    const int64_t* pool, int64_t B, int64_t n, int64_t max_coverage,
    int64_t* flows) {
    for (int64_t b = 0; b < B; ++b) {
        if (bstart[b] < 0 || bend[b] >= n || bend[b] < bstart[b]) return false;
        if (off[b + 1] <= off[b]) return false;
        for (int64_t k = off[b]; k < off[b + 1]; ++k) {
            if (pool[k] < 0) return false;
            if (k > off[b] && pool[k] < pool[k - 1]) return false;  // unsorted
        }
    }

    // the engine indexes nodes/arcs with int32; reject inputs that overflow
    if (n + 1 > INT32_MAX) return false;

    ConvexCostScaling s;
    s.N = (int32_t)(n + 1);  // nodes 0..n
    // hierarchical chain shortcuts: zero-cost arcs i+st -> i at strides
    // 16/256/4096. Each is a composition of chain arcs with the same (zero)
    // cost and non-binding capacity, so the optimum is unchanged — but
    // excess now travels the coordinate line in O(log n) hops instead of
    // one node at a time (the dominant push count otherwise)
    std::vector<int64_t> strides;
    for (int64_t st = 16; st < n; st *= 16) strides.push_back(st);
    int64_t n_skip = 0;
    for (int64_t st : strides) n_skip += n / st;
    if (B + n + n_skip > INT32_MAX) return false;
    s.A = (int32_t)(B + n + n_skip);
    s.scale = (int64_t)s.N;

    // capped coverage -> node supplies (create_demand_function semantics,
    // quasi_mcp_cpu_max_flow_solver.cpp:58-87), weighted by capacities
    std::vector<int64_t> bcov(n + 2, 0);
    int64_t total_cap = 0;
    for (int64_t b = 0; b < B; ++b) {
        int64_t c = off[b + 1] - off[b];
        bcov[bstart[b] + 1] += c;
        bcov[bend[b] + 2] -= c;
        total_cap += c;
    }
    for (int64_t j = 1; j <= n; ++j) bcov[j] += bcov[j - 1];
    for (int64_t j = 0; j <= n; ++j) bcov[j] = std::min(bcov[j], max_coverage);
    s.excess.assign(s.N, 0);  // supply = -demand
    s.excess[0] = bcov[1];
    for (int64_t i = 1; i < n; ++i) s.excess[i] = -(bcov[i] - bcov[i + 1]);
    s.excess[n] = -bcov[n];

    s.tail.resize(s.A);
    s.head.resize(s.A);
    s.cap.resize(s.A);
    s.cost_off.resize(s.A);
    const int64_t chain_cap =
        (max_coverage > 0 ? 100 * max_coverage : 1) + total_cap;
    s.cost_pool.assign(pool, pool + off[B]);
    int64_t max_c = 0;
    for (int64_t b = 0; b < B; ++b) {
        s.tail[b] = (int32_t)bstart[b];
        s.head[b] = (int32_t)(bend[b] + 1);
        s.cap[b] = off[b + 1] - off[b];
        s.cost_off[b] = off[b];
        max_c = std::max(max_c, pool[off[b + 1] - 1]);
    }
    // chain arcs i+1 -> i: constant zero cost (cost_off = -1 sentinel)
    for (int64_t i = 0; i < n; ++i) {
        int32_t a = (int32_t)(B + i);
        s.tail[a] = (int32_t)(i + 1);
        s.head[a] = (int32_t)i;
        s.cap[a] = chain_cap;
        s.cost_off[a] = -1;
    }
    int64_t a_next = B + n;
    for (int64_t st : strides)
        for (int64_t i = 0; i + st <= n; i += st) {
            int32_t a = (int32_t)a_next++;
            s.tail[a] = (int32_t)(i + st);
            s.head[a] = (int32_t)i;
            s.cap[a] = chain_cap;
            s.cost_off[a] = -1;
        }
    s.finish_graph();

    // engine dispatch: SSP cost is O(total_supply * Dijkstra) — total
    // supply is the positive variation of the capped target, typically a
    // few thousand regardless of read count — while cost-scaling refines
    // the whole graph log(C*N) times. Use SSP unless the supply is large
    // (oscillating targets). GD_MCMF_ENGINE=scale|ssp overrides.
    int64_t pos_supply = 0;
    for (int32_t u = 0; u < s.N; ++u)
        if (s.excess[u] > 0) pos_supply += s.excess[u];
    const char* eng = std::getenv("GD_MCMF_ENGINE");
    bool use_ssp = eng ? std::strcmp(eng, "ssp") == 0
                       : pos_supply <= 200000;
    if (use_ssp) {
        ConvexSSP ssp(s);
        if (!ssp.run()) return false;
    } else {
        if (!s.run(max_c * s.scale)) return false;
    }
    for (int64_t b = 0; b < B; ++b) flows[b] = s.flow[b];
    return true;
}

}  // namespace

extern "C" {

// Convex bucket interface: buckets = distinct (start, end); pool holds each
// bucket's per-unit costs sorted ascending, segmented by off (size B+1).
// flows[b] (caller-allocated) gets the number of selected units (the
// bucket's cheapest). Returns 0, or -1 on error.
int64_t gd_qmcp_mcmf_convex(
    const int64_t* bstart, const int64_t* bend, const int64_t* off,
    const int64_t* pool, int64_t B, int64_t n, int64_t max_coverage,
    int64_t* flows) {
    if (B == 0) return 0;
    return solve_convex(bstart, bend, off, pool, B, n, max_coverage, flows)
               ? 0
               : -1;
}

// Capacitated bucket interface (kept for compatibility/tests): one cost per
// bucket. flows[i] gets selected units on bucket arc i.
int64_t gd_qmcp_mcmf_flows(
    const int64_t* start, const int64_t* end, const int64_t* cost_in,
    const int64_t* cap_in, int64_t A, int64_t n, int64_t max_coverage,
    int64_t* flows) {
    if (A == 0) return 0;
    // expand to the convex interface: each bucket's pool = cap copies of
    // its cost (already "sorted")
    std::vector<int64_t> off(A + 1, 0);
    for (int64_t i = 0; i < A; ++i) {
        if (cap_in[i] <= 0) return -1;
        off[i + 1] = off[i] + cap_in[i];
    }
    std::vector<int64_t> pool(off[A]);
    for (int64_t i = 0; i < A; ++i)
        std::fill(pool.begin() + off[i], pool.begin() + off[i + 1],
                  cost_in[i]);
    return solve_convex(start, end, off.data(), pool.data(), A, n,
                        max_coverage, flows)
               ? 0
               : -1;
}

// Per-read interface (kept for compatibility): returns selected count
// (>=0) with *out_sel = malloc'd ascending indices, or -1 on error.
int64_t gd_qmcp_mcmf(
    const int64_t* start, const int64_t* end, const int64_t* cost_in,
    int64_t R, int64_t n, int64_t max_coverage, int64_t** out_sel) {
    *out_sel = nullptr;
    if (R == 0) {
        *out_sel = static_cast<int64_t*>(std::malloc(1));
        return 0;
    }
    std::vector<int64_t> caps(R, 1), flows(R, 0);
    if (gd_qmcp_mcmf_flows(start, end, cost_in, caps.data(), R, n,
                           max_coverage, flows.data()) != 0)
        return -1;
    std::vector<int64_t> sel;
    sel.reserve(R / 4);
    for (int64_t i = 0; i < R; ++i)
        if (flows[i] > 0) sel.push_back(i);
    int64_t* out = static_cast<int64_t*>(std::malloc(
        sizeof(int64_t) * std::max<int64_t>((int64_t)sel.size(), 1)));
    std::memcpy(out, sel.data(), sel.size() * sizeof(int64_t));
    *out_sel = out;
    return (int64_t)sel.size();
}

}  // extern "C"
