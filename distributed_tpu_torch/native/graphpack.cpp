// graphpack: the O(T+E) host pack of a task graph for the level-synchronous
// placement engine (distributed_tpu_torch/ops/leveled.py).
//
// The port's own copy of the reference package's C++ pack.  One pass
// computes topological levels, the two heaviest dependencies of every task
// and its transfer costs, all in (level, index) order, so each wave of the
// engine is a contiguous slice of the sorted arrays and the device needs no
// dependency edges and no indegree bookkeeping.
//
// Entry points (plain C, loaded with ctypes by native/__init__.py):
//   graphpack_full     topology and row fill in one call (pack_graph);
//   graphpack_topo     the serial topology phase of the streamed driver;
//   graphpack_fill     rows [i0, i1) of the sorted arrays (the streamed
//                      driver's filler thread calls it chunk by chunk);
//   unpack_assignment  downloaded (assign+1)*4+choice codes back into
//                      original task order.
//
// The heaviest-dependency choice mirrors decide_worker's candidate set
// (the holders of a task's dependencies) and dep_total its missing-bytes
// term.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Returns the number of levels (>=0) on success, -1 if the graph has a
// cycle (some tasks never became ready).  All output buffers are
// caller-allocated with length T (offsets: T+1).
//
//   level[t]     topological level of task t (0 = no dependencies)
//   perm[i]      original index of the i-th task in (level, index) order
//   heavy[t]     dependency of t with the largest out_bytes (-1 if none;
//                ties broken toward the lowest source index)
//   heavy2[t]    second-largest dependency by out_bytes (-1 if <2 deps)
//   dep_total[t] sum of out_bytes over t's dependencies
//   offsets[l]   start of level l in perm; offsets[n_levels] == T
//   indeg_out[t] number of dependencies of t (may be null)
//   inv[t]       sorted position of task t (may be null)
static int64_t topo_core(
    int64_t T, int64_t E,
    const float* out_bytes,
    const int32_t* src, const int32_t* dst,
    int32_t* level, int32_t* perm, int32_t* heavy, int32_t* heavy2,
    float* dep_total, int32_t* offsets,
    int32_t* indeg_out, int32_t* inv)
{
    if (T <= 0) return 0;

    std::vector<int32_t> indeg(T, 0);
    // int32 CSR: E < 2^31 by construction (int32 edge indices), and the
    // peel is memory-bound
    std::vector<int32_t> outptr(T + 1, 0);

    // The edge reductions split into two independent halves: the HEAVY
    // half (top-2 heaviest deps and dependency byte totals, read only by
    // the row fill) and the TOPOLOGY half (indegree and CSR counts, read
    // by the Kahn peel).  On a multi-core host the heavy half runs on a
    // second thread while this one goes on into the CSR fill and the peel;
    // the join happens at return.  Both halves scan the edges in the same
    // order, so ties and sums are bit-identical to the sequential pass.
    auto heavy_pass = [&]() {
        std::vector<float> heavy_bytes(T, -1.0f);
        std::vector<float> heavy2_bytes(T, -1.0f);
        for (int64_t t = 0; t < T; ++t) {
            heavy[t] = -1;
            heavy2[t] = -1;
            dep_total[t] = 0.0f;
        }
        for (int64_t e = 0; e < E; ++e) {
            int32_t s = src[e], d = dst[e];
            if (s < 0 || s >= T || d < 0 || d >= T || s == d) continue;
            float b = out_bytes[s];
            dep_total[d] += b;
            if (b > heavy_bytes[d] || (b == heavy_bytes[d] && s < heavy[d])) {
                heavy2_bytes[d] = heavy_bytes[d];
                heavy2[d] = heavy[d];
                heavy_bytes[d] = b;
                heavy[d] = s;
            } else if (b > heavy2_bytes[d]
                       || (b == heavy2_bytes[d] && s < heavy2[d])) {
                heavy2_bytes[d] = b;
                heavy2[d] = s;
            }
        }
    };
    std::thread heavy_thread;
    bool threaded =
        E >= (int64_t)1 << 18 && std::thread::hardware_concurrency() > 1;
    if (threaded) {
        heavy_thread = std::thread(heavy_pass);
    } else {
        heavy_pass();
    }

    for (int64_t t = 0; t < T; ++t) level[t] = -1;
    for (int64_t e = 0; e < E; ++e) {
        int32_t s = src[e], d = dst[e];
        if (s < 0 || s >= T || d < 0 || d >= T || s == d) continue;
        indeg[d] += 1;
        outptr[s + 1] += 1;
    }
    if (indeg_out != nullptr)
        std::memcpy(indeg_out, indeg.data(), T * sizeof(int32_t));

    // CSR out-adjacency fill (the second and last edge pass)
    for (int64_t t = 0; t < T; ++t) outptr[t + 1] += outptr[t];
    std::vector<int32_t> outadj(outptr[T]);
    {
        std::vector<int32_t> fill(outptr.begin(), outptr.end() - 1);
        for (int64_t e = 0; e < E; ++e) {
            int32_t s = src[e], d = dst[e];
            if (s < 0 || s >= T || d < 0 || d >= T || s == d) continue;
            outadj[fill[s]++] = d;
        }
    }

    // Kahn's algorithm, level-synchronous.  The order inside a frontier
    // does not change the levels, so no per-level sort: the stable
    // (level, original index) permutation comes from one counting sort
    // over the levels afterwards.
    std::vector<int32_t> frontier, next;
    frontier.reserve(T);
    next.reserve(T);
    for (int64_t t = 0; t < T; ++t)
        if (indeg[t] == 0) frontier.push_back((int32_t)t);

    int64_t placed = 0, n_levels = 0;
    while (!frontier.empty()) {
        for (int32_t t : frontier) level[t] = (int32_t)n_levels;
        placed += (int64_t)frontier.size();
        next.clear();
        for (int32_t t : frontier)
            for (int32_t j = outptr[t]; j < outptr[t + 1]; ++j)
                if (--indeg[outadj[j]] == 0) next.push_back(outadj[j]);
        frontier.swap(next);
        ++n_levels;
    }
    if (placed != T) {  // cycle
        if (heavy_thread.joinable()) heavy_thread.join();
        return -1;
    }

    // counting sort by level; scanning tasks in ascending original index
    // keeps the order inside a level stable
    std::vector<int64_t> fill(n_levels + 1, 0);
    for (int64_t t = 0; t < T; ++t) fill[level[t] + 1] += 1;
    for (int64_t l = 0; l < n_levels; ++l) fill[l + 1] += fill[l];
    for (int64_t l = 0; l <= n_levels; ++l) offsets[l] = (int32_t)fill[l];
    for (int64_t t = 0; t < T; ++t) perm[fill[level[t]]++] = (int32_t)t;
    if (inv != nullptr)
        for (int64_t i = 0; i < T; ++i) inv[perm[i]] = (int32_t)i;
    if (heavy_thread.joinable()) heavy_thread.join();
    return n_levels;
}

// Streamed phase 1: topology only.  Emits what the driver needs to plan
// the waves and allocate the device buffers (level, perm, offsets) and the
// original-order reductions the fill consumes (heavy, heavy2, dep_total,
// indeg) with the inverse permutation.  Returns n_levels, -1 on a cycle.
// All buffers caller-allocated, length T (offsets: T+1).
int64_t graphpack_topo(
    int64_t T, int64_t E,
    const float* out_bytes,
    const int32_t* src, const int32_t* dst,
    int32_t* level, int32_t* perm, int32_t* offsets,
    int32_t* heavy, int32_t* heavy2, float* dep_total,
    int32_t* indeg, int32_t* inv)
{
    return topo_core(T, E, out_bytes, src, dst, level, perm, heavy, heavy2,
                     dep_total, offsets, indeg, inv);
}

// Streamed phase 2: sorted rows [i0, i1) of the arrays the waves read.
//   dur_s[i]    duration of sorted task i
//   heavy_s[i]  heaviest dep of sorted task i as a SORTED index (-1 none)
//   heavy2_s[i] second-heaviest dep as a SORTED index (-1 none)
//   xp_s[i]     transfer seconds if co-located with the heavy dep
//   xp2_s[i]    transfer seconds if co-located with the 2nd-heaviest dep
//   xa_s[i]     transfer seconds if placed anywhere else
// ``latency`` is the per-remote-dependency round trip: co-location with a
// dependency saves one; any other placement pays one per dependency.
void graphpack_fill(
    int64_t i0, int64_t i1,
    const float* durations, const float* out_bytes,
    const int32_t* perm, const int32_t* inv,
    const int32_t* heavy, const int32_t* heavy2,
    const float* dep_total, const int32_t* indeg,
    double inv_bandwidth, double latency,
    float* dur_s, int32_t* heavy_s, int32_t* heavy2_s,
    float* xp_s, float* xp2_s, float* xa_s)
{
    float ibw = (float)inv_bandwidth;
    float lat = (float)latency;
    for (int64_t i = i0; i < i1; ++i) {
        int32_t t = perm[i];
        dur_s[i] = durations[t];
        int32_t h = heavy[t];
        int32_t h2 = heavy2[t];
        heavy_s[i] = h >= 0 ? inv[h] : -1;
        heavy2_s[i] = h2 >= 0 ? inv[h2] : -1;
        float hb = h >= 0 ? out_bytes[h] : 0.0f;
        float h2b = h2 >= 0 ? out_bytes[h2] : 0.0f;
        float deg = (float)indeg[t];
        float extra = lat * (deg > 1.0f ? deg - 1.0f : 0.0f);
        xa_s[i] = dep_total[t] * ibw + lat * deg;
        xp_s[i] = (dep_total[t] - hb) * ibw + extra;
        xp2_s[i] = (dep_total[t] - h2b) * ibw + extra;
    }
}

// The whole pack in one call: topology, then every row.  level/perm/
// offsets as in graphpack_topo, the row arrays as in graphpack_fill.
int64_t graphpack_full(
    int64_t T, int64_t E,
    const float* durations, const float* out_bytes,
    const int32_t* src, const int32_t* dst,
    double inv_bandwidth, double latency,
    int32_t* level, int32_t* perm, int32_t* offsets,
    float* dur_s, int32_t* heavy_s, int32_t* heavy2_s,
    float* xp_s, float* xp2_s, float* xa_s)
{
    std::vector<int32_t> heavy(T), heavy2(T), indeg(T), inv(T);
    std::vector<float> dep_total(T);
    int64_t n_levels = graphpack_topo(
        T, E, out_bytes, src, dst, level, perm, offsets,
        heavy.data(), heavy2.data(), dep_total.data(),
        indeg.data(), inv.data());
    if (n_levels < 0) return -1;
    graphpack_fill(0, T, durations, out_bytes, perm, inv.data(),
                   heavy.data(), heavy2.data(), dep_total.data(),
                   indeg.data(), inv_bandwidth, latency,
                   dur_s, heavy_s, heavy2_s, xp_s, xp2_s, xa_s);
    return n_levels;
}

// The downloaded codes back into original task order, one sweep:
//   codes[i] = (assign_sorted[i] + 1) * 4 + choice_sorted[i]
void unpack_assignment(
    int64_t T,
    const int32_t* codes, const int32_t* perm,
    int32_t* assignment, int8_t* choice)
{
    for (int64_t i = 0; i < T; ++i) {
        int32_t v = codes[i];
        int32_t t = perm[i];
        assignment[t] = v / 4 - 1;
        choice[t] = (int8_t)(v & 3);
    }
}

}  // extern "C"
