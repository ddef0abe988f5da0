// Native SoA transition core for the scheduler's four dominant arms
// (docs/native_engine.md).  Built on demand by native/__init__.py with
// g++ -O3 (NO -ffast-math: the doubles here must round exactly like
// CPython's) and driven through ctypes by scheduler/native_engine.py.
//
// Division of labor (the bit-identity argument):
//
//   - this core owns the DECISIONS and the drain CONTROL FLOW: which
//     transitions run in what order (an ordered rec-dict with exact
//     CPython dict.popitem semantics), which worker a task lands on
//     (worker_objective / comm cost, evaluated in the same IEEE op
//     order as state.py — no -ffast-math, no reassociation), the
//     occupancy float bookkeeping, and the idle/saturated membership
//     flips;
//   - the python bridge replays the emitted TAPE onto the real
//     TaskState/WorkerState objects — every relation mutation in the
//     same order the scalar oracle would perform it (the relation
//     fields are insertion-ordered OrderedSets, so "same order" is
//     well-defined and this core mirrors it with plain vectors), and
//     every message/story/ledger row is built from python truth;
//   - anything an arm needs that this core does not model ESCAPES to
//     the python oracle per key: the drain stops at a transition
//     boundary, hands back the tape so far plus the pending rec-dict,
//     and the bridge finishes that event with the real
//     _transition/_transitions.
//
// The compiled arm set (kept a subset of the extracted scheduler table
// by graft-lint rule "state-machine", which reads COMPILED_ARMS in
// native_engine.py):
//
//   (released, waiting)    -> arm_rw
//   (waiting, processing)  -> arm_wp   (non-rootish locality path only)
//   (processing, memory)   -> arm_pm
//   (memory, released)     -> arm_mr

#include <cstdint>
#include <cmath>
#include <string>
#include <vector>
#include <unordered_map>
#include <algorithm>

namespace {

enum State : uint8_t {
    S_RELEASED = 0, S_WAITING = 1, S_NO_WORKER = 2, S_QUEUED = 3,
    S_PROCESSING = 4, S_MEMORY = 5, S_ERRED = 6, S_FORGOTTEN = 7,
};

enum Flag : uint8_t {
    F_ACTOR = 1, F_RESTRICTED = 2, F_NO_RUNSPEC = 4, F_BLAMED = 8,
    F_LONG_RUNNING = 16,
};

enum WStatus : uint8_t { W_RUNNING = 0, W_CLOSED = 5 };

// tape opcodes (mirrored by native_engine.py)
enum Op : int32_t {
    OP_FREEKEYS_STALE = 0,  // a = event index
    OP_ADD_REPLICA = 1,     // a = task row, b = worker slot (memory dup)
    OP_PM = 2,              // a = task, b = worker, c = event index
    OP_WP = 3,              // a = task, b = worker, c = flags (bit0:
                            //   register unknown-duration), f1 = duration,
                            //   f2 = comm
    OP_MR = 4,              // a = task
    OP_RW = 5,              // a = task
    OP_FLIP = 6,            // a = worker, b = set (0 idle, 1
                            //   idle_task_count, 2 saturated), c = add
    OP_META = 7,            // a = task, c = event index: misrouted
                            //   completion — the oracle pops metadata
                            //   before its worker guard drops the event
};

enum Status : int32_t { R_DONE = 0, R_ESCAPE = 1, R_TAPE_FULL = 2 };

// escape reasons (the dtpu_engine_native_escapes_total breakdown and
// the tests' escape-taxonomy assertions)
enum EscapeWhy : int32_t {
    E_UNCOMPILED_EDGE = 0,
    E_ACTOR = 1,
    E_RESTRICTED = 2,
    E_ROOTISH = 3,
    E_PLACEMENT_EXT = 4,
    E_BARE_DEP = 5,
    E_NO_WORKER = 6,
    E_FORGOTTEN_DEP = 7,
    E_EVENT_SHAPE = 8,
};

// worst-case tape rows one transition can emit (arm row + membership
// flips); headroom is checked at transition boundaries only, so an arm
// body never half-applies
constexpr int64_t TAPE_MARGIN = 16;

struct Task {
    uint8_t live = 0;
    uint8_t state = S_RELEASED;
    uint8_t flags = 0;
    int32_t prefix = -1;
    int32_t group = -1;
    int64_t nbytes = -1;
    int32_t processing_on = -1;
    int32_t who_wants = 0;
    int32_t waiting_count = 0;
    double occ_contrib = 0.0;          // value parked in ws.processing[ts]
    std::vector<int32_t> deps;         // insertion-ordered (OrderedSet)
    std::vector<uint8_t> dep_waiting;  // parallel: dep in ts.waiting_on
    std::vector<int32_t> dependents;
    std::vector<int32_t> waiters;      // ordered subset of dependents
    std::vector<int32_t> who_has;      // ordered worker slots
};

struct Worker {
    uint8_t live = 0;
    uint8_t status = W_RUNNING;
    uint8_t idle = 0, idle_tc = 0, saturated = 0;
    int32_t nthreads = 1;
    int64_t nbytes = 0;
    double occupancy = 0.0;
    int32_t nprocessing = 0;
    std::string address;
};

struct Prefix { double avg = -1.0; };

struct Group {
    int64_t n_tasks = 0;
    std::vector<int32_t> deps;  // dep group ids
};

// Ordered rec-dict with CPython dict semantics: update-in-place keeps
// position, popitem pops the LAST live entry, re-insert after a pop
// appends at the end.
struct RecDict {
    std::vector<std::pair<int32_t, int32_t>> entries;  // (row, target)
    std::unordered_map<int32_t, int32_t> pos;

    void set(int32_t row, int32_t target) {
        auto it = pos.find(row);
        if (it != pos.end()) { entries[it->second].second = target; return; }
        pos[row] = (int32_t)entries.size();
        entries.emplace_back(row, target);
    }
    bool pop(int32_t *row, int32_t *target) {
        while (!entries.empty()) {
            auto &e = entries.back();
            if (pos.count(e.first) && pos[e.first]
                    == (int32_t)entries.size() - 1) {
                *row = e.first; *target = e.second;
                pos.erase(e.first);
                entries.pop_back();
                return true;
            }
            entries.pop_back();  // tombstone (superseded position)
        }
        return false;
    }
    bool empty() const { return pos.empty(); }
    void clear() { entries.clear(); pos.clear(); }
};

struct Engine {
    std::vector<Task> tasks;
    std::vector<Worker> workers;
    std::vector<Prefix> prefixes;
    std::vector<Group> groups;

    // params, refreshed at each segment start (eng_params)
    double bandwidth = 1.0;
    double latency = 0.0;
    double unknown_duration = 0.5;
    double saturation = 1.1;  // +inf allowed
    double total_occupancy = 0.0;
    int64_t total_nthreads = 0;
    int32_t n_live = 0;
    int32_t n_running = 0;
    uint8_t placement_attached = 0;

    RecDict recs;

    // tape (borrowed bridge buffers, set per segment)
    int32_t *t_op = nullptr, *t_a = nullptr, *t_b = nullptr,
            *t_c = nullptr;
    double *t_f1 = nullptr, *t_f2 = nullptr;
    int64_t t_cap = 0, t_len = 0;

    // per-segment touched workers (occupancy write-back)
    std::vector<int32_t> touched;
    std::vector<uint8_t> touched_mark;

    int64_t n_transitions = 0;   // lifetime, native-executed
    int64_t n_escapes = 0;       // lifetime escape count
    int64_t why_counts[16] = {0};

    int32_t esc_row = -1, esc_target = -1, esc_why = -1;

    Task &T(int32_t r) { return tasks[r]; }
    Worker &W(int32_t s) { return workers[s]; }

    void touch(int32_t slot) {
        if ((size_t)slot >= touched_mark.size())
            touched_mark.resize(slot + 1, 0);
        if (!touched_mark[slot]) {
            touched_mark[slot] = 1;
            touched.push_back(slot);
        }
    }

    void tape(int32_t op, int32_t a, int32_t b, int32_t c,
              double f1, double f2) {
        // headroom was reserved at the transition boundary
        t_op[t_len] = op; t_a[t_len] = a; t_b[t_len] = b; t_c[t_len] = c;
        t_f1[t_len] = f1; t_f2[t_len] = f2;
        ++t_len;
    }

    bool headroom() const { return t_cap - t_len >= TAPE_MARGIN; }

    int64_t get_nbytes(const Task &t) const {
        return t.nbytes >= 0 ? t.nbytes : 1024;  // DEFAULT_DATA_SIZE
    }

    static bool vec_contains(const std::vector<int32_t> &v, int32_t x) {
        return std::find(v.begin(), v.end(), x) != v.end();
    }
    static void vec_discard(std::vector<int32_t> &v, int32_t x) {
        auto it = std::find(v.begin(), v.end(), x);
        if (it != v.end()) v.erase(it);  // preserves order of the rest
    }
    static void vec_add(std::vector<int32_t> &v, int32_t x) {
        if (!vec_contains(v, x)) v.push_back(x);
    }

    int32_t dep_index(const Task &t, int32_t dep) const {
        for (size_t i = 0; i < t.deps.size(); ++i)
            if (t.deps[i] == dep) return (int32_t)i;
        return -1;
    }

    // ------------------------------------------------------ worker model

    bool worker_full(const Worker &w) const {
        if (std::isinf(saturation)) return false;
        int64_t cap = (int64_t)std::ceil(w.nthreads * saturation);
        if (cap < 1) cap = 1;
        return w.nprocessing >= cap;
    }

    // exact mirror of SchedulerState.check_idle_saturated, emitting
    // membership FLIPS (applied by the bridge in tape order, so the
    // python collections end with the same membership AND the same
    // dict insertion order as the oracle's call sequence)
    void check_idle_saturated(int32_t slot) {
        Worker &w = W(slot);
        touch(slot);
        if (total_nthreads == 0 || w.status == W_CLOSED) return;
        double occ = w.occupancy;
        int64_t p = w.nprocessing;
        double avg = total_nthreads
            ? total_occupancy / (double)total_nthreads : 0.0;
        if ((p < w.nthreads || occ < w.nthreads * avg / 2)
            && w.status == W_RUNNING) {
            if (!w.idle) { w.idle = 1; tape(OP_FLIP, slot, 0, 1, 0, 0); }
            if (w.saturated) { w.saturated = 0; tape(OP_FLIP, slot, 2, 0, 0, 0); }
        } else {
            if (w.idle) { w.idle = 0; tape(OP_FLIP, slot, 0, 0, 0, 0); }
            int64_t nc = w.nthreads;
            if (p > nc && occ > nc * avg) {
                if (!w.saturated) {
                    w.saturated = 1; tape(OP_FLIP, slot, 2, 1, 0, 0);
                }
            } else if (w.saturated) {
                w.saturated = 0; tape(OP_FLIP, slot, 2, 0, 0, 0);
            }
        }
        if (!worker_full(w) && w.status == W_RUNNING) {
            if (!w.idle_tc) { w.idle_tc = 1; tape(OP_FLIP, slot, 1, 1, 0, 0); }
        } else if (w.idle_tc) {
            w.idle_tc = 0; tape(OP_FLIP, slot, 1, 0, 0, 0);
        }
    }

    void adjust_occupancy(Worker &w, double delta) {
        w.occupancy = std::max(0.0, w.occupancy + delta);
        total_occupancy = std::max(0.0, total_occupancy + delta);
    }

    // ------------------------------------------------------- cost model

    double task_duration(const Task &t, bool *unknown) const {
        if (t.prefix >= 0) {
            double avg = prefixes[t.prefix].avg;
            if (avg >= 0) { *unknown = false; return avg; }
        }
        *unknown = (t.prefix >= 0);
        return unknown_duration;
    }

    double comm_cost(const Task &t, int32_t slot) const {
        // both get_comm_cost branches sum the same ints: exact
        int64_t nb = 0, n = 0;
        for (int32_t d : t.deps) {
            const Task &dt = tasks[d];
            if (vec_contains(dt.who_has, slot)) continue;
            nb += get_nbytes(dt);
            ++n;
        }
        return (double)nb / bandwidth + (double)n * latency;
    }

    // worker_objective for a non-actor task: (start_time, ws.nbytes)
    void objective(const Task &t, int32_t slot, double *start,
                   int64_t *wnbytes) const {
        const Worker &w = workers[slot];
        int64_t dep_bytes = 0, n_missing = 0;
        for (int32_t d : t.deps) {
            const Task &dt = tasks[d];
            if (!vec_contains(dt.who_has, slot)) {
                ++n_missing;
                dep_bytes += get_nbytes(dt);
            }
        }
        int64_t nt = w.nthreads > 1 ? w.nthreads : 1;
        double stack = w.occupancy / (double)nt
                       + (double)dep_bytes / bandwidth
                       + (double)n_missing * latency;
        bool unk;
        *start = stack + task_duration(t, &unk);
        *wnbytes = w.nbytes;
    }

    bool better(int32_t s, double st, int64_t nb, int32_t best,
                double bst, int64_t bnb) const {
        if (best < 0) return true;
        if (st != bst) return st < bst;
        if (nb != bnb) return nb < bnb;
        return workers[s].address < workers[best].address;
    }

    bool is_rootish(const Task &t) const {
        if (t.flags & F_RESTRICTED) return false;
        if (t.group < 0) return false;
        const Group &g = groups[t.group];
        if (!(g.n_tasks > total_nthreads * 2)) return false;
        if (!((int64_t)g.deps.size() < 5)) return false;
        int64_t s = 0;
        for (int32_t dg : g.deps) s += groups[dg].n_tasks;
        return s < 5;
    }

    // --------------------------------------------------------- the arms
    //
    // Each arm either fully executes (returns true) or escapes BEFORE
    // mutating anything (returns false with esc_why set) — that is
    // what makes the per-key oracle handoff exact.

    bool arm_rw(int32_t row) {  // released -> waiting
        Task &t = T(row);
        if (n_live == 0) { esc_why = E_NO_WORKER; return false; }
        if (t.waiting_count != 0) { esc_why = E_UNCOMPILED_EDGE; return false; }
        for (int32_t d : t.deps)
            if (tasks[d].state == S_FORGOTTEN) {
                // the oracle erreds mid-loop on a forgotten dep; hand
                // the whole transition over instead of modelling it
                esc_why = E_FORGOTTEN_DEP; return false;
            }
        tape(OP_RW, row, -1, 0, 0, 0);
        for (size_t i = 0; i < t.deps.size(); ++i) {
            Task &dt = tasks[t.deps[i]];
            if (dt.who_has.empty()) {
                t.dep_waiting[i] = 1;
                ++t.waiting_count;
                if (dt.state == S_RELEASED) recs.set(t.deps[i], S_WAITING);
                else if (dt.state == S_MEMORY) recs.set(t.deps[i], S_RELEASED);
            }
            vec_add(dt.waiters, row);
        }
        t.state = S_WAITING;
        ++n_transitions;
        if (t.waiting_count == 0) recs.set(row, S_PROCESSING);
        return true;
    }

    bool arm_wp(int32_t row) {  // waiting -> processing (non-rootish)
        Task &t = T(row);
        if (placement_attached) { esc_why = E_PLACEMENT_EXT; return false; }
        if (t.flags & F_ACTOR) { esc_why = E_ACTOR; return false; }
        if (t.flags & F_RESTRICTED) { esc_why = E_RESTRICTED; return false; }
        if (is_rootish(t)) { esc_why = E_ROOTISH; return false; }
        if (n_running == 0) { esc_why = E_NO_WORKER; return false; }
        for (int32_t d : t.deps)
            if (tasks[d].who_has.empty()) { esc_why = E_BARE_DEP; return false; }
        // candidates: dep holders ∩ running, else all running; min by
        // (start_time, nbytes, address) — addresses are unique, so the
        // scan order cannot affect the winner
        int32_t best = -1;
        double best_start = 0.0;
        int64_t best_nbytes = 0;
        bool any = false;
        for (int32_t d : t.deps) {
            for (int32_t s : tasks[d].who_has) {
                const Worker &w = workers[s];
                if (!w.live || w.status != W_RUNNING) continue;
                any = true;
                double st; int64_t nb;
                objective(t, s, &st, &nb);
                if (better(s, st, nb, best, best_start, best_nbytes)) {
                    best = s; best_start = st; best_nbytes = nb;
                }
            }
        }
        if (!any) {
            for (size_t s = 0; s < workers.size(); ++s) {
                const Worker &w = workers[s];
                if (!w.live || w.status != W_RUNNING) continue;
                double st; int64_t nb;
                objective(t, (int32_t)s, &st, &nb);
                if (better((int32_t)s, st, nb, best, best_start,
                           best_nbytes)) {
                    best = (int32_t)s; best_start = st; best_nbytes = nb;
                }
            }
        }
        if (best < 0) { esc_why = E_NO_WORKER; return false; }
        bool unk;
        double duration = task_duration(t, &unk);
        double comm = comm_cost(t, best);
        tape(OP_WP, row, best, unk ? 1 : 0, duration, comm);
        Worker &w = W(best);
        t.occ_contrib = duration + comm;
        ++w.nprocessing;
        t.processing_on = best;
        t.state = S_PROCESSING;
        adjust_occupancy(w, duration + comm);
        ++n_transitions;
        check_idle_saturated(best);
        return true;
    }

    void arm_pm(int32_t row, int32_t slot, int32_t ev, int64_t nbytes,
                double dur, uint8_t has_dur) {
        // processing -> memory; guards already passed, cannot escape
        Task &t = T(row);
        tape(OP_PM, row, slot, ev, 0, 0);
        if (has_dur && t.prefix >= 0) {
            Prefix &p = prefixes[t.prefix];
            p.avg = p.avg < 0 ? dur : 0.5 * dur + 0.5 * p.avg;
        }
        // _exit_processing_common
        Worker &w = W(slot);
        t.processing_on = -1;
        bool was_lr = t.flags & F_LONG_RUNNING;
        t.flags &= (uint8_t)~F_LONG_RUNNING;
        if (!was_lr) adjust_occupancy(w, -t.occ_contrib);
        --w.nprocessing;
        if (w.nprocessing == 0) {
            total_occupancy -= w.occupancy;
            w.occupancy = 0.0;
        }
        check_idle_saturated(slot);
        // update_nbytes (pre-add_replica holders), then add_replica
        if (nbytes >= 0) {
            int64_t old = t.nbytes >= 0 ? get_nbytes(t) : 0;
            int64_t diff = nbytes - old;
            for (int32_t h : t.who_has) { W(h).nbytes += diff; touch(h); }
            t.nbytes = nbytes;
        }
        if (!vec_contains(t.who_has, slot)) {
            w.nbytes += get_nbytes(t);
            touch(slot);
            t.who_has.push_back(slot);
        }
        t.state = S_MEMORY;
        ++n_transitions;
        // _notify_waiters_task_in_memory
        for (int32_t dep_row : t.dependents) {
            Task &dt = tasks[dep_row];
            int32_t di = dep_index(dt, row);
            if (di >= 0 && dt.dep_waiting[di]) {
                dt.dep_waiting[di] = 0;
                --dt.waiting_count;
                if (dt.waiting_count == 0 && dt.state == S_WAITING)
                    recs.set(dep_row, S_PROCESSING);
            }
        }
        for (int32_t d : t.deps) {
            Task &dt = tasks[d];
            vec_discard(dt.waiters, row);
            if (dt.waiters.empty() && dt.who_wants == 0)
                recs.set(d, S_RELEASED);
        }
        if (t.waiters.empty() && t.who_wants == 0)
            recs.set(row, S_RELEASED);
    }

    bool arm_mr(int32_t row) {  // memory -> released
        Task &t = T(row);
        if (t.flags & F_ACTOR) { esc_why = E_ACTOR; return false; }
        tape(OP_MR, row, -1, 0, 0, 0);
        for (int32_t wrow : t.waiters) {
            Task &dt = tasks[wrow];
            if (dt.state == S_NO_WORKER || dt.state == S_PROCESSING
                || dt.state == S_QUEUED) {
                recs.set(wrow, S_WAITING);
            } else if (dt.state == S_WAITING) {
                int32_t di = dep_index(dt, row);
                if (di >= 0 && !dt.dep_waiting[di]) {
                    dt.dep_waiting[di] = 1;
                    ++dt.waiting_count;
                }
            }
        }
        for (int32_t h : t.who_has) {
            W(h).nbytes -= get_nbytes(t);
            touch(h);
        }
        t.who_has.clear();
        t.state = S_RELEASED;
        ++n_transitions;
        bool rerun = false;
        if (t.flags & F_NO_RUNSPEC) {
            recs.set(row, S_FORGOTTEN);  // escapes when popped
        } else if (!(t.flags & F_BLAMED)
                   && (t.who_wants > 0 || !t.waiters.empty())) {
            recs.set(row, S_WAITING);
            rerun = true;
        }
        if (rerun) {
            for (int32_t d : t.deps) vec_add(tasks[d].waiters, row);
        } else {
            for (int32_t d : t.deps) {
                Task &dt = tasks[d];
                if (vec_contains(dt.waiters, row)) {
                    vec_discard(dt.waiters, row);
                    if (dt.waiters.empty() && dt.who_wants == 0)
                        recs.set(d, S_RELEASED);
                }
            }
        }
        return true;
    }

    // ------------------------------------------------------- drain core

    // 1 executed / no-op; 0 escape (esc_* set); -1 tape headroom
    int run_rec(int32_t row, int32_t target) {
        Task &t = T(row);
        if (!t.live) return 1;
        if (t.state == (uint8_t)target) return 1;  // start==finish no-op
        esc_why = E_UNCOMPILED_EDGE;
        bool ok = false;
        if (t.state == S_RELEASED && target == S_WAITING) ok = arm_rw(row);
        else if (t.state == S_WAITING && target == S_PROCESSING)
            ok = arm_wp(row);
        else if (t.state == S_MEMORY && target == S_RELEASED)
            ok = arm_mr(row);
        if (ok) return 1;
        esc_row = row; esc_target = target;
        ++n_escapes;
        if (esc_why >= 0 && esc_why < 16) ++why_counts[esc_why];
        return 0;
    }

    int drain() {
        int32_t row, target;
        while (true) {
            if (!headroom()) return -1;  // pending recs survive in place
            if (!recs.pop(&row, &target)) return 1;
            int r = run_rec(row, target);
            if (r != 1) return r;
        }
    }
};

}  // namespace

// ---------------------------------------------------------------- C ABI

extern "C" {

void *eng_new() { return new Engine(); }
void eng_free(void *h) { delete (Engine *)h; }

void eng_params(void *h, double bandwidth, double latency,
                double unknown_duration, double saturation,
                double total_occupancy, int64_t total_nthreads,
                int32_t n_live, int32_t n_running,
                int32_t placement_attached) {
    Engine &e = *(Engine *)h;
    e.bandwidth = bandwidth;
    e.latency = latency;
    e.unknown_duration = unknown_duration;
    e.saturation = saturation;
    e.total_occupancy = total_occupancy;
    e.total_nthreads = total_nthreads;
    e.n_live = n_live;
    e.n_running = n_running;
    e.placement_attached = (uint8_t)placement_attached;
}

void eng_worker_upsert(void *h, int32_t slot, int32_t status,
                       int32_t nthreads, int64_t nbytes, double occupancy,
                       int32_t nprocessing, int32_t idle, int32_t idle_tc,
                       int32_t saturated, const char *addr) {
    Engine &e = *(Engine *)h;
    if ((size_t)slot >= e.workers.size()) e.workers.resize(slot + 1);
    Worker &w = e.workers[slot];
    w.live = 1;
    w.status = (uint8_t)status;
    w.nthreads = nthreads;
    w.nbytes = nbytes;
    w.occupancy = occupancy;
    w.nprocessing = nprocessing;
    w.idle = (uint8_t)idle;
    w.idle_tc = (uint8_t)idle_tc;
    w.saturated = (uint8_t)saturated;
    if (addr) w.address = addr;
}

void eng_worker_close(void *h, int32_t slot) {
    Engine &e = *(Engine *)h;
    if ((size_t)slot < e.workers.size()) {
        e.workers[slot].live = 0;
        e.workers[slot].status = W_CLOSED;
    }
}

void eng_prefix_set(void *h, int32_t pid, double avg) {
    Engine &e = *(Engine *)h;
    if ((size_t)pid >= e.prefixes.size()) e.prefixes.resize(pid + 1);
    e.prefixes[pid].avg = avg;
}

double eng_prefix_get(void *h, int32_t pid) {
    Engine &e = *(Engine *)h;
    return (size_t)pid < e.prefixes.size() ? e.prefixes[pid].avg : -1.0;
}

void eng_group_upsert(void *h, int32_t gid, int64_t n_tasks,
                      int32_t ndeps, const int32_t *dep_gids) {
    Engine &e = *(Engine *)h;
    int32_t hi = gid;
    for (int32_t i = 0; i < ndeps; ++i) hi = std::max(hi, dep_gids[i]);
    if ((size_t)hi >= e.groups.size()) e.groups.resize(hi + 1);
    Group &g = e.groups[gid];
    g.n_tasks = n_tasks;
    g.deps.assign(dep_gids, dep_gids + ndeps);
}

// Bulk authoritative sync: every row's vectors are handed over exactly
// as python sees them (deps + waiting flags, waiters, who_has,
// dependents), so vector ORDER mirrors OrderedSet insertion order by
// fiat.  Cross-links into rows NOT in this batch are maintained with
// order-preserving dedup adds/discards; the bridge marks every task
// whose relations changed dirty, so persisting appends only touch rows
// whose python order did not change either.
void eng_task_sync_bulk(
    void *h, int64_t n, const int32_t *rows, const uint8_t *state,
    const uint8_t *flags, const int32_t *prefix, const int32_t *group,
    const int64_t *nbytes, const int32_t *who_wants,
    const int32_t *processing_on, const double *occ_contrib,
    const int64_t *dep_off, const int32_t *dep_flat,
    const uint8_t *depw_flat,
    const int64_t *wtr_off, const int32_t *wtr_flat,
    const int64_t *who_off, const int32_t *who_flat,
    const int64_t *dept_off, const int32_t *dept_flat) {
    Engine &e = *(Engine *)h;
    // pre-size the task vector (rows and any row referenced)
    int32_t hi = -1;
    for (int64_t i = 0; i < n; ++i) hi = std::max(hi, rows[i]);
    for (int64_t i = 0; i < dep_off[n]; ++i) hi = std::max(hi, dep_flat[i]);
    for (int64_t i = 0; i < wtr_off[n]; ++i) hi = std::max(hi, wtr_flat[i]);
    for (int64_t i = 0; i < dept_off[n]; ++i)
        hi = std::max(hi, dept_flat[i]);
    if (hi >= 0 && (size_t)hi >= e.tasks.size()) e.tasks.resize(hi + 1);
    for (int64_t i = 0; i < n; ++i) {
        int32_t r = rows[i];
        Task &t = e.tasks[r];
        // unlink dropped dep edges (their dependents keep stale refs
        // otherwise)
        int64_t lo = dep_off[i], hi2 = dep_off[i + 1];
        for (int32_t d : t.deps) {
            bool still = false;
            for (int64_t j = lo; j < hi2; ++j)
                if (dep_flat[j] == d) { still = true; break; }
            if (!still) Engine::vec_discard(e.tasks[d].dependents, r);
        }
        t.live = 1;
        t.state = state[i];
        t.flags = flags[i];
        t.prefix = prefix[i];
        t.group = group[i];
        t.nbytes = nbytes[i];
        t.who_wants = who_wants[i];
        t.processing_on = processing_on[i];
        t.occ_contrib = occ_contrib[i];
        t.deps.assign(dep_flat + lo, dep_flat + hi2);
        t.dep_waiting.assign(depw_flat + lo, depw_flat + hi2);
        t.waiting_count = 0;
        for (int64_t j = lo; j < hi2; ++j)
            if (depw_flat[j]) ++t.waiting_count;
        t.waiters.assign(wtr_flat + wtr_off[i], wtr_flat + wtr_off[i + 1]);
        t.who_has.assign(who_flat + who_off[i], who_flat + who_off[i + 1]);
        t.dependents.assign(dept_flat + dept_off[i],
                            dept_flat + dept_off[i + 1]);
        for (int32_t d : t.deps) Engine::vec_add(e.tasks[d].dependents, r);
    }
}

void eng_task_forget(void *h, int32_t row) {
    Engine &e = *(Engine *)h;
    if ((size_t)row >= e.tasks.size()) return;
    Task &t = e.tasks[row];
    for (int32_t d : t.deps) {
        if ((size_t)d < e.tasks.size()) {
            Engine::vec_discard(e.tasks[d].dependents, row);
            Engine::vec_discard(e.tasks[d].waiters, row);
        }
    }
    for (int32_t dep_row : t.dependents) {
        if ((size_t)dep_row < e.tasks.size()) {
            Task &dt = e.tasks[dep_row];
            for (size_t i = 0; i < dt.deps.size(); ++i)
                if (dt.deps[i] == row) {
                    if (dt.dep_waiting[i]) --dt.waiting_count;
                    dt.deps.erase(dt.deps.begin() + i);
                    dt.dep_waiting.erase(dt.dep_waiting.begin() + i);
                    break;
                }
        }
    }
    t = Task();  // live = 0
}

void eng_set_tape(void *h, int32_t *op, int32_t *a, int32_t *b,
                  int32_t *c, double *f1, double *f2, int64_t cap) {
    Engine &e = *(Engine *)h;
    e.t_op = op; e.t_a = a; e.t_b = b; e.t_c = c;
    e.t_f1 = f1; e.t_f2 = f2;
    e.t_cap = cap; e.t_len = 0;
    e.touched.clear();
    std::fill(e.touched_mark.begin(), e.touched_mark.end(), 0);
    e.esc_row = e.esc_target = e.esc_why = -1;
}

// Drain a task-finished flood segment.  Returns R_DONE / R_ESCAPE /
// R_TAPE_FULL; *consumed = events fully processed natively.  On
// R_ESCAPE with esc_row >= 0 the escaping event's chain is partially
// done and *consumed INCLUDES it — the bridge finishes the popped
// transition + pending recs with the oracle.  With esc_row < 0
// (event-shape escape) the event was NOT touched and *consumed
// excludes it — the bridge oracles the whole event.  On R_TAPE_FULL
// *consumed counts events whose chains completed natively; pending
// recs (if any) belong to the last counted event.
int32_t eng_drain_finished(void *h, int64_t n, const int32_t *ev_task,
                           const int32_t *ev_slot,
                           const int64_t *ev_nbytes, const double *ev_dur,
                           const uint8_t *ev_flags, int64_t *consumed) {
    Engine &e = *(Engine *)h;
    e.recs.clear();
    for (int64_t i = 0; i < n; ++i) {
        *consumed = i;
        if (!e.headroom()) return R_TAPE_FULL;
        if (ev_flags[i] & 2) {
            e.esc_row = e.esc_target = -1;
            e.esc_why = E_EVENT_SHAPE;
            ++e.n_escapes;
            ++e.why_counts[E_EVENT_SHAPE];
            return R_ESCAPE;
        }
        int32_t row = ev_task[i];
        int32_t slot = ev_slot[i];
        // stimulus_task_finished guards
        if (row < 0 || (size_t)row >= e.tasks.size()
            || !e.tasks[row].live) {
            e.tape(OP_FREEKEYS_STALE, (int32_t)i, -1, 0, 0, 0);
            continue;
        }
        Task &t = e.T(row);
        if (t.state == S_RELEASED || t.state == S_FORGOTTEN
            || t.state == S_ERRED) {
            e.tape(OP_FREEKEYS_STALE, (int32_t)i, -1, 0, 0, 0);
            continue;
        }
        if (t.state == S_MEMORY) {
            if (slot >= 0 && e.workers[slot].live
                && !Engine::vec_contains(t.who_has, slot)) {
                e.workers[slot].nbytes += e.get_nbytes(t);
                e.touch(slot);
                t.who_has.push_back(slot);
                e.tape(OP_ADD_REPLICA, row, slot, (int32_t)i, 0, 0);
            }
            continue;
        }
        if (t.state != S_PROCESSING) continue;
        if (slot < 0 || t.processing_on != slot) {
            // stale/misrouted: the oracle still applies the event's
            // metadata pop before _transition's worker guard drops it
            e.tape(OP_META, row, -1, (int32_t)i, 0, 0);
            continue;
        }
        e.arm_pm(row, slot, (int32_t)i, ev_nbytes[i], ev_dur[i],
                 ev_flags[i] & 1);
        int r = e.drain();
        if (r == -1) { *consumed = i + 1; return R_TAPE_FULL; }
        if (r == 0) { *consumed = i + 1; return R_ESCAPE; }
    }
    *consumed = n;
    return R_DONE;
}

// Drain one recommendations round (the transitions()/transitions_batch
// seam): (rows[i], targets[i]) in python dict insertion order.
int32_t eng_drain_recs(void *h, int64_t n, const int32_t *rows,
                       const int32_t *targets) {
    Engine &e = *(Engine *)h;
    e.recs.clear();
    for (int64_t i = 0; i < n; ++i) e.recs.set(rows[i], targets[i]);
    int r = e.drain();
    if (r == -1) return R_TAPE_FULL;
    if (r == 0) return R_ESCAPE;
    return R_DONE;
}

int64_t eng_tape_len(void *h) { return ((Engine *)h)->t_len; }
int32_t eng_escape_row(void *h) { return ((Engine *)h)->esc_row; }
int32_t eng_escape_target(void *h) { return ((Engine *)h)->esc_target; }
int32_t eng_escape_why(void *h) { return ((Engine *)h)->esc_why; }

// pending rec-dict handoff, oldest first (python dict order)
int64_t eng_pending_recs(void *h, int32_t *rows, int32_t *targets,
                         int64_t cap) {
    Engine &e = *(Engine *)h;
    int64_t n = 0;
    for (size_t i = 0; i < e.recs.entries.size(); ++i) {
        auto &p = e.recs.entries[i];
        auto it = e.recs.pos.find(p.first);
        if (it == e.recs.pos.end() || it->second != (int32_t)i) continue;
        if (n >= cap) break;
        rows[n] = p.first;
        targets[n] = p.second;
        ++n;
    }
    return n;
}

// occupancy write-back for the workers touched by the last segment
int64_t eng_touched(void *h, int32_t *slots, double *occ, int64_t cap) {
    Engine &e = *(Engine *)h;
    int64_t n = 0;
    for (int32_t s : e.touched) {
        if (n >= cap) break;
        slots[n] = s;
        occ[n] = e.workers[s].occupancy;
        ++n;
    }
    return n;
}

double eng_total_occupancy(void *h) {
    return ((Engine *)h)->total_occupancy;
}

int64_t eng_transitions(void *h) { return ((Engine *)h)->n_transitions; }
int64_t eng_escapes(void *h) { return ((Engine *)h)->n_escapes; }
int64_t eng_escape_count(void *h, int32_t why) {
    Engine &e = *(Engine *)h;
    return (why >= 0 && why < 16) ? e.why_counts[why] : 0;
}

// Live-row counts for the census walk-vs-counter audit on the
// authoritative SoA families: [0] live task rows, [1] task row
// capacity, [2] live worker slots, [3] worker slot capacity,
// [4] prefix rows, [5] group rows.
void eng_counts(void *h, int64_t *out) {
    Engine &e = *(Engine *)h;
    int64_t lt = 0, lw = 0;
    for (const Task &t : e.tasks) lt += t.live;
    for (const Worker &w : e.workers) lw += w.live;
    out[0] = lt;
    out[1] = (int64_t)e.tasks.size();
    out[2] = lw;
    out[3] = (int64_t)e.workers.size();
    out[4] = (int64_t)e.prefixes.size();
    out[5] = (int64_t)e.groups.size();
}

// Incremental deltas for the frequent between-flood mutations (the
// add-keys/AMM replica traffic and nbytes/who_wants updates): one call
// instead of a full dirty-row resync.  Harmless on rows that are also
// dirty — the authoritative resync overwrites.

void eng_replica_add(void *h, int32_t row, int32_t slot) {
    Engine &e = *(Engine *)h;
    if ((size_t)row >= e.tasks.size() || (size_t)slot >= e.workers.size())
        return;
    Task &t = e.tasks[row];
    if (!t.live || Engine::vec_contains(t.who_has, slot)) return;
    e.workers[slot].nbytes += e.get_nbytes(t);
    t.who_has.push_back(slot);
}

void eng_replica_remove(void *h, int32_t row, int32_t slot) {
    Engine &e = *(Engine *)h;
    if ((size_t)row >= e.tasks.size() || (size_t)slot >= e.workers.size())
        return;
    Task &t = e.tasks[row];
    if (!t.live || !Engine::vec_contains(t.who_has, slot)) return;
    e.workers[slot].nbytes -= e.get_nbytes(t);
    Engine::vec_discard(t.who_has, slot);
}

void eng_task_nbytes(void *h, int32_t row, int64_t nbytes) {
    Engine &e = *(Engine *)h;
    if ((size_t)row >= e.tasks.size()) return;
    Task &t = e.tasks[row];
    if (!t.live) return;
    int64_t old = t.nbytes >= 0 ? e.get_nbytes(t) : 0;
    int64_t diff = nbytes - old;
    for (int32_t hslot : t.who_has) e.workers[hslot].nbytes += diff;
    t.nbytes = nbytes;
}

void eng_task_who_wants(void *h, int32_t row, int32_t n) {
    Engine &e = *(Engine *)h;
    if ((size_t)row < e.tasks.size() && e.tasks[row].live)
        e.tasks[row].who_wants = n;
}

// scalar read-back for the DTPU_NATIVE_CHECK audit
void eng_task_read(void *h, int32_t row, int64_t *out) {
    Engine &e = *(Engine *)h;
    if ((size_t)row >= e.tasks.size()) { out[0] = -1; return; }
    Task &t = e.tasks[row];
    out[0] = t.live;
    out[1] = t.state;
    out[2] = t.processing_on;
    out[3] = t.waiting_count;
    out[4] = (int64_t)t.waiters.size();
    out[5] = (int64_t)t.who_has.size();
    out[6] = t.nbytes;
    out[7] = t.who_wants;
}

void eng_worker_read(void *h, int32_t slot, double *occ, int64_t *out) {
    Engine &e = *(Engine *)h;
    if ((size_t)slot >= e.workers.size()) { out[0] = -1; return; }
    Worker &w = e.workers[slot];
    *occ = w.occupancy;
    out[0] = w.live;
    out[1] = w.status;
    out[2] = w.nprocessing;
    out[3] = w.nbytes;
    out[4] = w.idle;
    out[5] = w.idle_tc;
    out[6] = w.saturated;
}

}  // extern "C"
