// CDCL SAT solver — the native decision-procedure core of mythril_tpu.
//
// Role parity: the reference (Mythril) delegates every check-sat to the z3 C++
// library. This build has no z3; path constraints are bit-blasted to CNF by
// mythril_tpu.smt.bitblast and discharged here. Classic CDCL: two-watched-literal
// propagation, first-UIP conflict learning, VSIDS-style activity with phase saving,
// Luby restarts, and learned-clause reduction.
//
// The port's copy of native/cdcl.cpp, built by mythril_tpu_torch/native/__init__.py.
//
// C ABI (ctypes): clauses arrive as a flat 0-terminated literal stream in DIMACS
// convention (+v / -v, variables 1-indexed). Returns 1 SAT / 0 UNSAT / -1 budget
// exceeded; on SAT, model_out[v-1] holds 0/1 per variable.
#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <algorithm>

namespace {

using Lit = int32_t;  // internal: 2*var + sign, var 0-indexed
inline Lit mk_lit(int var, bool neg) { return 2 * var + (neg ? 1 : 0); }
inline int lit_var(Lit l) { return l >> 1; }
inline bool lit_neg(Lit l) { return l & 1; }
inline Lit lit_not(Lit l) { return l ^ 1; }

enum LBool : int8_t { kFalse = 0, kTrue = 1, kUndef = 2 };

struct Clause {
  std::vector<Lit> lits;
  double activity = 0.0;
  bool learned = false;
};

class Solver {
 public:
  explicit Solver(int n_vars) { ensure_vars(n_vars); }

  // grow all per-variable structures (incremental sessions add variables as
  // the bit-blaster's monotone clause pool grows)
  void ensure_vars(int n_vars) {
    if (n_vars <= n_vars_) return;
    assign_.resize(n_vars, kUndef);
    phase_.resize(n_vars, 0);
    level_.resize(n_vars, 0);
    reason_.resize(n_vars, -1);
    activity_.resize(n_vars, 0.0);
    watches_.resize(2 * n_vars);
    seen_.resize(n_vars, 0);
    heap_pos_.resize(n_vars, -1);
    for (int v = n_vars_; v < n_vars; ++v) insert_heap(v);
    n_vars_ = n_vars;
  }

  bool add_clause(std::vector<Lit> lits) {
    if (broken_) return false;
    cancel_until(0);
    std::sort(lits.begin(), lits.end());
    lits.erase(std::unique(lits.begin(), lits.end()), lits.end());
    for (size_t i = 0; i + 1 < lits.size(); ++i)
      if (lits[i] == lit_not(lits[i + 1])) return true;  // tautology
    if (lits.empty()) { broken_ = true; return false; }
    if (lits.size() == 1) {
      if (value(lits[0]) == kFalse) { broken_ = true; return false; }
      if (value(lits[0]) == kUndef) enqueue(lits[0], -1);
      return true;
    }
    // watches must not start on level-0-false literals in an incremental
    // session: move two non-false literals (or a true one) to the front
    size_t front = 0;
    for (size_t k = 0; k < lits.size() && front < 2; ++k)
      if (value(lits[k]) != kFalse) std::swap(lits[front++], lits[k]);
    if (front == 0) { broken_ = true; return false; }  // all false at level 0
    if (front == 1 && value(lits[0]) == kUndef) enqueue(lits[0], -1);
    clauses_.push_back({std::move(lits), 0.0, false});
    attach(static_cast<int>(clauses_.size()) - 1);
    return true;
  }

  // 1 SAT, 0 UNSAT (under assumptions), -1 budget exceeded.
  // timeout_ms > 0 adds a wall-clock deadline beside the conflict budget:
  // the conflict count is only a throughput *proxy* (solver.py
  // CONFLICTS_PER_MS) and individual queries were measured blowing ~20%
  // past --solver-timeout on conflict count alone; the reference enforces
  // a hard watchdog (mythril/support/model.py:104-119).
  int solve(int64_t max_conflicts, const std::vector<Lit>& assumptions = {},
            int64_t timeout_ms = 0) {
    if (broken_) return 0;
    using Clock = std::chrono::steady_clock;
    const bool timed = timeout_ms > 0;
    const Clock::time_point deadline =
        timed ? Clock::now() + std::chrono::milliseconds(timeout_ms)
              : Clock::time_point();
    cancel_until(0);
    if (propagate() != -1) { broken_ = true; return 0; }  // top-level conflict
    int64_t conflicts = 0;
    int64_t decisions = 0;
    int64_t restart_limit = luby(restart_count_) * 128;
    int64_t reduce_limit = 4000 + static_cast<int64_t>(num_learned_);
    for (;;) {
      int confl = propagate();
      if (confl != -1) {
        ++conflicts;
        if (timed && (conflicts & 255) == 0 && Clock::now() >= deadline)
          return -1;
        if (decision_level() == 0) { broken_ = true; return 0; }
        if (decision_level() <= static_cast<int>(assumptions.size()))
          return 0;  // conflict forced by the assumption prefix alone
        std::vector<Lit> learnt;
        int backtrack_level;
        analyze(confl, learnt, backtrack_level);
        cancel_until(backtrack_level);
        if (learnt.size() == 1 && backtrack_level == 0) {
          enqueue(learnt[0], -1);
        } else {
          clauses_.push_back({learnt, clause_inc_, true});
          int ci = static_cast<int>(clauses_.size()) - 1;
          attach(ci);
          enqueue(learnt[0], ci);
        }
        decay_activities();
        if (conflicts >= max_conflicts) return -1;
        if (conflicts >= restart_limit) {
          ++restart_count_;
          restart_limit = conflicts + luby(restart_count_) * 128;
          cancel_until(0);
        }
        if (static_cast<int64_t>(num_learned_) >= reduce_limit) {
          reduce_learned();
          reduce_limit += 1000;
        }
      } else if (decision_level() < static_cast<int>(assumptions.size())) {
        // assumption prefix: one decision level per assumption literal
        Lit a = assumptions[decision_level()];
        if (value(a) == kFalse) return 0;  // UNSAT under assumptions
        new_decision_level();
        if (value(a) == kUndef) enqueue(a, -1);
      } else {
        if (timed && (++decisions & 8191) == 0 && Clock::now() >= deadline)
          return -1;
        int next = pick_branch_var();
        if (next == -1) return 1;  // all assigned: SAT
        new_decision_level();
        enqueue(mk_lit(next, phase_[next] == 0), -1);
      }
    }
  }

  LBool model(int var) const { return assign_[var]; }
  int n_vars() const { return n_vars_; }

 private:
  LBool value(Lit l) const {
    LBool v = assign_[lit_var(l)];
    if (v == kUndef) return kUndef;
    return (v == kTrue) != lit_neg(l) ? kTrue : kFalse;
  }

  void attach(int ci) {
    Clause& c = clauses_[ci];
    watches_[lit_not(c.lits[0])].push_back(ci);
    watches_[lit_not(c.lits[1])].push_back(ci);
    if (c.learned) ++num_learned_;
  }

  void enqueue(Lit l, int reason) {
    int v = lit_var(l);
    assign_[v] = lit_neg(l) ? kFalse : kTrue;
    phase_[v] = lit_neg(l) ? 0 : 1;
    level_[v] = decision_level();
    reason_[v] = reason;
    trail_.push_back(l);
  }

  // returns conflicting clause index or -1
  int propagate() {
    while (qhead_ < trail_.size()) {
      Lit p = trail_[qhead_++];  // p is true; scan clauses watching ~p's negation slot
      std::vector<int>& ws = watches_[p];
      size_t keep = 0;
      for (size_t i = 0; i < ws.size(); ++i) {
        int ci = ws[i];
        Clause& c = clauses_[ci];
        // ensure the false literal is at position 1
        Lit false_lit = lit_not(p);
        if (c.lits[0] == false_lit) std::swap(c.lits[0], c.lits[1]);
        if (value(c.lits[0]) == kTrue) { ws[keep++] = ci; continue; }
        bool moved = false;
        for (size_t k = 2; k < c.lits.size(); ++k) {
          if (value(c.lits[k]) != kFalse) {
            std::swap(c.lits[1], c.lits[k]);
            watches_[lit_not(c.lits[1])].push_back(ci);
            moved = true;
            break;
          }
        }
        if (moved) continue;
        ws[keep++] = ci;
        if (value(c.lits[0]) == kFalse) {
          for (size_t j = i + 1; j < ws.size(); ++j) ws[keep++] = ws[j];
          ws.resize(keep);
          qhead_ = trail_.size();
          return ci;
        }
        enqueue(c.lits[0], ci);
      }
      ws.resize(keep);
    }
    return -1;
  }

  void analyze(int confl, std::vector<Lit>& learnt, int& backtrack_level) {
    learnt.clear();
    learnt.push_back(0);  // slot for the asserting literal
    int counter = 0;
    Lit p = -1;
    size_t trail_idx = trail_.size();
    int ci = confl;
    do {
      Clause& c = clauses_[ci];
      if (c.learned) bump_clause(c);
      for (size_t j = (p == -1 ? 0 : 1); j < c.lits.size(); ++j) {
        Lit q = c.lits[j];
        int v = lit_var(q);
        if (!seen_[v] && level_[v] > 0) {
          seen_[v] = 1;
          bump_var(v);
          if (level_[v] >= decision_level()) ++counter;
          else learnt.push_back(q);
        }
      }
      // pick next literal to expand from trail
      while (!seen_[lit_var(trail_[trail_idx - 1])]) --trail_idx;
      --trail_idx;
      p = trail_[trail_idx];
      seen_[lit_var(p)] = 0;
      --counter;
      ci = reason_[lit_var(p)];
    } while (counter > 0);
    learnt[0] = lit_not(p);

    // minimal backtrack level = max level among learnt[1..]
    backtrack_level = 0;
    int max_i = 1;
    for (size_t i = 1; i < learnt.size(); ++i) {
      if (level_[lit_var(learnt[i])] > backtrack_level) {
        backtrack_level = level_[lit_var(learnt[i])];
        max_i = static_cast<int>(i);
      }
    }
    if (learnt.size() > 1) std::swap(learnt[1], learnt[max_i]);
    for (Lit l : learnt) seen_[lit_var(l)] = 0;
  }

  void cancel_until(int lvl) {
    while (!trail_lim_.empty() && decision_level() > lvl) {
      size_t bound = trail_lim_.back();
      while (trail_.size() > bound) {
        int v = lit_var(trail_.back());
        assign_[v] = kUndef;
        reason_[v] = -1;
        insert_heap(v);
        trail_.pop_back();
      }
      trail_lim_.pop_back();
    }
    qhead_ = trail_.size();
  }

  int decision_level() const { return static_cast<int>(trail_lim_.size()); }
  void new_decision_level() { trail_lim_.push_back(trail_.size()); }

  void bump_var(int v) {
    activity_[v] += var_inc_;
    if (activity_[v] > 1e100) {
      for (auto& a : activity_) a *= 1e-100;
      var_inc_ *= 1e-100;
      // activities rescaled uniformly: heap order unchanged
    }
    if (heap_pos_[v] >= 0) sift_up(heap_pos_[v]);
  }
  void bump_clause(Clause& c) {
    c.activity += clause_inc_;
    if (c.activity > 1e20) {
      for (auto& cl : clauses_) if (cl.learned) cl.activity *= 1e-20;
      clause_inc_ *= 1e-20;
    }
  }
  void decay_activities() { var_inc_ /= 0.95; clause_inc_ /= 0.999; }

  // -- indexed binary max-heap over activity_ ------------------------------------
  void sift_up(int i) {
    int v = heap_[i];
    while (i > 0) {
      int parent = (i - 1) / 2;
      if (activity_[heap_[parent]] >= activity_[v]) break;
      heap_[i] = heap_[parent];
      heap_pos_[heap_[i]] = i;
      i = parent;
    }
    heap_[i] = v;
    heap_pos_[v] = i;
  }

  void sift_down(int i) {
    int v = heap_[i];
    int n = static_cast<int>(heap_.size());
    for (;;) {
      int child = 2 * i + 1;
      if (child >= n) break;
      if (child + 1 < n && activity_[heap_[child + 1]] > activity_[heap_[child]])
        ++child;
      if (activity_[heap_[child]] <= activity_[v]) break;
      heap_[i] = heap_[child];
      heap_pos_[heap_[i]] = i;
      i = child;
    }
    heap_[i] = v;
    heap_pos_[v] = i;
  }

  void insert_heap(int v) {
    if (heap_pos_[v] >= 0) return;
    heap_.push_back(v);
    heap_pos_[v] = static_cast<int>(heap_.size()) - 1;
    sift_up(heap_pos_[v]);
  }

  int pick_branch_var() {
    while (!heap_.empty()) {
      int v = heap_[0];
      int last = heap_.back();
      heap_.pop_back();
      heap_pos_[v] = -1;
      if (!heap_.empty() && v != last) {
        heap_[0] = last;
        heap_pos_[last] = 0;
        sift_down(0);
      }
      if (assign_[v] == kUndef) return v;
    }
    return -1;
  }

  void reduce_learned() {
    // drop the lower-activity half of learned clauses not currently reasons
    std::vector<int> learned_idx;
    for (size_t i = 0; i < clauses_.size(); ++i)
      if (clauses_[i].learned) learned_idx.push_back(static_cast<int>(i));
    if (learned_idx.size() < 100) return;
    std::sort(learned_idx.begin(), learned_idx.end(), [&](int a, int b) {
      return clauses_[a].activity < clauses_[b].activity;
    });
    std::vector<bool> is_reason(clauses_.size(), false);
    for (int v = 0; v < n_vars_; ++v)
      if (reason_[v] >= 0) is_reason[reason_[v]] = true;
    std::vector<bool> drop(clauses_.size(), false);
    size_t limit = learned_idx.size() / 2;
    for (size_t i = 0; i < limit; ++i)
      if (!is_reason[learned_idx[i]] && clauses_[learned_idx[i]].lits.size() > 2)
        drop[learned_idx[i]] = true;
    // rebuild clause list + watches with stable remapping
    std::vector<int> remap(clauses_.size(), -1);
    std::vector<Clause> kept;
    kept.reserve(clauses_.size());
    for (size_t i = 0; i < clauses_.size(); ++i) {
      if (!drop[i]) {
        remap[i] = static_cast<int>(kept.size());
        kept.push_back(std::move(clauses_[i]));
      }
    }
    clauses_ = std::move(kept);
    num_learned_ = 0;
    for (auto& c : clauses_) if (c.learned) ++num_learned_;
    for (auto& w : watches_) w.clear();
    for (size_t i = 0; i < clauses_.size(); ++i) {
      watches_[lit_not(clauses_[i].lits[0])].push_back(static_cast<int>(i));
      watches_[lit_not(clauses_[i].lits[1])].push_back(static_cast<int>(i));
    }
    for (int v = 0; v < n_vars_; ++v)
      if (reason_[v] >= 0) reason_[v] = remap[reason_[v]];
  }

  static int64_t luby(int64_t i) {
    // Luby sequence: 1,1,2,1,1,2,4,...
    for (int64_t k = 1; k < 64; ++k) {
      if (i == (1LL << k) - 1) return 1LL << (k - 1);
    }
    int64_t k = 1;
    while ((1LL << k) - 1 < i) ++k;
    return luby(i - (1LL << (k - 1)) + 1);
  }

  int n_vars_ = 0;
  bool broken_ = false;  // pool unsatisfiable at level 0: every query UNSAT
  std::vector<Clause> clauses_;
  std::vector<LBool> assign_;
  std::vector<uint8_t> phase_;
  std::vector<int> level_;
  std::vector<int> reason_;
  std::vector<double> activity_;
  std::vector<std::vector<int>> watches_;
  std::vector<uint8_t> seen_;
  std::vector<int> heap_;
  std::vector<int> heap_pos_;
  std::vector<Lit> trail_;
  std::vector<size_t> trail_lim_;
  size_t qhead_ = 0;
  size_t num_learned_ = 0;
  double var_inc_ = 1.0;
  double clause_inc_ = 1.0;
  int restart_count_ = 1;
};

}  // namespace

static bool feed_clauses(Solver& solver, const int32_t* lits, size_t n_lits) {
  std::vector<Lit> clause;
  for (size_t i = 0; i < n_lits; ++i) {
    int32_t l = lits[i];
    if (l == 0) {
      if (!solver.add_clause(clause)) return false;
      clause.clear();
    } else {
      int var = std::abs(l) - 1;
      clause.push_back(mk_lit(var, l < 0));
    }
  }
  // flush a trailing clause missing its 0 terminator rather than dropping it
  if (!clause.empty()) return solver.add_clause(clause);
  return true;
}

extern "C" int mtpu_solve(const int32_t* lits, size_t n_lits, int32_t n_vars,
                          int64_t max_conflicts, uint8_t* model_out,
                          int64_t timeout_ms) {
  Solver solver(n_vars);
  if (!feed_clauses(solver, lits, n_lits)) return 0;
  int result = solver.solve(max_conflicts, {}, timeout_ms);
  if (result == 1 && model_out) {
    for (int v = 0; v < n_vars; ++v)
      model_out[v] = solver.model(v) == kTrue ? 1 : 0;
  }
  return result;
}

// ---------------------------------------------------------------------------
// Incremental session API: a long-lived solver fed a monotone clause pool
// (the bit-blaster's structurally-hashed gate definitions), queried under
// assumption literals (the Tseitin roots of each path-constraint set).
// Learned clauses, VSIDS activities and saved phases persist across queries —
// the z3-incrementality equivalent the reference leans on
// (mythril/support/model.py:69, z3 Solver reuse).
// ---------------------------------------------------------------------------

extern "C" void* mtpu_session_new() { return new Solver(0); }

extern "C" void mtpu_session_free(void* handle) {
  delete static_cast<Solver*>(handle);
}

// returns 0 if the pool became unsatisfiable at level 0, else 1
extern "C" int mtpu_session_add(void* handle, const int32_t* lits,
                                size_t n_lits, int32_t max_var) {
  Solver* solver = static_cast<Solver*>(handle);
  solver->ensure_vars(max_var);
  return feed_clauses(*solver, lits, n_lits) ? 1 : 0;
}

// 1 SAT, 0 UNSAT under assumptions, -1 budget exceeded.
// On SAT, model_out[v-1] holds 0/1 for vars 1..n_vars.
extern "C" int mtpu_session_solve(void* handle, const int32_t* assumptions,
                                  size_t n_assumptions, int64_t max_conflicts,
                                  uint8_t* model_out, int32_t n_vars,
                                  int64_t timeout_ms) {
  Solver* solver = static_cast<Solver*>(handle);
  solver->ensure_vars(n_vars);
  std::vector<Lit> assume;
  assume.reserve(n_assumptions);
  for (size_t i = 0; i < n_assumptions; ++i) {
    int32_t l = assumptions[i];
    assume.push_back(mk_lit(std::abs(l) - 1, l < 0));
  }
  int result = solver->solve(max_conflicts, assume, timeout_ms);
  if (result == 1 && model_out) {
    for (int v = 0; v < n_vars; ++v)
      model_out[v] = solver->model(v) == kTrue ? 1 : 0;
  }
  return result;
}
