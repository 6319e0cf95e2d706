// odesat_tpu native host runtime (C ABI, loaded via ctypes).
//
// The TPU owns the numeric hot loop (JAX/Pallas); this library owns the
// host-side hot paths around it:
//
//  * DIMACS parsing (odesat_parse_dimacs) — the reference parses with
//    per-line string splitting (reference: src/cnf.rs:138-172); this is a
//    single-pass byte scanner for multi-hundred-MB CNF files.
//  * CNF preprocessing (odesat_preprocess) — blocked-clause elimination +
//    greedy bounded variable elimination + subsumption with a witness
//    trace (reference semantics: src/cnf.rs:418-840). This is the
//    reference's O(V*R)-per-round host bottleneck (SURVEY.md §3 hot spot
//    #3); the rebuild keeps bit-identical *deterministic* semantics with
//    the Python implementation in odesat_tpu/preprocess (sorted candidate
//    order, strict-less tie-breaking) — parity is enforced by tests.
//  * A single-threaded CPU ODE solver (odesat_baseline_*) implementing
//    the same dynamics (src/system.rs:25-154 semantics) used ONLY to
//    anchor benchmark baselines, since no Rust toolchain exists in this
//    environment to run the reference itself.
//
// Literal encoding across the ABI: lit = (variable << 1) | is_negated,
// so ordering by the encoded value equals ordering by (variable, neg)
// — the same order as the Rust BTreeSet<Literal> and the Python tuple
// sort, which keeps clause ordering deterministic and identical across
// all three implementations.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <map>
#include <set>
#include <thread>
#include <vector>

extern "C" {

typedef int32_t lit_t;

// ---------------------------------------------------------------------------
// memory helpers
// ---------------------------------------------------------------------------

void odesat_free(void* p) { std::free(p); }

static void* dup_bytes(const void* src, size_t n) {
  void* out = std::malloc(n ? n : 1);
  if (out && n) std::memcpy(out, src, n);
  return out;
}

// ---------------------------------------------------------------------------
// DIMACS parser
// ---------------------------------------------------------------------------

// Parses DIMACS text. Returns 0 on success. Outputs: flat literal array
// (encoded), clause offsets (n_clauses+1), declared varnum (-1 if no
// header; caller falls back to counting used variables). Blank /
// content-free lines are skipped; '%' ends the file (SATLIB).
int odesat_parse_dimacs(const char* text, int64_t len, lit_t** out_lits,
                        int64_t** out_offsets, int64_t* out_n_clauses,
                        int64_t* out_varnum) {
  std::vector<lit_t> lits;
  std::vector<int64_t> offsets;
  offsets.push_back(0);
  int64_t varnum = -1;

  const char* p = text;
  const char* end = text + len;
  while (p < end) {
    // find line end
    const char* eol = p;
    while (eol < end && *eol != '\n') ++eol;
    // skip leading whitespace
    const char* q = p;
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q == eol) { p = eol + 1; continue; }           // blank
    if (*q == 'c') { p = eol + 1; continue; }          // comment
    if (*q == '%') break;                              // SATLIB end marker
    if (*q == 'p') {
      // p cnf nbvar nbclauses — nbclauses ignored
      q += 1;
      while (q < eol && *q == ' ') ++q;
      if (eol - q < 3 || std::strncmp(q, "cnf", 3) != 0) return 1;
      q += 3;
      varnum = 0;
      while (q < eol && (*q == ' ' || *q == '\t')) ++q;
      bool any = false;
      while (q < eol && *q >= '0' && *q <= '9') {
        varnum = varnum * 10 + (*q - '0');
        ++q; any = true;
      }
      if (!any) return 1;
      p = eol + 1;
      continue;
    }
    // clause line: integers until 0 sentinel
    size_t start = lits.size();
    while (q < eol) {
      while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      if (q == eol) break;
      bool neg = false;
      if (*q == '-') { neg = true; ++q; }
      int64_t v = 0;
      bool any = false;
      while (q < eol && *q >= '0' && *q <= '9') {
        v = v * 10 + (*q - '0');
        ++q; any = true;
      }
      if (!any) return 2;  // junk token
      if (v == 0) break;   // sentinel: rest of line ignored
      lits.push_back((lit_t)((v << 1) | (neg ? 1 : 0)));
    }
    if (lits.size() > start) offsets.push_back((int64_t)lits.size());
    p = eol + 1;
  }

  *out_lits = (lit_t*)dup_bytes(lits.data(), lits.size() * sizeof(lit_t));
  *out_offsets =
      (int64_t*)dup_bytes(offsets.data(), offsets.size() * sizeof(int64_t));
  *out_n_clauses = (int64_t)offsets.size() - 1;
  *out_varnum = varnum;
  return 0;
}

// ---------------------------------------------------------------------------
// preprocessing (BCE + greedy VE + subsumption) with witness trace
// ---------------------------------------------------------------------------

namespace {

using Clause = std::vector<lit_t>;  // sorted encoded literals, deduped

struct ClauseLess {
  bool operator()(const Clause& a, const Clause& b) const {
    return std::lexicographical_compare(a.begin(), a.end(), b.begin(), b.end());
  }
};
using ClauseSet = std::set<Clause, ClauseLess>;

inline int32_t lit_var(lit_t l) { return l >> 1; }
inline bool lit_neg(lit_t l) { return l & 1; }
inline lit_t lit_compl(lit_t l) { return l ^ 1; }

// Occurrence lists: sorted unique vectors with a minimal set-like
// interface. Iteration order is identical to the std::set<Clause> this
// replaces (ascending ClauseLess), so every downstream consumer —
// resolvent generation order, trace serialization, blocked-clause
// scans — behaves byte-identically; the win is contiguous clause
// headers instead of tree-node chasing in the 6.6M-resolvent candidate
// scan (lists are ~10-20 entries, so the O(n) insert/erase moves are
// noise next to the 47k scans that iterate them).
struct SortedClauses {
  std::vector<Clause> v;
  void insert(const Clause& c) {
    auto it = std::lower_bound(v.begin(), v.end(), c, ClauseLess{});
    if (it == v.end() || *it != c) v.insert(it, c);
  }
  void erase(const Clause& c) {
    auto it = std::lower_bound(v.begin(), v.end(), c, ClauseLess{});
    if (it != v.end() && *it == c) v.erase(it);
  }
  size_t size() const { return v.size(); }
  bool empty() const { return v.empty(); }
  auto begin() const { return v.begin(); }
  auto end() const { return v.end(); }
};

struct Occ {
  SortedClauses pos, neg;
};

struct Pre {
  ClauseSet clauses;
  int64_t varnum;
  std::map<int32_t, Occ> index;

  // trace: serialized as it is produced
  std::vector<uint8_t> trace;

  // All-u32 little-endian stream (kind included) so the Python side
  // can decode the whole blob with one np.frombuffer instead of a
  // per-field byte walk (which was ~0.36 s of the n=10k preprocess).
  void trace_u32(uint32_t x) {
    for (int i = 0; i < 4; i++) trace.push_back((x >> (8 * i)) & 0xff);
  }
  void trace_clause(const Clause& c) {
    trace_u32((uint32_t)c.size());
    for (lit_t l : c) trace_u32((uint32_t)l);
  }
};

bool is_tautology(const Clause& c) {
  // literals sorted by (var, neg): complementary pair is adjacent
  for (size_t i = 0; i + 1 < c.size(); ++i)
    if (c[i + 1] == (c[i] ^ 1) && lit_var(c[i]) == lit_var(c[i + 1])) return true;
  return false;
}

void sort_dedup(Clause& c) {
  std::sort(c.begin(), c.end());
  c.erase(std::unique(c.begin(), c.end()), c.end());
}

// ---------------------------------------------------------------------------
// flat candidate-scan machinery (the greedy pick's hot path)
//
// candidate_ratio runs tens of times per VE round (47k scans on n=10k);
// the previous vector<Clause> + unordered_map formulation spent most of
// its time in per-resolvent heap allocations, append-then-sort clause
// construction, and per-scan hash-table builds. This version generates
// resolvents into one per-thread flat buffer with a linear sorted
// merge, dedups via an index sort, and runs the forward rarest-literal
// subsumption with per-literal occurrence vectors reused across scans
// (cleared through a touched list). The resulting resolvent SET is
// identical — parity with the Python twin stays byte-exact
// (tests/test_native.py).
// ---------------------------------------------------------------------------

struct ScanScratch {
  std::vector<lit_t> lits;     // flat resolvent literals
  std::vector<uint32_t> offs;  // resolvent k = [offs[k], offs[k+1])
  std::vector<uint32_t> idx;   // unique resolvents (first-occurrence order)
  std::vector<uint32_t> order; // subsumption processing order
  std::vector<char> alive;
  // stamped dedup hash table (stamp marks live entries; no per-scan clear)
  std::vector<uint32_t> tab, tab_stamp;
  uint32_t stamp = 0;
  // counting-sort occurrence lists: cnt/beg/cur per encoded literal,
  // items = flat per-literal buckets; size_cnt for the by-size order
  std::vector<uint32_t> cnt, beg, cur, items, size_cnt, size_beg;
  std::vector<uint64_t> mask;  // 64-bit literal bloom per resolvent
  std::vector<lit_t> touched;  // cnt entries used this scan
  std::vector<lit_t> nbuf;     // var-stripped neg clauses (flat)
  std::vector<uint32_t> noffs;
  Clause own;                  // pos clause minus var
};

ScanScratch& scan_scratch() {
  thread_local ScanScratch s;
  return s;
}

// Worker threads free their scratch at join; the calling thread's
// thread_local persists for the process lifetime, so odesat_preprocess
// releases it explicitly once the greedy loop is done (peak-scan
// buffers can hold tens of MB the solver no longer needs).
void release_scan_scratch() {
  ScanScratch& s = scan_scratch();
  s = ScanScratch{};
}

// Linear sorted merge of two var-stripped sorted ranges (candidate_
// ratio pre-strips the eliminated variable from both sides), deduped,
// appended to `out`. Returns false (and restores `out`) on a
// tautological resolvent. Encoded literals order as (var, neg), so a
// complementary pair is the adjacent values l/l^1 — detected while
// merging without any binary search.
bool merge_clean(const Clause& own, const lit_t* b0, const lit_t* b1,
                 std::vector<lit_t>& out) {
  const size_t start = out.size();
  size_t i = 0;
  const size_t ni = own.size();
  const lit_t* j = b0;
  for (;;) {
    if (i == ni && j == b1) break;
    if (j == b1) { out.insert(out.end(), own.begin() + i, own.end()); break; }
    if (i == ni) { out.insert(out.end(), j, b1); break; }
    lit_t a = own[i], b = *j;
    if (a == b) {
      lit_t comp = a ^ 1;
      bool taut = (a & 1)
          ? ((i > 0 && own[i - 1] == comp) || (j > b0 && *(j - 1) == comp))
          : ((i + 1 < ni && own[i + 1] == comp) ||
             (j + 1 < b1 && *(j + 1) == comp));
      if (taut) { out.resize(start); return false; }
      out.push_back(a); ++i; ++j;
    } else if (a < b) {
      if ((a ^ 1) == b) { out.resize(start); return false; }
      out.push_back(a); ++i;
    } else {
      if ((b ^ 1) == a) { out.resize(start); return false; }
      out.push_back(b); ++j;
    }
  }
  return true;
}

// True iff `clause` has at least one non-tautological, non-empty
// resolvent on `var` — calculate_resolvents(...).empty() without
// building anything (early exit on the first survivor).
bool any_resolvent(const Pre& st, const Clause& clause, int32_t var) {
  auto it = st.index.find(var);
  if (it == st.index.end()) return false;
  bool clause_has_pos =
      std::binary_search(clause.begin(), clause.end(), (lit_t)(var << 1));
  const SortedClauses& opposing = clause_has_pos ? it->second.neg : it->second.pos;
  bool own_nonempty = false;
  for (lit_t l : clause)
    own_nonempty = own_nonempty || (lit_var(l) != var);
  for (const Clause& other : opposing) {
    bool taut = false, other_nonempty = false;
    for (lit_t l : other) {
      if (lit_var(l) == var) continue;
      other_nonempty = true;
      // complement lookup in the ORIGINAL clause is safe: l's variable
      // differs from var, so it can't collide with the stripped lits
      if (std::binary_search(clause.begin(), clause.end(), lit_compl(l))) {
        taut = true;
        break;
      }
    }
    if (!taut && (own_nonempty || other_nonempty)) return true;
  }
  return false;
}

// blocking variable if some literal has no surviving resolvents, scanned
// in sorted literal order (matches Python's sorted(clause))
int32_t is_blocked(const Pre& st, const Clause& clause) {
  for (lit_t l : clause)
    if (!any_resolvent(st, clause, lit_var(l))) return lit_var(l);
  return -1;
}

// Occurrence-indexed subsumption for the full clause database: a
// subsuming clause contains only literals of the subsumed one, so it
// appears in the occurrence list of at least one of its literals —
// scanning those lists replaces the all-pairs O(M^2) sweep (50s at
// M=24k) with Sum_c Sum_{l in c} |occ(l)| short includes() tests.
// Produces exactly the same final set (strict-subset subsumers only).
void subsume_clauses(ClauseSet& clauses) {
  std::vector<Clause> to_remove;
  for (const Clause& c : clauses) {
    for (const Clause& other : clauses) {
      if (&c == &other || other.size() >= c.size()) continue;
      if (std::includes(c.begin(), c.end(), other.begin(), other.end())) {
        to_remove.push_back(c);
        break;
      }
    }
  }
  for (const Clause& c : to_remove) clauses.erase(c);
}

void index_remove(Pre& st, const Clause& c) {
  for (lit_t l : c) {
    auto it = st.index.find(lit_var(l));
    if (it == st.index.end()) continue;
    (lit_neg(l) ? it->second.neg : it->second.pos).erase(c);
  }
}

void index_add(Pre& st, const Clause& c) {
  for (lit_t l : c)
    (lit_neg(l) ? st.index[lit_var(l)].neg : st.index[lit_var(l)].pos).insert(c);
}

// returns changed vars; writes a BCE trace step
bool eliminate_if_blocked(Pre& st, const Clause& clause,
                          std::set<int32_t>* changed) {
  int32_t var = is_blocked(st, clause);
  if (var < 0) return false;
  for (lit_t l : clause)
    if (changed) changed->insert(lit_var(l));
  index_remove(st, clause);
  st.clauses.erase(clause);
  st.trace_u32(1);  // BCE
  st.trace_u32((uint32_t)var);
  st.trace_u32(1);
  st.trace_clause(clause);
  return true;
}

// VE by clause distribution; writes a VE trace step with the
// positive-occurrence clauses minus the eliminated literal
void eliminate_variable(Pre& st, int32_t var, const ClauseSet& resolvents,
                        std::set<int32_t>* changed) {
  auto it = st.index.find(var);
  if (it == st.index.end()) return;
  Occ occ = std::move(it->second);
  st.index.erase(it);

  std::vector<const Clause*> originals;
  for (const Clause& c : occ.pos) originals.push_back(&c);
  for (const Clause& c : occ.neg) originals.push_back(&c);

  for (const Clause* c : originals) {
    for (lit_t l : *c) {
      changed->insert(lit_var(l));
      auto jt = st.index.find(lit_var(l));
      if (jt == st.index.end()) continue;
      jt->second.pos.erase(*c);
      jt->second.neg.erase(*c);
    }
    st.clauses.erase(*c);
  }

  for (const Clause& r : resolvents) {
    st.clauses.insert(r);
    index_add(st, r);
  }
  st.varnum -= 1;

  // trace: VE(var, modified positive clauses)
  st.trace_u32(0);
  st.trace_u32((uint32_t)var);
  // build modified pos clauses (dedup via set for deterministic order)
  ClauseSet modified;
  lit_t pos_lit = (lit_t)(var << 1);
  for (const Clause& c : occ.pos) {
    Clause m;
    m.reserve(c.size());
    for (lit_t l : c)
      if (l != pos_lit) m.push_back(l);
    modified.insert(std::move(m));
  }
  st.trace_u32((uint32_t)modified.size());
  for (const Clause& m : modified) st.trace_clause(m);
}


// Persistent worker pool for the greedy pick's candidate scan. The
// scan runs once per elimination round (1339 rounds at n=10k) over a
// small candidate set (~35), so per-round std::thread spawning cost
// more than the ~1 ms of scan work it parallelized — measured net
// NEGATIVE on short rounds, and it also reallocated every worker's
// thread_local ScanScratch each round. Workers here live for the
// process, wait on a generation counter, and pull candidate indices
// off one shared atomic; per-worker scratch persists across rounds.
class ScanPool {
 public:
  static ScanPool& get() {
    static ScanPool p;
    return p;
  }

  // Run fn(i) for i in [0, n) on the pool + the calling thread.
  // Blocks until every pool thread has finished the generation.
  void run(size_t n, size_t workers, const std::function<void(size_t)>& fn) {
    // Serialize whole rounds: odesat_preprocess is reachable from
    // multiple Python threads (ctypes releases the GIL for the foreign
    // call) and job_/gen_/next_/done_ are process-wide — without this,
    // one call's workers could run against another call's dangling fn.
    std::lock_guard<std::mutex> entry(entry_mu_);
    {
      std::lock_guard<std::mutex> lk(mu_);
      // new threads capture the CURRENT generation so they cannot join
      // (and double-count `done_` for) a round already in flight
      while (threads_.size() < workers)
        threads_.emplace_back([this, g = gen_] { loop(g); });
      job_ = &fn;
      n_items_ = n;
      next_.store(0, std::memory_order_relaxed);
      done_ = 0;
      ++gen_;
    }
    cv_.notify_all();
    for (size_t i; (i = next_.fetch_add(1)) < n;) fn(i);
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [&] { return done_ == threads_.size(); });
    job_ = nullptr;
  }

  ~ScanPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

 private:
  void loop(uint64_t seen) {
    for (;;) {
      const std::function<void(size_t)>* job;
      size_t n;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || gen_ != seen; });
        if (stop_) return;
        seen = gen_;
        job = job_;
        n = n_items_;
      }
      if (job)
        for (size_t i; (i = next_.fetch_add(1)) < n;) (*job)(i);
      {
        std::lock_guard<std::mutex> lk(mu_);
        ++done_;
      }
      cv_done_.notify_one();
    }
  }

  std::mutex entry_mu_;  // serializes whole run() rounds across callers
  std::mutex mu_;
  std::condition_variable cv_, cv_done_;
  std::vector<std::thread> threads_;
  const std::function<void(size_t)>* job_ = nullptr;
  std::atomic<size_t> next_{0};
  size_t n_items_ = 0;
  size_t done_ = 0;
  uint64_t gen_ = 0;
  bool stop_ = false;
};

// greedy pick: variable minimizing the post-elimination ratio; accepted
// only while ratio <= target; candidates scanned in sorted order with
// strict-less tie-breaking (deterministic; matches the Python pipeline)
double g_t_resolve = 0;  // ODESAT_NATIVE_PROFILE (serial scan only)
double g_t_gen = 0, g_t_dedup = 0, g_t_sub = 0;  // candidate_ratio stages
double g_t_sub_occ = 0, g_t_sub_order = 0, g_t_sub_probe = 0;
long g_n_all = 0, g_n_uniq = 0, g_n_probes = 0, g_n_includes = 0;
long g_survivors = 0, g_occwalk = 0;
long g_n_prune0 = 0, g_n_prune2 = 0;  // can't-win prune hits per stage

struct StageTimer {
  // stage accounting for the profiled serial scan; compiled to nothing
  // measurable when ODESAT_NATIVE_PROFILE is unset
  double* sink;
  std::chrono::steady_clock::time_point t0;
  static bool on() {
    static const bool v = std::getenv("ODESAT_NATIVE_PROFILE") != nullptr;
    return v;
  }
  explicit StageTimer(double* s) : sink(s) {
    if (on()) t0 = std::chrono::steady_clock::now();
  }
  ~StageTimer() {
    if (on())
      *sink += std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0).count();
  }
};

// Forward rarest-literal subsumption sweep over a flat clause buffer:
// `idx` names |idx| sorted-literal clause spans of `offs` into `base`.
// Marks sc.alive[p] = 0 for every clause strictly subsumed by another
// in the set and returns the survivor count. Iterate potential
// subsumers ascending by size and probe only the rarest literal's
// occurrence list (a superset of s contains every literal of s, so it
// appears in all of s's lists). Dead subsumers are skipped:
// strict-subset subsumption is transitive (s' < s < c), so their
// victims fall to an earlier, still-alive ancestor — the final set is
// identical to the all-pairs sweep and independent of the processing
// order. Structured to prove "nothing to do" cheaply:
//  * occurrence lists store by-size RANKS, so a subsumer of size z
//    probes only the list suffix holding sizes > z;
//  * a 64-bit literal bloom mask per clause (bits l&63) rejects nearly
//    every survivor pair before std::includes touches the literals.
// Callers skip the call when n < 2 or all sizes are equal (a strict
// subset needs a strictly smaller subsumer).
size_t forward_subsume_flat(const lit_t* base, const std::vector<uint32_t>& offs,
                            const std::vector<uint32_t>& idx, uint32_t max_sz,
                            ScanScratch& sc) {
  const size_t n = idx.size();
  auto size_of = [&](uint32_t p) { return offs[idx[p] + 1] - offs[idx[p]]; };
  auto _tso = std::chrono::steady_clock::now();
  // per-literal occurrence lists built by counting sort into one flat
  // buffer (cnt/beg/cur reused across scans, cleared via `touched`);
  // the counting pass also builds the bloom masks
  lit_t max_lit = 0;
  for (uint32_t p = 0; p < n; ++p)
    max_lit = std::max(max_lit, base[offs[idx[p] + 1] - 1]);
  if ((size_t)max_lit >= sc.cnt.size()) {
    sc.cnt.resize(max_lit + 1, 0);
    sc.beg.resize(max_lit + 1);
    sc.cur.resize(max_lit + 1);
  }
  if (sc.mask.size() < n) sc.mask.resize(n);
  uint32_t total = 0;
  for (uint32_t p = 0; p < n; ++p) {
    uint64_t mk = 0;
    for (uint32_t o = offs[idx[p]]; o < offs[idx[p] + 1]; ++o) {
      lit_t l = base[o];
      if (sc.cnt[l]++ == 0) sc.touched.push_back(l);
      ++total;
      mk |= 1ull << (l & 63);
    }
    sc.mask[p] = mk;
  }
  uint32_t running = 0;
  for (lit_t l : sc.touched) {
    sc.beg[l] = running;
    sc.cur[l] = running;
    running += sc.cnt[l];
  }

  if (StageTimer::on()) {
    auto _now = std::chrono::steady_clock::now();
    g_t_sub_occ += std::chrono::duration<double>(_now - _tso).count();
    _tso = _now;
  }
  // ascending-size processing order via counting sort (stable);
  // size_beg snapshots each size's first rank before the fill
  // destroys the prefix array (suffix boundaries below)
  std::vector<uint32_t>& order = sc.order;
  order.resize(n);
  sc.size_cnt.assign(max_sz + 2, 0);
  for (uint32_t p = 0; p < n; ++p) ++sc.size_cnt[size_of(p) + 1];
  for (uint32_t z = 1; z <= max_sz + 1; ++z) sc.size_cnt[z] += sc.size_cnt[z - 1];
  sc.size_beg.assign(sc.size_cnt.begin(), sc.size_cnt.end());
  for (uint32_t p = 0; p < n; ++p) order[sc.size_cnt[size_of(p)]++] = p;

  // occurrence lists hold RANKS, filled in rank order so every list
  // ascends by size -- a subsumer probes only its strict-suffix
  sc.items.resize(total);
  for (uint32_t r = 0; r < n; ++r) {
    uint32_t p = order[r];
    for (uint32_t o = offs[idx[p]]; o < offs[idx[p] + 1]; ++o)
      sc.items[sc.cur[base[o]]++] = r;
  }

  if (StageTimer::on()) {
    auto _now = std::chrono::steady_clock::now();
    g_t_sub_order += std::chrono::duration<double>(_now - _tso).count();
    _tso = _now;
  }
  sc.alive.assign(n, 1);
  for (uint32_t r = 0; r < n; ++r) {
    uint32_t p = order[r];
    if (!sc.alive[p]) continue;
    const lit_t* s0 = base + offs[idx[p]];
    const lit_t* s1 = base + offs[idx[p] + 1];
    const uint32_t sz = (uint32_t)(s1 - s0);
    if (sz == max_sz) continue;  // nothing strictly larger to subsume
    lit_t rare = *s0;
    for (const lit_t* l = s0; l < s1; ++l)
      if (sc.cnt[*l] < sc.cnt[rare]) rare = *l;
    if (sc.cnt[rare] == 1) continue;  // the only occurrence is p itself
    const uint32_t* q0 = sc.items.data() + sc.beg[rare];
    const uint32_t* q1 = q0 + sc.cnt[rare];
    // first rank whose size exceeds sz (list ascends by rank)
    const uint32_t* qp = std::lower_bound(q0, q1, sc.size_beg[sz + 1]);
    if (StageTimer::on()) g_occwalk += (long)(q1 - qp);
    const uint64_t mp = sc.mask[p];
    for (; qp < q1; ++qp) {
      uint32_t q = order[*qp];
      if (!sc.alive[q]) continue;
      if (mp & ~sc.mask[q]) continue;  // some literal of p not in q
      if (StageTimer::on()) ++g_n_includes;
      if (std::includes(base + offs[idx[q]], base + offs[idx[q] + 1], s0, s1))
        sc.alive[q] = 0;
    }
  }
  if (StageTimer::on())
    g_t_sub_probe += std::chrono::duration<double>(
        std::chrono::steady_clock::now() - _tso).count();
  size_t survivors = 0;
  for (uint32_t p = 0; p < n; ++p) survivors += sc.alive[p] ? 1 : 0;
  for (lit_t l : sc.touched) sc.cnt[l] = 0;
  sc.touched.clear();
  return survivors;
}

// Final whole-formula subsumption pass (reference: src/cnf.rs:808 → 521)
// via the same forward sweep — the victim-side walk this replaces paid
// Sum_c Sum_l |occ(l)| over heavily-shared literals.
void subsume_clauses_indexed(ClauseSet& clauses) {
  // empty-clause special case: it subsumes every other clause but sits
  // in no occurrence list, so the sweep below would never visit it
  if (clauses.count(Clause{})) {
    clauses.clear();
    clauses.insert(Clause{});
    return;
  }
  const size_t n = clauses.size();
  if (n < 2) return;
  ScanScratch& sc = scan_scratch();
  std::vector<lit_t> L;
  std::vector<uint32_t> offs(1, 0);
  std::vector<const Clause*> ptrs;
  ptrs.reserve(n);
  uint32_t min_sz = UINT32_MAX, max_sz = 0;
  for (const Clause& c : clauses) {
    L.insert(L.end(), c.begin(), c.end());
    offs.push_back((uint32_t)L.size());
    ptrs.push_back(&c);
    min_sz = std::min(min_sz, (uint32_t)c.size());
    max_sz = std::max(max_sz, (uint32_t)c.size());
  }
  if (min_sz == max_sz) return;  // a strict subset needs a smaller subsumer
  std::vector<uint32_t> idx(n);
  for (uint32_t p = 0; p < n; ++p) idx[p] = p;
  forward_subsume_flat(L.data(), offs, idx, max_sz, sc);
  for (uint32_t p = 0; p < n; ++p)
    if (!sc.alive[p]) clauses.erase(*ptrs[p]);
}

// Per-candidate work of the greedy pick: resolvents + self-subsumption
// + the post-elimination ratio. Pure function of read-only `st`; all
// working memory lives in the per-thread ScanScratch.
//
// `prune_above`: a can't-win threshold (the scan's running best ratio).
// The function may return 1e300 early once a SOUND lower bound on this
// candidate's ratio exceeds it — such a candidate's true ratio is
// strictly above the scan's final minimum, so the greedy pick (and the
// `smallest > target` termination) are byte-identical to the unpruned
// scan. Two bounds, cheapest first:
//   stage 0 (before generation): survivors >= 0, so
//     ratio >= (C - |pos| - |neg|) / (V - 1);
//   stage 2 (after gen+dedup):   every minimum-size resolvent survives
//     self-subsumption (only a STRICTLY smaller subset can subsume), so
//     ratio >= (C - |pos| - |neg| + n_min_size) / (V - 1) — this skips
//     the subsume stage, the scan's most expensive, for most
//     non-winning candidates.
// Winner re-materialization (res_out != nullptr) never prunes.
double candidate_ratio(const Pre& st, int32_t var, std::vector<Clause>* res_out,
                       double prune_above = 1e300) {
  auto it = st.index.find(var);
  if (it == st.index.end()) return 1e300;
  const double vc = (double)st.varnum - 1;
  const double base_cnt = (double)st.clauses.size() -
                          (double)it->second.pos.size() -
                          (double)it->second.neg.size();
  if (!res_out && vc > 0 && base_cnt / vc > prune_above) {
    if (StageTimer::on()) ++g_n_prune0;
    return 1e300;
  }
  ScanScratch& sc = scan_scratch();
  std::vector<lit_t>& L = sc.lits;
  std::vector<uint32_t>& offs = sc.offs;
  L.clear();
  offs.assign(1, 0);

  // 1. generate all non-tautological, non-empty resolvents flat
  //    (empty resolvents silently dropped — reference quirk,
  //    src/cnf.rs:474-476)
  {
  StageTimer _t(&g_t_gen);
  // pre-strip the eliminated variable from every neg clause ONCE (each
  // is merged |pos| times; stripping in the merge paid the skip branch
  // per element per pair). Adjacent-complement tautology probes are
  // unaffected: l and l^1 are consecutive values, so removing var's
  // literal can never sit between a complement pair.
  std::vector<lit_t>& NB = sc.nbuf;
  std::vector<uint32_t>& NO = sc.noffs;
  NB.clear();
  NO.assign(1, 0);
  for (const Clause& other : it->second.neg) {
    for (lit_t l : other)
      if (lit_var(l) != var) NB.push_back(l);
    NO.push_back((uint32_t)NB.size());
  }
  const size_t nn = NO.size() - 1;
  for (const Clause& c : it->second.pos) {
    sc.own.clear();
    for (lit_t l : c)
      if (lit_var(l) != var) sc.own.push_back(l);
    for (size_t q = 0; q < nn; ++q) {
      const lit_t* b0 = NB.data() + NO[q];
      const lit_t* b1 = NB.data() + NO[q + 1];
      if (merge_clean(sc.own, b0, b1, L) && L.size() > offs.back())
        offs.push_back((uint32_t)L.size());
      else
        L.resize(offs.back());  // taut (already restored) or empty
    }
  }
  }
  const size_t n_all = offs.size() - 1;

  // 2. dedup via a stamped open-addressing hash table (first-occurrence
  //    order). The downstream consumers only need the unique SET: the
  //    subsumption sweep below is processing-order independent, the
  //    count feeds a ratio, and the winner's survivors land in a sorted
  //    ClauseSet — so no lexicographic sort is required (the index sort
  //    this replaced was ~25% of the scan).
  std::vector<uint32_t>& idx = sc.idx;
  idx.clear();
  const lit_t* base = L.data();
  auto seg_eq = [&](uint32_t a, uint32_t b) {
    return offs[a + 1] - offs[a] == offs[b + 1] - offs[b] &&
           std::equal(base + offs[a], base + offs[a + 1], base + offs[b]);
  };
  {
    StageTimer _t(&g_t_dedup);
    size_t want = 16;
    while (want < 2 * n_all) want <<= 1;
    if (sc.tab.size() < want) {
      sc.tab.assign(want, 0);
      sc.tab_stamp.assign(want, 0);
      sc.stamp = 0;
    }
    const size_t mask = sc.tab.size() - 1;
    ++sc.stamp;
    if (sc.stamp == 0) {  // stamp wrap: reset the table once per 2^32 scans
      std::fill(sc.tab_stamp.begin(), sc.tab_stamp.end(), 0);
      sc.stamp = 1;
    }
    for (uint32_t k = 0; k < n_all; ++k) {
      uint64_t h = 1469598103934665603ull;  // FNV-1a over the literals
      for (uint32_t o = offs[k]; o < offs[k + 1]; ++o) {
        h ^= (uint32_t)L[o];
        h *= 1099511628211ull;
      }
      h ^= h >> 32;
      size_t pos = (size_t)h & mask;
      bool dup = false;
      while (sc.tab_stamp[pos] == sc.stamp) {
        if (seg_eq(sc.tab[pos], k)) { dup = true; break; }
        pos = (pos + 1) & mask;
      }
      if (dup) continue;
      sc.tab_stamp[pos] = sc.stamp;
      sc.tab[pos] = k;
      idx.push_back(k);
    }
  }
  const size_t n = idx.size();

  size_t survivors = n;
  if (StageTimer::on()) { g_n_all += (long)n_all; g_n_uniq += (long)n; }
  // 3. self-subsumption of the resolvent set via forward_subsume_flat
  //    (rationale and structure documented at the function definition).
  //    All-one-size scans exit immediately — a strict subset needs a
  //    strictly smaller subsumer — and the min-size count feeds the
  //    stage-2 can't-win prune below.
  auto size_of = [&](uint32_t p) { return offs[idx[p] + 1] - offs[idx[p]]; };
  uint32_t max_sz = 0, min_sz = 0, n_min_cnt = 0;
  if (n >= 2) {
    min_sz = UINT32_MAX;
    for (uint32_t p = 0; p < n; ++p) {
      uint32_t z = size_of(p);
      max_sz = std::max(max_sz, z);
      if (z < min_sz) { min_sz = z; n_min_cnt = 1; }
      else if (z == min_sz) ++n_min_cnt;
    }
  }
  // stage-2 prune: survivors >= n_min_cnt (nothing strictly smaller
  // exists to subsume a minimum-size resolvent), so skip the subsume
  // stage when even that floor keeps this candidate above the running
  // best (see the prune_above contract in the function comment)
  if (!res_out && n >= 2 && min_sz != max_sz && vc > 0 &&
      (base_cnt + (double)n_min_cnt) / vc > prune_above) {
    if (StageTimer::on()) ++g_n_prune2;
    return 1e300;
  }
  if (n >= 2 && min_sz != max_sz) {
    StageTimer _t(&g_t_sub);
    survivors = forward_subsume_flat(base, offs, idx, max_sz, sc);
    if (StageTimer::on()) g_survivors += (long)survivors;
    if (res_out) {
      res_out->clear();
      res_out->reserve(survivors);
      for (uint32_t p = 0; p < n; ++p)
        if (sc.alive[p])
          res_out->emplace_back(base + offs[idx[p]], base + offs[idx[p] + 1]);
    }
  } else if (res_out) {
    // single resolvent or all one size: every unique resolvent survives
    res_out->clear();
    res_out->reserve(n);
    for (uint32_t k : idx)
      res_out->emplace_back(base + offs[k], base + offs[k + 1]);
  }

  return vc > 0 ? (base_cnt + (double)survivors) / vc : 1e300;
}

bool min_ratio_resolvant(const Pre& st, const std::set<int32_t>& candidates,
                         float target, int32_t* out_var,
                         ClauseSet* out_resolvents) {
  const bool prof = std::getenv("ODESAT_NATIVE_PROFILE") != nullptr;
  auto now = [] { return std::chrono::steady_clock::now(); };
  // Scan candidates in a cheap ratio-proxy order — ascending
  // |pos|*|neg| - |pos| - |neg| (resolvents generated minus clauses
  // removed) — so the running best drops fast and the can't-win prune
  // in candidate_ratio fires for most of the scan. The reduce below is
  // lexicographic on (ratio, var), which equals the reference's
  // first-strict-less scan over ascending vars (lowest var among ties),
  // so the pick is independent of this order.
  std::vector<int32_t> vars(candidates.begin(), candidates.end());
  {
    std::vector<std::pair<int64_t, int32_t>> ord;
    ord.reserve(vars.size());
    for (int32_t var : vars) {
      auto it = st.index.find(var);
      int64_t key = INT64_MAX;
      if (it != st.index.end()) {
        const int64_t p = (int64_t)it->second.pos.size();
        const int64_t q = (int64_t)it->second.neg.size();
        key = p * q - p - q;
      }
      ord.emplace_back(key, var);
    }
    std::sort(ord.begin(), ord.end());
    for (size_t i = 0; i < ord.size(); ++i) vars[i] = ord[i].second;
  }
  const size_t n = vars.size();
  unsigned hw = std::thread::hardware_concurrency();
  // ODESAT_NATIVE_THREADS overrides the pool width (0/unset = hardware
  // count) — production control, and the only way to exercise the
  // threaded scan on single-core hosts.
  if (const char* env = std::getenv("ODESAT_NATIVE_THREADS")) {
    long want = std::atol(env);
    if (want > 0) hw = (unsigned)want;
  }
  size_t nt = std::min<size_t>(hw ? hw : 1, n);
  if (prof) nt = 1;  // keep the resolve/subsume split meaningful

  double smallest = 1e300;
  int32_t best = -1;
  std::vector<Clause> best_res;
  if (nt > 1 && n >= 16) {
    // The candidate scan only READS `st`; each worker pulls candidate
    // indices off a shared atomic counter and records its ratio. The
    // reduce below is a sequential argmin over the ascending-var order,
    // so the winner (strict-less tie-break = lowest var) is
    // byte-identical to the serial scan — parity with the Python twin
    // stays exact (tests/test_native.py). Workers come from the
    // persistent ScanPool (per-round std::thread spawning measured net
    // negative on ~1 ms rounds).
    std::vector<double> ratios(n, 1e300);
    // shared running best for the can't-win prune: ratios are finite
    // non-negative doubles, whose IEEE ordering equals their bit
    // pattern's integer ordering, so a relaxed CAS-min on the bits
    // suffices. A stale (larger) read only prunes less — the reduce
    // below still sees every candidate that could win, so the pick
    // stays byte-identical run to run.
    uint64_t inf_bits;
    {
      double d = 1e300;
      std::memcpy(&inf_bits, &d, sizeof d);
    }
    std::atomic<uint64_t> best_bits(inf_bits);
    ScanPool::get().run(n, nt - 1, [&](size_t i) {
      uint64_t b = best_bits.load(std::memory_order_relaxed);
      double cur;
      std::memcpy(&cur, &b, sizeof cur);
      double r = candidate_ratio(st, vars[i], nullptr, cur);
      ratios[i] = r;
      uint64_t rb;
      std::memcpy(&rb, &r, sizeof rb);
      while (rb < b &&
             !best_bits.compare_exchange_weak(b, rb, std::memory_order_relaxed)) {
      }
    });
    size_t bi = n;
    for (size_t i = 0; i < n; ++i)
      if (ratios[i] < smallest ||
          (bi < n && ratios[i] == smallest && vars[i] < vars[bi])) {
        smallest = ratios[i];
        bi = i;
      }
    if (bi == n || smallest > (double)target) return false;
    best = vars[bi];
    // recompute only the winner's resolvents (one candidate's work —
    // cheaper than keeping every candidate's vector alive)
    candidate_ratio(st, best, &best_res);
  } else {
    // count-only scans; only the winner's resolvents are materialized
    // (the res_out emission per candidate was ~6.6M Clause allocations
    // across the n=10k run)
    for (int32_t var : vars) {
      auto ta = now();
      double ratio = candidate_ratio(st, var, nullptr, smallest);
      if (prof) {
        auto tc = now();
        g_t_resolve += std::chrono::duration<double>(tc - ta).count();
      }
      if (ratio < smallest || (ratio == smallest && best >= 0 && var < best)) {
        smallest = ratio;
        best = var;
      }
    }
    if (best < 0 || smallest > (double)target) return false;
    candidate_ratio(st, best, &best_res);
  }
  *out_var = best;
  out_resolvents->clear();
  for (Clause& c : best_res) out_resolvents->insert(std::move(c));
  return true;
}

}  // namespace

// Preprocess: inputs are encoded literals + offsets; outputs reduced
// formula (caller frees) + trace blob. Returns 0 on success.
int odesat_preprocess(const lit_t* lits, const int64_t* offsets,
                      int64_t n_clauses, int64_t varnum, float target_ratio,
                      lit_t** out_lits, int64_t** out_offsets,
                      int64_t* out_n_clauses, int64_t* out_varnum,
                      uint8_t** out_trace, int64_t* out_trace_len) {
  const bool prof = std::getenv("ODESAT_NATIVE_PROFILE") != nullptr;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t0 = now();
  g_t_resolve = g_t_gen = g_t_dedup = g_t_sub = 0;  // per-call stage split
  g_t_sub_occ = g_t_sub_order = g_t_sub_probe = 0;
  g_n_all = g_n_uniq = g_n_includes = g_survivors = g_occwalk = 0;
  g_n_prune0 = g_n_prune2 = 0;
  Pre st;
  st.varnum = varnum;
  for (int64_t m = 0; m < n_clauses; ++m) {
    Clause c(lits + offsets[m], lits + offsets[m + 1]);
    sort_dedup(c);
    st.clauses.insert(std::move(c));
  }
  for (const Clause& c : st.clauses) index_add(st, c);

  // initial BCE sweep: snapshot blocked clauses, then eliminate
  std::vector<Clause> blocked;
  for (const Clause& c : st.clauses)
    if (is_blocked(st, c) >= 0) blocked.push_back(c);
  for (const Clause& c : blocked) eliminate_if_blocked(st, c, nullptr);
  auto t1 = now();

  // greedy VE loop
  double t_pick = 0, t_elim = 0, t_bce = 0;
  long n_rounds = 0, n_cands = 0;
  std::set<int32_t> candidates;
  for (auto& kv : st.index) candidates.insert(kv.first);
  for (;;) {
    int32_t var;
    ClauseSet resolvents;
    auto ta = now();
    bool found =
        min_ratio_resolvant(st, candidates, target_ratio, &var, &resolvents);
    auto tb = now();
    t_pick += secs(ta, tb);
    n_rounds += 1;
    n_cands += (long)candidates.size();
    if (!found) break;
    candidates.clear();
    eliminate_variable(st, var, resolvents, &candidates);
    auto tc = now();
    t_elim += secs(tb, tc);
    for (const Clause& r : resolvents) {
      if (!st.clauses.count(r)) continue;
      std::set<int32_t> changed2;
      if (eliminate_if_blocked(st, r, &changed2))
        candidates.insert(changed2.begin(), changed2.end());
    }
    t_bce += secs(tc, now());
  }
  if (prof)
    std::fprintf(stderr,
                 "[odesat_native] greedy VE split: pick %.2fs "
                 "(resolve+subsume %.2fs = gen %.2f + dedup %.2f + "
                 "subsume %.2f; profiling forces the serial scan), "
                 "elim %.2fs, "
                 "bce-on-resolvents %.2fs (%ld rounds, %ld candidate scans)\n"
                 "[odesat_native] subsume split: occ %.3f order %.3f probe %.3f"
                 " | n_all %ld uniq %ld includes %ld\n"
                 "[odesat_native] stats: survivors %ld occwalk %ld "
                 "prune0 %ld prune2 %ld\n",
                 t_pick, g_t_resolve, g_t_gen, g_t_dedup, g_t_sub, t_elim,
                 t_bce, n_rounds, n_cands,
                 g_t_sub_occ, g_t_sub_order, g_t_sub_probe,
                 g_n_all, g_n_uniq, g_n_includes,
                 g_survivors, g_occwalk, g_n_prune0, g_n_prune2);
  auto t2 = now();
  release_scan_scratch();  // drop the peak-VE buffers before the final pass
  subsume_clauses_indexed(st.clauses);  // regrows a small final-set scratch
  release_scan_scratch();
  auto t3 = now();
  if (prof)
    std::fprintf(stderr,
                 "[odesat_native] preprocess phases: build+bce %.2fs, "
                 "greedy VE %.2fs, final subsume %.2fs\n",
                 secs(t0, t1), secs(t1, t2), secs(t2, t3));

  // serialize reduced formula (ClauseSet iteration = deterministic order)
  std::vector<lit_t> flat;
  std::vector<int64_t> offs;
  offs.push_back(0);
  for (const Clause& c : st.clauses) {
    flat.insert(flat.end(), c.begin(), c.end());
    offs.push_back((int64_t)flat.size());
  }
  *out_lits = (lit_t*)dup_bytes(flat.data(), flat.size() * sizeof(lit_t));
  *out_offsets = (int64_t*)dup_bytes(offs.data(), offs.size() * sizeof(int64_t));
  *out_n_clauses = (int64_t)offs.size() - 1;
  *out_varnum = st.varnum;
  *out_trace = (uint8_t*)dup_bytes(st.trace.data(), st.trace.size());
  *out_trace_len = (int64_t)st.trace.size();
  return 0;
}

// ---------------------------------------------------------------------------
// single-core CPU baseline solver (benchmark anchor)
// ---------------------------------------------------------------------------

namespace {

struct Baseline {
  // flattened clause structure over normalized variables [0, n)
  std::vector<int32_t> var;    // per literal
  std::vector<double> q;       // +1 / -1 per literal
  std::vector<int64_t> offs;   // clause offsets
  int64_t n_vars, n_clauses;

  std::vector<double> v, xs, xl, dv, dxs, dxl;

  // one derivative evaluation; returns allsat
  bool derivatives(double zeta) {
    std::fill(dv.begin(), dv.end(), 0.0);
    bool allsat = true;
    for (int64_t m = 0; m < n_clauses; ++m) {
      double mn = 1e300, mn2 = 1e300;
      for (int64_t i = offs[m]; i < offs[m + 1]; ++i) {
        double value = 1.0 - q[i] * v[var[i]];
        if (value < mn) { mn2 = mn; mn = value; }
        else if (value < mn2) { mn2 = value; }
      }
      double c = 0.5 * mn;
      for (int64_t i = offs[m]; i < offs[m + 1]; ++i) {
        double value = 1.0 - q[i] * v[var[i]];
        double g = 0.5 * q[i] * (value != mn ? mn : mn2);
        double r = (c == value) ? 0.5 * (q[i] - v[var[i]]) : 0.0;
        dv[var[i]] += xl[m] * xs[m] * g + (1.0 + zeta * xl[m]) * (1.0 - xs[m]) * r;
      }
      dxs[m] = 20.0 * (xs[m] + 1e-3) * (c - 0.25);
      dxl[m] = 5.0 * (c - 0.05);
      allsat = allsat && (c < 0.25);
    }
    return allsat;
  }

  void update(double dt) {
    double cap = 1e4 * (double)n_clauses;
    for (int64_t m = 0; m < n_clauses; ++m) {
      xs[m] = std::fmin(std::fmax(xs[m] + dt * dxs[m], 1e-3), 1.0 - 1e-3);
      xl[m] = std::fmin(std::fmax(xl[m] + dt * dxl[m], 1.0), cap);
    }
    for (int64_t i = 0; i < n_vars; ++i)
      v[i] = std::fmin(std::fmax(v[i] + dt * dv[i], -1.0), 1.0);
  }
};

uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13; x ^= x >> 7; x ^= x << 17;
  return *s = x;
}

}  // namespace

// Runs `steps` fixed-dt steps of the single-core ODE on a normalized
// formula; returns steps/second (wall). Used to anchor vs_baseline.
double odesat_baseline_steps_per_sec(const lit_t* lits, const int64_t* offsets,
                                     int64_t n_clauses, int64_t varnum,
                                     int64_t steps, double dt, double zeta,
                                     uint64_t seed) {
  Baseline b;
  b.n_vars = varnum;
  b.n_clauses = n_clauses;
  b.offs.assign(offsets, offsets + n_clauses + 1);
  int64_t n_lits = offsets[n_clauses];
  b.var.resize(n_lits);
  b.q.resize(n_lits);
  for (int64_t i = 0; i < n_lits; ++i) {
    b.var[i] = lit_var(lits[i]);
    b.q[i] = lit_neg(lits[i]) ? -1.0 : 1.0;
  }
  b.v.resize(varnum);
  uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ULL;
  for (int64_t i = 0; i < varnum; ++i)
    b.v[i] = 2.0 * ((double)(xorshift(&s) >> 11) / 9007199254740992.0) - 1.0;
  b.xs.assign(n_clauses, 0.0);
  for (int64_t m = 0; m < n_clauses; ++m) {
    bool any_neg = false;
    for (int64_t i = offsets[m]; i < offsets[m + 1]; ++i)
      any_neg = any_neg || lit_neg(lits[i]);
    b.xs[m] = any_neg ? 1.0 : -1.0;
  }
  b.xl.assign(n_clauses, 1.0);
  b.dv.resize(varnum);
  b.dxs.resize(n_clauses);
  b.dxl.resize(n_clauses);

  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  int64_t done = 0;
  for (; done < steps; ++done) {
    b.derivatives(zeta);  // no early exit: steady-state throughput
    b.update(dt);
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  double elapsed =
      (double)(t1.tv_sec - t0.tv_sec) + 1e-9 * (double)(t1.tv_nsec - t0.tv_nsec);
  // fold a data dependence into the result so the loop cannot be elided
  volatile double sink = b.v[0];
  (void)sink;
  return (double)done / elapsed;
}

}  // extern "C"
