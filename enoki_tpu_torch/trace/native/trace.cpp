// enoki_tpu_torch native trace runtime: graph construction, scheduler,
// refcounts, dirty tracking and structural kernel-cache hashing.
//
// The port's own copy of the lazy trace's core (the JAX package keeps
// another; the two never share a library or a symbol). It is the
// counterpart of the source paper's compiled tracing JIT (src/cuda/jit.cu):
// there, a global Context owns a variable table, live set, dirty list and
// kernel cache, ops append PTX templates (cuda_trace_append,
// jit.cu:701-861), and cuda_eval() topo-sorts live variables with
// subtree-size-priority child ordering before emitting one fused kernel
// (jit.cu:983-1508). Here the C++ core owns the same responsibilities --
// trace append with broadcast validation, external/internal reference
// counting, scatter dirty-marking, DFS scheduling, and a structural hash
// that keys the compiled-kernel cache -- while code generation is the
// Python side's (trace/codegen.py writes one CUDA kernel per fused run of
// the schedule on the card; trace/plain.py interprets the schedule over
// PyTorch ops on the CPU).
//
// Exposed as a plain C ABI consumed via ctypes, every symbol prefixed
// ett_ and everything else hidden (built with -fvisibility=hidden), so
// that a process holding both packages' cores keeps two states.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

enum : uint32_t { kMaxDeps = 4 };

struct Variable {
    int32_t opcode = 0;
    int32_t dtype = 0;
    uint64_t size = 0;
    uint32_t dep[kMaxDeps] = {0, 0, 0, 0};
    int32_t ext_ref = 0;   // references held by Python handles
    int32_t int_ref = 0;   // references held by other variables' deps
    uint64_t literal = 0;  // literal payload as a dtype bit pattern
                           // (zero-extended to 64 bits; bit-exact for
                           // every dtype incl. u64 -- a double carrier
                           // would truncate ints >= 2^53)
    bool is_literal = false;
    bool is_data = false;    // leaf backed by a Python-held device buffer
    bool side_effect = false;  // scatter-like: must be kept until evaluated
    bool dirty = false;        // scatter target: reads must eval first
    bool materialized = false;  // buffer exists on the Python side
    uint64_t subtree_size = 1;  // priority for child ordering at schedule
};

struct Context {
    std::unordered_map<uint32_t, Variable> vars;
    // labels live OUT of Variable: they are rare (debug tooling only)
    // and an inline std::string would put a non-trivial ctor/dtor and
    // 32 dead bytes on the append hot path
    std::unordered_map<uint32_t, std::string> labels;
    uint32_t ctr = 1;  // 0 is the null variable
    bool ctr_wrapped = false;  // 2^32 appends happened at least once
    std::vector<uint32_t> side_effects;  // pending scatter ops
    int log_level = 0;
    // stats (whos-style accounting, jit.cu:1564-1634)
    uint64_t n_appends = 0, n_evals = 0, n_freed = 0, peak_vars = 0;
    Context() { vars.reserve(1u << 16); }
};

Context ctx;

struct ScheduleEntry {
    uint32_t id;
    int32_t opcode;
    int32_t dtype;
    uint64_t size;
    // positional indices into the schedule (or ~0u for absent), so the
    // hash is structural -- independent of variable-id numbering
    uint32_t dep_pos[kMaxDeps];
    uint64_t literal;  // dtype bit pattern (see Variable::literal)
    uint8_t is_literal;
    uint8_t is_data;
};

struct Schedule {
    std::vector<ScheduleEntry> entries;
    std::vector<uint32_t> outputs;  // positions in `entries`
    uint64_t hash = 0;
};

Schedule sched;

Variable *var(uint32_t id) {
    auto it = ctx.vars.find(id);
    return it == ctx.vars.end() ? nullptr : &it->second;
}

void free_var(uint32_t id);

// Freeing is ITERATIVE for the same reason the schedule DFS is: dropping
// the head handle of a 10^5+-op unevaluated chain (or releasing a
// consumed subgraph's deps after a deep-chain eval) must not recurse the
// C stack one frame per op. Single-threaded: the worklist never sees
// reentrant use (nothing here calls back out).
void free_var(uint32_t id) {
    static std::vector<uint32_t> work;  // pending dec_ref_int targets
    Variable *v = var(id);
    if (!v) return;
    for (uint32_t d : v->dep)
        if (d) work.push_back(d);
    ctx.vars.erase(id);
    if (!ctx.labels.empty()) ctx.labels.erase(id);
    ctx.n_freed++;
    while (!work.empty()) {
        uint32_t cur = work.back();
        work.pop_back();
        Variable *cv = var(cur);
        if (!cv) continue;
        if (--cv->int_ref <= 0 && cv->ext_ref <= 0) {
            for (uint32_t d : cv->dep)
                if (d) work.push_back(d);
            ctx.vars.erase(cur);
            if (!ctx.labels.empty()) ctx.labels.erase(cur);
            ctx.n_freed++;
        }
    }
}

void dec_ref_int(uint32_t id) {
    Variable *v = var(id);
    if (!v) return;
    if (--v->int_ref <= 0 && v->ext_ref <= 0) free_var(id);
}

// Fresh variable id. Pre-wrap (the first 2^32 appends -- years of normal
// sessions, ~20 min of nothing-but-appends) this is one predictable
// branch on the hot path. After a wrap, probe past still-live ids so a
// new variable can never alias and overwrite a live one (which would
// corrupt deps/refcounts of unrelated arrays). Python-side id-keyed
// caches tolerate recycling: _BUFFERS prunes dead vids each eval,
// _VERSION prunes on read, and the partition cache is dirty-checked and
// 256-entry bounded -- all far smaller than one 2^32 cycle.
uint32_t next_id() {
    uint32_t id = ctx.ctr++;
    if (ctx.ctr == 0) ctx.ctr_wrapped = true, ctx.ctr = 1;
    if (!ctx.ctr_wrapped) return id;
    while (id == 0 || ctx.vars.count(id)) {
        id = ctx.ctr++;
        if (ctx.ctr == 0) ctx.ctr = 1;
    }
    return id;
}

}  // namespace

#pragma GCC visibility push(default)
extern "C" {

// ---- variable creation -------------------------------------------------

// Append an op. Broadcast rule identical to cuda_trace_append
// (jit.cu:776-782): every dep size must be 1 or equal to the op size.
// Returns the new variable id, 0 on a size violation, or (uint32_t)-1
// when a dependency is dirty (the caller must eval it and retry -- the
// read-after-scatter protocol, jit.cu:719-730; the check lives here so
// the binding layer pays one map lookup per dependency, not two).
// References into std::unordered_map stay valid across inserts, so the
// dep pointers gathered during validation are reused for the int_ref
// increments after the insert below.
uint32_t ett_append(int32_t opcode, int32_t dtype, uint64_t size,
                   uint32_t d0, uint32_t d1, uint32_t d2, uint32_t d3) {
    uint32_t deps[kMaxDeps] = {d0, d1, d2, d3};
    Variable *dv[kMaxDeps] = {nullptr, nullptr, nullptr, nullptr};
    uint64_t subtree = 1;
    for (int i = 0; i < (int)kMaxDeps; ++i) {
        uint32_t d = deps[i];
        if (!d) continue;
        Variable *v = var(d);
        if (!v) return 0;
        if (v->size != 1 && v->size != size && size != 1) return 0;
        if (v->dirty) return (uint32_t)-1;
        subtree += v->subtree_size;
        dv[i] = v;
    }
    uint32_t id = next_id();
    Variable &nv = ctx.vars[id];
    nv.opcode = opcode;
    nv.dtype = dtype;
    nv.size = size;
    std::memcpy(nv.dep, deps, sizeof(deps));
    nv.ext_ref = 1;
    nv.subtree_size = subtree;
    for (int i = 0; i < (int)kMaxDeps; ++i)
        if (dv[i]) dv[i]->int_ref++;
    ctx.n_appends++;
    ctx.peak_vars = std::max<uint64_t>(ctx.peak_vars, ctx.vars.size());
    if (ctx.log_level >= 4)
        std::fprintf(stderr, "ett_append(op=%d, id=%u, size=%llu)\n", opcode,
                     id, (unsigned long long)size);
    return id;
}

// Append without the broadcast-size check: gather/scatter ops mix the
// source/target size with the index size (the reference routes these
// through extra_dep for the same reason, jit.cu:61-111).
uint32_t ett_append_raw(int32_t opcode, int32_t dtype, uint64_t size,
                       uint32_t d0, uint32_t d1, uint32_t d2, uint32_t d3) {
    uint32_t deps[kMaxDeps] = {d0, d1, d2, d3};
    Variable *dv[kMaxDeps] = {nullptr, nullptr, nullptr, nullptr};
    uint64_t subtree = 1;
    for (int i = 0; i < (int)kMaxDeps; ++i) {
        uint32_t d = deps[i];
        if (!d) continue;
        Variable *v = var(d);
        if (!v) return 0;
        subtree += v->subtree_size;
        dv[i] = v;
    }
    uint32_t id = next_id();
    Variable &nv = ctx.vars[id];
    nv.opcode = opcode;
    nv.dtype = dtype;
    nv.size = size;
    std::memcpy(nv.dep, deps, sizeof(deps));
    nv.ext_ref = 1;
    nv.subtree_size = subtree;
    for (int i = 0; i < (int)kMaxDeps; ++i)
        if (dv[i]) dv[i]->int_ref++;
    ctx.n_appends++;
    ctx.peak_vars = std::max<uint64_t>(ctx.peak_vars, ctx.vars.size());
    return id;
}

uint32_t ett_literal(int32_t dtype, uint64_t value, uint64_t size) {
    uint32_t id = next_id();
    Variable &v = ctx.vars[id];
    v.dtype = dtype;
    v.size = size;
    v.ext_ref = 1;
    v.literal = value;
    v.is_literal = true;
    ctx.n_appends++;
    return id;
}

// Leaf variable backed by a Python-held device buffer.
uint32_t ett_data(int32_t dtype, uint64_t size) {
    uint32_t id = next_id();
    Variable &v = ctx.vars[id];
    v.dtype = dtype;
    v.size = size;
    v.ext_ref = 1;
    v.is_data = true;
    v.materialized = true;
    ctx.n_appends++;
    return id;
}

// ---- refcounting (jit.cu external/internal refs) -----------------------

void ett_inc_ref_ext(uint32_t id) {
    Variable *v = var(id);
    if (v) v->ext_ref++;
}

void ett_dec_ref_ext(uint32_t id) {
    Variable *v = var(id);
    if (!v) return;
    if (--v->ext_ref <= 0 && v->int_ref <= 0) free_var(id);
}

// ---- introspection ------------------------------------------------------

uint64_t ett_var_size(uint32_t id) { Variable *v = var(id); return v ? v->size : 0; }
int32_t ett_var_dtype(uint32_t id) { Variable *v = var(id); return v ? v->dtype : -1; }
int32_t ett_var_opcode(uint32_t id) { Variable *v = var(id); return v ? v->opcode : -1; }
int32_t ett_var_materialized(uint32_t id) { Variable *v = var(id); return v && v->materialized; }
// Internal (dep-held) reference count: > 0 means recorded, not-yet-
// evaluated ops read this variable (materialization releases dep refs,
// ett_set_materialized). The scatter path uses it to detect
// write-after-pending-read hazards.
int32_t ett_var_int_ref(uint32_t id) { Variable *v = var(id); return v ? v->int_ref : 0; }
int32_t ett_var_exists(uint32_t id) { return var(id) != nullptr; }
uint32_t ett_num_vars(void) { return (uint32_t)ctx.vars.size(); }

void ett_set_label(uint32_t id, const char *label) {
    Variable *v = var(id);
    if (v) ctx.labels[id] = label ? label : "";
}

// Label read-back for the tape introspection tools (the reference's
// graphviz/whos renderers read node labels, autodiff.cpp:1076,1165).
// Returns the label length (0 if unset / unknown id).
int32_t ett_get_label(uint32_t id, char *buf, int32_t cap) {
    auto it = ctx.labels.find(id);
    if (it == ctx.labels.end() || it->second.empty() || cap <= 0) {
        if (cap > 0) buf[0] = 0;
        return 0;
    }
    int32_t n = (int32_t)it->second.size();
    if (n >= cap) n = cap - 1;
    memcpy(buf, it->second.data(), (size_t)n);
    buf[n] = 0;
    return n;
}

// ---- scatter / dirty tracking (jit.cu:674,719-730) ----------------------

// Mark `target` dirty (a scatter wrote to it) and `op` as a side effect
// that must be retained until the next eval.
void ett_mark_side_effect(uint32_t op, uint32_t target) {
    Variable *t = var(target);
    Variable *o = var(op);
    if (t) t->dirty = true;
    if (o) {
        o->side_effect = true;
        o->int_ref++;  // keep alive until evaluated
    }
    ctx.side_effects.push_back(op);
}

int32_t ett_is_dirty(uint32_t id) {
    Variable *v = var(id);
    return v && v->dirty;
}

// Remove `op` from the pending side-effect list (and drop the keep-alive
// reference the mark added). Used when a newer scatter into the same
// target CHAINS on this one: the chain tail carries the side effect and
// the intermediate no longer needs its own output buffer.
void ett_unmark_side_effect(uint32_t op) {
    auto it = std::find(ctx.side_effects.begin(), ctx.side_effects.end(), op);
    if (it == ctx.side_effects.end()) return;
    ctx.side_effects.erase(it);
    Variable *o = var(op);
    if (o) o->side_effect = false;
    dec_ref_int(op);
}

int32_t ett_num_side_effects(void) { return (int32_t)ctx.side_effects.size(); }

// ---- scheduling (cuda_eval's DFS, jit.cu:1385-1416) ----------------------

namespace {

// 64-bit word mixer for the structural hash (splitmix64 finalizer):
// the old byte-at-a-time FNV cost ~70 ns/entry over the ~33 hashed
// bytes; four word mixes per entry cost ~8 ns at equal key quality for
// cache-keying purposes.
inline uint64_t mix64(uint64_t h, uint64_t w) {
    h ^= w;
    h *= 0xff51afd7ed558ccdull;
    h ^= h >> 33;
    return h;
}

// Iterative post-order DFS (a fused chain can be 10^5+ ops deep; native
// recursion would overflow the C stack). Children are visited larger
// subtree first so register pressure in the fused program stays low --
// the subtree-size-priority child ordering of the reference scheduler
// (jit.cu:1385-1416). `order` carries the Variable pointer alongside
// the id: unordered_map references are stable, and the later schedule
// passes would otherwise re-look-up every node.
void dfs(uint32_t root, std::vector<std::pair<uint32_t, Variable *>> &order,
         std::unordered_map<uint32_t, uint32_t> &pos) {
    struct Frame { uint32_t id; uint8_t next; uint32_t kids[kMaxDeps];
                   uint8_t n_kids; Variable *v; };
    static std::vector<Frame> stack;  // reused across calls
    stack.clear();

    auto push = [&](uint32_t id) -> bool {
        if (pos.count(id)) return false;
        Variable *v = var(id);
        if (!v) return false;
        pos[id] = ~0u;  // visiting marker: one push per node, even in
                        // diamond-shaped graphs (overwritten at emit)
        Frame f;
        f.id = id;
        f.next = 0;
        f.n_kids = 0;
        f.v = v;
        if (!(v->materialized || v->is_literal)) {
            // collect + order children by descending subtree size
            // (insertion sort over <= 4 entries)
            uint64_t sz[kMaxDeps];
            for (uint32_t k = 0; k < kMaxDeps; ++k) {
                uint32_t d = v->dep[k];
                if (!d) continue;
                Variable *vd = var(d);
                uint64_t s = vd ? vd->subtree_size : 0;
                uint32_t j = f.n_kids;
                while (j > 0 && sz[j - 1] < s) {
                    f.kids[j] = f.kids[j - 1];
                    sz[j] = sz[j - 1];
                    --j;
                }
                f.kids[j] = d;
                sz[j] = s;
                ++f.n_kids;
            }
        }
        stack.push_back(f);
        return true;
    };

    if (!push(root)) return;
    while (!stack.empty()) {
        Frame &f = stack.back();
        if (f.next < f.n_kids) {
            uint32_t child = f.kids[f.next++];
            push(child);  // no-op if already placed
        } else {
            pos[f.id] = (uint32_t)order.size();
            order.emplace_back(f.id, f.v);
            stack.pop_back();
        }
    }
}

}  // namespace

// Build a schedule for `n` output variables (plus all pending side
// effects). Returns the number of schedule entries.
//
// Like cuda_eval (jit.cu:1165-1205), every *externally referenced*
// unevaluated variable that the schedule touches becomes an additional
// output: a Python handle held across an eval must be backed by a real
// buffer afterwards (its producing subgraph is released), and the AD
// tape can then hand out gradients of intermediates.
uint32_t ett_schedule(const uint32_t *outs, uint32_t n) {
    sched.entries.clear();
    sched.outputs.clear();

    // dedup: an explicitly requested id may also be a pending side
    // effect (a held scatter handle under eval-all-live); a duplicate
    // output slot would double its cotangent in the AD tape
    std::vector<uint32_t> roots;
    {
        std::unordered_map<uint32_t, bool> seen;
        for (uint32_t i = 0; i < n; ++i)
            if (!seen.count(outs[i])) { seen[outs[i]] = true; roots.push_back(outs[i]); }
        for (uint32_t se : ctx.side_effects)
            if (!seen.count(se)) { seen[se] = true; roots.push_back(se); }
    }

    static uint32_t last_n = 1024;  // pos sizing hint from the last run
    std::vector<std::pair<uint32_t, Variable *>> order;
    std::unordered_map<uint32_t, uint32_t> pos;
    order.reserve(last_n);
    pos.reserve(last_n + last_n / 2);
    for (uint32_t r : roots) dfs(r, order, pos);
    last_n = (uint32_t)order.size() | 1;

    std::unordered_map<uint32_t, bool> is_root;
    for (uint32_t r : roots) is_root[r] = true;
    for (auto &ov : order) {
        Variable *v = ov.second;
        if (v->ext_ref > 0 && !v->materialized && !v->is_literal &&
            !is_root.count(ov.first)) {
            roots.push_back(ov.first);
            is_root[ov.first] = true;
        }
    }

    sched.entries.reserve(order.size());
    uint64_t h = 0xcbf29ce484222325ull;
    for (auto &ov : order) {
        Variable *v = ov.second;
        ScheduleEntry e;
        e.id = ov.first;
        e.opcode = (v->materialized || v->is_literal) ? 0 : v->opcode;
        e.dtype = v->dtype;
        e.size = v->size;
        e.literal = v->literal;
        e.is_literal = v->is_literal;
        e.is_data = v->materialized && !v->is_literal;
        for (uint32_t k = 0; k < kMaxDeps; ++k) {
            uint32_t d = (e.opcode && v->dep[k]) ? v->dep[k] : 0;
            e.dep_pos[k] = d ? pos[d] : ~0u;
        }
        sched.entries.push_back(e);
        // structural hash: opcode, dtype, broadcast-class (size==1 vs
        // full), positional deps -- the analog of the reference's
        // kernel source hash (jit.cu:1239-1249)
        // NOTE: literal VALUES are deliberately not hashed -- the Python
        // side passes them as runtime scalar inputs, so a program that
        // differs only in a constant (a moved scene parameter, a new
        // epsilon) reuses the compiled kernel: the kernels read their
        // literals from a stream at run time. (The source paper embeds
        // literals in the PTX source and recompiles on change,
        // cuda.h:267-317.)
        uint64_t kind = e.is_literal ? 3 : (e.size == 1 ? 1 : 2);
        h = mix64(h, (uint64_t)(uint32_t)e.opcode |
                         ((uint64_t)(uint32_t)e.dtype << 32));
        h = mix64(h, kind | (e.size != 1 ? e.size << 2 : 0));
        h = mix64(h, (uint64_t)e.dep_pos[0] | ((uint64_t)e.dep_pos[1] << 32));
        h = mix64(h, (uint64_t)e.dep_pos[2] | ((uint64_t)e.dep_pos[3] << 32));
    }
    for (uint32_t r : roots) {
        uint32_t p = pos.count(r) ? pos[r] : ~0u;
        sched.outputs.push_back(p);
        h = mix64(h, p);
    }
    sched.hash = h;
    ctx.n_evals++;
    if (ctx.log_level >= 1)
        std::fprintf(stderr, "ett_schedule: %zu entries, %zu outputs, hash=%016llx\n",
                     sched.entries.size(), sched.outputs.size(),
                     (unsigned long long)sched.hash);
    return (uint32_t)sched.entries.size();
}

uint64_t ett_schedule_hash(void) { return sched.hash; }

// All live (externally referenced, unevaluated, non-literal) variable
// ids: the target set of a bare eval() -- cuda_eval with no argument
// evaluates every live variable (jit.cu:1418-1428).
uint32_t ett_live_vars(uint32_t *out, uint32_t cap) {
    uint32_t n = 0;
    for (auto &kv : ctx.vars) {
        const Variable &v = kv.second;
        if (v.ext_ref > 0 && !v.materialized && !v.is_literal) {
            if (n < cap) out[n] = kv.first;
            ++n;
        }
    }
    return n;
}

// Bulk accessors for the cache-hit fast path: a hit needs only the data
// leaves (executable inputs, in schedule order) and the output variable
// ids -- not the full per-entry walk.
uint32_t ett_schedule_data_ids(uint32_t *out, uint32_t cap) {
    uint32_t n = 0;
    for (const ScheduleEntry &e : sched.entries)
        if (e.is_data) {
            if (n < cap) out[n] = e.id;
            ++n;
        }
    return n;
}

// Literal payloads of the current schedule, in schedule order (runtime
// scalar inputs to the compiled program -- see the hash note above).
// Each literal is its dtype's bit pattern zero-extended to 64 bits; the
// dtype code is returned alongside so the Python side can regroup the
// stream into per-dtype typed arrays without truncation.
uint32_t ett_schedule_literals(uint64_t *bits, int32_t *dtypes,
                              uint32_t cap) {
    uint32_t n = 0;
    for (const ScheduleEntry &e : sched.entries)
        if (e.is_literal) {
            if (n < cap) {
                bits[n] = e.literal;
                dtypes[n] = e.dtype;
            }
            ++n;
        }
    return n;
}

uint32_t ett_schedule_output_ids(uint32_t *out, uint32_t cap) {
    uint32_t n = 0;
    for (uint32_t p : sched.outputs) {
        uint32_t id = p == ~0u ? 0 : sched.entries[p].id;
        if (n < cap) out[n] = id;
        ++n;
    }
    return n;
}
uint32_t ett_schedule_num_outputs(void) { return (uint32_t)sched.outputs.size(); }
uint32_t ett_schedule_output(uint32_t i) { return sched.outputs[i]; }

void ett_schedule_entry(uint32_t i, uint32_t *id, int32_t *opcode,
                       int32_t *dtype, uint64_t *size, uint32_t *dep_pos,
                       uint64_t *literal, int32_t *is_literal,
                       int32_t *is_data) {
    const ScheduleEntry &e = sched.entries[i];
    *id = e.id;
    *opcode = e.opcode;
    *dtype = e.dtype;
    *size = e.size;
    std::memcpy(dep_pos, e.dep_pos, sizeof(e.dep_pos));
    *literal = e.literal;
    *is_literal = e.is_literal;
    *is_data = e.is_data;
}

// Bulk schedule read for the compile path: one call filling parallel
// arrays instead of an O(n) per-entry ctypes walk (178 ms -> ~1 ms for
// a 10,444-op schedule). flags bit0 = is_literal, bit1 = is_data.
uint32_t ett_schedule_read(uint32_t *ids, int32_t *opcodes, int32_t *dtypes,
                          uint64_t *sizes, uint32_t *dep_pos,
                          uint64_t *literals, uint8_t *flags,
                          uint32_t cap) {
    uint32_t n = (uint32_t)sched.entries.size();
    if (n > cap) return n;
    for (uint32_t i = 0; i < n; ++i) {
        const ScheduleEntry &e = sched.entries[i];
        ids[i] = e.id;
        opcodes[i] = e.opcode;
        dtypes[i] = e.dtype;
        sizes[i] = e.size;
        std::memcpy(dep_pos + 4 * i, e.dep_pos, sizeof(e.dep_pos));
        literals[i] = e.literal;
        flags[i] = (uint8_t)(e.is_literal | (e.is_data << 1));
    }
    return n;
}

// After eval: mark a variable materialized and release its dependency
// references (jit.cu:1484-1507 releases inner refs of evaluated vars so
// the consumed subgraph can be collected).
void ett_set_materialized(uint32_t id) {
    Variable *v = var(id);
    if (!v) return;
    v->materialized = true;
    v->dirty = false;
    uint32_t deps[kMaxDeps];
    std::memcpy(deps, v->dep, sizeof(deps));
    std::memset(v->dep, 0, sizeof(v->dep));
    v->subtree_size = 1;
    for (uint32_t d : deps)
        if (d) dec_ref_int(d);
}

// Demote a variable to a plain data leaf backed by a Python-held buffer.
// Needed when a scatter rebinds a LITERAL target: the var now holds real
// data and must stop schedule-walking as a literal (which would re-read
// the pristine constant instead of the scattered buffer).
void ett_set_data(uint32_t id) {
    Variable *v = var(id);
    if (!v) return;
    v->is_literal = false;
    v->is_data = true;
    v->materialized = true;
}

// Release the pending side-effect list (each held one internal ref).
void ett_clear_side_effects(void) {
    for (uint32_t se : ctx.side_effects) dec_ref_int(se);
    ctx.side_effects.clear();
}

// ---- logging / stats (cuda_whos, log levels) -----------------------------

void ett_set_log_level(int32_t level) { ctx.log_level = level; }
int32_t ett_log_level(void) { return ctx.log_level; }

void ett_stats(uint64_t *n_vars, uint64_t *n_appends, uint64_t *n_evals,
              uint64_t *n_freed, uint64_t *peak_vars) {
    *n_vars = ctx.vars.size();
    *n_appends = ctx.n_appends;
    *n_evals = ctx.n_evals;
    *n_freed = ctx.n_freed;
    *peak_vars = ctx.peak_vars;
}

// whos-style live variable table (jit.cu:1564-1634).
int32_t ett_whos(char *buf, int32_t cap) {
    std::string s = "  ID    refs    size  op    flags  label\n";
    std::vector<uint32_t> ids;
    ids.reserve(ctx.vars.size());
    for (auto &kv : ctx.vars) ids.push_back(kv.first);
    std::sort(ids.begin(), ids.end());
    uint64_t mem = 0;
    for (uint32_t id : ids) {
        Variable &v = ctx.vars[id];
        auto lit = ctx.labels.find(id);
        const char *label = lit == ctx.labels.end() ? "" : lit->second.c_str();
        char line[256];
        std::snprintf(line, sizeof(line), "%6u  %d/%d  %8llu  %3d   %s%s%s%s  %s\n",
                      id, v.ext_ref, v.int_ref, (unsigned long long)v.size,
                      v.opcode, v.materialized ? "M" : "-",
                      v.dirty ? "D" : "-", v.side_effect ? "S" : "-",
                      v.is_literal ? "L" : "-", label);
        s += line;
        if (v.materialized) mem += v.size * 4;
    }
    char tail[128];
    std::snprintf(tail, sizeof(tail),
                  "  %zu live variables, ~%.2f MiB materialized\n",
                  ctx.vars.size(), mem / (1024.0 * 1024.0));
    s += tail;
    int32_t n = (int32_t)std::min<size_t>(s.size(), (size_t)cap - 1);
    std::memcpy(buf, s.data(), n);
    buf[n] = 0;
    return (int32_t)s.size();
}

// Reset everything (tests). The id counter stays monotonic: stale Python
// handles from before the reset may dec-ref their ids arbitrarily late
// (GC), and reused ids would let them free unrelated new variables.
void ett_reset(void) {
    ctx.vars.clear();
    ctx.labels.clear();
    ctx.side_effects.clear();
    ctx.n_appends = ctx.n_evals = ctx.n_freed = ctx.peak_vars = 0;
    sched.entries.clear();
    sched.outputs.clear();
    sched.hash = 0;
}

// Every entry's variable id, in schedule order (the device check of a
// cache hit reads the ids of the literal and IOTA entries).
uint32_t ett_schedule_ids(uint32_t *out, uint32_t cap) {
    uint32_t n = 0;
    for (const ScheduleEntry &e : sched.entries) {
        if (n < cap) out[n] = e.id;
        ++n;
    }
    return n;
}

}  // extern "C"
#pragma GCC visibility pop
