// CPython fastcall bindings for the trace-append hot path of the port's
// trace core (trace.cpp beside it; the module is _etnative_torch, so that
// it never meets the JAX package's _etnative in one process).
//
// The reference's trace append is a direct C++ call (cuda_trace_append,
// jit.cu:701-861). Going through ctypes costs ~1 us of FFI per call plus
// one extra call per dependency for the dirty check; this module exposes
// the hot subset as METH_FASTCALL (~60 ns/call) with the dirty check
// folded INTO the append. Cold APIs stay on ctypes against the same
// shared object (one dlopen, one state).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <cstdint>
#include <cstring>
#include <unordered_map>

extern "C" {
uint32_t ett_append(int32_t, int32_t, uint64_t, uint32_t, uint32_t, uint32_t,
                   uint32_t);
uint32_t ett_append_raw(int32_t, int32_t, uint64_t, uint32_t, uint32_t,
                       uint32_t, uint32_t);
uint32_t ett_literal(int32_t, uint64_t, uint64_t);
uint32_t ett_data(int32_t, uint64_t);
void ett_inc_ref_ext(uint32_t);
void ett_dec_ref_ext(uint32_t);
int32_t ett_is_dirty(uint32_t);
int32_t ett_var_materialized(uint32_t);
}

namespace {

// append(opcode, dtype, size, d0, d1, d2, d3, raw) -> int
//   > 0 : new variable id
//     0 : broadcast-size violation (raw=0 only)
//    -1 : some dependency is dirty -- caller must eval it and retry
//         (the read-after-scatter protocol, jit.cu:719-730)
PyObject *py_append(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 8) {
        PyErr_SetString(PyExc_TypeError, "append expects 8 ints");
        return nullptr;
    }
    long long v[8];
    for (int i = 0; i < 8; ++i) {
        v[i] = PyLong_AsLongLong(args[i]);
        if (v[i] == -1 && PyErr_Occurred()) return nullptr;
    }
    uint32_t d[4] = {(uint32_t)v[3], (uint32_t)v[4], (uint32_t)v[5],
                     (uint32_t)v[6]};
    uint32_t id;
    if (v[7]) {
        // raw appends (scatter family) legitimately take dirty deps --
        // the chaining protocol -- so the dirty refusal stays out of
        // ett_append_raw and lives here for parity with the old contract
        for (int i = 0; i < 4; ++i)
            if (d[i] && ett_is_dirty(d[i])) return PyLong_FromLong(-1);
        id = ett_append_raw((int32_t)v[0], (int32_t)v[1], (uint64_t)v[2], d[0],
                           d[1], d[2], d[3]);
    } else {
        // ett_append refuses dirty deps itself (single lookup per dep)
        id = ett_append((int32_t)v[0], (int32_t)v[1], (uint64_t)v[2], d[0],
                       d[1], d[2], d[3]);
        if (id == (uint32_t)-1) return PyLong_FromLong(-1);
    }
    return PyLong_FromUnsignedLong(id);
}

// literal(dtype, bits, size) -> id
PyObject *py_literal(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "literal expects 3 ints");
        return nullptr;
    }
    long dtype = PyLong_AsLong(args[0]);
    uint64_t bits = PyLong_AsUnsignedLongLong(args[1]);
    uint64_t size = PyLong_AsUnsignedLongLong(args[2]);
    if (PyErr_Occurred()) return nullptr;
    return PyLong_FromUnsignedLong(ett_literal((int32_t)dtype, bits, size));
}

// data(dtype, size) -> id
PyObject *py_data(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "data expects 2 ints");
        return nullptr;
    }
    long dtype = PyLong_AsLong(args[0]);
    uint64_t size = PyLong_AsUnsignedLongLong(args[1]);
    if (PyErr_Occurred()) return nullptr;
    return PyLong_FromUnsignedLong(ett_data((int32_t)dtype, size));
}

PyObject *py_dec_ref(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs == 1) ett_dec_ref_ext((uint32_t)PyLong_AsUnsignedLong(args[0]));
    Py_RETURN_NONE;
}

PyObject *py_inc_ref(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs == 1) ett_inc_ref_ext((uint32_t)PyLong_AsUnsignedLong(args[0]));
    Py_RETURN_NONE;
}

PyObject *py_is_dirty(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 1) {
        PyErr_SetString(PyExc_TypeError, "is_dirty expects 1 int");
        return nullptr;
    }
    return PyLong_FromLong(
        ett_is_dirty((uint32_t)PyLong_AsUnsignedLong(args[0])));
}

PyObject *py_materialized(PyObject *, PyObject *const *args,
                          Py_ssize_t nargs) {
    if (nargs != 1) {
        PyErr_SetString(PyExc_TypeError, "materialized expects 1 int");
        return nullptr;
    }
    return PyLong_FromLong(
        ett_var_materialized((uint32_t)PyLong_AsUnsignedLong(args[0])));
}

// ---------------------------------------------------------------------------
// C fast path for LazyArray operator dispatch.
//
// VarBase is the C base type LazyArray inherits: it carries the handle
// state (index, _size, _code, _dev) as RAW C fields -- no PyLong boxing --
// and its tp_dealloc releases the native variable's external reference
// directly, replacing a Python-level __del__ (which costs a frame +
// fastcall per destroyed handle; ~40% of the re-trace budget was object
// lifecycle). binop()/unop() read/write the C fields at fixed offsets,
// the dtype promotion is a C table, and the result object is built with
// tp_alloc directly. Scalar operands, dirty dependencies and broadcast
// violations return None: the Python slow path (LazyArray._bin/_record)
// handles them.
// ---------------------------------------------------------------------------

struct VarObject {
    PyObject_HEAD
    uint32_t index;
    unsigned long long size_;
    int code_;
    int dev_;  // the Python side's device code; -1 = a device-free scalar
};

void var_dealloc(PyObject *self) {
    uint32_t id = ((VarObject *)self)->index;
    if (id) ett_dec_ref_ext(id);
    Py_TYPE(self)->tp_free(self);
}

PyMemberDef var_members[] = {
    {"index", T_UINT, offsetof(VarObject, index), 0,
     "native variable id (0 = detached handle)"},
    {"_size", T_ULONGLONG, offsetof(VarObject, size_), 0, nullptr},
    {"_code", T_INT, offsetof(VarObject, code_), 0, nullptr},
    {"_dev", T_INT, offsetof(VarObject, dev_), 0,
     "device code of the variable (trace._DEVICES; -1 for a scalar)"},
    {nullptr, 0, 0, 0, nullptr}};

PyTypeObject VarBase_Type = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "_etnative_torch.VarBase",            /* tp_name */
    sizeof(VarObject),              /* tp_basicsize */
    0,                              /* tp_itemsize */
    var_dealloc,                    /* tp_dealloc */
};

PyTypeObject *g_lazy = nullptr;  // the LazyArray class (VarBase subclass)
int g_promote[16][16];
int g_ndtypes = 0;

// set_class(LazyArray, promote_flat, n_dtypes): one-time wiring
PyObject *py_set_class(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "set_class expects 3 args");
        return nullptr;
    }
    PyObject *cls = args[0];
    if (!PyType_Check(cls) ||
        !PyType_IsSubtype((PyTypeObject *)cls, &VarBase_Type)) {
        PyErr_SetString(PyExc_TypeError,
                        "set_class expects a VarBase subclass");
        return nullptr;
    }
    long nd = PyLong_AsLong(args[2]);
    if (nd <= 0 || nd > 16) {
        PyErr_SetString(PyExc_ValueError, "n_dtypes out of range");
        return nullptr;
    }
    PyObject *flat = args[1];
    for (long i = 0; i < nd; ++i)
        for (long j = 0; j < nd; ++j) {
            PyObject *v = PySequence_GetItem(flat, i * nd + j);
            if (!v) return nullptr;
            g_promote[i][j] = (int)PyLong_AsLong(v);
            Py_DECREF(v);
        }
    Py_INCREF(cls);
    Py_XDECREF((PyObject *)g_lazy);
    g_lazy = (PyTypeObject *)cls;
    g_ndtypes = (int)nd;
    Py_RETURN_NONE;
}

// ---- C scalar-literal fast path -------------------------------------------
// Python scalar operands repeat heavily (polynomial coefficients on every
// retrace); one shared native literal per (dtype, bit pattern) is enough
// because literal vars are immutable. Keys are the encoded BITS, so
// -0.0 / 0.0 and NaN payloads are distinct naturally (the Python-side
// cache needs sign/NaN special-casing for its value keys). The cache
// holds one ext reference per entry; lit_cache_clear() (called by
// trace.reset() right after ett_reset) empties it without dec-refs --
// the native reset already dropped every variable wholesale.
// Dtype codes mirror enoki_tpu_torch/trace/__init__.py _DTYPES:
//   0 f32, 1 f64, 2 i32, 3 u32, 4 bool, 5 bf16, 6 i64, 7 u64, 8 f16
// bf16/f16 scalar encoding (rounding) stays on the Python path.
constexpr int kNumCodes = 9;
std::unordered_map<uint64_t, uint32_t> g_lit_cache[kNumCodes];
constexpr size_t kLitCacheCap = 1u << 14;

// encode a double into the dtype's bit pattern; returns false when this
// dtype/value combination must take the Python slow path
bool encode_float_bits(int code, double d, uint64_t *bits) {
    if (code == 0) {
        float f = (float)d;
        uint32_t b;
        std::memcpy(&b, &f, 4);
        *bits = b;
        return true;
    }
    if (code == 1) {
        uint64_t b;
        std::memcpy(&b, &d, 8);
        *bits = b;
        return true;
    }
    return false;  // int/bool/16-bit targets: Python decides semantics
}

bool encode_int_bits(int code, long long v, uint64_t *bits) {
    switch (code) {
        case 0: case 1: return encode_float_bits(code, (double)v, bits);
        case 2: *bits = (uint64_t)(uint32_t)(int32_t)v; return (int32_t)v == v;
        case 3: if (v < 0) return false;
                *bits = (uint64_t)(uint32_t)v; return (long long)(uint32_t)v == v;
        case 4: *bits = v ? 1 : 0; return true;
        case 6: *bits = (uint64_t)v; return true;
        case 7: if (v < 0) return false;
                *bits = (uint64_t)v; return true;
        default: return false;  // bf16/f16 rounding lives in Python
    }
}

// shared literal id for (code, bits), creating + caching on miss.
// Returned ids are BORROWED from the cache (callers must not dec):
// ett_literal's creation ref (ext_ref=1) IS the cache's reference, so
// every id lit_id hands out is owned by exactly one place. When the
// cache fills it is reset wholesale -- releasing the refs frees only
// literals no live op depends on (consuming ops hold int refs), and
// a once-per-16384-distinct-scalars rebuild is amortized noise. The
// old overflow path returned an ownerless ext_ref=1 variable: one
// leaked trace var per distinct scalar past the cap.
uint32_t lit_id(int code, uint64_t bits) {
    auto &m = g_lit_cache[code];
    auto it = m.find(bits);
    if (it != m.end()) return it->second;
    if (m.size() >= kLitCacheCap) {
        for (auto &kv : m) ett_dec_ref_ext(kv.second);
        m.clear();
    }
    uint32_t id = ett_literal(code, bits, 1);
    if (id) m.emplace(bits, id);
    return id;
}

// scalar operand -> shared literal id of dtype `code`; 0 = fall back
uint32_t scalar_lit(PyObject *b, int code) {
    uint64_t bits;
    if (PyFloat_CheckExact(b)) {
        if (!encode_float_bits(code, PyFloat_AS_DOUBLE(b), &bits)) return 0;
    } else if (PyBool_Check(b)) {
        if (!encode_int_bits(code, b == Py_True ? 1 : 0, &bits)) return 0;
    } else if (PyLong_CheckExact(b)) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(b, &overflow);
        if (overflow || (v == -1 && PyErr_Occurred())) {
            PyErr_Clear();
            return 0;  // u64-range ints etc.: Python handles
        }
        if (!encode_int_bits(code, v, &bits)) return 0;
    } else {
        return 0;
    }
    return lit_id(code, bits);
}

PyObject *py_lit_cache_clear(PyObject *, PyObject *const *, Py_ssize_t) {
    // no dec-refs: only called right after ett_reset dropped all vars
    for (auto &m : g_lit_cache) m.clear();
    Py_RETURN_NONE;
}

// builds the result handle; releases the appended native var's ext
// reference on failure (OOM-only today, but the var would otherwise
// leak for the lifetime of the trace)
PyObject *make_result(uint32_t id, unsigned long long size, int code,
                      int dev) {
    PyObject *r = g_lazy->tp_alloc(g_lazy, 0);
    if (!r) { ett_dec_ref_ext(id); return nullptr; }
    VarObject *v = (VarObject *)r;
    v->index = id;
    v->size_ = size;
    v->code_ = code;
    v->dev_ = dev;
    return r;
}

// binop(a, b, opcode, out_code) -> LazyArray | None (caller falls back)
//   out_code: -1 = promote(a._code, b._code), else the fixed dtype code
PyObject *py_binop(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 4) {
        PyErr_SetString(PyExc_TypeError, "binop expects 4 args");
        return nullptr;
    }
    PyObject *a = args[0], *b = args[1];
    if (!g_lazy || Py_TYPE(a) != g_lazy) Py_RETURN_NONE;
    long opcode = PyLong_AsLong(args[2]);
    long out_code = PyLong_AsLong(args[3]);
    if (PyErr_Occurred()) return nullptr;
    VarObject *va = (VarObject *)a;
    int ca = va->code_;
    if (ca < 0 || ca >= g_ndtypes) Py_RETURN_NONE;
    uint32_t idb;
    int cb;
    int dev = va->dev_;
    unsigned long long size;
    if (Py_TYPE(b) == g_lazy) {
        VarObject *vb = (VarObject *)b;
        cb = vb->code_;
        if (cb < 0 || cb >= g_ndtypes) Py_RETURN_NONE;
        idb = vb->index;
        // operands on two devices: the Python slow path raises
        if (dev < 0) dev = vb->dev_;
        else if (vb->dev_ >= 0 && vb->dev_ != dev) Py_RETURN_NONE;
        size = va->size_ >= vb->size_ ? va->size_ : vb->size_;
    } else {
        // Python scalar operand: shared literal of a's dtype (the same
        // coercion rule as LazyArray._coerce, bits-keyed cache)
        idb = scalar_lit(b, ca);
        if (!idb) Py_RETURN_NONE;
        cb = ca;
        size = va->size_;
    }
    long dc = out_code >= 0 ? out_code : g_promote[ca][cb];
    // dirty deps make ett_append return -1 -> the slow path evals the
    // pending scatter and retries
    uint32_t id = ett_append((int32_t)opcode, (int32_t)dc, size,
                            va->index, idb, 0, 0);
    if (id == 0 || id == (uint32_t)-1) Py_RETURN_NONE;
    return make_result(id, size, (int)dc, dev);
}

// unop(a, opcode, out_code) -> LazyArray | None
PyObject *py_unop(PyObject *, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "unop expects 3 args");
        return nullptr;
    }
    PyObject *a = args[0];
    if (!g_lazy || Py_TYPE(a) != g_lazy) Py_RETURN_NONE;
    long opcode = PyLong_AsLong(args[1]);
    long out_code = PyLong_AsLong(args[2]);
    if (PyErr_Occurred()) return nullptr;
    VarObject *va = (VarObject *)a;
    long dc = out_code >= 0 ? out_code : va->code_;
    uint32_t id = ett_append((int32_t)opcode, (int32_t)dc, va->size_,
                            va->index, 0, 0, 0);
    if (id == 0 || id == (uint32_t)-1) Py_RETURN_NONE;
    return make_result(id, va->size_, (int)dc, va->dev_);
}

PyMethodDef kMethods[] = {
    {"append", (PyCFunction)(void *)py_append, METH_FASTCALL, nullptr},
    {"literal", (PyCFunction)(void *)py_literal, METH_FASTCALL, nullptr},
    {"data", (PyCFunction)(void *)py_data, METH_FASTCALL, nullptr},
    {"dec_ref", (PyCFunction)(void *)py_dec_ref, METH_FASTCALL, nullptr},
    {"inc_ref", (PyCFunction)(void *)py_inc_ref, METH_FASTCALL, nullptr},
    {"is_dirty", (PyCFunction)(void *)py_is_dirty, METH_FASTCALL, nullptr},
    {"materialized", (PyCFunction)(void *)py_materialized, METH_FASTCALL,
     nullptr},
    {"set_class", (PyCFunction)(void *)py_set_class, METH_FASTCALL, nullptr},
    {"lit_cache_clear", (PyCFunction)(void *)py_lit_cache_clear,
     METH_FASTCALL, nullptr},
    {"binop", (PyCFunction)(void *)py_binop, METH_FASTCALL, nullptr},
    {"unop", (PyCFunction)(void *)py_unop, METH_FASTCALL, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_etnative_torch",
                       "enoki-tpu trace hot path", -1, kMethods,
                       nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__etnative_torch(void) {
    VarBase_Type.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE;
    VarBase_Type.tp_members = var_members;
    VarBase_Type.tp_new = PyType_GenericNew;
    VarBase_Type.tp_doc =
        "C base of LazyArray: raw-int handle fields + dealloc that "
        "releases the native variable reference.";
    if (PyType_Ready(&VarBase_Type) < 0) return nullptr;
    PyObject *m = PyModule_Create(&kModule);
    if (!m) return nullptr;
    Py_INCREF(&VarBase_Type);
    if (PyModule_AddObject(m, "VarBase", (PyObject *)&VarBase_Type) < 0) {
        Py_DECREF(&VarBase_Type);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
