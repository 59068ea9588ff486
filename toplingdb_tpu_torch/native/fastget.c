/* CPython C-extension fast path for the native point-read call (the
 * port's copy of toplingdb_tpu/native/fastget.c, built as the module
 * `tpt_fastget`).
 *
 * The hot Get's per-call cost under ctypes is dominated by argument
 * marshaling. This METH_FASTCALL shim calls tpulsm_getctx_get directly
 * (symbols resolved from the port's already-built _tpulsm_native.so via
 * dlopen, RTLD_LOCAL: toplingdb_tpu's library exports the same names, and
 * promoting either to global scope would let one package's calls bind to
 * the other's code) and returns the value as bytes.
 *
 * Protocol: get(ctx_addr, key, snap_seq) ->
 *   bytes  found (value)
 *   None   decisive miss
 *   False  native fallback (the Python state machine must run)
 * The GIL is released around the native chain walk, matching the ctypes
 * path's concurrency (ctx is per-thread).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>

typedef int32_t (*getctx_get_fn)(void*, const uint8_t*, int32_t, uint64_t);
typedef int64_t* (*getctx_out_fn)(void*);
typedef uint8_t* (*getctx_val_fn)(void*);
typedef int32_t (*getctx_mget_fn)(void*, const uint8_t*, const int64_t*,
                                  const int32_t*, int64_t, uint64_t,
                                  int8_t*, int64_t*, int64_t*, uint8_t*,
                                  int64_t, int64_t*, int64_t*);

static getctx_get_fn p_get;
static getctx_out_fn p_out;
static getctx_val_fn p_val;
static getctx_mget_fn p_mget;

/* Result-arena cache: one grown arena kept between calls (a fresh 1MiB
 * alloc per batch — an mmap + page faults — would dominate small-batch
 * multigets). Taking and returning it hold g_arena_mu: the cache does
 * not rely on the GIL, so it stays consistent on an interpreter without
 * one. A second thread entering mid-call allocates its own arena. The
 * arenas come from malloc (PyMem_Malloc needs the GIL's protection). */
static pthread_mutex_t g_arena_mu = PTHREAD_MUTEX_INITIALIZER;
static uint8_t* g_arena_cache = NULL;
static int64_t g_arena_cache_cap = 0;

static uint8_t* arena_take(int64_t* cap) {
  uint8_t* a;
  pthread_mutex_lock(&g_arena_mu);
  a = g_arena_cache;
  *cap = g_arena_cache_cap;
  g_arena_cache = NULL;
  g_arena_cache_cap = 0;
  pthread_mutex_unlock(&g_arena_mu);
  if (a) return a;
  *cap = 1 << 20;
  return (uint8_t*)malloc((size_t)*cap);
}

static void arena_give(uint8_t* a, int64_t cap) {
  uint8_t* drop = a;
  if (!a) return;
  pthread_mutex_lock(&g_arena_mu);
  if (!g_arena_cache || cap > g_arena_cache_cap) {
    drop = g_arena_cache;
    g_arena_cache = a;
    g_arena_cache_cap = cap;
  }
  pthread_mutex_unlock(&g_arena_mu);
  free(drop);
}

static PyObject* fg_bind(PyObject* self, PyObject* args) {
  const char* path;
  (void)self;
  if (!PyArg_ParseTuple(args, "s", &path)) return NULL;
  void* h = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (!h) {
    PyErr_SetString(PyExc_OSError, dlerror());
    return NULL;
  }
  p_get = (getctx_get_fn)dlsym(h, "tpulsm_getctx_get");
  p_out = (getctx_out_fn)dlsym(h, "tpulsm_getctx_out");
  p_val = (getctx_val_fn)dlsym(h, "tpulsm_getctx_val");
  p_mget = (getctx_mget_fn)dlsym(h, "tpulsm_getctx_multiget");
  if (!p_get || !p_out || !p_val) {
    PyErr_SetString(PyExc_OSError, "tpulsm_getctx_* symbols missing");
    return NULL;
  }
  Py_RETURN_NONE;
}

/* multiget(ctx_addr, keys: list[bytes], snap_seq) ->
 *   (results: list[bytes | None | False], counters: tuple[int x 6])
 * False entries need the Python state machine (merge/blob/entity...).
 * The whole batch walk + result materialization happens here — the
 * per-key Python/numpy assembly dominated the batched read wall. */
static PyObject* fg_multiget(PyObject* self, PyObject* const* args,
                             Py_ssize_t nargs) {
  (void)self;
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "multiget(ctx_addr, keys, snap_seq)");
    return NULL;
  }
  if (!p_mget) {
    PyErr_SetString(PyExc_RuntimeError, "multiget symbol unavailable");
    return NULL;
  }
  void* ctx = PyLong_AsVoidPtr(args[0]);
  if (!ctx && PyErr_Occurred()) return NULL;
  PyObject* keys = args[1];
  if (!PyList_Check(keys)) {
    PyErr_SetString(PyExc_TypeError, "keys must be a list of bytes");
    return NULL;
  }
  unsigned long long seq = PyLong_AsUnsignedLongLong(args[2]);
  if (PyErr_Occurred()) return NULL;
  Py_ssize_t n = PyList_GET_SIZE(keys);
  if (n == 0) return Py_BuildValue("([], (iiiiii))", 0, 0, 0, 0, 0, 0);

  int64_t* offs = (int64_t*)PyMem_Malloc(sizeof(int64_t) * n);
  int32_t* lens = (int32_t*)PyMem_Malloc(sizeof(int32_t) * n);
  int8_t* status = (int8_t*)PyMem_Malloc(n);
  int64_t* voffs = (int64_t*)PyMem_Malloc(sizeof(int64_t) * n);
  int64_t* vlens = (int64_t*)PyMem_Malloc(sizeof(int64_t) * n);
  uint8_t* keybuf = NULL;
  uint8_t* arena = NULL;
  PyObject* out = NULL;
  PyObject* cctr = NULL;
  PyObject* res = NULL;
  int64_t total = 0;
  int64_t arena_cap = 1 << 20;
  int64_t used = 0;
  int64_t ctr[6] = {0, 0, 0, 0, 0, 0};
  int32_t rc = -2;
  Py_ssize_t i;
  int oom = 0;

  if (!offs || !lens || !status || !voffs || !vlens) goto oom_exit;
  for (i = 0; i < n; i++) {
    PyObject* k = PyList_GET_ITEM(keys, i);
    char* kb;
    Py_ssize_t kl;
    if (PyBytes_AsStringAndSize(k, &kb, &kl) != 0) goto fail_exit;
    offs[i] = total;
    lens[i] = (int32_t)kl;
    total += kl;
  }
  keybuf = (uint8_t*)PyMem_Malloc(total ? (size_t)total : 1);
  if (!keybuf) goto oom_exit;
  for (i = 0; i < n; i++) {
    PyObject* k = PyList_GET_ITEM(keys, i);
    memcpy(keybuf + offs[i], PyBytes_AS_STRING(k),
           (size_t)PyBytes_GET_SIZE(k));
  }
  arena = arena_take(&arena_cap);
  while (rc == -2 && arena_cap <= ((int64_t)1 << 32)) {
    if (!arena) goto oom_exit;
    Py_BEGIN_ALLOW_THREADS
    rc = p_mget(ctx, keybuf, offs, lens, (int64_t)n, (uint64_t)seq,
                status, voffs, vlens, arena, arena_cap, &used, ctr);
    Py_END_ALLOW_THREADS
    if (rc == -2) {
      arena_cap *= 4;
      free(arena);
      arena = (uint8_t*)malloc((size_t)arena_cap);
    }
  }
  if (rc != 0) {
    /* batch-level fallback: caller uses the ctypes/Python path */
    res = Py_None;
    Py_INCREF(res);
    goto cleanup;
  }
  out = PyList_New(n);
  if (!out) goto oom_exit;
  for (i = 0; i < n; i++) {
    PyObject* v;
    if (status[i] == 1) {
      v = PyBytes_FromStringAndSize((const char*)arena + voffs[i],
                                    (Py_ssize_t)vlens[i]);
      if (!v) goto oom_exit;
    } else if (status[i] == 2) {
      v = Py_False;
      Py_INCREF(v);
    } else {
      v = Py_None;
      Py_INCREF(v);
    }
    PyList_SET_ITEM(out, i, v);
  }
  cctr = Py_BuildValue("(LLLLLL)", (long long)ctr[0], (long long)ctr[1],
                       (long long)ctr[2], (long long)ctr[3],
                       (long long)ctr[4], (long long)ctr[5]);
  if (!cctr) goto fail_exit;
  res = PyTuple_Pack(2, out, cctr);
  goto cleanup;

oom_exit:
  oom = 1;
fail_exit:
  if (oom) PyErr_NoMemory();
  res = NULL;
cleanup:
  Py_XDECREF(out);
  Py_XDECREF(cctr);
  PyMem_Free(keybuf);
  arena_give(arena, arena_cap);
  PyMem_Free(offs);
  PyMem_Free(lens);
  PyMem_Free(status);
  PyMem_Free(voffs);
  PyMem_Free(vlens);
  return res;
}

static PyObject* fg_get(PyObject* self, PyObject* const* args,
                        Py_ssize_t nargs) {
  (void)self;
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "get(ctx_addr, key, snap_seq)");
    return NULL;
  }
  if (!p_get) {
    PyErr_SetString(PyExc_RuntimeError, "bind() not called");
    return NULL;
  }
  void* ctx = PyLong_AsVoidPtr(args[0]);
  if (!ctx && PyErr_Occurred()) return NULL;
  char* kbuf;
  Py_ssize_t klen;
  if (PyBytes_AsStringAndSize(args[1], &kbuf, &klen) != 0) return NULL;
  unsigned long long seq = PyLong_AsUnsignedLongLong(args[2]);
  if (PyErr_Occurred()) return NULL;
  int32_t rc;
  Py_BEGIN_ALLOW_THREADS
  rc = p_get(ctx, (const uint8_t*)kbuf, (int32_t)klen, (uint64_t)seq);
  Py_END_ALLOW_THREADS
  if (rc == 1) {
    int64_t* out = p_out(ctx);
    return PyBytes_FromStringAndSize((const char*)p_val(ctx),
                                     (Py_ssize_t)out[0]);
  }
  if (rc == 0) Py_RETURN_NONE;
  Py_RETURN_FALSE; /* fallback: run the Python chain */
}

/* bound_addr() -> int: the address bind() resolved tpulsm_getctx_get to
 * (0 before bind), so a caller can check which library it lies in. */
static PyObject* fg_bound_addr(PyObject* self, PyObject* unused) {
  (void)self;
  (void)unused;
  return PyLong_FromVoidPtr((void*)p_get);
}

static PyMethodDef fg_methods[] = {
    {"bind", fg_bind, METH_VARARGS,
     "bind(native_so_path): resolve the getctx symbols"},
    {"bound_addr", fg_bound_addr, METH_NOARGS,
     "bound_addr() -> address of the bound tpulsm_getctx_get"},
    {"get", (PyCFunction)(void (*)(void))fg_get, METH_FASTCALL,
     "get(ctx_addr, key, snap_seq) -> bytes | None | False"},
    {"multiget", (PyCFunction)(void (*)(void))fg_multiget, METH_FASTCALL,
     "multiget(ctx_addr, keys, snap_seq) -> (results, counters) | None"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef fg_module = {
    PyModuleDef_HEAD_INIT, "tpt_fastget",
    "ctypes-free fast path for tpulsm_getctx_get", -1, fg_methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_tpt_fastget(void) {
  return PyModule_Create(&fg_module);
}
