/* _qsim_native: C hot paths for host-side result processing.
 *
 * The engine's device work is JAX/XLA; this module covers the
 * host-side loops that remain after device results land: turning count
 * histograms into {bitstring: count} dicts (the GUI/bridge/script result
 * format, up to 2^n entries) and packing bit matrices into basis indices.
 * Pure C99 + CPython API + buffer protocol — no NumPy C API dependency.
 *
 * Reference equivalents being accelerated:
 *   quantum_sim/engine/measurement.py:56-58 (dict comprehension over 2^n)
 *   quantum_sim/engine/noise.py:128-139     (per-shot bitstring packing)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* Write the n-bit binary representation of idx into buf (no terminator). */
static inline void
format_bits(char *buf, uint64_t idx, int num_qubits)
{
    for (int b = 0; b < num_qubits; b++) {
        buf[b] = (char)('0' + ((idx >> (num_qubits - 1 - b)) & 1u));
    }
}

/* counts_from_array(counts_buffer, num_qubits) -> dict[str, int]
 *
 * counts_buffer: any C-contiguous buffer of int64 (e.g. a NumPy array via
 * memoryview). Zero entries are skipped.
 */
static PyObject *
counts_from_array(PyObject *self, PyObject *args)
{
    PyObject *obj;
    int num_qubits;
    if (!PyArg_ParseTuple(args, "Oi", &obj, &num_qubits)) {
        return NULL;
    }
    if (num_qubits < 1 || num_qubits > 63) {
        PyErr_SetString(PyExc_ValueError, "num_qubits must be in [1, 63]");
        return NULL;
    }

    Py_buffer view;
    if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO | PyBUF_FORMAT) < 0) {
        return NULL;
    }
    if (view.itemsize != 8 || view.format == NULL
        || (strcmp(view.format, "l") != 0 && strcmp(view.format, "q") != 0)) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_TypeError,
                        "expected a contiguous int64 buffer");
        return NULL;
    }

    const int64_t *data = (const int64_t *)view.buf;
    Py_ssize_t n = view.len / 8;

    PyObject *dict = PyDict_New();
    if (dict == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }

    char buf[64];
    for (Py_ssize_t i = 0; i < n; i++) {
        if (data[i] == 0) {
            continue;
        }
        format_bits(buf, (uint64_t)i, num_qubits);
        PyObject *key = PyUnicode_FromStringAndSize(buf, num_qubits);
        PyObject *val = PyLong_FromLongLong(data[i]);
        if (key == NULL || val == NULL
            || PyDict_SetItem(dict, key, val) < 0) {
            Py_XDECREF(key);
            Py_XDECREF(val);
            Py_DECREF(dict);
            PyBuffer_Release(&view);
            return NULL;
        }
        Py_DECREF(key);
        Py_DECREF(val);
    }

    PyBuffer_Release(&view);
    return dict;
}

/* histogram_from_indices(indices_buffer, num_qubits) -> dict[str, int]
 *
 * indices_buffer: C-contiguous int64 sampled basis indices (one entry per
 * shot). Builds the counts dict directly without a dense 2^n histogram.
 */
static PyObject *
histogram_from_indices(PyObject *self, PyObject *args)
{
    PyObject *obj;
    int num_qubits;
    if (!PyArg_ParseTuple(args, "Oi", &obj, &num_qubits)) {
        return NULL;
    }
    if (num_qubits < 1 || num_qubits > 63) {
        PyErr_SetString(PyExc_ValueError, "num_qubits must be in [1, 63]");
        return NULL;
    }

    Py_buffer view;
    if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO | PyBUF_FORMAT) < 0) {
        return NULL;
    }
    if (view.itemsize != 8) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_TypeError, "expected an int64 buffer");
        return NULL;
    }

    const int64_t *data = (const int64_t *)view.buf;
    Py_ssize_t n = view.len / 8;

    PyObject *dict = PyDict_New();
    if (dict == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }

    char buf[64];
    for (Py_ssize_t i = 0; i < n; i++) {
        format_bits(buf, (uint64_t)data[i], num_qubits);
        PyObject *key = PyUnicode_FromStringAndSize(buf, num_qubits);
        if (key == NULL) {
            goto fail;
        }
        PyObject *existing = PyDict_GetItem(dict, key); /* borrowed */
        long long current = existing ? PyLong_AsLongLong(existing) : 0;
        PyObject *val = PyLong_FromLongLong(current + 1);
        if (val == NULL || PyDict_SetItem(dict, key, val) < 0) {
            Py_XDECREF(val);
            Py_DECREF(key);
            goto fail;
        }
        Py_DECREF(val);
        Py_DECREF(key);
    }

    PyBuffer_Release(&view);
    return dict;

fail:
    Py_DECREF(dict);
    PyBuffer_Release(&view);
    return NULL;
}

/* pack_bits(bits_buffer, rows, num_qubits) -> list[int]
 *
 * bits_buffer: C-contiguous uint8 matrix (rows x num_qubits) of 0/1
 * values; returns the basis index of each row (qubit 0 = MSB).
 */
static PyObject *
pack_bits(PyObject *self, PyObject *args)
{
    PyObject *obj;
    Py_ssize_t rows;
    int num_qubits;
    if (!PyArg_ParseTuple(args, "Oni", &obj, &rows, &num_qubits)) {
        return NULL;
    }

    Py_buffer view;
    if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO) < 0) {
        return NULL;
    }
    if (view.len < rows * (Py_ssize_t)num_qubits) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "buffer too small");
        return NULL;
    }

    const uint8_t *bits = (const uint8_t *)view.buf;
    PyObject *out = PyList_New(rows);
    if (out == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    for (Py_ssize_t r = 0; r < rows; r++) {
        uint64_t idx = 0;
        const uint8_t *row = bits + r * num_qubits;
        for (int b = 0; b < num_qubits; b++) {
            idx = (idx << 1) | (row[b] & 1u);
        }
        PyObject *val = PyLong_FromUnsignedLongLong(idx);
        if (val == NULL) {
            Py_DECREF(out);
            PyBuffer_Release(&view);
            return NULL;
        }
        PyList_SET_ITEM(out, r, val);
    }

    PyBuffer_Release(&view);
    return out;
}

/* uf_decode(edges, n_edges, n_checks, boundary, weights, syndromes,
 *           n_trials, out)
 *
 * Union-find matching decoder over a batch of syndromes (the C twin of
 * qec_matching._decode_one_py — same deterministic choices, so outputs
 * are bit-identical; test-locked).
 *
 *   edges:     C-contiguous int32 (n_edges x 2) vertex pairs
 *   weights:   C-contiguous int32 (n_edges,) integer edge costs >= 1
 *              (an edge is traversable after 2*weight growth units)
 *   syndromes: C-contiguous uint8 (n_trials x n_checks) 0/1
 *   out:       writable C-contiguous uint8 (n_trials x n_edges)
 *   boundary:  virtual boundary vertex index (== n_checks) or -1
 *
 * Returns 0 on success, 1 if any syndrome is unmatchable (odd defect
 * parity in a boundary-free component).
 */

typedef struct {
    int *parent;
    signed char *parity;    /* valid at roots */
    unsigned char *on_bnd;  /* valid at roots */
    unsigned char *occupied;
    unsigned char *active;
    unsigned char *defect;
    unsigned char *visited;
    int *growth;
    int *newly_full;
    int *adj_head;          /* CSR adjacency over full edges */
    int *adj_next;
    int *adj_vert;
    int *adj_edge;
    int *order;
    int *tree_par;
    int *tree_edge;
} UFWork;

static int
uf_find(int *parent, int v)
{
    int root = v;
    while (parent[root] != root) root = parent[root];
    while (parent[v] != root) { int nxt = parent[v]; parent[v] = root; v = nxt; }
    return root;
}

static int
uf_decode_one(const int32_t *edges, const int32_t *wts, int maxcap,
              int ne, int nc, int bnd, int nv,
              const uint8_t *syn, uint8_t *corr, UFWork *w)
{
    for (int v = 0; v < nv; v++) {
        w->parent[v] = v;
        w->defect[v] = (v < nc) ? (syn[v] & 1u) : 0;
        w->occupied[v] = w->defect[v];
        w->parity[v] = (signed char)w->defect[v];
        w->on_bnd[v] = 0;
        w->visited[v] = 0;
    }
    memset(w->growth, 0, sizeof(int) * (size_t)ne);
    memset(corr, 0, (size_t)ne);

    /* growth rounds */
    int converged = 0;
    for (int it = 0; it < maxcap * nv + 4; it++) {
        int any_active = 0;
        for (int v = 0; v < nv; v++) {
            w->active[v] = 0;
            if (w->occupied[v]) {
                int r = uf_find(w->parent, v);
                w->active[v] = (w->parity[r] & 1) && !w->on_bnd[r];
                any_active |= w->active[v];
            }
        }
        if (!any_active) { converged = 1; break; }
        int grew = 0, n_full = 0;
        for (int e = 0; e < ne; e++) {
            int cap = 2 * wts[e];
            if (w->growth[e] >= cap) continue;
            int u = edges[2 * e], v = edges[2 * e + 1];
            int add = (int)w->active[u] + (int)w->active[v];
            if (add) {
                grew = 1;
                w->growth[e] = (w->growth[e] + add > cap)
                               ? cap : w->growth[e] + add;
                if (w->growth[e] == cap) w->newly_full[n_full++] = e;
            }
        }
        if (!grew) return 1;  /* unmatchable */
        for (int i = 0; i < n_full; i++) {
            int e = w->newly_full[i];
            int u = edges[2 * e], v = edges[2 * e + 1];
            if (!w->occupied[u]) {
                w->occupied[u] = 1;
                if (u == bnd) w->on_bnd[u] = 1;
            }
            if (!w->occupied[v]) {
                w->occupied[v] = 1;
                if (v == bnd) w->on_bnd[v] = 1;
            }
            int ru = uf_find(w->parent, u), rv = uf_find(w->parent, v);
            if (ru != rv) {
                w->parent[rv] = ru;
                w->parity[ru] ^= w->parity[rv];
                w->on_bnd[ru] |= w->on_bnd[rv];
            }
        }
    }
    if (!converged) return 2;

    /* CSR adjacency over fully-grown edges; heads in edge-index order
     * (build by prepending in REVERSE edge order so traversal order
     * matches the Python adjacency lists). */
    for (int v = 0; v < nv; v++) w->adj_head[v] = -1;
    for (int e = ne - 1; e >= 0; e--) {
        if (w->growth[e] != 2 * wts[e]) continue;
        int u = edges[2 * e], v = edges[2 * e + 1];
        int su = 2 * e, sv = 2 * e + 1;
        w->adj_vert[su] = v; w->adj_edge[su] = e;
        w->adj_next[su] = w->adj_head[u]; w->adj_head[u] = su;
        w->adj_vert[sv] = u; w->adj_edge[sv] = e;
        w->adj_next[sv] = w->adj_head[v]; w->adj_head[v] = sv;
    }

    /* peeling */
    int bnd_root = (bnd >= 0 && w->occupied[bnd])
                   ? uf_find(w->parent, bnd) : -1;
    for (int start = 0; start < nv; start++) {
        if (!w->occupied[start] || w->visited[start]) continue;
        int root = (bnd_root >= 0 && uf_find(w->parent, start) == bnd_root)
                   ? bnd : start;
        int n_order = 0;
        w->order[n_order++] = root;
        w->visited[root] = 1;
        for (int head = 0; head < n_order; head++) {
            int u = w->order[head];
            for (int s = w->adj_head[u]; s >= 0; s = w->adj_next[s]) {
                int nb = w->adj_vert[s];
                if (!w->visited[nb]) {
                    w->visited[nb] = 1;
                    w->tree_par[nb] = u;
                    w->tree_edge[nb] = w->adj_edge[s];
                    w->order[n_order++] = nb;
                }
            }
        }
        for (int i = n_order - 1; i >= 1; i--) {
            int u = w->order[i];
            if (w->defect[u]) {
                corr[w->tree_edge[u]] ^= 1;
                w->defect[u] = 0;
                w->defect[w->tree_par[u]] ^= 1;
            }
        }
        if (root != bnd && w->defect[root]) return 2;
    }
    return 0;
}

static PyObject *
uf_decode(PyObject *self, PyObject *args)
{
    PyObject *edges_obj, *wts_obj, *syn_obj, *out_obj;
    int ne, nc, bnd;
    Py_ssize_t n_trials;
    if (!PyArg_ParseTuple(args, "OiiiOOnO", &edges_obj, &ne, &nc, &bnd,
                          &wts_obj, &syn_obj, &n_trials, &out_obj)) {
        return NULL;
    }
    Py_buffer ev, wv, sv, ov;
    if (PyObject_GetBuffer(edges_obj, &ev, PyBUF_CONTIG_RO) < 0) return NULL;
    if (PyObject_GetBuffer(wts_obj, &wv, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&ev);
        return NULL;
    }
    if (PyObject_GetBuffer(syn_obj, &sv, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&ev); PyBuffer_Release(&wv);
        return NULL;
    }
    if (PyObject_GetBuffer(out_obj, &ov, PyBUF_CONTIG) < 0) {
        PyBuffer_Release(&ev); PyBuffer_Release(&wv); PyBuffer_Release(&sv);
        return NULL;
    }
    int nv = nc + (bnd >= 0 ? 1 : 0);
    const int32_t *wts = (const int32_t *)wv.buf;
    int maxcap = 2;
    int wts_ok = (wv.len >= (Py_ssize_t)ne * 4);
    if (wts_ok) {
        for (int e = 0; e < ne; e++) {
            if (wts[e] < 1) { wts_ok = 0; break; }
            if (2 * wts[e] > maxcap) maxcap = 2 * wts[e];
        }
    }
    if (ev.len < (Py_ssize_t)ne * 2 * 4
        || !wts_ok
        || sv.len < n_trials * (Py_ssize_t)nc
        || ov.len < n_trials * (Py_ssize_t)ne
        || (bnd >= 0 && bnd != nc)) {
        PyBuffer_Release(&ev); PyBuffer_Release(&wv);
        PyBuffer_Release(&sv); PyBuffer_Release(&ov);
        PyErr_SetString(PyExc_ValueError, "uf_decode: bad buffer shapes");
        return NULL;
    }

    UFWork w;
    w.parent = (int *)malloc(sizeof(int) * (size_t)nv);
    w.parity = (signed char *)malloc((size_t)nv);
    w.on_bnd = (unsigned char *)malloc((size_t)nv);
    w.occupied = (unsigned char *)malloc((size_t)nv);
    w.active = (unsigned char *)malloc((size_t)nv);
    w.defect = (unsigned char *)malloc((size_t)nv);
    w.visited = (unsigned char *)malloc((size_t)nv);
    w.growth = (int *)malloc(sizeof(int) * (size_t)(ne > 0 ? ne : 1));
    w.newly_full = (int *)malloc(sizeof(int) * (size_t)(ne > 0 ? ne : 1));
    w.adj_head = (int *)malloc(sizeof(int) * (size_t)nv);
    w.adj_next = (int *)malloc(sizeof(int) * (size_t)(2 * (ne > 0 ? ne : 1)));
    w.adj_vert = (int *)malloc(sizeof(int) * (size_t)(2 * (ne > 0 ? ne : 1)));
    w.adj_edge = (int *)malloc(sizeof(int) * (size_t)(2 * (ne > 0 ? ne : 1)));
    w.order = (int *)malloc(sizeof(int) * (size_t)nv);
    w.tree_par = (int *)malloc(sizeof(int) * (size_t)nv);
    w.tree_edge = (int *)malloc(sizeof(int) * (size_t)nv);

    int rc = 0;
    if (!w.parent || !w.parity || !w.on_bnd || !w.occupied || !w.active
        || !w.defect || !w.visited || !w.growth || !w.newly_full
        || !w.adj_head || !w.adj_next || !w.adj_vert || !w.adj_edge
        || !w.order || !w.tree_par || !w.tree_edge) {
        rc = -1;
    } else {
        const int32_t *edges = (const int32_t *)ev.buf;
        const uint8_t *syn = (const uint8_t *)sv.buf;
        uint8_t *out = (uint8_t *)ov.buf;
        Py_BEGIN_ALLOW_THREADS
        for (Py_ssize_t t = 0; t < n_trials; t++) {
            int r = uf_decode_one(edges, wts, maxcap, ne, nc, bnd, nv,
                                  syn + t * nc, out + t * ne, &w);
            if (r != 0) { rc = r; break; }
        }
        Py_END_ALLOW_THREADS
    }

    free(w.parent); free(w.parity); free(w.on_bnd); free(w.occupied);
    free(w.active); free(w.defect); free(w.visited); free(w.growth);
    free(w.newly_full); free(w.adj_head); free(w.adj_next);
    free(w.adj_vert); free(w.adj_edge); free(w.order);
    free(w.tree_par); free(w.tree_edge);

    PyBuffer_Release(&ev); PyBuffer_Release(&wv);
    PyBuffer_Release(&sv); PyBuffer_Release(&ov);
    if (rc == -1) return PyErr_NoMemory();
    if (rc == 2) {
        PyErr_SetString(PyExc_RuntimeError,
                        "uf_decode: internal convergence failure");
        return NULL;
    }
    return PyLong_FromLong(rc);
}

static PyMethodDef Methods[] = {
    {"uf_decode", uf_decode, METH_VARARGS,
     "Batched union-find matching decode over a CSS sector graph."},
    {"counts_from_array", counts_from_array, METH_VARARGS,
     "Dense int64 histogram -> {bitstring: count} dict (zeros skipped)."},
    {"histogram_from_indices", histogram_from_indices, METH_VARARGS,
     "Sampled int64 basis indices -> {bitstring: count} dict."},
    {"pack_bits", pack_bits, METH_VARARGS,
     "uint8 (rows x n) bit matrix -> list of basis indices."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_qsim_native",
    "C hot paths for host-side result processing.", -1, Methods,
};

PyMODINIT_FUNC
PyInit__qsim_native(void)
{
    return PyModule_Create(&moduledef);
}
