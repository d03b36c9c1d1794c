/* nbodyhpc_jax._hostio — native host-side runtime: particle file IO and
 * deterministic parallel data generation.
 *
 * Counterpart of the reference's native CPU runtime pieces:
 *  - raw particle file loading (reference: kdtree/src/cpp/main.cpp:103-114
 *    reads packed float3; rasterization/src/cpp/main.cpp:86-101 reads packed
 *    Vertex{pos[3], weight, radius} records) — here via mmap + one memcpy
 *    into aligned numpy buffers, multi-GB friendly.
 *  - Philox4x32-10 counter-based random point generation (reference:
 *    kdtree/src/cpp/include/kdtree/kdtree_utils.hpp:16-90 uses Random123),
 *    parallelized over POSIX threads; counter-based means the stream is
 *    identical for any thread count.
 *
 * Plain CPython C API (no pybind11 in this environment).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

/* ------------------------- Philox4x32-10 ------------------------------- */

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

static inline void philox4x32_round(uint32_t ctr[4], const uint32_t key[2]) {
    uint64_t p0 = (uint64_t)PHILOX_M0 * ctr[0];
    uint64_t p1 = (uint64_t)PHILOX_M1 * ctr[2];
    uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
    uint32_t out[4];
    out[0] = hi1 ^ ctr[1] ^ key[0];
    out[1] = lo1;
    out[2] = hi0 ^ ctr[3] ^ key[1];
    out[3] = lo0;
    memcpy(ctr, out, sizeof(out));
}

static inline void philox4x32_10(uint32_t ctr[4], uint32_t k0, uint32_t k1) {
    uint32_t key[2] = {k0, k1};
    for (int i = 0; i < 10; ++i) {
        philox4x32_round(ctr, key);
        key[0] += PHILOX_W0;
        key[1] += PHILOX_W1;
    }
}

typedef struct {
    float *out;
    int64_t start;  /* first float index (multiple of 4 blocks handled below) */
    int64_t count;  /* number of floats to produce */
    uint64_t seed;
    float scale;
} gen_job_t;

static void *gen_worker(void *arg) {
    gen_job_t *j = (gen_job_t *)arg;
    int64_t first_blk = j->start / 4;
    int64_t last = j->start + j->count;
    int64_t last_blk = (last + 3) / 4;
    /* top 24 bits * 2^-24: every uint32 maps to a float STRICTLY below 1
     * (a raw (float)u32 * 2^-32 rounds values near 2^32 up to 1.0f, which
     * would emit exactly `scale` and break the [0, scale) contract) */
    const float inv = 1.0f / 16777216.0f;
    for (int64_t b = first_blk; b < last_blk; ++b) {
        uint32_t ctr[4] = {(uint32_t)b, (uint32_t)(b >> 32), 0u, 0u};
        philox4x32_10(ctr, (uint32_t)j->seed, (uint32_t)(j->seed >> 32));
        for (int q = 0; q < 4; ++q) {
            int64_t idx = b * 4 + q;
            if (idx >= j->start && idx < last)
                j->out[idx] = (float)(ctr[q] >> 8) * inv * j->scale;
        }
    }
    return NULL;
}

static PyObject *hostio_philox_uniform(PyObject *self, PyObject *args) {
    Py_ssize_t n;
    unsigned long long seed;
    double scale = 1.0;
    int nthreads = 0;
    if (!PyArg_ParseTuple(args, "nK|di", &n, &seed, &scale, &nthreads))
        return NULL;
    if (n < 0) {
        PyErr_SetString(PyExc_ValueError, "n must be non-negative");
        return NULL;
    }
    npy_intp dims[1] = {(npy_intp)n};
    PyArrayObject *arr =
        (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_FLOAT32);
    if (!arr) return NULL;
    float *out = (float *)PyArray_DATA(arr);

    if (nthreads <= 0) {
        long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
        nthreads = ncpu > 0 ? (int)ncpu : 1;
    }
    if (nthreads > 64) nthreads = 64;
    if ((Py_ssize_t)nthreads > n / 4096 + 1) nthreads = (int)(n / 4096 + 1);

    Py_BEGIN_ALLOW_THREADS {
        pthread_t tids[64];
        gen_job_t jobs[64];
        int64_t per = (n + nthreads - 1) / nthreads;
        per = (per + 3) / 4 * 4; /* block-align so threads never share a block */
        int launched = 0;
        for (int t = 0; t < nthreads; ++t) {
            int64_t s = (int64_t)t * per;
            if (s >= n) break;
            int64_t c = n - s < per ? n - s : per;
            jobs[t].out = out;
            jobs[t].start = s;
            jobs[t].count = c;
            jobs[t].seed = seed;
            jobs[t].scale = (float)scale;
            pthread_create(&tids[t], NULL, gen_worker, &jobs[t]);
            launched++;
        }
        for (int t = 0; t < launched; ++t) pthread_join(tids[t], NULL);
    }
    Py_END_ALLOW_THREADS;
    return (PyObject *)arr;
}

/* --------------------------- particle file IO --------------------------- */

static PyObject *hostio_read_records(PyObject *self, PyObject *args) {
    /* read_records(path, ncols) -> float32 array (N, ncols), mmap + memcpy */
    const char *path;
    Py_ssize_t ncols;
    if (!PyArg_ParseTuple(args, "sn", &path, &ncols)) return NULL;
    if (ncols <= 0) {
        PyErr_SetString(PyExc_ValueError, "ncols must be positive");
        return NULL;
    }
    int fd = open(path, O_RDONLY);
    if (fd < 0) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    if (st.st_size % ((int64_t)ncols * 4) != 0) {
        close(fd);
        PyErr_Format(PyExc_ValueError,
                     "%s: size %lld is not a multiple of the %zd-float "
                     "record width", path, (long long)st.st_size, ncols);
        return NULL;
    }
    int64_t nrec = st.st_size / ((int64_t)ncols * 4);
    npy_intp dims[2] = {(npy_intp)nrec, (npy_intp)ncols};
    PyArrayObject *arr =
        (PyArrayObject *)PyArray_SimpleNew(2, dims, NPY_FLOAT32);
    if (!arr) {
        close(fd);
        return NULL;
    }
    int64_t nbytes = nrec * ncols * 4;
    if (nbytes > 0) {
        void *map = mmap(NULL, (size_t)nbytes, PROT_READ, MAP_PRIVATE, fd, 0);
        if (map == MAP_FAILED) {
            close(fd);
            Py_DECREF(arr);
            PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
            return NULL;
        }
        Py_BEGIN_ALLOW_THREADS
        memcpy(PyArray_DATA(arr), map, (size_t)nbytes);
        munmap(map, (size_t)nbytes);
        Py_END_ALLOW_THREADS;
    }
    close(fd);
    return (PyObject *)arr;
}

static PyObject *hostio_write_records(PyObject *self, PyObject *args) {
    /* write_records(path, array2d_float32) */
    const char *path;
    PyObject *obj;
    if (!PyArg_ParseTuple(args, "sO", &path, &obj)) return NULL;
    PyArrayObject *arr = (PyArrayObject *)PyArray_FROM_OTF(
        obj, NPY_FLOAT32, NPY_ARRAY_IN_ARRAY);
    if (!arr) return NULL;
    FILE *f = fopen(path, "wb");
    if (!f) {
        Py_DECREF(arr);
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    size_t nbytes = (size_t)PyArray_NBYTES(arr);
    size_t written;
    Py_BEGIN_ALLOW_THREADS
    written = fwrite(PyArray_DATA(arr), 1, nbytes, f);
    fclose(f);
    Py_END_ALLOW_THREADS;
    Py_DECREF(arr);
    if (written != nbytes) {
        PyErr_SetString(PyExc_OSError, "short write");
        return NULL;
    }
    Py_RETURN_NONE;
}

/* ----------------------- streaming chunk loader ------------------------- */
/* Double-buffered record streaming: a POSIX prefetch thread reads chunk
 * i+1 while Python consumes chunk i — the host analog of the reference's
 * dedicated Vulkan transfer queue overlapping uploads with compute
 * (rasterization/src/cpp/vulkan_support.cpp:204-237,
 *  point_renderer.cpp:393-449). */

typedef struct {
    PyObject_HEAD
    int fd;
    int64_t ncols;
    int64_t chunk_rows;
    int64_t nrec;      /* total records in the file */
    int64_t next_row;  /* first row of the chunk being prefetched */
    float *buf;        /* prefetch destination (owned until handed out) */
    int64_t buf_rows;
    pthread_t thr;
    int thr_running;
    struct {
        int fd;
        float *dst;
        int64_t off_bytes;
        int64_t nbytes;
        int error; /* errno from a failed/short pread; 0 on success */
    } job; /* one in flight per loader (start only after join) */
} LoaderObject;

typedef struct {
    int fd;
    float *dst;
    int64_t off_bytes;
    int64_t nbytes;
    int error; /* errno from a failed/short pread; 0 on success */
} prefetch_job_t;

static void *prefetch_worker(void *arg) {
    prefetch_job_t *j = (prefetch_job_t *)arg; /* points into the Loader */
    int64_t done = 0;
    j->error = 0;
    while (done < j->nbytes) {
        ssize_t r = pread(j->fd, (char *)j->dst + done,
                          (size_t)(j->nbytes - done), j->off_bytes + done);
        if (r < 0) {
            j->error = errno ? errno : EIO;
            return NULL;
        }
        if (r == 0) { /* file shrank under us: do NOT fabricate rows */
            j->error = EIO;
            return NULL;
        }
        done += r;
    }
    return NULL;
}

static void loader_start_prefetch(LoaderObject *self) {
    int64_t rows = self->nrec - self->next_row;
    if (rows <= 0) {
        self->buf = NULL;
        self->buf_rows = 0;
        return;
    }
    if (rows > self->chunk_rows) rows = self->chunk_rows;
    int64_t nbytes = rows * self->ncols * 4;
    self->buf = (float *)malloc((size_t)nbytes);
    if (!self->buf) {
        self->buf_rows = 0;
        self->job.error = ENOMEM;
        return;
    }
    self->buf_rows = rows;
    self->job.fd = self->fd;
    self->job.dst = self->buf;
    self->job.off_bytes = self->next_row * self->ncols * 4;
    self->job.nbytes = nbytes;
    self->job.error = 0;
    if (pthread_create(&self->thr, NULL, prefetch_worker, &self->job) != 0) {
        free(self->buf);
        self->buf = NULL;
        self->buf_rows = 0;
        self->job.error = EAGAIN;
        return;
    }
    self->thr_running = 1;
    self->next_row += rows;
}

static void loader_join(LoaderObject *self) {
    if (self->thr_running) {
        Py_BEGIN_ALLOW_THREADS
        pthread_join(self->thr, NULL);
        Py_END_ALLOW_THREADS;
        self->thr_running = 0;
    }
}

static void buf_capsule_free(PyObject *cap) {
    free(PyCapsule_GetPointer(cap, NULL));
}

static PyObject *loader_next_chunk(PyObject *self_o, PyObject *noargs) {
    /* next() -> float32 (rows, ncols) or None at EOF; kicks off the next
     * prefetch before returning. */
    LoaderObject *self = (LoaderObject *)self_o;
    loader_join(self);
    if (self->job.error) {
        errno = self->job.error;
        self->job.error = 0;
        free(self->buf);
        self->buf = NULL;
        return PyErr_SetFromErrno(PyExc_OSError);
    }
    if (!self->buf) Py_RETURN_NONE;
    float *data = self->buf;
    int64_t rows = self->buf_rows;
    self->buf = NULL;
    loader_start_prefetch(self); /* overlap with the caller's compute */

    npy_intp dims[2] = {(npy_intp)rows, (npy_intp)self->ncols};
    PyArrayObject *arr = (PyArrayObject *)PyArray_SimpleNewFromData(
        2, dims, NPY_FLOAT32, data);
    if (!arr) {
        free(data);
        return NULL;
    }
    PyObject *cap = PyCapsule_New(data, NULL, buf_capsule_free);
    if (!cap) {
        Py_DECREF(arr); /* arr does not own data yet; free it ourselves */
        free(data);
        return NULL;
    }
    if (PyArray_SetBaseObject(arr, cap) != 0) {
        /* SetBaseObject steals the capsule reference even on failure */
        Py_DECREF(arr);
        return NULL;
    }
    return (PyObject *)arr;
}

static PyObject *loader_close(PyObject *self_o, PyObject *noargs) {
    LoaderObject *self = (LoaderObject *)self_o;
    loader_join(self);
    free(self->buf);
    self->buf = NULL;
    if (self->fd >= 0) close(self->fd);
    self->fd = -1;
    Py_RETURN_NONE;
}

static void loader_dealloc(LoaderObject *self) {
    loader_join(self);
    free(self->buf);
    if (self->fd >= 0) close(self->fd);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef loader_methods[] = {
    {"next_chunk", loader_next_chunk, METH_NOARGS,
     "next_chunk() -> float32 (rows, ncols) or None at EOF."},
    {"close", loader_close, METH_NOARGS, "join the prefetch thread and close"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject LoaderType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_hostio.Loader",
    .tp_basicsize = sizeof(LoaderObject),
    .tp_dealloc = (destructor)loader_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = loader_methods,
    .tp_doc = "Double-buffered streaming record loader (prefetch thread)."};

static PyObject *hostio_stream_open(PyObject *self, PyObject *args) {
    /* stream_open(path, ncols, chunk_rows) -> Loader */
    const char *path;
    Py_ssize_t ncols, chunk_rows;
    if (!PyArg_ParseTuple(args, "snn", &path, &ncols, &chunk_rows))
        return NULL;
    if (ncols <= 0 || chunk_rows <= 0) {
        PyErr_SetString(PyExc_ValueError,
                        "ncols and chunk_rows must be positive");
        return NULL;
    }
    int fd = open(path, O_RDONLY);
    if (fd < 0) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    if (st.st_size % ((int64_t)ncols * 4) != 0) {
        close(fd);
        PyErr_Format(PyExc_ValueError,
                     "%s: size %lld is not a multiple of the %zd-float "
                     "record width", path, (long long)st.st_size, ncols);
        return NULL;
    }
    LoaderObject *ld = PyObject_New(LoaderObject, &LoaderType);
    if (!ld) {
        close(fd);
        return NULL;
    }
    ld->fd = fd;
    ld->ncols = ncols;
    ld->chunk_rows = chunk_rows;
    ld->nrec = st.st_size / ((int64_t)ncols * 4);
    ld->next_row = 0;
    ld->buf = NULL;
    ld->buf_rows = 0;
    ld->thr_running = 0;
    ld->job.error = 0;
    loader_start_prefetch(ld);
    return (PyObject *)ld;
}

/* ------------------------------ module --------------------------------- */

static PyMethodDef hostio_methods[] = {
    {"philox_uniform", hostio_philox_uniform, METH_VARARGS,
     "philox_uniform(n, seed, scale=1.0, nthreads=0) -> float32[n] in "
     "[0, scale); deterministic counter-based stream, threaded."},
    {"read_records", hostio_read_records, METH_VARARGS,
     "read_records(path, ncols) -> float32 (N, ncols) from a packed file."},
    {"write_records", hostio_write_records, METH_VARARGS,
     "write_records(path, arr) — write float32 records."},
    {"stream_open", hostio_stream_open, METH_VARARGS,
     "stream_open(path, ncols, chunk_rows) -> Loader (double-buffered "
     "prefetching record stream)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef hostio_module = {
    PyModuleDef_HEAD_INIT, "_hostio",
    "Native host IO / data generation for nbodyhpc_jax", -1, hostio_methods};

PyMODINIT_FUNC PyInit__hostio(void) {
    import_array();
    if (PyType_Ready(&LoaderType) < 0) return NULL;
    PyObject *m = PyModule_Create(&hostio_module);
    if (!m) return NULL;
    Py_INCREF(&LoaderType);
    if (PyModule_AddObject(m, "Loader", (PyObject *)&LoaderType) < 0) {
        Py_DECREF(&LoaderType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
