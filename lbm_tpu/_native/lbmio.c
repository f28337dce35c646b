/* lbmio — native formatted I/O for the LBM engine.
 *
 * The equivalent of the reference's C host I/O layer (write_values /
 * obstacle loader, d2q9-bgk.c:571-586 and :772-856): the compute path
 * lives on the accelerator, but formatting a
 * 1M-line final_state.dat (1024x1024 grid ~ 70 MB of text) is host work
 * where native code is ~10x faster than Python string formatting.
 *
 * Exposed functions (all operate on C-contiguous buffers):
 *   write_final_state(path, ux, uy, speed, pressure, obstacles, ny, nx)
 *       ux/uy/speed/pressure: float64[ny*nx]; obstacles: int32[ny*nx].
 *   write_av_vels(path, av)            av: float64[n].
 *   parse_obstacles(path, nx, ny) -> (bytes mask[ny*nx], free_cells)
 *       xx yy 1 triplets with the reference's range checks and
 *       duplicate-guarded free-cell count.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* Grab a read-only contiguous buffer of `itemsize`-sized elements whose
 * element format matches `fmt` ('d' = float64, 'i' = int32).  The format
 * check matters: a float32 array of an 8-divisible byte length would
 * otherwise be silently reinterpreted as doubles and written as noise. */
static int
get_buffer(PyObject *obj, Py_buffer *view, Py_ssize_t expect_items,
           Py_ssize_t itemsize, char fmt, const char *name)
{
    if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
        return -1;
    if (view->itemsize != itemsize || view->format == NULL ||
        view->format[0] != fmt || view->format[1] != '\0') {
        PyErr_Format(PyExc_ValueError,
                     "%s: expected a '%c' buffer of %zd-byte items, got "
                     "format '%s' with itemsize %zd",
                     name, fmt, itemsize,
                     view->format ? view->format : "B", view->itemsize);
        PyBuffer_Release(view);
        return -1;
    }
    if (expect_items >= 0 && view->len != expect_items * itemsize) {
        PyErr_Format(PyExc_ValueError,
                     "%s: expected %zd items of %zd bytes, got %zd bytes",
                     name, expect_items, itemsize, view->len);
        PyBuffer_Release(view);
        return -1;
    }
    return 0;
}

static PyObject *
write_final_state(PyObject *self, PyObject *args)
{
    const char *path;
    PyObject *oux, *ouy, *ospeed, *opressure, *oobs;
    Py_ssize_t ny, nx;
    if (!PyArg_ParseTuple(args, "sOOOOOnn", &path, &oux, &ouy, &ospeed,
                          &opressure, &oobs, &ny, &nx))
        return NULL;

    Py_ssize_t n = ny * nx;
    Py_buffer bux, buy, bspeed, bpressure, bobs;
    if (get_buffer(oux, &bux, n, 8, 'd', "ux") < 0)
        return NULL;
    if (get_buffer(ouy, &buy, n, 8, 'd', "uy") < 0)
        goto fail1;
    if (get_buffer(ospeed, &bspeed, n, 8, 'd', "speed") < 0)
        goto fail2;
    if (get_buffer(opressure, &bpressure, n, 8, 'd', "pressure") < 0)
        goto fail3;
    if (get_buffer(oobs, &bobs, n, 4, 'i', "obstacles") < 0)
        goto fail4;

    {
        const double *ux = (const double *)bux.buf;
        const double *uy = (const double *)buy.buf;
        const double *speed = (const double *)bspeed.buf;
        const double *pressure = (const double *)bpressure.buf;
        const int32_t *obs = (const int32_t *)bobs.buf;

        FILE *fp = fopen(path, "w");
        if (!fp) {
            PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
            goto fail5;
        }
        /* 1 MiB stdio buffer keeps write() syscalls rare. */
        setvbuf(fp, NULL, _IOFBF, 1 << 20);

        /* fprintf/fclose failures (ENOSPC, I/O errors) must surface —
         * a silently truncated final_state.dat would only be found
         * later as a mysterious checker failure. */
        int io_error = 0;
        Py_BEGIN_ALLOW_THREADS
        for (Py_ssize_t y = 0; y < ny && !io_error; ++y) {
            for (Py_ssize_t x = 0; x < nx; ++x) {
                Py_ssize_t i = y * nx + x;
                if (fprintf(fp, "%d %d %.12E %.12E %.12E %.12E %d\n",
                            (int)x, (int)y, ux[i], uy[i], speed[i],
                            pressure[i], (int)obs[i]) < 0) {
                    io_error = 1;
                    break;
                }
            }
        }
        /* fclose flushes the stdio buffer — its failure is a failed
         * write of up to the final 1 MiB. */
        if (fclose(fp) != 0)
            io_error = 1;
        Py_END_ALLOW_THREADS
        if (io_error) {
            PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
            goto fail5;
        }
    }

    PyBuffer_Release(&bobs);
    PyBuffer_Release(&bpressure);
    PyBuffer_Release(&bspeed);
    PyBuffer_Release(&buy);
    PyBuffer_Release(&bux);
    Py_RETURN_NONE;

fail5:
    PyBuffer_Release(&bobs);
fail4:
    PyBuffer_Release(&bpressure);
fail3:
    PyBuffer_Release(&bspeed);
fail2:
    PyBuffer_Release(&buy);
fail1:
    PyBuffer_Release(&bux);
    return NULL;
}

static PyObject *
write_av_vels(PyObject *self, PyObject *args)
{
    const char *path;
    PyObject *oav;
    if (!PyArg_ParseTuple(args, "sO", &path, &oav))
        return NULL;

    Py_buffer bav;
    if (get_buffer(oav, &bav, -1, 8, 'd', "av") < 0)
        return NULL;

    {
        Py_ssize_t n = bav.len / 8;
        const double *av = (const double *)bav.buf;
        FILE *fp = fopen(path, "w");
        if (!fp) {
            PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
            PyBuffer_Release(&bav);
            return NULL;
        }
        setvbuf(fp, NULL, _IOFBF, 1 << 20);
        int io_error = 0;
        Py_BEGIN_ALLOW_THREADS
        for (Py_ssize_t i = 0; i < n; ++i) {
            if (fprintf(fp, "%zd:\t%.12E\n", i, av[i]) < 0) {
                io_error = 1;
                break;
            }
        }
        if (fclose(fp) != 0)
            io_error = 1;
        Py_END_ALLOW_THREADS
        if (io_error) {
            PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
            PyBuffer_Release(&bav);
            return NULL;
        }
    }
    PyBuffer_Release(&bav);
    Py_RETURN_NONE;
}

static PyObject *
parse_obstacles(PyObject *self, PyObject *args)
{
    const char *path;
    Py_ssize_t nx, ny;
    if (!PyArg_ParseTuple(args, "snn", &path, &nx, &ny))
        return NULL;

    FILE *fp = fopen(path, "r");
    if (!fp) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }

    PyObject *mask_bytes = PyBytes_FromStringAndSize(NULL, nx * ny);
    if (!mask_bytes) {
        fclose(fp);
        return NULL;
    }
    char *mask = PyBytes_AS_STRING(mask_bytes);
    memset(mask, 0, (size_t)(nx * ny));

    long free_cells = (long)(nx * ny);
    long xx, yy, blocked;
    long lineno = 0;
    /* Line-based parsing (NOT a whitespace-stream fscanf, which would
     * silently re-group values across malformed line boundaries): each
     * non-blank line must hold exactly three integers, same contract as
     * the pure-Python fallback in geometry.py.  The line buffer GROWS to
     * the full physical line (no fixed cap), so arbitrarily wide
     * whitespace/column formatting parses identically in both parsers —
     * a fixed fgets buffer would either split long lines into fragments
     * (each potentially scanning as a valid triplet) or reject padding
     * the Python parser accepts. */
    size_t cap = 256;
    char *line = (char *)malloc(cap);
    if (!line) {
        fclose(fp);
        Py_DECREF(mask_bytes);
        return PyErr_NoMemory();
    }
    while (fgets(line, (int)cap, fp)) {
        ++lineno;
        size_t len = strlen(line);
        while (len > 0 && line[len - 1] != '\n' && !feof(fp)) {
            /* 64 MiB bounds both memory on hostile input and the (int)
             * casts below (fgets takes int); no legitimate obstacle line
             * approaches this. */
            if (cap >= (size_t)64 * 1024 * 1024) {
                free(line);
                fclose(fp);
                Py_DECREF(mask_bytes);
                PyErr_Format(PyExc_ValueError,
                             "%s:%ld: line longer than 64 MiB", path,
                             lineno);
                return NULL;
            }
            cap *= 2;
            char *bigger = (char *)realloc(line, cap);
            if (!bigger) {
                free(line);
                fclose(fp);
                Py_DECREF(mask_bytes);
                return PyErr_NoMemory();
            }
            line = bigger;
            if (!fgets(line + len, (int)(cap - len), fp))
                break;
            len = strlen(line);
        }
        char extra[8];
        int rv = sscanf(line, "%ld %ld %ld %7s", &xx, &yy, &blocked, extra);
        if (rv <= 0) {
            /* Same blank-line set as Python's str.split(): all ASCII
             * whitespace, including \v and \f. */
            int only_ws = 1;
            for (const char *p = line; *p; ++p) {
                if (*p != ' ' && *p != '\t' && *p != '\r' && *p != '\n' &&
                    *p != '\v' && *p != '\f') {
                    only_ws = 0;
                    break;
                }
            }
            if (only_ws)
                continue;
        }
        if (rv != 3) {
            free(line);
            fclose(fp);
            Py_DECREF(mask_bytes);
            PyErr_Format(PyExc_ValueError,
                         "%s:%ld: expected 3 values per line", path, lineno);
            return NULL;
        }
        if (xx < 0 || xx >= nx) {
            free(line);
            fclose(fp);
            Py_DECREF(mask_bytes);
            PyErr_Format(PyExc_ValueError,
                         "%s:%ld: obstacle x-coord out of range", path, lineno);
            return NULL;
        }
        if (yy < 0 || yy >= ny) {
            free(line);
            fclose(fp);
            Py_DECREF(mask_bytes);
            PyErr_Format(PyExc_ValueError,
                         "%s:%ld: obstacle y-coord out of range", path, lineno);
            return NULL;
        }
        if (blocked != 1) {
            free(line);
            fclose(fp);
            Py_DECREF(mask_bytes);
            PyErr_Format(PyExc_ValueError,
                         "%s:%ld: obstacle blocked value should be 1", path,
                         lineno);
            return NULL;
        }
        if (!mask[yy * nx + xx]) {
            mask[yy * nx + xx] = 1;
            --free_cells;
        }
    }
    free(line);
    fclose(fp);
    return Py_BuildValue("(Nl)", mask_bytes, free_cells);
}

static PyMethodDef methods[] = {
    {"write_final_state", write_final_state, METH_VARARGS,
     "write final_state.dat in the reference byte format"},
    {"write_av_vels", write_av_vels, METH_VARARGS,
     "write av_vels.dat in the reference byte format"},
    {"parse_obstacles", parse_obstacles, METH_VARARGS,
     "parse xx/yy/1 triplets -> (mask bytes, free_cells)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "lbmio",
    "native formatted I/O for the LBM engine", -1, methods,
};

PyMODINIT_FUNC
PyInit_lbmio(void)
{
    return PyModule_Create(&module);
}
