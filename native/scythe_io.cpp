// Fast CSV grid I/O for scythe-tpu (CPython C extension, no third-party deps).
//
// The reference's I/O layer is compiled CSV machinery (Julia CSV.jl /
// DataFrames behind src/io.jl and Springsteel's read_physical_grid /
// write_grid).  This is the framework's native equivalent: a small C++
// parser/formatter for the physical_out_<t>.csv interchange format, exposed
// to Python via the buffer protocol (no numpy headers needed).
//
//   read_csv(path)                  -> (names: list[str], nrows, ncols, bytes)
//   write_csv(path, names, buffer, nrows, ncols) -> None
//
// scythe_tpu.io wraps these with numpy views and falls back to pure-numpy
// when the extension is not built.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FileCloser {
    FILE* f;
    ~FileCloser() {
        if (f) fclose(f);
    }
};

PyObject* read_csv(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

    FILE* f = fopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    FileCloser closer{f};

    // slurp the file
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(static_cast<size_t>(size));
    if (size > 0 && fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                        static_cast<size_t>(size)) {
        PyErr_SetString(PyExc_OSError, "short read");
        return nullptr;
    }

    // header line
    size_t pos = buf.find('\n');
    if (pos == std::string::npos) {
        PyErr_SetString(PyExc_ValueError, "CSV has no header line");
        return nullptr;
    }
    std::string header = buf.substr(0, pos);
    if (!header.empty() && header.back() == '\r') header.pop_back();
    PyObject* names = PyList_New(0);
    if (!names) return nullptr;
    size_t start = 0;
    size_t ncols = 0;
    while (true) {
        size_t comma = header.find(',', start);
        std::string name = header.substr(
            start, comma == std::string::npos ? std::string::npos : comma - start);
        PyObject* s = PyUnicode_FromStringAndSize(name.data(), (Py_ssize_t)name.size());
        if (!s || PyList_Append(names, s) < 0) {
            Py_XDECREF(s);
            Py_DECREF(names);
            return nullptr;
        }
        Py_DECREF(s);
        ++ncols;
        if (comma == std::string::npos) break;
        start = comma + 1;
    }

    // data rows
    std::vector<double> data;
    data.reserve(1024 * ncols);
    const char* p = buf.data() + pos + 1;
    const char* end = buf.data() + buf.size();
    size_t nrows = 0;
    while (p < end) {
        // skip blank lines
        if (*p == '\n' || *p == '\r') {
            ++p;
            continue;
        }
        for (size_t c = 0; c < ncols; ++c) {
            char* next = nullptr;
            errno = 0;
            double v = strtod(p, &next);
            if (next == p) {
                Py_DECREF(names);
                PyErr_Format(PyExc_ValueError,
                             "CSV parse error at row %zu col %zu", nrows + 2, c + 1);
                return nullptr;
            }
            data.push_back(v);
            p = next;
            if (c + 1 < ncols) {
                if (p < end && *p == ',') ++p;
            }
        }
        while (p < end && (*p == '\r' || *p == '\n')) ++p;
        ++nrows;
    }

    PyObject* bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(data.data()),
        (Py_ssize_t)(data.size() * sizeof(double)));
    if (!bytes) {
        Py_DECREF(names);
        return nullptr;
    }
    PyObject* out = Py_BuildValue("(OnnO)", names, (Py_ssize_t)nrows,
                                  (Py_ssize_t)ncols, bytes);
    Py_DECREF(names);
    Py_DECREF(bytes);
    return out;
}

PyObject* write_csv(PyObject*, PyObject* args) {
    const char* path;
    PyObject* names;
    Py_buffer view;
    Py_ssize_t nrows, ncols;
    if (!PyArg_ParseTuple(args, "sOy*nn", &path, &names, &view, &nrows, &ncols))
        return nullptr;

    if (view.len < (Py_ssize_t)(nrows * ncols * sizeof(double))) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "buffer too small for nrows*ncols");
        return nullptr;
    }
    const double* data = static_cast<const double*>(view.buf);

    FILE* f = fopen(path, "wb");
    if (!f) {
        PyBuffer_Release(&view);
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    FileCloser closer{f};

    Py_ssize_t n_names = PySequence_Length(names);
    for (Py_ssize_t i = 0; i < n_names; ++i) {
        PyObject* item = PySequence_GetItem(names, i);
        if (!item) {
            PyBuffer_Release(&view);
            return nullptr;
        }
        const char* s = PyUnicode_AsUTF8(item);
        fputs(s ? s : "", f);
        Py_DECREF(item);
        if (i + 1 < n_names) fputc(',', f);
    }
    fputc('\n', f);

    std::string line;
    line.reserve(ncols * 26);
    char num[64];
    for (Py_ssize_t r = 0; r < nrows; ++r) {
        line.clear();
        for (Py_ssize_t c = 0; c < ncols; ++c) {
            int n = snprintf(num, sizeof num, "%.17g", data[r * ncols + c]);
            line.append(num, (size_t)n);
            if (c + 1 < ncols) line.push_back(',');
        }
        line.push_back('\n');
        fwrite(line.data(), 1, line.size(), f);
    }
    PyBuffer_Release(&view);
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"read_csv", read_csv, METH_VARARGS,
     "read_csv(path) -> (names, nrows, ncols, float64 bytes)"},
    {"write_csv", write_csv, METH_VARARGS,
     "write_csv(path, names, buffer, nrows, ncols)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "scythe_native_io",
    "Native CSV grid I/O for scythe-tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit_scythe_native_io() { return PyModule_Create(&module); }
