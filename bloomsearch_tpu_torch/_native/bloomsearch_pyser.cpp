// Batch dict-row JSON serializer (CPython API).
//
// Replaces the per-row json.dumps(...).encode() loop on the ingest hot path
// (engine.py _ingest_rows): one call serializes a whole batch of dict rows
// straight into the engine's length-prefixed stream format and returns
// (stream bytes, offsets int64 bytes, lengths int64 bytes) — offsets point
// past each 4-byte prefix so the native tokenizer consumes the same buffer
// with no re-copy.
//
// Exactness contract: output is BYTE-IDENTICAL to
// json.dumps(row, separators=(",", ":")) — ensure_ascii \uXXXX escapes
// (incl. surrogate pairs), CPython float repr via PyOS_double_to_string
// 'r' + Py_DTSF_ADD_DOT_0, Infinity/-Infinity/NaN (allow_nan=True), ints,
// bools, null, nested dicts/lists/tuples. Anything unsupported (non-str
// keys, custom types, cycles past depth 64) returns None and the caller
// falls back to json.dumps for the whole batch — never a silently
// different serialization. Parity is fuzz-tested in
// tests/test_native_ingest.py.
//
// Loaded with ctypes.PyDLL (GIL held). Kept in its own shared object so an
// interpreter without resolvable libpython symbols degrades gracefully
// without touching the main compute library.

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buf {
  std::string s;
  void put(char c) { s.push_back(c); }
  void put(const char* p, size_t n) { s.append(p, n); }
};

const char* kHex = "0123456789abcdef";

void put_u_escape(Buf& b, uint32_t cp) {
  char esc[6] = {'\\', 'u', kHex[(cp >> 12) & 15], kHex[(cp >> 8) & 15],
                 kHex[(cp >> 4) & 15], kHex[cp & 15]};
  b.put(esc, 6);
}

bool write_str(Buf& b, PyObject* obj) {
  // Iterate codepoints (not UTF-8 bytes): json.dumps with the default
  // ensure_ascii escapes every non-ASCII char as \uXXXX / surrogate pairs.
  if (PyUnicode_READY(obj) != 0) return false;
  const Py_ssize_t n = PyUnicode_GET_LENGTH(obj);
  const int kind = PyUnicode_KIND(obj);
  const void* data = PyUnicode_DATA(obj);
  b.put('"');
  for (Py_ssize_t i = 0; i < n; i++) {
    const Py_UCS4 c = PyUnicode_READ(kind, data, i);
    if (c == '"') {
      b.put("\\\"", 2);
    } else if (c == '\\') {
      b.put("\\\\", 2);
    } else if (c >= 0x20 && c < 0x7f) {
      b.put((char)c);
    } else if (c == '\n') {
      b.put("\\n", 2);
    } else if (c == '\t') {
      b.put("\\t", 2);
    } else if (c == '\r') {
      b.put("\\r", 2);
    } else if (c == '\b') {
      b.put("\\b", 2);
    } else if (c == '\f') {
      b.put("\\f", 2);
    } else if (c < 0x10000) {
      put_u_escape(b, c);  // covers controls, 0x7f, and the whole BMP
    } else {
      const uint32_t v = c - 0x10000;
      put_u_escape(b, 0xd800 + (v >> 10));
      put_u_escape(b, 0xdc00 + (v & 0x3ff));
    }
  }
  b.put('"');
  return true;
}

// Returns: 1 ok, 0 unsupported (clean fallback), -1 python error.
int write_value(Buf& b, PyObject* obj, int depth) {
  if (depth > 64) return 0;
  if (obj == Py_None) {
    b.put("null", 4);
    return 1;
  }
  if (PyBool_Check(obj)) {
    if (obj == Py_True) b.put("true", 4);
    else b.put("false", 5);
    return 1;
  }
  if (PyUnicode_Check(obj)) {
    return write_str(b, obj) ? 1 : -1;
  }
  if (PyLong_Check(obj)) {
    int overflow = 0;
    const long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (!overflow) {
      if (v == -1 && PyErr_Occurred()) return -1;
      char tmp[24];
      const int len = snprintf(tmp, sizeof(tmp), "%lld", v);
      b.put(tmp, (size_t)len);
      return 1;
    }
    // Arbitrary precision: base int repr (json.dumps calls
    // PyLong_Type.tp_repr, so a subclass __str__/__repr__ must NOT be
    // consulted — it could emit non-JSON and break byte parity).
    PyObject* s = PyLong_Type.tp_repr(obj);
    if (s == nullptr) return -1;
    Py_ssize_t n;
    const char* u = PyUnicode_AsUTF8AndSize(s, &n);
    if (u == nullptr) {
      Py_DECREF(s);
      return -1;
    }
    b.put(u, (size_t)n);
    Py_DECREF(s);
    return 1;
  }
  if (PyFloat_Check(obj)) {
    const double v = PyFloat_AS_DOUBLE(obj);
    if (v != v) {
      b.put("NaN", 3);  // json.dumps allow_nan=True spellings
      return 1;
    }
    if (v > 1.7976931348623157e308) {
      b.put("Infinity", 8);
      return 1;
    }
    if (v < -1.7976931348623157e308) {
      b.put("-Infinity", 9);
      return 1;
    }
    char* r = PyOS_double_to_string(v, 'r', 0, Py_DTSF_ADD_DOT_0, nullptr);
    if (r == nullptr) return -1;
    b.put(r, strlen(r));
    PyMem_Free(r);
    return 1;
  }
  if (PyDict_Check(obj)) {
    // EXACT dicts only: json.dumps' C encoder uses items() for dict
    // subclasses (OrderedDict with a moved key would serialize in a
    // different order here than json.dumps — a silent byte divergence).
    if (!PyDict_CheckExact(obj)) return 0;  // clean fallback to json.dumps
    b.put('{');
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    bool first = true;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      if (!PyUnicode_Check(key)) return 0;  // json.dumps would coerce; bail
      if (!first) b.put(',');
      first = false;
      if (!write_str(b, key)) return -1;
      b.put(':');
      const int rc = write_value(b, value, depth + 1);
      if (rc != 1) return rc;
    }
    b.put('}');
    return 1;
  }
  if (PyList_Check(obj) || PyTuple_Check(obj)) {
    b.put('[');
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
    PyObject** items = PySequence_Fast_ITEMS(obj);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (i) b.put(',');
      const int rc = write_value(b, items[i], depth + 1);
      if (rc != 1) return rc;
    }
    b.put(']');
    return 1;
  }
  return 0;  // unsupported type: caller falls back to json.dumps
}

}  // namespace

extern "C" {

// rows: list[dict] -> (stream bytes, offsets int64-LE bytes, lengths
// int64-LE bytes) | None (unsupported content: fall back) ; NULL on error.
// Called via ctypes.PyDLL (GIL held), not as a bound method.
static PyObject* serialize_rows_impl(PyObject* rows) {
  if (!PyList_Check(rows)) {
    PyErr_SetString(PyExc_TypeError, "rows must be a list");
    return nullptr;
  }
  const Py_ssize_t n = PyList_GET_SIZE(rows);
  Buf b;
  b.s.reserve((size_t)n * 96);
  std::vector<int64_t> offsets;
  std::vector<int64_t> lengths;
  offsets.reserve((size_t)n);
  lengths.reserve((size_t)n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* row = PyList_GET_ITEM(rows, i);
    if (!PyDict_Check(row)) Py_RETURN_NONE;
    const size_t prefix_at = b.s.size();
    b.put("\0\0\0\0", 4);  // length prefix placeholder
    const size_t start = b.s.size();
    const int rc = write_value(b, row, 0);
    if (rc == -1) return nullptr;
    if (rc == 0) Py_RETURN_NONE;  // unsupported somewhere: full fallback
    const uint64_t len = b.s.size() - start;
    if (len > 0xFFFFFFFFull) Py_RETURN_NONE;  // row too large: fallback path raises
    const uint32_t len32 = (uint32_t)len;
    std::memcpy(&b.s[prefix_at], &len32, 4);  // little-endian hosts only
    offsets.push_back((int64_t)start);
    lengths.push_back((int64_t)len);
  }
  PyObject* stream = PyBytes_FromStringAndSize(b.s.data(), (Py_ssize_t)b.s.size());
  PyObject* offs = PyBytes_FromStringAndSize(
      (const char*)offsets.data(), (Py_ssize_t)(offsets.size() * 8));
  PyObject* lens = PyBytes_FromStringAndSize(
      (const char*)lengths.data(), (Py_ssize_t)(lengths.size() * 8));
  if (!stream || !offs || !lens) {
    Py_XDECREF(stream);
    Py_XDECREF(offs);
    Py_XDECREF(lens);
    return nullptr;
  }
  PyObject* out = PyTuple_Pack(3, stream, offs, lens);
  Py_DECREF(stream);
  Py_DECREF(offs);
  Py_DECREF(lens);
  return out;
}

__attribute__((visibility("default"))) PyObject* bs_serialize_rows(PyObject* rows) {
  // Exception firewall: std::bad_alloc from Buf/vector growth would
  // otherwise unwind through the ctypes boundary and std::terminate the
  // whole interpreter; raise MemoryError like the json.dumps path would.
  try {
    return serialize_rows_impl(rows);
  } catch (const std::bad_alloc&) {
    PyErr_NoMemory();
    return nullptr;
  } catch (...) {
    PyErr_SetString(PyExc_RuntimeError, "native row serializer failed");
    return nullptr;
  }
}

}  // extern "C"
