// Python binding of the kernel library: one call from Python per launch.
//
//   launch(name, *args)   call C entry `name` (entries.h) on the current
//                         stream of the card its tensors lie on
//   set_counts(d)         count each successful launch in d[name]
//
// Each argument is converted by its C parameter's type, read from the
// entry's prototype: a `const T*` takes a tensor of T's type (int32_t:
// torch.int32, int64_t: torch.int64, float, double), a `T*` (an output)
// the same or a shape, an int or a tuple of ints, for which the binding
// allocates an uninitialised tensor of T's type beside the other
// tensors; an int64_t or int32_t takes an int, a double a float; the
// stream is the binding's.  Every tensor must be on one CUDA device and
// contiguous, or launch raises ValueError and launches nothing.  A
// nonzero return of the entry raises RuntimeError; otherwise launch
// counts the launch and returns what it allocated: None, a tensor, or a
// tuple of them in parameter order.
//
// Argument conversion, the checks, the stream and device lookups and
// the outputs' allocation are done here, in one call, because done in
// Python around a C call they were most of a kernel call's host time,
// more than a PyTorch operator's (PERF.md section 6).  The file is
// compiled by the host compiler against torch's headers, in parallel
// with the kernels' nvcc, and linked with them into one extension
// module (ops/_build.py).
//
// Its compile is the longest step of the kernel build, so it is kept
// small.  It includes no torch Python or autograd header
// (torch/csrc/autograd/python_variable.h alone took 8.9 s): a tensor
// argument is reached through its public `_cdata` attribute, the
// address of its TensorImpl, and a new output is wrapped by torch's
// exported THPVariable_Wrap, declared here.  And one function, not one
// per entry, converts the arguments, launches and counts: each entry
// adds only a table of its parameters' kinds and a call that unpacks
// them (tools/time_torch_binding_build.py times the parts).
#include <Python.h>

#include <ATen/cuda/EmptyTensor.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>

#include <cstdint>
#include <exception>
#include <optional>
#include <tuple>
#include <type_traits>
#include <utility>

#define RMI_ENTRY(name, params) extern "C" int name params;
#include "entries.h"
#undef RMI_ENTRY

// libtorch_python: the Python tensor of `var`
PyObject* THPVariable_Wrap(const at::TensorBase& var);

namespace {

constexpr int kMaxParams = 28;
constexpr int kMaxOutputs = 4;
constexpr int kMaxDims = 8;

// the dict each launch is counted in (ops/_build.launches)
PyObject* g_counts = nullptr;
PyObject* g_tensor_type = nullptr;   // torch.Tensor
PyObject* g_cdata = nullptr;         // "_cdata": a tensor's TensorImpl address

// what a C parameter takes from Python
enum class Kind : uint8_t { kInput, kOutput, kInt64, kInt32, kDouble, kStream };

struct Param {
  Kind kind;
  c10::ScalarType dtype;     // of a tensor's elements
};

// one converted argument, as the entry's parameter takes it
union Slot {
  void* ptr;
  int64_t i64;
  int32_t i32;
  double f64;
};

template <class T>
constexpr c10::ScalarType kDtype = c10::ScalarType::Undefined;
template <>
constexpr c10::ScalarType kDtype<float> = c10::ScalarType::Float;
template <>
constexpr c10::ScalarType kDtype<double> = c10::ScalarType::Double;
template <>
constexpr c10::ScalarType kDtype<int32_t> = c10::ScalarType::Int;
template <>
constexpr c10::ScalarType kDtype<int64_t> = c10::ScalarType::Long;

template <class P>
constexpr Param param_of() {
  if constexpr (std::is_same_v<P, void*>) {
    return {Kind::kStream, c10::ScalarType::Undefined};
  } else if constexpr (std::is_pointer_v<P>) {
    using E = std::remove_const_t<std::remove_pointer_t<P>>;
    static_assert(kDtype<E> != c10::ScalarType::Undefined, "no torch type for this pointer");
    return {std::is_const_v<std::remove_pointer_t<P>> ? Kind::kInput : Kind::kOutput,
            kDtype<E>};
  } else if constexpr (std::is_same_v<P, int64_t>) {
    return {Kind::kInt64, c10::ScalarType::Undefined};
  } else if constexpr (std::is_same_v<P, int32_t>) {
    return {Kind::kInt32, c10::ScalarType::Undefined};
  } else {
    static_assert(std::is_same_v<P, double>, "a parameter type the binding cannot convert");
    return {Kind::kDouble, c10::ScalarType::Undefined};
  }
}

template <class P>
P from_slot(const Slot& s) {
  if constexpr (std::is_pointer_v<P>) {
    return static_cast<P>(s.ptr);
  } else if constexpr (std::is_same_v<P, int64_t>) {
    return s.i64;
  } else if constexpr (std::is_same_v<P, int32_t>) {
    return s.i32;
  } else {
    return s.f64;
  }
}

// an entry's parameter table and the call that unpacks its slots
template <class F>
struct Sig;

template <class... P>
struct Sig<int (*)(P...)> {
  static constexpr int N = sizeof...(P);
  static_assert(N <= kMaxParams, "too many parameters");
  static_assert(std::is_same_v<std::tuple_element_t<N - 1, std::tuple<P...>>, void*>,
                "an entry's last parameter is its stream");
  static constexpr Param params[N] = {param_of<P>()...};

  template <auto Fn, size_t... I>
  static int unpack(const Slot* s, std::index_sequence<I...>) {
    return Fn(from_slot<P>(s[I])...);
  }

  template <auto Fn>
  static int call(const Slot* s) {
    return unpack<Fn>(s, std::index_sequence_for<P...>());
  }
};

struct Entry {
  const char* name;
  const Param* params;
  int nparams;            // the stream, the last, included
  int (*call)(const Slot*);
  PyObject* key;          // the name as a Python str, made at import
};

// one launch's state: the entry, the tensors' device, what it allocated
struct Call {
  explicit Call(const char* entry) : name(entry) {}
  const char* name;
  int index = 0;             // of the argument being converted, from 1
  int device = -1;
  int nouts = 0;
  at::TensorBase outs[kMaxOutputs];
};

bool fail(PyObject* type, const Call& c, const char* what) {
  PyErr_Format(type, "%s: argument %d: %s", c.name, c.index, what);
  return false;
}

// a tensor argument: on the call's one CUDA device, contiguous, of the
// parameter's type
bool tensor_arg(PyObject* o, Call& c, const Param& p, Slot& v) {
  PyObject* addr = PyObject_GetAttr(o, g_cdata);
  if (addr == nullptr) return false;
  auto* t = static_cast<c10::TensorImpl*>(PyLong_AsVoidPtr(addr));
  Py_DECREF(addr);
  if (t == nullptr) return false;
  if (!t->is_cuda()) {
    PyErr_Format(PyExc_ValueError, "%s: argument %d: a tensor on %s, not on a CUDA device",
                 c.name, c.index, t->device().str().c_str());
    return false;
  }
  const int dev = t->device().index();
  if (c.device < 0) {
    c.device = dev;
  } else if (dev != c.device) {
    PyErr_Format(PyExc_ValueError, "%s: tensors on cuda:%d and cuda:%d", c.name, c.device,
                 dev);
    return false;
  }
  if (!t->is_contiguous()) return fail(PyExc_ValueError, c, "non-contiguous input");
  const c10::ScalarType type = c10::typeMetaToScalarType(t->dtype());
  if (type != p.dtype) {
    PyErr_Format(PyExc_ValueError, "%s: argument %d: want %s, got %s", c.name, c.index,
                 c10::toString(p.dtype), c10::toString(type));
    return false;
  }
  v.ptr = p.kind == Kind::kInput ? const_cast<void*>(t->data()) : t->mutable_data();
  return true;
}

// an output given as a shape: a new tensor of the parameter's type on
// the call's device
bool new_output(PyObject* o, Call& c, const Param& p, Slot& v) {
  int64_t dims[kMaxDims];
  Py_ssize_t nd = 1;
  if (PyTuple_Check(o)) {
    nd = PyTuple_GET_SIZE(o);
    if (nd > kMaxDims) return fail(PyExc_ValueError, c, "a shape of too many dimensions");
    for (Py_ssize_t i = 0; i < nd; ++i) {
      dims[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(o, i));
      if (dims[i] == -1 && PyErr_Occurred()) return false;
    }
  } else if (PyLong_Check(o)) {
    dims[0] = PyLong_AsLongLong(o);
    if (dims[0] == -1 && PyErr_Occurred()) return false;
  } else {
    return fail(PyExc_TypeError, c, "want a tensor or a shape");
  }
  for (Py_ssize_t i = 0; i < nd; ++i) {
    if (dims[i] < 0) return fail(PyExc_ValueError, c, "a negative size");
  }
  if (c.device < 0) return fail(PyExc_ValueError, c, "an output's shape before any tensor");
  if (c.nouts == kMaxOutputs) return fail(PyExc_ValueError, c, "too many outputs");
  // as torch's own operators make their outputs, past the dispatcher
  at::TensorBase t = at::detail::empty_cuda(
      c10::IntArrayRef(dims, (size_t)nd), p.dtype,
      c10::Device(c10::kCUDA, (c10::DeviceIndex)c.device), std::nullopt);
  v.ptr = t.data_ptr();
  c.outs[c.nouts++] = std::move(t);
  return true;
}

bool int_arg(PyObject* o, Call& c, int64_t& v) {
  if (!PyLong_Check(o)) return fail(PyExc_TypeError, c, "want an int");
  v = PyLong_AsLongLong(o);
  return !(v == -1 && PyErr_Occurred());
}

// argument c.index, for parameter p
bool convert(PyObject* o, Call& c, const Param& p, Slot& v) {
  switch (p.kind) {
    case Kind::kInput:
    case Kind::kOutput:
      if (PyObject_TypeCheck(o, reinterpret_cast<PyTypeObject*>(g_tensor_type))) {
        return tensor_arg(o, c, p, v);
      }
      if (p.kind == Kind::kOutput) return new_output(o, c, p, v);
      return fail(PyExc_TypeError, c, "want a tensor");
    case Kind::kInt64:
      return int_arg(o, c, v.i64);
    case Kind::kInt32: {
      int64_t w = 0;
      if (!int_arg(o, c, w)) return false;
      if (w < INT32_MIN || w > INT32_MAX) return fail(PyExc_OverflowError, c, "outside int32");
      v.i32 = (int32_t)w;
      return true;
    }
    case Kind::kDouble:
      if (!PyFloat_Check(o) && !PyLong_Check(o)) return fail(PyExc_TypeError, c, "want a float");
      v.f64 = PyFloat_AsDouble(o);
      return !(v.f64 == -1.0 && PyErr_Occurred());
    case Kind::kStream:
      break;
  }
  return fail(PyExc_TypeError, c, "no argument for the stream");
}

PyObject* outputs(Call& c) {
  if (c.nouts == 0) Py_RETURN_NONE;
  if (c.nouts == 1) return THPVariable_Wrap(c.outs[0]);
  PyObject* tup = PyTuple_New(c.nouts);
  if (tup == nullptr) return nullptr;
  for (int i = 0; i < c.nouts; ++i) {
    PyObject* t = THPVariable_Wrap(c.outs[i]);
    if (t == nullptr) {
      Py_DECREF(tup);
      return nullptr;
    }
    PyTuple_SET_ITEM(tup, i, t);
  }
  return tup;
}

bool count(PyObject* key) {
  if (g_counts == nullptr) return true;
  PyObject* old = PyDict_GetItemWithError(g_counts, key);
  if (old == nullptr && PyErr_Occurred()) return false;
  const long long n = old == nullptr ? 0 : PyLong_AsLongLong(old);
  if (n == -1 && PyErr_Occurred()) return false;
  PyObject* now = PyLong_FromLongLong(n + 1);
  if (now == nullptr) return false;
  const int rc = PyDict_SetItem(g_counts, key, now);
  Py_DECREF(now);
  return rc == 0;
}

// the tensors' card made current for the launch, and the one before
// made current again after it
struct OnDevice {
  explicit OnDevice(c10::DeviceIndex dev) {
    const c10::DeviceIndex cur = c10::cuda::current_device();
    if (cur != dev) {
      c10::cuda::set_device(dev);
      before = cur;
    }
  }
  ~OnDevice() {
    if (before >= 0) c10::cuda::set_device(before);
  }
  c10::DeviceIndex before = -1;
};

PyObject* run(const Entry& e, PyObject* const* args, Py_ssize_t nargs) {
  const int n = e.nparams - 1;      // the stream is the binding's
  if (nargs != n) {
    return PyErr_Format(PyExc_TypeError, "%s takes %d arguments, %zd given", e.name, n, nargs);
  }
  Call c(e.name);
  Slot slots[kMaxParams];
  try {
    for (int i = 0; i < n; ++i) {      // in parameter order, stopping at the first refusal
      c.index = i + 1;
      if (!convert(args[i], c, e.params[i], slots[i])) return nullptr;
    }
    if (c.device < 0) return PyErr_Format(PyExc_ValueError, "%s: no tensor", e.name);
    const auto dev = (c10::DeviceIndex)c.device;
    OnDevice on(dev);
    slots[n].ptr = c10::cuda::getCurrentCUDAStream(dev).stream();
    const int rc = e.call(slots);
    if (rc != 0) return PyErr_Format(PyExc_RuntimeError, "%s: CUDA error %d at launch", e.name, rc);
  } catch (const c10::Error& err) {
    PyErr_SetString(PyExc_RuntimeError, err.what_without_backtrace());
    return nullptr;
  } catch (const std::exception& err) {
    PyErr_SetString(PyExc_RuntimeError, err.what());
    return nullptr;
  }
  if (!count(e.key)) return nullptr;
  return outputs(c);
}

#define RMI_ENTRY(name, proto)                                                      \
  {#name, Sig<decltype(&name)>::params, Sig<decltype(&name)>::N,                   \
   &Sig<decltype(&name)>::call<&name>, nullptr},
Entry g_entries[] = {
#include "entries.h"
};
#undef RMI_ENTRY

constexpr Py_ssize_t kEntries = sizeof(g_entries) / sizeof(g_entries[0]);

PyObject* g_index = nullptr;   // name -> index into g_entries

PyObject* launch(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs < 1 || !PyUnicode_Check(args[0])) {
    PyErr_SetString(PyExc_TypeError, "launch(name, *args): name must be a str");
    return nullptr;
  }
  PyObject* at = PyDict_GetItemWithError(g_index, args[0]);
  if (at == nullptr) {
    if (!PyErr_Occurred()) PyErr_Format(PyExc_ValueError, "unknown C entry point %R", args[0]);
    return nullptr;
  }
  return run(g_entries[PyLong_AsSsize_t(at)], args + 1, nargs - 1);
}

PyObject* set_counts(PyObject*, PyObject* d) {
  if (!PyDict_Check(d)) {
    PyErr_SetString(PyExc_TypeError, "set_counts takes a dict");
    return nullptr;
  }
  Py_INCREF(d);
  Py_XSETREF(g_counts, d);
  Py_RETURN_NONE;
}

PyMethodDef g_methods[] = {
    {"launch", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(launch)),
     METH_FASTCALL, "launch(name, *args): call C entry `name` on the current stream."},
    {"set_counts", set_counts, METH_O, "set_counts(d): count each launch in d[name]."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef g_module = {PyModuleDef_HEAD_INIT, "rmi_kernels", nullptr, -1, g_methods,
                        nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_rmi_kernels() {
  PyObject* torch = PyImport_ImportModule("torch");
  if (torch == nullptr) return nullptr;
  g_tensor_type = PyObject_GetAttrString(torch, "Tensor");
  Py_DECREF(torch);
  if (g_tensor_type == nullptr) return nullptr;
  if (!PyType_Check(g_tensor_type)) {
    PyErr_SetString(PyExc_TypeError, "torch.Tensor is not a type");
    return nullptr;
  }
  g_cdata = PyUnicode_InternFromString("_cdata");
  g_index = PyDict_New();
  if (g_cdata == nullptr || g_index == nullptr) return nullptr;
  for (Py_ssize_t i = 0; i < kEntries; ++i) {
    g_entries[i].key = PyUnicode_InternFromString(g_entries[i].name);
    PyObject* at = PyLong_FromSsize_t(i);
    if (g_entries[i].key == nullptr || at == nullptr ||
        PyDict_SetItem(g_index, g_entries[i].key, at) != 0) {
      Py_XDECREF(at);
      return nullptr;
    }
    Py_DECREF(at);
  }
  return PyModule_Create(&g_module);
}
