"""Seeded violation for kernel_parity: a CUDA kernel wrapper with no
plain version, no ops.py entry, no cuda-marked test, no phase-2 case, and
a launcher symbol in a source that does not exist."""
import ctypes

from repro_torch.kernels import _build

launches = {"rowcopy": 0}


def rowcopy(x, out):
    fn = _build.function("rowcopy", "rowcopy_f32", [ctypes.c_void_p] * 2)
    fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()))
    launches["rowcopy"] += 1
    return out
