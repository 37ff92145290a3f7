"""Seeded violation for cost: a CUDA kernel wrapper with no KERNEL_COSTS
formula."""
import ctypes

from repro_torch.kernels import _build

launches = {"mystery_scan": 0}


def mystery_scan(x, out):
    fn = _build.function("mystery", "mystery_scan_f32", [ctypes.c_void_p] * 2)
    fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()))
    launches["mystery_scan"] += 1
    return out
